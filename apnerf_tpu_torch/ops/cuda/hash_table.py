"""The hash grid table's gradient, summed in a fixed order
(``csrc/hash_table_bwd.cu``).

``hash_table_bwd(n_rows, idx, g, weights=None)`` is the table half of the
hash encoding's backward at JAX's boundary (``_rowgather_interp_bwd`` in
``apnerf_tpu/ops/hashgrid.py``): d [n_rows, F], each row the sum over the
terms m with ``idx[m]`` that row of ``weights[m] * g[m // K]``, g [M / K, F]
the encoding's cotangent and K = M / len(g) (8 trilinear corners a
position). Without weights (K = 1) it is the plain row gather's backward.

On the card the CUDA kernel partitions the terms by the index's high bits
(a count, scans, a stable sort of each batch of 2048 terms by bucket) and
sums each bucket of the table in shared memory, chunk by chunk: each chunk
by its tree, each key's sum then added to the slice. No float is added
atomically (integer atomics count, and name a chunk's keys, only), no
library sort or scatter runs, and the bits repeat
from run to run. ``hash_table_bwd_emulated`` is that order of adds in numpy,
bit for bit, for the tests and ``chip_smoke.py``. For CPU tensors the plain
version adds the products one by one in ascending m with ``index_add_``.

The kernel replaces no Pallas kernel: its JAX counterpart is XLA's
scatter-add of the weighted cotangents, deterministic there. PyTorch's
``index_add_`` on the card adds with float atomics, in an order that
changes from run to run, and its accumulating ``index_put_``, which sorts,
sums each row's run serially (on an H100, PERF.md: 512 ms for one row of
2^21 terms).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build

# the kernel's constants (csrc/hash_table_bwd.cu): threads and items a
# thread of the reduce block, terms a reduce block at most, a bucket's rows x
# F at most (its slice in shared memory), tiles a scan thread
THREADS, ITEMS, SEGMENT, SLICE_FLOATS, GROUP = 256, 4, 32768, 16384, 64
WARPS = THREADS // 32
CHUNK = THREADS * ITEMS
# terms a partition block sorts at once; a tile, a count or partition
# block's share of the terms, is a whole number of batches (``plan``): free
# of the order of adds
BATCH, BATCH_ITEMS = 2048, 8
# buckets a tile keeps its offsets of in shared memory, at most
MAX_BUCKETS = 16384
# dependent adds a term passes within a chunk, at most: its thread's chain,
# the warp's scan, the chain over the warps, the exclusive prefix
CHUNK_DEPTH = ITEMS + WARPS + 5


class Plan(NamedTuple):
    bits: int       # a bucket holds 2^bits rows
    n_buckets: int
    tile: int       # terms a count or partition block
    n_tiles: int
    n_groups: int
    max_slots: int  # partial slices of the split buckets, at most

    @property
    def ws_ints(self) -> int:
        """int32 words of the counts, the group sums and the bucket tables."""
        return (self.n_tiles + self.n_groups) * self.n_buckets + 5 * self.n_buckets + 4


def row_bits(F: int) -> int:
    """log2 of a bucket's rows: the most, a power of two, whose F floats a
    row fit ``SLICE_FLOATS``."""
    if not 1 <= F <= SLICE_FLOATS:
        raise ValueError(f"hash_table_bwd: 1 to {SLICE_FLOATS} features a row, got {F}")
    return (SLICE_FLOATS // F).bit_length() - 1


def plan(M: int, F: int, n_rows: int, slots: int = 512) -> Plan:
    """The launch plan of M terms of F features into n_rows rows, tiles
    sized so that the partition's blocks fill the card's ``slots`` once."""
    bits = row_bits(F)
    n_buckets = -(-n_rows // (1 << bits))
    if n_buckets > MAX_BUCKETS:
        raise ValueError(f"hash_table_bwd: {n_rows} rows of {F} features make {n_buckets} "
                         f"buckets, past {MAX_BUCKETS}")
    tile = BATCH * max(1, -(-M // (slots * BATCH)))
    n_tiles = -(-M // tile)
    return Plan(bits, n_buckets, tile, n_tiles, -(-n_tiles // GROUP), 2 * -(-M // SEGMENT))


def order_depth(bucket_terms: int, weighted: bool = False) -> int:
    """Dependent roundings a term passes, at most, in a bucket of
    ``bucket_terms`` terms: a chunk's tree, the add into the slice of each
    chunk of its segment, one for each segment in the combining chain, and
    the product's own where there are weights.
    A float32 sum in this order is within depth x 2^-24 x the sum of its
    terms' magnitudes of the exact sum."""
    chunks = -(-min(bucket_terms, SEGMENT) // CHUNK)
    return (CHUNK_DEPTH + chunks + max(1, -(-bucket_terms // SEGMENT))
            + int(weighted))


def _terms_per_row(M: int, g: torch.Tensor, weights) -> int:
    K = M // max(g.shape[0], 1)
    if (weights is None and K != 1) or K < 1 or K * g.shape[0] != M:
        raise ValueError(f"hash_table_bwd: {M} indices for {g.shape[0]} cotangent rows "
                         + ("with weights: M must be a multiple" if weights is not None
                            else "without weights: one a row"))
    return K


def hash_table_bwd_plain(n_rows: int, idx: torch.Tensor, g: torch.Tensor,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``index_add_`` of the terms ``weights[m] * g[m // K]`` (the product a
    separate multiply) at idx [M] into zeros [n_rows, F]."""
    if weights is not None:
        K = _terms_per_row(idx.shape[0], g, weights)
        g = g.repeat_interleave(K, dim=0) * weights[:, None]
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx, g)


@functools.lru_cache(maxsize=None)
def _slots(dev: torch.device, F: int, n_buckets: int, one_row: bool) -> int:
    """Partition blocks the card holds at once (the kernel's occupancy)."""
    with torch.cuda.device(dev):
        n = build.library().apnerf_hash_table_bwd_slots(F, n_buckets, int(one_row))
    if n <= 0:
        raise RuntimeError(f"hash_table_bwd: no partition block fits the card ({n})")
    return n


def hash_table_bwd(n_rows: int, idx: torch.Tensor, g: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d [n_rows, F] from the cotangent g [M / K, F] (float32), the indices
    idx [M] (int32) and the weights [M] (float32, or None: K = 1, all 1):
    the kernel for CUDA tensors, the plain version for CPU tensors. An index
    outside [0, n_rows) adds nothing on the card (the gather refuses it
    first)."""
    if g.device.type == "cpu":
        return hash_table_bwd_plain(n_rows, idx, g, weights)
    if g.device.type != "cuda":
        raise ValueError(f"hash_table_bwd: unsupported device {g.device}")
    if g.dim() != 2 or idx.dim() != 1 or n_rows < 1 or (
            weights is not None and tuple(weights.shape) != tuple(idx.shape)):
        raise ValueError(f"hash_table_bwd: cotangents [M / K, F], indices [M] and weights [M] "
                         f"into at least one row, got {tuple(g.shape)}, {tuple(idx.shape)} and "
                         f"{None if weights is None else tuple(weights.shape)} into {n_rows}")
    tensors = (g, idx) if weights is None else (g, idx, weights)
    if (g.dtype != torch.float32 or idx.dtype != torch.int32
            or (weights is not None and weights.dtype != torch.float32)
            or any(t.device != g.device for t in tensors)):
        raise ValueError(f"hash_table_bwd: float32 cotangents and weights, int32 indices, on one "
                         f"device, got {[(t.dtype, str(t.device)) for t in tensors]}")
    M, F = idx.shape[0], g.shape[1]
    if M == 0 or F == 0:
        return torch.zeros((n_rows, F), dtype=torch.float32, device=g.device)
    K = _terms_per_row(M, g, weights)
    if M >= 1 << 31:
        raise ValueError(f"hash_table_bwd: {M} terms, past the kernel's int32 positions")
    one_row = weights is not None and K % BATCH_ITEMS == 0
    p = plan(M, F, n_rows, _slots(g.device, F, plan(M, F, n_rows).n_buckets, one_row))
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    idx = idx.contiguous()
    if idx.data_ptr() % 16:
        idx = idx.clone()
    if weights is not None:
        weights = weights.contiguous()
        if weights.data_ptr() % 16:
            weights = weights.clone()
    dev = g.device
    out = torch.empty((n_rows, F), dtype=torch.float32, device=dev)
    ws = torch.empty(p.ws_ints, dtype=torch.int32, device=dev)
    keys = torch.empty(M, dtype=torch.int16, device=dev)
    fl = torch.empty(M * F + p.max_slots * (F << p.bits), dtype=torch.float32, device=dev)
    err = build.library().apnerf_hash_table_bwd(
        idx.data_ptr(), g.data_ptr(), 0 if weights is None else weights.data_ptr(), M, K, F,
        n_rows, p.bits, p.n_buckets, p.tile, ws.data_ptr(), keys.data_ptr(), fl.data_ptr(),
        fl.data_ptr() + 4 * M * F, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_table_bwd: CUDA launch failed, error {err}")
    hash_table_bwd.launches += 1
    return out


# kernel launches since the counter was last reset (chip_smoke.py reads it)
hash_table_bwd.launches = 0


def _shift(x, d, axis, fill):
    """x moved d places up ``axis`` (lane l reads lane l - d), ``fill`` below d."""
    out = np.roll(x, d, axis=axis)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, d)
    out[tuple(sl)] = fill
    return out


def _chunk_sums(keys, vals, R):
    """The kernel's trees: each key's sum within each chunk → (chunk, key,
    sum) of each run's last item. keys [n, CHUNK] (R past the chunk's
    terms), vals [n, CHUNK, F] float32 in ascending m. The terms are
    sorted stably by the order of their key's first appearance."""
    n, F = keys.shape[0], vals.shape[2]
    places = np.arange(CHUNK)
    first = np.full((n, CHUNK), CHUNK, np.int64)  # a term's key's first place, by key
    by_key = np.lexsort((np.broadcast_to(places, keys.shape), keys), axis=1)
    k_sorted = np.take_along_axis(keys, by_key, axis=1)
    group = np.r_[np.ones((n, 1), bool).T, (np.diff(k_sorted, axis=1) != 0).T].T
    head_place = np.maximum.accumulate(np.where(group, places, 0), axis=1)
    np.put_along_axis(first, by_key, np.take_along_axis(by_key, head_place, axis=1), axis=1)
    first = np.where(keys < R, first, CHUNK)
    order = np.lexsort((np.broadcast_to(places, keys.shape), first), axis=1)
    k = np.take_along_axis(keys, order, axis=1)
    v = np.take_along_axis(vals, order[..., None], axis=1)
    head = k != _shift(k, 1, 1, -1)
    nxt = np.roll(k, -1, axis=1)
    nxt[:, -1] = -1
    end = (k != nxt) & (k < R)
    h = head.reshape(n, THREADS, ITEMS)
    v = v.reshape(n, THREADS, ITEMS, F)
    acc = np.empty_like(v)
    acc[:, :, 0] = v[:, :, 0]
    for i in range(1, ITEMS):
        acc[:, :, i] = np.where(h[:, :, i, None], v[:, :, i], acc[:, :, i - 1] + v[:, :, i])
    fl = h.any(axis=2).reshape(n, WARPS, 32)
    s = acc[:, :, -1].reshape(n, WARPS, 32, F)
    lane = np.arange(32)[None, None, :]
    d = 1
    while d < 32:
        fu, su = _shift(fl, d, 2, False), _shift(s, d, 2, 0.0)
        s = np.where(((lane >= d) & ~fl)[..., None], su + s, s)
        fl = np.where(lane >= d, fl | fu, fl)
        d *= 2
    carry = np.zeros((n, WARPS, F), np.float32)
    for w in range(1, WARPS):
        carry[:, w] = (s[:, 0, 31] if w == 1 else
                       np.where(fl[:, w - 1, 31, None], s[:, w - 1, 31],
                                carry[:, w - 1] + s[:, w - 1, 31]))
    fx, ex = _shift(fl, 1, 2, False), _shift(s, 1, 2, 0.0)
    warp = np.arange(WARPS)[None, :, None]
    x = np.where(((warp > 0) & ~fx)[..., None], carry[:, :, None] + ex, ex)
    x[:, :, 0] = carry
    x = x.reshape(n, THREADS, 1, F)
    cont = ~np.logical_or.accumulate(h, axis=2)
    val = np.where(cont[..., None], x + acc, acc).reshape(n, CHUNK, F)
    c, i = np.nonzero(end)
    return c, k[c, i], val[c, i]


def hash_table_bwd_emulated(n_rows: int, idx, g, weights=None) -> np.ndarray:
    """The kernel's function in its order of adds, in numpy float32, bit
    for bit: the terms partitioned by bucket in ascending m, each bucket's
    segments of ``SEGMENT`` terms and their chunks of ``CHUNK``, each chunk
    sorted stably by the order of its keys' first appearance and summed by
    the chunk's tree, each key's sum chained into the segment's slice chunk
    after chunk, the segments' slices chained in order. Takes numpy arrays
    (or CPU tensors)."""
    idx = np.asarray(idx).astype(np.int64)
    g = np.asarray(g, dtype=np.float32)
    F = g.shape[1]
    if weights is None:
        terms = g
    else:
        K = idx.shape[0] // g.shape[0]
        terms = np.repeat(g, K, axis=0) * np.asarray(weights, dtype=np.float32)[:, None]
    bits = row_bits(F)
    R = 1 << bits
    keep = np.nonzero((idx >= 0) & (idx < n_rows))[0]
    bucket = idx[keep] >> bits
    order = np.argsort(bucket, kind="stable")
    keep, bucket = keep[order], bucket[order]
    n_buckets = -(-n_rows // R)
    total = np.bincount(bucket, minlength=n_buckets)
    base = np.r_[0, np.cumsum(total)[:-1]]
    nseg = np.maximum(1, -(-total // SEGMENT))
    seg_first = np.r_[0, np.cumsum(nseg)]
    # each term's segment and place in it
    q = np.arange(len(keep)) - base[bucket]
    seg = seg_first[bucket] + q // SEGMENT
    r = q % SEGMENT
    seg_terms = np.bincount(seg, minlength=seg_first[-1])
    seg_chunks = -(-seg_terms // CHUNK)
    chunk_first = np.r_[0, np.cumsum(seg_chunks)]
    chunk = chunk_first[seg] + r // CHUNK
    keys = np.full((chunk_first[-1], CHUNK), R, np.int64)
    vals = np.zeros((chunk_first[-1], CHUNK, F), np.float32)
    keys[chunk, r % CHUNK] = idx[keep] & (R - 1)
    vals[chunk, r % CHUNK] = terms[keep]
    n_chunks = chunk_first[-1]
    with np.errstate(over="ignore", invalid="ignore"):
        c, k, v = _chunk_sums(keys, vals, R)
    # chunk by chunk into their segments' slices: each key's sum in the chunk
    chunk_seg = np.repeat(np.arange(seg_first[-1]), seg_chunks)
    step = np.arange(n_chunks) - chunk_first[chunk_seg]
    slices = np.zeros((seg_first[-1] * R, F), np.float32)
    at = chunk_seg[c] * R + k
    for s in range(int(seg_chunks.max(initial=0))):
        sel = step[c] == s
        slices[at[sel]] = slices[at[sel]] + v[sel]
    slices = slices.reshape(seg_first[-1], R, F)
    out = np.zeros((n_buckets * R, F), np.float32)
    for b in range(n_buckets):
        acc = slices[seg_first[b]]
        for s in range(seg_first[b] + 1, seg_first[b + 1]):
            acc = acc + slices[s]
        out[b * R:(b + 1) * R] = acc
    return out[:n_rows]
