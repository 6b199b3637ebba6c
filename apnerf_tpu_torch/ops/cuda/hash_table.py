"""The hash grid table's backward, summed in a fixed order
(``csrc/hash_table_bwd.cu``).

``hash_table_bwd(n_rows, idx, g)`` is the gradient of a row gather
``table[idx]`` from a table of ``n_rows`` rows: d [n_rows, F], each row the
sum of the cotangent rows g [M, F] whose index is that row. On the card the
indices are sorted stably (``torch.sort``) and the CUDA kernel sums each
row's terms in an order fixed by the sorted positions, with no atomics, so a
run repeats bit for bit; for CPU tensors its plain version, ``index_add_``,
adds the terms one by one in ascending m. PyTorch's ``index_add_`` on the
card adds with float atomics, in an order that changes from run to run, and
its accumulating ``index_put_``, which sorts too, sums each row's run
serially: on an H100 (``chip_smoke.py`` phase 30, PERF.md) 512 ms for one
row of 2^21 terms, against 0.82 ms for this kernel with its sort.

The kernel replaces no Pallas kernel: its JAX counterpart is XLA's
transpose of the table gather in ``apnerf_tpu/ops/hashgrid.py``,
deterministic there. ``ops/hashgrid.py`` takes it as the backward of
every table gather.
"""

from __future__ import annotations

import torch

from . import build

# sorted positions a warp of the kernel's first pass sums (kTile)
TILE = 1024


def hash_table_bwd_plain(n_rows: int, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``index_add_`` of g [M, F] at idx [M] into zeros [n_rows, F]."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx, g)


def n_tiles(M: int) -> int:
    """Tiles of ``TILE`` sorted positions over M rows: the first pass's warps
    and the second pass's threads."""
    return -(-M // TILE)


def hash_table_bwd(n_rows: int, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d [n_rows, F] from the cotangents g [M, F] (float32) of the rows
    gathered at idx [M] (int32): the kernel for CUDA tensors, the plain
    version for CPU tensors. An index outside [0, n_rows) adds nothing on
    the card (the gather refuses it first)."""
    if g.device.type == "cpu":
        return hash_table_bwd_plain(n_rows, idx, g)
    if g.device.type != "cuda":
        raise ValueError(f"hash_table_bwd: unsupported device {g.device}")
    if g.dim() != 2 or idx.dim() != 1 or idx.shape[0] != g.shape[0] or n_rows < 1:
        raise ValueError(f"hash_table_bwd: cotangents [M, F] and indices [M] into at least one "
                         f"row, got {tuple(g.shape)} and {tuple(idx.shape)} into {n_rows}")
    if g.dtype != torch.float32 or idx.dtype != torch.int32 or idx.device != g.device:
        raise ValueError(f"hash_table_bwd: float32 cotangents and int32 indices on one device, "
                         f"got {g.dtype} on {g.device} and {idx.dtype} on {idx.device}")
    M, F = g.shape
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=g.device)
    if M == 0 or F == 0:
        return out
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    skey, perm = torch.sort(idx, stable=True)
    T = n_tiles(M)
    head = torch.empty((T, F), dtype=torch.float32, device=g.device)
    tail = torch.empty((T, F), dtype=torch.float32, device=g.device)
    cont = torch.empty((T,), dtype=torch.uint8, device=g.device)
    err = build.library().apnerf_hash_table_bwd(
        skey.data_ptr(), perm.data_ptr(), g.data_ptr(), M, F, n_rows, out.data_ptr(),
        head.data_ptr(), tail.data_ptr(), cont.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_table_bwd: CUDA launch failed, error {err}")
    hash_table_bwd.launches += 1
    return out


# kernel launches since the counter was last reset (chip_smoke.py reads it)
hash_table_bwd.launches = 0
