"""Multiresolution hash-grid encoding (Instant-NGP).

Port of ``apnerf_tpu/ops/hashgrid.py``: ``HashGridConfig``,
``init_hash_table``, ``_level_indices`` and ``hash_encode``. One [L, T, F]
table (every level the same size, as tiny-cuda-nn keeps it); levels
whose dense (res+1)³ grid fits T index by stride, larger ones by the
Instant-NGP xor-of-prime-multiples hash. Per level a position is scaled
by the level's resolution, floored, and the 8 surrounding vertices'
features are blended with trilinear weights.

``hash_encode`` gathers every level's corners in one ``index_select`` on
the flat [L·T, F] table (int32 indices, per-level offsets), each row of F
float32 features read as one element of F·4 bytes (``_RowGather``); its
backward is an ``index_add_`` of the rows' cotangents into the flat table.
On the card that add is made with atomics, so the table's gradient is not
bit-repeatable between runs. The JAX package's row-gather custom VJP and
its ``optimization_barrier`` fences were workarounds for the TPU's
gathers and are not carried over.

The hash works in uint32 in JAX (multiplications wrap). Here it works in
int64 on coordinates masked to 32 bits: ``(c * prime) & 0xFFFFFFFF``,
then xor, then ``% T``, which equals the wrapped uint32 result bit for
bit (an int64 product that overflows wraps modulo 2⁶⁴ and keeps its low
32 bits).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 4
    log2_table_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 4096

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def per_level_scale(self) -> float:
        return float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / max(self.n_levels - 1, 1)
            )
        )

    @property
    def resolutions(self) -> np.ndarray:
        """Per-level grid resolution, floor(base · scale^l) as in tcnn."""
        s = self.per_level_scale
        return np.array(
            [int(np.floor(self.base_resolution * (s**l) + 1e-6)) for l in range(self.n_levels)],
            dtype=np.int32,
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hash_table(
    cfg: HashGridConfig, generator: torch.Generator, device=None
) -> torch.Tensor:
    """[L, T, F] float32 drawn U(-1e-4, 1e-4), as tcnn initializes it."""
    u = torch.rand(
        (cfg.n_levels, cfg.table_size, cfg.n_features), generator=generator,
        device=generator.device,
    ).to(device)
    return u * 2e-4 - 1e-4


def _level_indices(coords: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """Table index (int64) for integer grid coordinates [..., 3] at one
    level: stride indexing when the (res+1)³ grid fits the table, else the
    spatial hash."""
    c = coords.long() & _MASK32  # JAX casts to uint32
    if (res + 1) ** 3 <= table_size:
        stride = res + 1
        return (c[..., 0] + c[..., 1] * stride + c[..., 2] * (stride * stride)) & _MASK32
    h = (c[..., 0] * _PRIMES[0]) & _MASK32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _MASK32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _MASK32)
    return h % table_size


def _corner_indices_and_weights(x: torch.Tensor, cfg: HashGridConfig):
    """Flat-table corner indices [L, N, 8] (int32, the level's offset
    added) and trilinear weights [L, N, 8] for unit-cube positions x
    [N, 3]. Corner c = 4i + 2j + k takes the (i, j, k) offset, as JAX's
    ``_CORNERS`` orders them. Differentiable in x through the weights.

    Positions outside the unit cube (their density is zeroed by the
    field's selector) index as JAX's gather does: dense levels by signed
    stride arithmetic, a negative flat index wrapped once by L·T and then
    every index clamped into the table."""
    L, T = cfg.n_levels, cfg.table_size
    resolutions = cfg.resolutions
    res_f = torch.as_tensor(resolutions, dtype=x.dtype, device=x.device)[:, None, None]
    xs = x[None] * res_f  # [L, N, 3]
    x0f = torch.floor(xs)
    w = xs - x0f
    x0 = x0f.long()
    # per dimension, the weight of offset 0 (1 - w) and of offset 1 (w)
    cw = [torch.stack([1.0 - w[..., d], w[..., d]], dim=-1) for d in range(3)]  # [L, N, 2]
    weights = (
        cw[0][..., :, None, None] * cw[1][..., None, :, None] * cw[2][..., None, None, :]
    ).reshape(L, x.shape[0], 8)
    # per dimension, the coordinate with offsets 0 and 1 [L, N, 2]; the 8
    # corners come from broadcasting them, corner 4i + 2j + k at (i, j, k)
    c = [x0[..., d, None] + torch.arange(2, device=x.device) for d in range(3)]
    dense = (resolutions.astype(np.int64) + 1) ** 3 <= T  # [L], static
    flat = torch.empty((L, x.shape[0], 8), dtype=torch.long, device=x.device)
    for sel, is_dense in ((np.flatnonzero(dense), True), (np.flatnonzero(~dense), False)):
        if not len(sel):
            continue
        lv = torch.as_tensor(sel, device=x.device)
        cs = [ci[lv] for ci in c]
        if is_dense:
            stride = torch.as_tensor(resolutions[sel].astype(np.int64) + 1,
                                     device=x.device)[:, None, None]
            cs = [cs[0], cs[1] * stride, cs[2] * (stride * stride)]
            f = cs[0][..., :, None, None] + cs[1][..., None, :, None] + cs[2][..., None, None, :]
        else:
            h = [((ci & _MASK32) * p) & _MASK32 for ci, p in zip(cs, _PRIMES)]
            f = (h[0][..., :, None, None] ^ h[1][..., None, :, None]
                 ^ h[2][..., None, None, :]) % T
        flat[lv] = f.reshape(len(sel), -1, 8)
    flat = flat + torch.arange(L, device=x.device)[:, None, None] * T
    idx = torch.where(flat < 0, flat + L * T, flat).clamp_(0, L * T - 1).to(torch.int32)
    return idx, weights


# a dtype as wide as a row of F float32 features, for F in the keys
_ROW_VIEW = {1: torch.int32, 2: torch.int64, 4: torch.complex128}


class _RowGather(torch.autograd.Function):
    """rows [M, F] = table [L·T, F] at idx [M] (int32). The forward reads
    each row as one element of F·4 bytes: on an H100 (PERF.md) every
    PyTorch gather of rows of 4 floats (``index_select``, advanced
    indexing, ``gather``, ``embedding``) took 20.2 ms at the train shape,
    33.5M rows, and ``index_select`` of the same rows as 16-byte elements
    0.32 ms; the bits are the same. The backward adds the rows' cotangents
    into a zero table with ``index_add_``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        view = _ROW_VIEW.get(table.shape[1])
        if view is None or table.dtype != torch.float32 or not table.is_contiguous():
            return table.index_select(0, idx)
        return table.view(view).index_select(0, idx).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        return d.index_add_(0, idx, g), None


def hash_encode(
    table: torch.Tensor,  # [L, T, F]
    x: torch.Tensor,  # [N, 3] in [0, 1]
    cfg: HashGridConfig,
) -> torch.Tensor:
    """Unit-cube positions → [N, L·F] features, level-major."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    N = x.shape[0]
    idx, weights = _corner_indices_and_weights(x, cfg)
    vals = _RowGather.apply(table.reshape(L * T, F), idx.reshape(-1)).view(L, N, 8, F)
    out = (vals * weights[..., None]).sum(dim=2)  # [L, N, F]
    return out.permute(1, 0, 2).reshape(N, L * F)
