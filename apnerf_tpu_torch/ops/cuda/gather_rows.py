"""Row gathers whose backward sums in a fixed order (``csrc/gather_rows.cu``).

``gather_rows(src, idx)`` is ``src.gather(-1, idx)`` and
``gather_rows_pair(src, idx_a, idx_b)`` two such gathers of one source.
Their forward is PyTorch's gather, a plain read. Their backward scatters
the cotangents back into the source's rows: on the card by the CUDA kernel
``gather_rows_bwd``, which sums each (row, bin)'s terms in ascending order
with no atomics, so a run repeats bit for bit, for any number of bins and
of queries; for CPU tensors by its plain version, ``scatter_add_``, whose
sequential sum the kernel matches bit for bit. PyTorch's own backward of a
gather is ``scatter_add_`` on the card too, with ``atomicAdd`` in an order
that changes from run to run.

The kernel replaces no Pallas kernel: its JAX counterpart is XLA's
transpose of ``take_along_axis`` / ``take_onehot``
(``apnerf_tpu/models/propnet.py:119-125``, ``apnerf_tpu/ops/pdf.py:74``),
deterministic there. The port routes every gather that carries a gradient
through it: the proposal loss's ``_outer`` (``models/propnet.py``) and the
inverse CDF of ``ops/pdf.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import build


def gather_rows_bwd_plain(n_bins: int, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                          ) -> torch.Tensor:
    """Σ over ``pairs`` (cotangent g [R, Q], index [R, Q]) in order of
    ``scatter_add_`` into zeros [R, n_bins]: on the CPU each row's terms are
    added one by one in ascending q, list after list."""
    g0 = pairs[0][0]
    out = torch.zeros(g0.shape[:-1] + (n_bins,), dtype=g0.dtype, device=g0.device)
    for g, idx in pairs:
        out.scatter_add_(-1, idx, g)
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_rows_bwd(n_bins: int, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> torch.Tensor:
    """d_src [R, n_bins] from one or two (cotangent [R, Q] f32, index [R, Q]
    int64) pairs of the same shape: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    g0 = pairs[0][0]
    if g0.device.type == "cpu":
        return gather_rows_bwd_plain(n_bins, pairs)
    if g0.device.type != "cuda":
        raise ValueError(f"gather_rows_bwd: unsupported device {g0.device}")
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"gather_rows_bwd: one or two index lists, got {len(pairs)}")
    if g0.dim() != 2 or n_bins < 1:
        raise ValueError(f"gather_rows_bwd: [R, Q] cotangents into at least 1 bin, got "
                         f"{tuple(g0.shape)} into {n_bins}")
    for g, idx in pairs:
        if g.dtype != torch.float32 or idx.dtype != torch.int64 or g.device != g0.device \
                or idx.device != g0.device or g.shape != g0.shape or idx.shape != g0.shape:
            raise ValueError(
                f"gather_rows_bwd: float32 cotangents and int64 indices of shape "
                f"{tuple(g0.shape)} on {g0.device}, got {g.dtype} {tuple(g.shape)} on "
                f"{g.device} and {idx.dtype} {tuple(idx.shape)} on {idx.device}")
        if not (g.is_contiguous() and idx.is_contiguous()):
            raise ValueError("gather_rows_bwd: cotangents and indices must be contiguous")
    R, Q = g0.shape
    out = torch.empty((R, n_bins), dtype=torch.float32, device=g0.device)
    if R == 0:
        return out
    if Q == 0:
        return out.zero_()
    (g_a, idx_a), (g_b, idx_b) = pairs[0], (pairs[1] if len(pairs) == 2 else (None, None))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.library().apnerf_gather_rows_bwd(
        g_a.data_ptr(), idx_a.data_ptr(), ptr(g_b), ptr(idx_b), R, Q, n_bins, out.data_ptr(),
        _stream(g0))
    if err != 0:
        raise RuntimeError(f"gather_rows_bwd: CUDA launch failed, error {err}")
    gather_rows_bwd.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, *idx):
        ctx.save_for_backward(*idx)
        ctx.n_bins, ctx.dtype = src.shape[-1], src.dtype
        return tuple(src.gather(-1, i) for i in idx)

    @staticmethod
    def backward(ctx, *grads):
        idx = ctx.saved_tensors
        K = ctx.n_bins
        pairs = [(g.float().reshape(-1, g.shape[-1]).contiguous(),
                  i.reshape(-1, i.shape[-1]).contiguous()) for g, i in zip(grads, idx)]
        d_src = gather_rows_bwd(K, pairs).reshape(idx[0].shape[:-1] + (K,)).to(ctx.dtype)
        return (d_src, *([None] * len(idx)))


def _check(src: torch.Tensor, idx: Sequence[torch.Tensor]):
    for i in idx:
        if i.shape[:-1] != src.shape[:-1] or i.shape != idx[0].shape:
            raise ValueError(f"gather_rows: indices {[tuple(i.shape) for i in idx]} for a "
                             f"source of {tuple(src.shape)}: one shape, the source's rows")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src.gather(-1, idx)`` (src [..., K], idx [..., Q] int64 → [..., Q]),
    whose gradient ``gather_rows_bwd`` sums."""
    _check(src, (idx,))
    if not (torch.is_grad_enabled() and src.requires_grad):
        return src.gather(-1, idx)
    return _GatherRows.apply(src, idx)[0]


def gather_rows_pair(src: torch.Tensor, idx_a: torch.Tensor, idx_b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``src.gather(-1, idx_a)``, ``src.gather(-1, idx_b)``), whose
    gradients into ``src`` one ``gather_rows_bwd`` sums: list a, then b."""
    _check(src, (idx_a, idx_b))
    if not (torch.is_grad_enabled() and src.requires_grad):
        # no backward to record (the renders' sampling): the gathers alone,
        # without a Function's host work
        return src.gather(-1, idx_a), src.gather(-1, idx_b)
    return _GatherRows.apply(src, idx_a, idx_b)


# kernel launches since the counter was last reset (chip_smoke.py reads it)
gather_rows_bwd.launches = 0
