"""Density activation shared by the fields.

Port of ``apnerf_tpu/models/ngp.py::trunc_exp``: ``exp`` whose gradient
is taken at the input clamped to 15 (``ngp.py:38-48``), so a large raw
density cannot produce an infinite gradient.
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
