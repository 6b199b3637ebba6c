"""Volume-rendering weights in CUDA kernels (``csrc/volrend.cu``).

Port of ``apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights``,
forward and backward. Where the JAX function returns the weights alone,
this one returns (weights, transmittance, alphas), the triple that
``render_weight_from_density`` returns, since that is the function it
serves in the port. As in the JAX function, only the weights are
differentiable: on the card the transmittance and alphas come out with
no gradient. ``fused_render_weights`` launches the kernels for CUDA
tensors and takes ``fused_render_weights_plain`` only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

MAX_SAMPLES = 1024


def fused_render_weights_plain(t0, t1, sigmas):
    """``render_weight_from_density`` as plain PyTorch ops
    (``apnerf_tpu/ops/volrend.py:55-83``); autograd gives its backward."""
    from ..volrend import render_transmittance_from_density  # volrend imports this module

    trans, alphas = render_transmittance_from_density(t0, t1, sigmas)
    return trans * alphas, trans, alphas


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_launch(t0, t1, sigmas):
    R, S = sigmas.shape
    out = [torch.empty((R, S), dtype=torch.float32, device=sigmas.device) for _ in range(3)]
    if R == 0 or S == 0:
        return tuple(out)
    err = build.library().apnerf_fused_render_weights_fwd(
        t0.data_ptr(), t1.data_ptr(), sigmas.data_ptr(), R, S,
        *(o.data_ptr() for o in out), _stream(sigmas),
    )
    if err != 0:
        raise RuntimeError(f"fused_render_weights: CUDA launch failed, error {err}")
    fused_render_weights.launches += 1
    return tuple(out)


def fused_render_weights_bwd(t0, t1, sigmas, g):
    """(t0, t1, σ, dL/dw) → (dσ, dt0, dt1), each [R, S] f32, by the
    backward kernel. CUDA tensors only."""
    if sigmas.device.type != "cuda":
        raise ValueError(f"fused_render_weights_bwd: unsupported device {sigmas.device}")
    for name, t in (("t0", t0), ("t1", t1), ("sigmas", sigmas), ("g", g)):
        _check(t, name, sigmas)
    R, S = sigmas.shape
    out = [torch.empty((R, S), dtype=torch.float32, device=sigmas.device) for _ in range(3)]
    if R == 0 or S == 0:
        return tuple(out)
    err = build.library().apnerf_fused_render_weights_bwd(
        t0.data_ptr(), t1.data_ptr(), sigmas.data_ptr(), g.data_ptr(), R, S,
        *(o.data_ptr() for o in out), _stream(sigmas),
    )
    if err != 0:
        raise RuntimeError(f"fused_render_weights_bwd: CUDA launch failed, error {err}")
    fused_render_weights_bwd.launches += 1
    return tuple(out)


class _RenderWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t0, t1, sigmas):
        w, trans, alphas = _fwd_launch(t0, t1, sigmas)
        ctx.save_for_backward(t0, t1, sigmas)
        ctx.mark_non_differentiable(trans, alphas)
        return w, trans, alphas

    @staticmethod
    def backward(ctx, g, _g_trans, _g_alphas):
        t0, t1, sigmas = ctx.saved_tensors
        dsig, dt0, dt1 = fused_render_weights_bwd(t0, t1, sigmas, g.float().contiguous())
        return dt0, dt1, dsig


def _check(t, name, sigmas):
    R, S = sigmas.shape
    if t.device != sigmas.device or t.dtype != torch.float32 or t.shape != (R, S):
        raise ValueError(
            f"fused_render_weights: {name} must be float32 {(R, S)} on "
            f"{sigmas.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_render_weights: {name} must be contiguous")


def fused_render_weights(
    t0: torch.Tensor,  # [R, S] f32
    t1: torch.Tensor,  # [R, S] f32
    sigmas: torch.Tensor,  # [R, S] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (weights, trans, alphas), each [R, S] f32. A CUDA tensor launches
    the forward kernel, and the backward kernel when a gradient flows
    through the weights, or raises."""
    if sigmas.device.type == "cpu":
        return fused_render_weights_plain(t0, t1, sigmas)
    if sigmas.device.type != "cuda":
        raise ValueError(f"fused_render_weights: unsupported device {sigmas.device}")
    if sigmas.dim() != 2:
        raise ValueError("fused_render_weights: inputs must be [R, S]")
    if sigmas.shape[1] > MAX_SAMPLES:
        raise ValueError(f"fused_render_weights: S={sigmas.shape[1]} exceeds {MAX_SAMPLES}")
    for name, t in (("t0", t0), ("t1", t1), ("sigmas", sigmas)):
        _check(t, name, sigmas)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (t0, t1, sigmas)):
        return _RenderWeights.apply(t0, t1, sigmas)
    return _fwd_launch(t0, t1, sigmas)


# kernel launches since the counters were last reset (chip_smoke.py reads them)
fused_render_weights.launches = 0
fused_render_weights_bwd.launches = 0
