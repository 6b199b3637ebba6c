"""Volume-rendering weights in one CUDA kernel (``csrc/volrend.cu``).

Port of ``apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights``,
forward only. Where the JAX function returns the weights alone, this one
returns (weights, transmittance, alphas), the triple that
``render_weight_from_density`` returns, since that is the function it
serves in the port. ``fused_render_weights`` launches the kernel for CUDA
tensors and takes ``fused_render_weights_plain`` only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

MAX_SAMPLES = 1024


def fused_render_weights_plain(t0, t1, sigmas):
    """``render_weight_from_density`` as plain PyTorch ops
    (``apnerf_tpu/ops/volrend.py:55-83``)."""
    from ..volrend import render_transmittance_from_density  # volrend imports this module

    trans, alphas = render_transmittance_from_density(t0, t1, sigmas)
    return trans * alphas, trans, alphas


def fused_render_weights(
    t0: torch.Tensor,  # [R, S] f32
    t1: torch.Tensor,  # [R, S] f32
    sigmas: torch.Tensor,  # [R, S] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (weights, trans, alphas), each [R, S] f32. A CUDA tensor launches
    the kernel or raises."""
    if sigmas.device.type == "cpu":
        return fused_render_weights_plain(t0, t1, sigmas)
    if sigmas.device.type != "cuda":
        raise ValueError(f"fused_render_weights: unsupported device {sigmas.device}")
    if sigmas.dim() != 2:
        raise ValueError("fused_render_weights: inputs must be [R, S]")
    R, S = sigmas.shape
    if S > MAX_SAMPLES:
        raise ValueError(f"fused_render_weights: S={S} exceeds {MAX_SAMPLES}")
    for name, t in (("t0", t0), ("t1", t1), ("sigmas", sigmas)):
        if t.device != sigmas.device or t.dtype != torch.float32 or t.shape != (R, S):
            raise ValueError(
                f"fused_render_weights: {name} must be float32 {(R, S)} on "
                f"{sigmas.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_render_weights: {name} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError("fused_render_weights: the CUDA kernel is forward-only")
    out = [torch.empty((R, S), dtype=torch.float32, device=sigmas.device) for _ in range(3)]
    if R == 0 or S == 0:
        return tuple(out)
    err = build.library().apnerf_fused_render_weights_fwd(
        t0.data_ptr(), t1.data_ptr(), sigmas.data_ptr(), R, S,
        *(o.data_ptr() for o in out),
        torch.cuda.current_stream(sigmas.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_render_weights: CUDA launch failed, error {err}")
    fused_render_weights.launches += 1
    return tuple(out)


# kernel launches since the counter was last reset (chip_smoke.py reads it)
fused_render_weights.launches = 0
