"""Dense volume rendering on ``[n_rays, n_samples]`` buffers.

Port of ``apnerf_tpu/ops/volrend.py`` (the functions the renderers use),
in plain PyTorch as JAX computes them without a kernel. The renderers
take their weights from the weights kernel instead,
``ops/cuda/volrend_cuda.py::fused_render_weights``, which returns the
weights alone; ``render_weight_from_density`` is the plain triple.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def exclusive_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def render_transmittance_from_density(
    t_starts: torch.Tensor, t_ends: torch.Tensor, sigmas: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (trans, alphas), each [R, S]."""
    sigmas_dt = sigmas * (t_ends - t_starts)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    trans = torch.exp(-exclusive_sum(sigmas_dt, dim=-1))
    return trans, alphas


def render_weight_from_density(
    t_starts: torch.Tensor, t_ends: torch.Tensor, sigmas: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (weights, trans, alphas), each [R, S]."""
    trans, alphas = render_transmittance_from_density(t_starts, t_ends, sigmas)
    return trans * alphas, trans, alphas


def render_visibility_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    early_stop_eps: float = 1e-4,
    alpha_thre=0.0,  # float or 0-dim tensor
) -> torch.Tensor:
    """Boolean visibility [R, S] (``volrend.py:120-151``): a sample is kept
    iff its alpha clears ``alpha_thre`` and the transmittance over the
    earlier kept samples stays above ``early_stop_eps`` (samples that fail
    the alpha test do not attenuate)."""
    sigmas_dt = sigmas * (t_ends - t_starts)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    vis_alpha = alphas >= alpha_thre
    kept = torch.where(vis_alpha, sigmas_dt, torch.zeros_like(sigmas_dt))
    trans = torch.exp(-exclusive_sum(kept, dim=-1))
    return vis_alpha & (trans > early_stop_eps)


def accumulate_along_rays(
    weights: torch.Tensor,  # [R, S]
    values: Optional[torch.Tensor] = None,  # [R, S, C]
) -> torch.Tensor:
    """Σ_i w_i v_i per ray → [R, C] ([R, 1] opacity when values is None)."""
    if values is None:
        return weights.sum(dim=-1, keepdim=True)
    return torch.einsum("rs,rsc->rc", weights, values)


def render_outputs(
    weights: torch.Tensor,  # [R, S]
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    rgbs: torch.Tensor,  # [R, S, 3]
    sems: Optional[torch.Tensor] = None,  # [R, S, C] logits
    render_bkgd: Optional[torch.Tensor] = None,  # [3]
) -> Dict[str, torch.Tensor]:
    """Colors, opacity, opacity-normalized depth and semantics; the
    background is composited onto color only (``volrend.py:154-201``)."""
    colors = accumulate_along_rays(weights, rgbs)
    opacities = accumulate_along_rays(weights, None)
    t_mid = ((t_starts + t_ends) * 0.5)[..., None]
    depths = accumulate_along_rays(weights, t_mid)
    eps = torch.finfo(rgbs.dtype).eps
    depths = depths / opacities.clamp(min=eps)
    out = {"rgb": colors, "opacity": opacities, "depth": depths}
    if sems is not None:
        out["sem"] = accumulate_along_rays(weights, sems)
    if render_bkgd is not None:
        out["rgb"] = out["rgb"] + render_bkgd * (1.0 - opacities)
    return out


def render_variance(
    weights: torch.Tensor,  # [R, S]
    values: torch.Tensor,  # [R, S, C]
    mean: torch.Tensor,  # [R, C]
) -> torch.Tensor:
    """Per-ray weighted variance Σ_i w_i (v_i - mean)² → [R, C]."""
    diff = values - mean[:, None, :]
    return torch.einsum("rs,rsc->rc", weights, diff * diff)
