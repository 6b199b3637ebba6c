"""Dense volume rendering on ``[n_rays, n_samples]`` buffers.

Port of ``apnerf_tpu/ops/volrend.py``, in plain PyTorch as JAX computes
it without a kernel: the density side (transmittance, weights with an
optional ``prefix_trans`` for chunked marching, visibility), the alpha
side (``exclusive_prod`` and the transmittance, weights and visibility
from alphas), accumulation and the composited outputs. The renderers and
trainers take their weights from the weights kernel instead,
``ops/cuda/volrend_cuda.py::fused_render_weights``, which returns the
weights alone; ``render_weight_from_density`` is the plain triple.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def exclusive_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def exclusive_prod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive cumulative product along ``dim``: the running product
    shifted right by one behind a 1, so a zero in x divides nothing."""
    cprod = torch.cumprod(x, dim=dim)
    n = x.shape[dim]
    return torch.cat([torch.ones_like(cprod.narrow(dim, 0, 1)), cprod.narrow(dim, 0, n - 1)],
                     dim=dim)


def render_transmittance_from_density(
    t_starts: torch.Tensor, t_ends: torch.Tensor, sigmas: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (trans, alphas), each [R, S]."""
    sigmas_dt = sigmas * (t_ends - t_starts)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    trans = torch.exp(-exclusive_sum(sigmas_dt, dim=-1))
    return trans, alphas


def render_weight_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,  # [R] or [R, 1]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (weights, trans, alphas), each [R, S]. ``prefix_trans`` scales
    each ray's transmittance by what an earlier chunk of its samples left
    (1 - the opacity so far)."""
    trans, alphas = render_transmittance_from_density(t_starts, t_ends, sigmas)
    if prefix_trans is not None:
        trans = trans * prefix_trans.reshape(-1, 1)
    return trans * alphas, trans, alphas


def render_transmittance_from_alpha(
    alphas: torch.Tensor, prefix_trans: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """T_i = Π_{j<i} (1 - α_j), times ``prefix_trans`` per ray."""
    trans = exclusive_prod(1.0 - alphas, dim=-1)
    if prefix_trans is not None:
        trans = trans * prefix_trans.reshape(-1, 1)
    return trans


def render_weight_from_alpha(
    alphas: torch.Tensor, prefix_trans: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (weights, trans) from alphas."""
    trans = render_transmittance_from_alpha(alphas, prefix_trans)
    return trans * alphas, trans


def render_visibility_from_alpha(
    alphas: torch.Tensor, early_stop_eps: float = 1e-4, alpha_thre: float = 0.0
) -> torch.Tensor:
    """Boolean visibility [R, S] from alphas: a sample is kept iff its
    alpha clears ``alpha_thre`` and the transmittance over the earlier
    kept samples stays above ``early_stop_eps``."""
    vis_alpha = alphas >= alpha_thre
    kept = torch.where(vis_alpha, alphas, torch.zeros_like(alphas))
    trans = exclusive_prod(1.0 - kept, dim=-1)
    return vis_alpha & (trans > early_stop_eps)


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
