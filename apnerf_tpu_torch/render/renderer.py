"""Occupancy-march renderers: the training and the test pass.

Port of ``apnerf_tpu/render/renderer.py``: ``_sample_positions``,
``render_rays``, ``render_train`` and ``render_test``. One dense pass:
march the occupancy grid → one field evaluation at the samples'
midpoints → σ masked by validity → the visibility mask from densities
without gradient (``alpha_thre`` clamped by the grid's mean occupancy)
→ weights → accumulation. The weights go through
``fused_render_weights``, the weights kernel (K2) forward
and, under autograd, its backward on the card; the march hands it
contiguous float32 [R, S] buffers with σ = 0 on padded samples.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops import volrend
from ..ops.cuda.volrend_cuda import fused_render_weights
from ..ops.grid_march import RaySegments, march_rays
from ..ops.occupancy import OccGridState


def _sample_positions(rays_o, rays_d, segs: RaySegments):
    t_mid = 0.5 * (segs.t_starts + segs.t_ends)  # [R, S]
    pos = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    return pos, t_mid


def render_rays(
    field_fn: Callable,  # (positions [R,S,3], dirs [R,S,3]) -> (rgb, sigma[, sem])
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3]
    occ: OccGridState,
    lattice: torch.Tensor,  # [K+1]
    max_samples: int,
    render_bkgd: Optional[torch.Tensor] = None,
    alpha_thre: float = 0.0,
    occ_mean: Optional[torch.Tensor] = None,
    with_variance: bool = False,
) -> Dict[str, torch.Tensor]:
    """→ dict of rgb, opacity, depth [R, ...] (+ sem), ``n_samples`` (the
    visible valid samples, a 0-dim tensor) and with ``with_variance``
    ``rgb_var`` [R, 3] and ``depth_var`` [R, 1]."""
    segs = march_rays(rays_o, rays_d, occ.binaries, occ.aabb, lattice, max_samples)
    pos, t_mid = _sample_positions(rays_o, rays_d, segs)
    out = field_fn(pos, rays_d[:, None, :].expand(pos.shape))
    if len(out) == 3:
        rgbs, sigmas, sems = out
    else:
        (rgbs, sigmas), sems = out, None
    sigmas = sigmas[..., 0] * segs.valid  # [R, S], contiguous

    thre = alpha_thre if occ_mean is None else torch.clamp(occ_mean, max=alpha_thre)
    vis = volrend.render_visibility_from_density(
        segs.t_starts, segs.t_ends, sigmas.detach(), alpha_thre=thre
    )
    sigmas = sigmas * vis
    n_samples = (vis & segs.valid).sum()

    weights = fused_render_weights(segs.t_starts, segs.t_ends, sigmas)
    outs = volrend.render_outputs(
        weights, segs.t_starts, segs.t_ends, rgbs, sems=sems, render_bkgd=render_bkgd
    )
    outs["n_samples"] = n_samples
    if with_variance:
        outs["rgb_var"] = volrend.render_variance(
            weights, rgbs, volrend.accumulate_along_rays(weights, rgbs)
        )
        outs["depth_var"] = volrend.render_variance(
            weights, t_mid[..., None], outs["depth"]
        )[..., 0:1]
    return outs


def render_train(
    field_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ: OccGridState,
    lattice: torch.Tensor,
    max_samples: int,
    render_bkgd: torch.Tensor,
    alpha_thre: float,
    occ_mean: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """The training render: gradients flow through the field evaluation."""
    return render_rays(
        field_fn, rays_o, rays_d, occ, lattice, max_samples, render_bkgd=render_bkgd,
        alpha_thre=alpha_thre, occ_mean=occ_mean,
    )


@torch.no_grad()
def render_test(
    field_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ: OccGridState,
    lattice: torch.Tensor,
    max_samples: int,
    render_bkgd: torch.Tensor,
    alpha_thre: float,
    with_variance: bool = False,
) -> Dict[str, torch.Tensor]:
    """The inference render, ``alpha_thre`` clamped by the grid's mean
    occupancy."""
    return render_rays(
        field_fn, rays_o, rays_d, occ, lattice, max_samples, render_bkgd=render_bkgd,
        alpha_thre=alpha_thre, occ_mean=occ.occs.mean(), with_variance=with_variance,
    )
