"""Proposal-network renderer: one proposal round, then the main field.

Port of ``apnerf_tpu/render/prop_renderer.py``: ``prop_sample_intervals``
and ``render_rays_prop`` with its three branches (``:146-232``): the
fused field-and-render branch (``field_packed_vr_fn``, no variance), the
packed-field branch (``field_packed_fn``, with and without variance) and
the plain ``field_fn`` branch. Every weights computation outside the
fused branch goes through ``fused_render_weights``, the CUDA weights
kernel on the card (the JAX package keeps its kernel opt-in,
``prop_renderer.py:41``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.propnet import propnet_sampling
from ..ops import volrend
from ..ops.cuda.volrend_cuda import fused_render_weights
from ..ops.grid_march import ray_aabb_intersect


def prop_sample_intervals(
    prop_density_fn: Callable,  # positions [R,Sp,3] -> sigma [R,Sp,1]
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3]
    aabb: torch.Tensor,  # [6]
    num_samples: int,
    num_prop_samples: int = 64,
    near_plane: float = 0.1,
    far_plane: float = 1e10,
    stratified: bool = True,
    generator: Optional[torch.Generator] = None,
    noises=None,
):
    """aabb clip + one proposal round → (t0, t1, t_mid, pos, miss, levels);
    t0/t1 carry no gradient, as the estimator samples without one."""
    t_min, t_max = ray_aabb_intersect(
        rays_o, rays_d, aabb, near_plane=near_plane, far_plane=far_plane
    )
    miss = t_min >= t_max
    t_lo = torch.where(miss, torch.full_like(t_min, near_plane), t_min.clamp(min=near_plane))
    t_hi = torch.where(miss, torch.full_like(t_max, near_plane * (1 + 1e-4)), t_max)

    def prop_sigma_fn(t0, t1):
        t_mid = 0.5 * (t0 + t1)
        pos = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
        return prop_density_fn(pos)[..., 0]

    t0, t1, levels = propnet_sampling(
        [prop_sigma_fn], [num_prop_samples], num_samples, rays_o, rays_d,
        near_plane=t_lo, far_plane=t_hi, stratified=stratified, generator=generator,
        noises=noises, sampling_type="uniform",
    )
    t0, t1 = t0.detach(), t1.detach()
    t_mid = 0.5 * (t0 + t1)
    pos = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    return t0, t1, t_mid, pos, miss, levels


def render_rays_prop(
    field_fn: Callable,  # (positions [R,S,3], dirs [R,S,3]) -> (rgb, sigma[, sem])
    prop_density_fn: Callable,  # positions [R,Sp,3] -> sigma [R,Sp,1]
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    num_samples: int,
    num_prop_samples: int = 64,
    near_plane: float = 0.1,
    far_plane: float = 1e10,
    render_bkgd: Optional[torch.Tensor] = None,
    stratified: bool = True,
    with_variance: bool = False,
    generator: Optional[torch.Generator] = None,
    noises=None,
    field_packed_fn: Optional[Callable] = None,
    field_packed_vr_fn: Optional[Callable] = None,
    return_levels: bool = False,
):
    """One proposal round + main field render → outs. Unlike the JAX
    function it computes no ``prop_loss``: the candidate render has no use
    for it. The train step asks with ``return_levels`` for what that loss
    reads and gets ``(outs, (levels, t0, t1, weights))``: references to
    tensors the render made anyway. Rays that miss the aabb get a
    degenerate near≈far interval, hence zero weights and pure background.

    ``field_packed_vr_fn``: ``(pos [R,S,3], rays_d [R,3], t0, t1, miss) →
    (acc [R, 5+C], weights [R, S])`` (``spectral.forward_packed_volrend``);
    taken when no variance is asked for. ``field_packed_fn``: ``(pos,
    rays_d) → packed [R, S, 4+C]`` (``spectral.forward_packed``). Either
    replaces ``field_fn``, with the same outputs."""
    t0, t1, t_mid, pos, miss, levels = prop_sample_intervals(
        prop_density_fn, rays_o, rays_d, aabb, num_samples=num_samples,
        num_prop_samples=num_prop_samples, near_plane=near_plane,
        far_plane=far_plane, stratified=stratified, generator=generator, noises=noises,
    )
    n_samples = (~miss).sum() * num_samples
    if field_packed_vr_fn is not None and not with_variance:
        # per-sample field values never reach this function: the kernel
        # returns the per-ray sums; the background and the depth's
        # normalisation stay out here
        acc, weights = field_packed_vr_fn(pos, rays_d, t0, t1, miss)
        opacities = acc[:, 3:4]
        rgb_acc = acc[:, 0:3]
        if render_bkgd is not None:
            rgb_acc = rgb_acc + render_bkgd * (1.0 - opacities)
        outs = {
            "rgb": rgb_acc,
            "opacity": opacities,
            "depth": acc[:, 4:5] / opacities.clamp(min=torch.finfo(acc.dtype).eps),
            "sem": acc[:, 5:],
            "n_samples": n_samples,
        }
        return (outs, (levels, t0, t1, weights)) if return_levels else outs

    if field_packed_fn is not None:
        y = field_packed_fn(pos, rays_d)  # [R, S, 4+C]
        rgbs, sigmas, sems = y[..., 0:3], y[..., 3:4], y[..., 4:]
    else:
        out = field_fn(pos, rays_d[:, None, :].expand(pos.shape))
        if len(out) == 3:
            rgbs, sigmas, sems = out
        else:
            (rgbs, sigmas), sems = out, None
    sigmas = sigmas[..., 0] * (~miss[:, None])
    weights = fused_render_weights(t0.contiguous(), t1.contiguous(), sigmas.float().contiguous())
    outs = volrend.render_outputs(weights, t0, t1, rgbs, sems=sems, render_bkgd=render_bkgd)
    outs["n_samples"] = n_samples
    if with_variance:
        outs["rgb_var"] = volrend.render_variance(
            weights, rgbs, volrend.accumulate_along_rays(weights, rgbs)
        )
        outs["depth_var"] = volrend.render_variance(
            weights, t_mid[..., None], outs["depth"]
        )[..., 0:1]
    return (outs, (levels, t0, t1, weights)) if return_levels else outs
