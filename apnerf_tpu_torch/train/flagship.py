"""The flagship train path: spectral field + proposal sampling.

Port of ``apnerf_tpu/train/flagship.py``: the field configs,
``default_spectral_schedule``, ``init_flagship_ensemble`` (params,
optimizer state and occupancy grids), the member core, the train phase
and ``make_flagship_occ_update``, whose density queries run through the
CUDA field kernel.

The member core's default route, ``lossgrad``, is the combined-kernel
branch (``flagship.py:119-194``):
  1. proposal sampling, without gradients;
  2. ``spectral.forward_packed_lossgrad``: the main field's render, 3-term
     loss and whole backward in one call of the CUDA train-step kernel;
  3. the proposal field recomputed at the level-0 midpoints (edges
     detached) and the proposal-matching loss differentiated by autograd,
     through the CUDA weights kernel's backward on the card;
  4. ``finish``: Adam with the NaN guard, on the device.
The other routes are the JAX member core's ``loss_fn`` branch
(``flagship.py:243-311``): one loss by autograd through
``render_rays_prop``, differing in the renderer branch and field call
each takes, and so in the kernels whose forward and backward it runs:
  ``volrend``  the fused field-and-render branch (``forward_packed_volrend``);
  ``packed``   the packed-field branch (``forward_packed``), weights kernel;
  ``field``    the plain branch, encode + trunk in the field kernel, heads
               outside;
  ``trunk``    the plain branch, the encode outside, the trunk in the MLP
               kernel;
  ``plain``    the plain branch with no field kernel: the plain chain, the
               route of a field no field kernel takes (``default_route``)
               and of no other.
A caller that names no route gets ``default_route``: the branch the JAX
package's configuration gates pick on its chip, decided from the field's
configuration alone. A named route whose kernels refuse the field raises
rather than becoming another. With the kernels' plain versions in their
place, each is the reference ``chip_smoke.py`` holds that route to.

The ensemble is a Python list of E member modules, not a vmapped axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PipelineConfig
from ..models import spectral
from ..models.propnet import prop_loss
from ..ops.cuda.fused_field_volrend import LOSS_WEIGHTS, loss_terms
from ..ops.cuda.volrend_cuda import fused_render_weights
from ..ops.occupancy import OccGridState, _draw, init_occ_grid, update_occ_grid
from ..render.prop_renderer import prop_sample_intervals, render_rays_prop
from .phase import make_train_phase
from .schedule import cyclic_lr
from .step import CoreOutput, EnsembleState, make_optimizer


class FlagshipMember(nn.Module):
    """One ensemble member: the main field and the proposal field
    (the JAX ``{"main": ..., "prop": ...}`` params tree)."""

    def __init__(self, main: spectral.SpectralField, prop: spectral.SpectralDensityField):
        super().__init__()
        self.main = main
        self.prop = prop

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "FlagshipMember":
        return cls(
            spectral.SpectralField.from_tree(tree["main"], device),
            spectral.SpectralDensityField.from_tree(tree["prop"], device),
        )


def default_spectral_schedule(cfg: PipelineConfig):
    """Cyclic LR anchored at ``cfg.spectral_lr`` (``flagship.py:38-47``)."""
    return cyclic_lr(
        cfg.spectral_lr / 10.0, cfg.spectral_lr,
        max(cfg.training_steps // 4, 1), gamma=cfg.spectral_lr_gamma,
    )


def make_spectral_config(cfg: PipelineConfig) -> spectral.SpectralConfig:
    return spectral.SpectralConfig(
        aabb=tuple(float(v) for v in cfg.aabb),
        neurons=cfg.spectral_neurons,
        layers=cfg.spectral_layers,
        geo_feat_dim=cfg.geo_feat_dim,
        n_levels=cfg.n_levels,
        freqs_per_level=cfg.spectral_freqs_per_level,
        base_freq=float(cfg.base_resolution),
        max_freq=float(cfg.max_resolution),
        num_semantic_classes=cfg.num_semantic_classes,
    )


def make_prop_config(cfg: PipelineConfig) -> spectral.SpectralDensityConfig:
    return spectral.SpectralDensityConfig(
        aabb=tuple(float(v) for v in cfg.aabb),
        neurons=cfg.prop_neurons,
        layers=cfg.prop_layers,
        max_freq=float(min(cfg.max_resolution, 256)),
    )


def init_flagship_params(
    cfg: PipelineConfig, generator: torch.Generator, device=None
) -> Tuple[List[FlagshipMember], List[OccGridState]]:
    """E freshly initialized members and their empty occupancy grids."""
    s_cfg, p_cfg = make_spectral_config(cfg), make_prop_config(cfg)
    members, occ = [], []
    for _ in range(cfg.n_ensembles):
        members.append(
            FlagshipMember(
                spectral.init_spectral(s_cfg, generator, device),
                spectral.init_spectral_density(p_cfg, generator, device),
            )
        )
        occ.append(init_occ_grid(cfg.aabb, cfg.main_grid_resolution, device))
    return members, occ


def init_flagship_ensemble(
    cfg: PipelineConfig, generator: torch.Generator, device=None
) -> EnsembleState:
    """Members, fresh Adam states and empty grids, at step 0
    (``flagship.py:75-97``)."""
    opt = make_optimizer(cfg, default_spectral_schedule(cfg))
    members, occ = init_flagship_params(cfg, generator, device)
    return EnsembleState(
        members=members, opt=[opt.init(list(m.parameters())) for m in members],
        occ=occ, step=0,
    )


def _main_loss(terms) -> torch.Tensor:
    """The weighted rgb, depth and semantic terms of the train loss."""
    return sum(c * t for c, t in zip(LOSS_WEIGHTS, terms))


ROUTES = ("lossgrad", "volrend", "packed", "field", "trunk", "plain")


def default_route(s_cfg: spectral.SpectralConfig) -> str:
    """The member core's route for a main field configuration, as the JAX
    package's gates pick its branch on its chip (``use_packed_lossgrad``,
    ``_use_fused_field``; their row-count and tiling conditions are the
    TPU's and are not carried over): the combined kernel ``lossgrad`` for
    a bf16 field with 2 or 3 hidden layers, viewdirs and semantic classes;
    ``field`` (encode + trunk in the field kernel, heads outside) for such
    a field without classes or without viewdirs; ``plain`` for f32 compute
    or another depth, where the JAX package runs its XLA chain. The
    renderers of the mapper take the packed kernels exactly where this is
    ``lossgrad``. The kernels take every width up to a 1024-wide trunk with
    heads H // 4 (past 512, at most 256 frequencies), 1 to 63 geometry
    features and 1 to 1024 classes
    (``ops/cuda/field_images.check_widths``); a field past those raises
    from their wrappers: its route is not changed for it. An unbounded
    field takes ``field``: the packed kernels decline it
    (``use_packed_field``, ``spectral.py:341``), the field kernel takes it."""
    if s_cfg.compute_dtype != "bfloat16" or s_cfg.layers not in (2, 3):
        return "plain"
    if s_cfg.use_viewdirs and s_cfg.num_semantic_classes > 0 and not s_cfg.unbounded:
        return "lossgrad"
    return "field"


def make_flagship_member_core(cfg: PipelineConfig, route: Optional[str] = None, schedule=None,
                              fused_prop: bool = False, grad_reduce: Optional[Callable] = None):
    """One member's train step → ``member_core(member, opt_state, batch,
    step, generator=None, noise=None) -> CoreOutput``. ``route`` is one of
    ``ROUTES`` (see the module docstring), or None for
    ``default_route(make_spectral_config(cfg))``; ``fused_prop`` takes the
    proposal field through the field kernel too, in sampling and in the
    proposal loss (the JAX package's opt-in route). ``schedule`` replaces
    the default cyclic LR (the final refit's). The member's parameters
    update in place. ``noise`` [R, S+1] replaces the stratified draw of
    proposal sampling. The occupancy grid is not touched here: the planner
    reads it, and ``make_flagship_occ_update`` refreshes it once per chunk
    (``flagship.py:196-204``). ``grad_reduce`` (a list of gradients → a
    list) is applied to the raw gradients before the NaN guard and Adam
    (``flagship.py:98-112``): the data-parallel phase's mean over ``data``,
    so every data rank of a member applies the same update, and a NaN on
    one rank skips the step on all of them."""
    s_cfg, p_cfg = make_spectral_config(cfg), make_prop_config(cfg)
    if route is None:
        route = default_route(s_cfg)
    if route not in ROUTES:
        raise ValueError(f"unknown train route {route!r}: one of {ROUTES}")
    if route == "plain" and default_route(s_cfg) != "plain":
        raise ValueError("train route 'plain' is the route of a field the field kernels do not "
                         "take (f32 compute, another depth); this one takes "
                         f"{default_route(s_cfg)!r}")
    opt = make_optimizer(cfg, schedule or default_spectral_schedule(cfg))
    S = cfg.max_samples_train

    def prop_density(member, pos):
        return spectral.query_density_field(member.prop, p_cfg, pos, fused=fused_prop)

    def sample(member, batch, generator, noise):
        aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=batch.origins.device)
        return prop_sample_intervals(
            lambda p: prop_density(member, p),
            batch.origins, batch.viewdirs, aabb, num_samples=S,
            num_prop_samples=cfg.num_prop_samples, near_plane=cfg.near_plane,
            stratified=True, generator=generator,
            noises=[noise] if noise is not None else None,
        )

    def fused_loss_and_grads(member, batch, generator, noise):
        with torch.no_grad():
            t0, t1, _, pos, miss, levels = sample(member, batch, generator, noise)
        t_edges0 = levels[0][0].detach()
        lossrows, weights, main_grads = spectral.forward_packed_lossgrad(
            member.main, s_cfg, pos, batch.viewdirs, t0, t1, miss,
            batch.pixels, batch.depth, batch.sem, batch.color_bkgd,
        )
        terms = loss_terms(lossrows)
        # the proposal loss: only the level-0 weights depend on the
        # proposal parameters, and the level-0 edges do not
        te0, te1 = t_edges0[..., :-1], t_edges0[..., 1:]
        tm0 = 0.5 * (te0 + te1)
        pos0 = batch.origins[:, None, :] + tm0[..., None] * batch.viewdirs[:, None, :]
        with torch.enable_grad():
            sig = prop_density(member, pos0)[..., 0]
            wp = fused_render_weights(te0.contiguous(), te1.contiguous(), sig.float().contiguous())
            p_loss = prop_loss([(t_edges0, wp)], t0, t1, weights)
            prop_grads = torch.autograd.grad(p_loss, list(member.prop.parameters()))
        loss = _main_loss(terms) + cfg.prop_loss_weight * p_loss.detach()
        grads = spectral.grads_in_order(member.main, main_grads) + list(prop_grads)
        return loss, (*terms, (~miss).sum() * S), grads

    def autograd_loss_and_grads(member, batch, generator, noise):
        main = member.main
        trunk = {"trunk": "mlp", "plain": None}.get(route, "field")

        def field_fn(pos, dirs):
            return spectral.forward(main, s_cfg, pos, dirs, trunk=trunk)

        def field_packed_fn(pos, rays_d):
            return spectral.forward_packed(main, s_cfg, pos, rays_d)

        def field_packed_vr_fn(pos, rays_d, t0, t1, miss):
            return spectral.forward_packed_volrend(main, s_cfg, pos, rays_d, t0, t1, miss)

        aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=batch.origins.device)
        with torch.enable_grad():
            out, (levels, t0, t1, weights) = render_rays_prop(
                field_fn, lambda p: prop_density(member, p), batch.origins, batch.viewdirs,
                aabb, num_samples=S, num_prop_samples=cfg.num_prop_samples,
                near_plane=cfg.near_plane, render_bkgd=batch.color_bkgd, stratified=True,
                generator=generator, noises=[noise] if noise is not None else None,
                field_packed_fn=field_packed_fn if route == "packed" else None,
                field_packed_vr_fn=field_packed_vr_fn if route == "volrend" else None,
                return_levels=True,
            )
            p_loss = prop_loss(levels, t0, t1, weights)
            terms = (
                F.huber_loss(out["rgb"], batch.pixels, delta=1.0),
                F.huber_loss(out["depth"][:, 0], batch.depth, delta=1.0),
                F.cross_entropy(out["sem"], batch.sem.long()),
            )
            loss = _main_loss(terms) + cfg.prop_loss_weight * p_loss
            grads = torch.autograd.grad(loss, list(member.parameters()))
        aux = (*(t.detach() for t in terms), out["n_samples"])
        return loss.detach(), aux, list(grads)

    loss_and_grads = fused_loss_and_grads if route == "lossgrad" else autograd_loss_and_grads

    def finish(member, opt_state, loss, aux, grads) -> CoreOutput:
        """The NaN-guarded Adam step (``flagship.py:207-232``): a
        non-finite gradient leaves parameters, moments and count as they
        were, selected on the device."""
        names, params = zip(*member.named_parameters())
        new_state, bad = opt.step(list(params), grads, opt_state, names=names)
        return CoreOutput(new_state, loss, *aux, bad)

    def member_core(member, opt_state, batch, step, generator=None, noise=None) -> CoreOutput:
        del step  # the schedule reads the optimizer's own count
        loss, aux, grads = loss_and_grads(member, batch, generator, noise)
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        return finish(member, opt_state, loss, aux, grads)

    return member_core


def make_flagship_train_phase(cfg: PipelineConfig, schedule=None, route: Optional[str] = None,
                              fused_prop: bool = False):
    """The chunk of steps over the flagship member core on ``route`` (same
    signature as ``phase.make_train_phase``'s ``phase_fn``). Pair it with
    ``make_flagship_occ_update`` once per chunk."""
    return make_train_phase(
        cfg, make_flagship_member_core(cfg, route, schedule=schedule, fused_prop=fused_prop))


def make_flagship_occ_update(cfg: PipelineConfig) -> Callable:
    """→ ``occ_update_fn(members, occ, step, occ_thre, generator=None,
    draws=None, local=None) -> new occ list``: one EMA update and
    re-binarization per member from its main field's density times
    ``render_step_size``. ``draws``, when given, holds one dict of draws
    per member (see ``update_occ_grid``). ``local``: the indices of
    ``members`` among ``cfg.n_ensembles`` (a mesh rank's); the generator
    then makes every member's draws in order and each member takes its
    own."""
    s_cfg = make_spectral_config(cfg)

    @torch.no_grad()
    def occ_update_fn(
        members: Sequence[FlagshipMember],
        occ: Sequence[OccGridState],
        step: int,
        occ_thre: float,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[dict]] = None,
        local: Optional[Sequence[int]] = None,
    ) -> List[OccGridState]:
        if draws is None:
            n_cells = occ[0].occs.numel()
            n_idx = n_cells if step < cfg.occ_warmup_steps else 2 * (n_cells // 4)
            every = [_draw(n_cells, n_idx, generator, occ[0].occs.device)
                     for _ in range(len(members) if local is None else cfg.n_ensembles)]
            draws = every if local is None else [every[m] for m in local]
        out = []
        for i, (member, grid) in enumerate(zip(members, occ)):
            def occ_eval_fn(x, main=member.main):
                return spectral.query_density(main, s_cfg, x) * cfg.render_step_size

            out.append(
                update_occ_grid(
                    grid, occ_eval_fn, step, occ_thre,
                    ema_decay=cfg.occ_ema_decay, warmup_steps=cfg.occ_warmup_steps,
                    draws=draws[i],
                )
            )
        return out

    return occ_update_fn
