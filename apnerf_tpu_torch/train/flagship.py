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
The four other routes are the JAX member core's ``loss_fn`` branch
(``flagship.py:243-311``): one loss by autograd through
``render_rays_prop``, differing in the renderer branch and field call
each takes, and so in the kernels whose forward and backward it runs:
  ``volrend``  the fused field-and-render branch (``forward_packed_volrend``);
  ``packed``   the packed-field branch (``forward_packed``), weights kernel;
  ``field``    the plain branch, encode + trunk in the field kernel, heads
               outside;
  ``trunk``    the plain branch, the encode outside, the trunk in the MLP
               kernel.
The JAX package picks among them with environment switches; here the route
is a plain argument, and a route whose kernels refuse the field raises
rather than becoming another. With the kernels' plain versions in their
place, each is the reference ``chip_smoke.py`` holds that route to.

The ensemble is a Python list of E member modules, not a vmapped axis.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PipelineConfig
from ..models import spectral
from ..models.propnet import prop_loss
from ..ops import volrend
from ..ops.cuda.fused_field_volrend import LOSS_WEIGHTS, loss_terms
from ..ops.occupancy import OccGridState, init_occ_grid, update_occ_grid
from ..render.prop_renderer import prop_sample_intervals, render_rays_prop
from .phase import make_train_phase
from .schedule import cyclic_lr
from .step import AdamState, EnsembleState, make_optimizer


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


class CoreOutput(NamedTuple):
    opt: AdamState
    loss: torch.Tensor  # [] f32
    loss_rgb: torch.Tensor
    loss_dep: torch.Tensor
    loss_sem: torch.Tensor
    n_samples: torch.Tensor  # [] int
    skipped: torch.Tensor  # [] bool: a NaN or infinite gradient, no update


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


ROUTES = ("lossgrad", "volrend", "packed", "field", "trunk")


def make_flagship_member_core(cfg: PipelineConfig, route: str = "lossgrad", schedule=None,
                              fused_prop: bool = False):
    """One member's train step → ``member_core(member, opt_state, batch,
    step, generator=None, noise=None) -> CoreOutput``. ``route`` is one of
    ``ROUTES`` (see the module docstring); ``fused_prop`` takes the
    proposal field through the field kernel too, in sampling and in the
    proposal loss (the JAX package's opt-in route). ``schedule`` replaces
    the default cyclic LR (the final refit's). The member's parameters
    update in place. ``noise`` [R, S+1] replaces the stratified draw of
    proposal sampling. The occupancy grid is not touched here: the planner
    reads it, and ``make_flagship_occ_update`` refreshes it once per chunk
    (``flagship.py:196-204``)."""
    if route not in ROUTES:
        raise ValueError(f"unknown train route {route!r}: one of {ROUTES}")
    s_cfg, p_cfg = make_spectral_config(cfg), make_prop_config(cfg)
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
            wp, _, _ = volrend.render_weight_from_density(te0, te1, sig)
            p_loss = prop_loss([(t_edges0, wp)], t0, t1, weights)
            prop_grads = torch.autograd.grad(p_loss, list(member.prop.parameters()))
        loss = _main_loss(terms) + cfg.prop_loss_weight * p_loss.detach()
        grads = spectral.grads_in_order(member.main, main_grads) + list(prop_grads)
        return loss, (*terms, (~miss).sum() * S), grads

    def autograd_loss_and_grads(member, batch, generator, noise):
        main = member.main
        trunk = "mlp" if route == "trunk" else "field"

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
        return finish(member, opt_state, loss, aux, grads)

    return member_core


def make_flagship_train_phase(cfg: PipelineConfig, schedule=None, route: str = "lossgrad",
                              fused_prop: bool = False):
    """The chunk of steps over the flagship member core on ``route`` (same
    signature as ``phase.make_train_phase``'s ``phase_fn``). Pair it with
    ``make_flagship_occ_update`` once per chunk."""
    return make_train_phase(
        cfg, make_flagship_member_core(cfg, route, schedule=schedule, fused_prop=fused_prop))


def make_flagship_occ_update(cfg: PipelineConfig) -> Callable:
    """→ ``occ_update_fn(members, occ, step, occ_thre, generator=None,
    draws=None) -> new occ list``: one EMA update and re-binarization per
    member from its main field's density times ``render_step_size``.
    ``draws``, when given, holds one dict of draws per member (see
    ``update_occ_grid``)."""
    s_cfg = make_spectral_config(cfg)

    @torch.no_grad()
    def occ_update_fn(
        members: Sequence[FlagshipMember],
        occ: Sequence[OccGridState],
        step: int,
        occ_thre: float,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[dict]] = None,
    ) -> List[OccGridState]:
        out = []
        for i, (member, grid) in enumerate(zip(members, occ)):
            def occ_eval_fn(x, main=member.main):
                return spectral.query_density(main, s_cfg, x) * cfg.render_step_size

            out.append(
                update_occ_grid(
                    grid, occ_eval_fn, step, occ_thre,
                    ema_decay=cfg.occ_ema_decay, warmup_steps=cfg.occ_warmup_steps,
                    generator=generator, draws=draws[i] if draws is not None else None,
                )
            )
        return out

    return occ_update_fn
