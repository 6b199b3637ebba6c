"""The example trainers: one radiance field trained on an offline dataset.

Port of ``apnerf_tpu/train/examples.py``: ``make_ngp_occ_trainer`` (NGP +
occupancy grid, the nerfacc Instant-NGP example), ``make_mlp_occ_trainer``
(the vanilla MLP NeRF + occupancy grid), ``make_ngp_prop_trainer`` (NGP +
one proposal density field, mip-NeRF 360's PDF matching loss) and
``make_tnerf_occ_trainer`` (T-NeRF + occupancy grid, per-ray timestamps).

Each returns its state and a step function (the NGP + occupancy trainer
also a render function). The state is a :class:`TrainerState`; the field's
parameters update in place, and a step returns the state with the new
optimizer state, grid and step count. A step function takes the ray batch
(origins, viewdirs, pixels [R, 3], for T-NeRF timestamps [R], and the
background [3]) and ``generator`` for its random draws, or the draws
themselves: ``occ_draws`` (the occupancy update's, as
``ops/occupancy.update_occ_grid`` takes them), ``noises`` (the stratified
proposal jitter, one [R, n + 1] tensor per proposal level) and
``occ_times`` (T-NeRF's timestamp per queried cell, [n_idx, 1]). It
returns ``(state, loss, n_samples)``: the loss and the samples that
reached the loss (the occupancy renders' visible samples), both 0-dim
tensors on the device, so a loop need not wait on the card.

The optimizer is ``train/step.py::Adam`` with ``optax.adam``'s semantics
and a constant learning rate (eps 1e-15 for the NGP trainers, optax's
1e-8 for the MLP ones), not ``torch.optim``. The weights that feed the
loss go through the weights kernel, ``fused_render_weights`` (K2; its
backward on every step): inside ``render/renderer.py::render_train``, in
each proposal level of ``models/propnet.py::propnet_sampling`` and for the
proposal trainer's final samples, whose intervals carry the proposal
field's gradient (so K2's backward is asked for dt0 and dt1 there). The
JAX package computes these weights with the plain
``render_weight_from_density``; a caller here that also needs the
transmittance or the alphas keeps that plain function.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models import mlp as mlpmod
from ..models import ngp as ngpmod
from ..models.propnet import prop_loss, propnet_sampling
from ..ops.cuda.volrend_cuda import fused_render_weights
from ..ops.grid_march import candidate_lattice
from ..ops.occupancy import OccGridState, init_occ_grid, maybe_update_occ_grid
from ..ops.volrend import render_outputs
from ..render.renderer import render_rays, render_train
from .step import Adam, AdamState

OCC_THRE = 1e-2  # the occupancy update's threshold cap, every trainer


class TrainerState(NamedTuple):
    params: nn.Module  # the field (the prop trainer: ``field`` and ``prop``)
    opt: AdamState
    occ: Optional[OccGridState]  # None for the proposal trainer
    step: int


def trainer_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises here, before anything is built."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the trainer was asked for {dev}, but torch.cuda.is_available() is "
                           "false (pass device='cpu' to train on the CPU)")
    return dev


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _lattice(n_candidates, near_plane, render_step_size, cone_angle, dev) -> torch.Tensor:
    return torch.as_tensor(candidate_lattice(n_candidates, near_plane, render_step_size,
                                             cone_angle), device=dev)


def _constant(lr: float):
    return lambda count: lr


def _update(opt: Adam, params: nn.Module, loss: torch.Tensor, state: AdamState) -> AdamState:
    """Gradients of ``loss`` by autograd (a parameter it does not reach gets
    zeros) and one Adam step in place."""
    leaves = list(params.parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return opt.step(leaves, grads, state)[0]


def _occ_step(state: TrainerState, opt: Adam, occ_eval, field_fn, loss_fn, lattice,
              max_samples, alpha_thre, origins, viewdirs, pixels, bkgd, generator, occ_draws):
    """The occupancy trainers' step: the grid update on its cadence (every
    16 steps, all cells in the first 256), the training render over the
    updated grid with ``alpha_thre`` clamped by its mean, the loss, Adam."""
    occ = maybe_update_occ_grid(state.occ, occ_eval, state.step, OCC_THRE,
                                generator=generator, draws=occ_draws)
    with torch.enable_grad():
        out = render_train(field_fn, origins, viewdirs, occ, lattice, max_samples, bkgd,
                           alpha_thre=alpha_thre, occ_mean=occ.occs.mean())
        loss = loss_fn(out["rgb"], pixels)
        new_opt = _update(opt, state.params, loss, state.opt)
    return TrainerState(state.params, new_opt, occ, state.step + 1), loss.detach(), out["n_samples"]


def _huber(rgb, pixels):
    return F.huber_loss(rgb, pixels, delta=1.0)


def make_ngp_occ_trainer(
    aabb,
    grid_resolution=(128, 128, 128),
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    near_plane: float = 0.0,
    alpha_thre: float = 0.0,
    max_samples: int = 128,
    n_candidates: int = 1024,
    lr: float = 1e-2,
    ngp_kwargs: Optional[Dict] = None,
    seed: int = 42,
    device="cuda",
):
    """NGP + occupancy grid → (state, step_fn, render_fn).
    ``step_fn(state, origins, viewdirs, pixels, bkgd, generator=None,
    occ_draws=None)``; ``render_fn(state, origins, viewdirs, bkgd)`` → the
    test render's dict (rgb, opacity, depth, n_samples), without gradient."""
    dev = trainer_device(device)
    cfg = ngpmod.NGPConfig(aabb=tuple(float(v) for v in aabb), **(ngp_kwargs or {}))
    field = ngpmod.init_ngp(cfg, _seeded(seed), dev)
    opt = Adam(_constant(lr), eps=1e-15)
    lattice = _lattice(n_candidates, near_plane, render_step_size, cone_angle, dev)
    state = TrainerState(field, opt.init(list(field.parameters())),
                         init_occ_grid(aabb, grid_resolution, dev), 0)

    def step_fn(state, origins, viewdirs, pixels, bkgd, generator=None, occ_draws=None):
        @torch.no_grad()
        def occ_eval(x):
            return ngpmod.query_density(state.params, cfg, x) * render_step_size

        def field_fn(pos, dirs):
            return ngpmod.forward(state.params, cfg, pos, dirs)

        return _occ_step(state, opt, occ_eval, field_fn, _huber, lattice, max_samples,
                         alpha_thre, origins, viewdirs, pixels, bkgd, generator, occ_draws)

    @torch.no_grad()
    def render_fn(state, origins, viewdirs, bkgd):
        return render_rays(
            lambda pos, dirs: ngpmod.forward(state.params, cfg, pos, dirs), origins, viewdirs,
            state.occ, lattice, max_samples, render_bkgd=bkgd, alpha_thre=alpha_thre,
            occ_mean=state.occ.occs.mean(),
        )

    return state, step_fn, render_fn


def make_mlp_occ_trainer(
    aabb,
    grid_resolution=(64, 64, 64),
    render_step_size: float = 5e-3,
    max_samples: int = 128,
    n_candidates: int = 512,
    lr: float = 5e-4,
    mlp_cfg: Optional[mlpmod.VanillaNeRFConfig] = None,
    seed: int = 42,
    device="cuda",
):
    """Vanilla MLP NeRF + occupancy grid, MSE loss → (state, step_fn);
    ``step_fn`` as the NGP trainer's."""
    dev = trainer_device(device)
    cfg = mlp_cfg or mlpmod.VanillaNeRFConfig()
    field = mlpmod.init_vanilla_nerf(cfg, _seeded(seed), dev)
    opt = Adam(_constant(lr))
    lattice = _lattice(n_candidates, 0.0, render_step_size, 0.0, dev)
    state = TrainerState(field, opt.init(list(field.parameters())),
                         init_occ_grid(aabb, grid_resolution, dev), 0)

    def step_fn(state, origins, viewdirs, pixels, bkgd, generator=None, occ_draws=None):
        @torch.no_grad()
        def occ_eval(x):
            return mlpmod.vanilla_query_density(state.params, x, cfg) * render_step_size

        def field_fn(pos, dirs):
            return mlpmod.vanilla_forward(state.params, pos, dirs, cfg)

        return _occ_step(state, opt, occ_eval, field_fn, F.mse_loss, lattice, max_samples, 0.0,
                         origins, viewdirs, pixels, bkgd, generator, occ_draws)

    return state, step_fn


def make_ngp_prop_trainer(
    aabb,
    num_samples: int = 48,
    prop_samples: Sequence[int] = (64,),
    near_plane: float = 0.2,
    far_plane: float = 1e3,
    sampling_type: str = "lindisp",
    lr: float = 1e-2,
    ngp_kwargs: Optional[Dict] = None,
    prop_kwargs: Optional[Dict] = None,
    seed: int = 42,
    device="cuda",
):
    """NGP + proposal density fields, trained jointly: huber on rgb plus
    the PDF matching loss → (state, step_fn). ``step_fn(state, origins,
    viewdirs, pixels, bkgd, generator=None, noises=None)``. The parameters
    are a ``ModuleDict`` of ``field`` and ``prop``, as the JAX tree."""
    dev = trainer_device(device)
    aabb = tuple(float(v) for v in aabb)
    cfg = ngpmod.NGPConfig(aabb=aabb, **(ngp_kwargs or {}))
    pcfg = ngpmod.NGPDensityConfig(aabb=aabb, **(prop_kwargs or {}))
    gen = _seeded(seed)
    params = nn.ModuleDict({"field": ngpmod.init_ngp(cfg, gen, dev),
                            "prop": ngpmod.init_ngp_density(pcfg, gen, dev)})
    opt = Adam(_constant(lr), eps=1e-15)
    state = TrainerState(params, opt.init(list(params.parameters())), None, 0)

    def step_fn(state, origins, viewdirs, pixels, bkgd, generator=None, noises=None):
        p = state.params

        def prop_sigma(t0, t1):
            tm = 0.5 * (t0 + t1)
            pos = origins[:, None, :] + tm[..., None] * viewdirs[:, None, :]
            return ngpmod.query_density_field(p["prop"], pcfg, pos)[..., 0]

        with torch.enable_grad():
            t0, t1, levels = propnet_sampling(
                [prop_sigma], list(prop_samples), num_samples, origins, viewdirs, near_plane,
                far_plane, stratified=True, generator=generator, noises=noises,
                sampling_type=sampling_type,
            )
            tm = 0.5 * (t0 + t1)
            pos = origins[:, None, :] + tm[..., None] * viewdirs[:, None, :]
            rgb, sigma = ngpmod.forward(p["field"], cfg, pos, viewdirs[:, None, :].expand(pos.shape))
            t0, t1 = t0.contiguous(), t1.contiguous()
            weights = fused_render_weights(t0, t1, sigma[..., 0].contiguous())
            out = render_outputs(weights, t0, t1, rgb, render_bkgd=bkgd)
            loss = _huber(out["rgb"], pixels) + prop_loss(levels, t0, t1, weights)
            new_opt = _update(opt, p, loss, state.opt)
        n = torch.full((), t0.numel(), device=t0.device)
        return TrainerState(p, new_opt, None, state.step + 1), loss.detach(), n

    return state, step_fn


def make_tnerf_occ_trainer(
    aabb,
    grid_resolution=(64, 64, 64),
    render_step_size: float = 5e-3,
    max_samples: int = 128,
    n_candidates: int = 512,
    lr: float = 5e-4,
    tnerf_cfg: Optional[mlpmod.TNeRFConfig] = None,
    seed: int = 42,
    device="cuda",
):
    """T-NeRF + occupancy grid, MSE loss → (state, step_fn).
    ``step_fn(state, origins, viewdirs, pixels, timestamps, bkgd,
    generator=None, occ_draws=None, occ_times=None)``: each ray's
    timestamp broadcast over its samples; the grid update queries each
    cell at a random timestamp (``occ_times``, or drawn from
    ``generator`` after the update's own draws)."""
    dev = trainer_device(device)
    cfg = tnerf_cfg or mlpmod.TNeRFConfig()
    field = mlpmod.init_tnerf(cfg, _seeded(seed), dev)
    opt = Adam(_constant(lr))
    lattice = _lattice(n_candidates, 0.0, render_step_size, 0.0, dev)
    state = TrainerState(field, opt.init(list(field.parameters())),
                         init_occ_grid(aabb, grid_resolution, dev), 0)

    def step_fn(state, origins, viewdirs, pixels, timestamps, bkgd, generator=None,
                occ_draws=None, occ_times=None):
        @torch.no_grad()
        def occ_eval(x):
            t = occ_times
            if t is None:
                t = torch.rand((x.shape[0], 1), generator=generator, device=x.device)
            return mlpmod.tnerf_query_density(state.params, x, t, cfg) * render_step_size

        def field_fn(pos, dirs):
            t = timestamps[:, None, None].expand(pos.shape[:-1] + (1,))
            return mlpmod.tnerf_forward(state.params, pos, t, dirs, cfg)

        return _occ_step(state, opt, occ_eval, field_fn, F.mse_loss, lattice, max_samples, 0.0,
                         origins, viewdirs, pixels, bkgd, generator, occ_draws)

    return state, step_fn
