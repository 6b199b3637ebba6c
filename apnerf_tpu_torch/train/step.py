"""Ensemble train state, the optimizer and the ngp+occ member step.

Port of ``apnerf_tpu/train/step.py``: ``EnsembleState``,
``make_optimizer`` (``:72-104``: ``optax.adam``, ``optax.adamw`` with
``cfg.weight_decay`` and the chain that decays the main field's spectrum
only, ``cfg.spectral_spectrum_wd``), ``reset_opt_state``, and the
(ngp, occ) oracle path's ``make_ngp_config``, ``init_ensemble``,
``make_member_core``, ``fetch_ensemble_batch`` and ``make_train_step``
(one ensemble step for given images, which the sharded train step
builds on). The optimizer is written as plain tensor ops, not
``torch.optim.Adam``, for two reasons:
  * optax evaluates the schedule at its OWN update count, which starts at
    0 and is not the train step (the bench starts training at step 1000);
  * a step with a non-finite gradient must leave the parameters, both
    moments and that count untouched, selected with ``torch.where`` on a
    device flag, so the train loop never waits on the host.
Each member's moments are kept flat, one [P] vector in the order of
``member.parameters()``, so one update is a handful of kernels.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import PipelineConfig
from ..data.dataset import RayBatch, fetch_rays
from ..models import ngp
from ..ops.grid_march import candidate_lattice
from ..ops.occupancy import OccGridState, _draw, init_occ_grid, maybe_update_occ_grid
from ..render.renderer import render_train
from .schedule import cyclic_lr


class AdamState(NamedTuple):
    mu: torch.Tensor  # [P] f32 first moments
    nu: torch.Tensor  # [P] f32 second moments
    count: torch.Tensor  # [] int32 updates applied (skipped steps do not count)


class EnsembleState(NamedTuple):
    """The ensemble's training state, one entry per member."""

    members: list  # train.flagship.FlagshipMember
    opt: List[AdamState]
    occ: list  # ops.occupancy.OccGridState
    step: int  # train steps taken, shared by the members


class CoreOutput(NamedTuple):
    """One member step's result. ``occ`` is the member's occupancy grid
    after the step on the path that updates it inside the step (ngp+occ),
    None on the flagship path."""

    opt: AdamState
    loss: torch.Tensor  # [] f32
    loss_rgb: torch.Tensor
    loss_dep: torch.Tensor
    loss_sem: torch.Tensor
    n_samples: torch.Tensor  # [] int
    skipped: torch.Tensor  # [] bool: a NaN or infinite gradient, no update
    occ: Optional[OccGridState] = None


class Adam:
    """``optax.adam``: bias-corrected moments, ``eps`` outside the square
    root, the learning rate read from ``schedule(count)``. With
    ``weight_decay`` it is ``optax.adamw``: ``weight_decay * p`` joins the
    Adam direction before the learning rate scales it, for every parameter
    or, with ``decay_mask`` (``(name, param) -> bool`` over the member's
    ``named_parameters()``), for the masked ones only."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decay_mask: Optional[Callable] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.decay_mask = weight_decay, decay_mask

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        return AdamState(zeros, zeros.clone(), torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def step(
        self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState,
        names: Optional[Sequence[str]] = None,
    ) -> Tuple[AdamState, torch.Tensor]:
        """Update ``params`` in place → (new state, bad). ``bad`` is a
        device bool: a gradient leaf held a NaN or an infinity, and then
        the parameters and the returned state equal the old ones.
        ``names`` (the parameters' names, in order) feeds ``decay_mask``."""
        g = torch.cat([x.reshape(-1) for x in grads]).float()
        p = torch.cat([x.reshape(-1) for x in params])
        bad = ~torch.isfinite(g).all()
        count = state.count
        c1 = (count + 1).float()
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        mu_hat = mu / (1 - self.b1 ** c1)
        nu_hat = nu / (1 - self.b2 ** c1)
        direction = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay > 0:
            if self.decay_mask is None:
                direction = direction + self.weight_decay * p
            else:
                if names is None:
                    raise ValueError("a masked weight decay needs the parameters' names")
                mask = torch.cat([
                    torch.full((x.numel(),), float(self.decay_mask(n, x)), device=p.device)
                    for n, x in zip(names, params)
                ])
                direction = direction + self.weight_decay * mask * p
        upd = -self.schedule(count) * direction
        p_new = torch.where(bad, p, p + upd)
        torch._foreach_copy_(
            list(params),
            [v.view_as(x) for v, x in zip(torch.split(p_new, [x.numel() for x in params]), params)],
        )
        new = AdamState(
            torch.where(bad, state.mu, mu), torch.where(bad, state.nu, nu),
            torch.where(bad, count, count + 1),
        )
        return new, bad


def make_optimizer(cfg: PipelineConfig, schedule: Optional[Callable] = None) -> Adam:
    """Adam with eps ``cfg.adam_eps`` (1e-15) under the cyclic LR
    (``step.py:72-104``): ``adamw`` when ``cfg.weight_decay`` > 0, else a
    decoupled decay of the main field's ``W`` and ``phase`` alone when
    ``cfg.spectral_spectrum_wd`` > 0, else plain Adam."""
    if schedule is None:
        schedule = cyclic_lr(cfg.lr_base, cfg.lr, max(cfg.training_steps // 4, 1))
    if cfg.weight_decay > 0:
        return Adam(schedule, eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    if cfg.spectral_spectrum_wd > 0:
        return Adam(
            schedule, eps=cfg.adam_eps, weight_decay=cfg.spectral_spectrum_wd,
            decay_mask=lambda name, _: name in ("main.W", "main.phase"),
        )
    return Adam(schedule, eps=cfg.adam_eps)


def reset_opt_state(state: EnsembleState, cfg: PipelineConfig, schedule) -> EnsembleState:
    """Fresh optimizer bookkeeping for a new schedule, and step 0
    (``step.py:126-131``)."""
    opt = make_optimizer(cfg, schedule)
    return state._replace(
        opt=[opt.init(list(m.parameters())) for m in state.members], step=0
    )


# -- the (ngp, occ) oracle path -------------------------------------------------------------


def make_ngp_config(cfg: PipelineConfig) -> ngp.NGPConfig:
    """The NGP field's configuration from the pipeline's (``step.py:55-69``)."""
    return ngp.NGPConfig(
        aabb=tuple(float(v) for v in cfg.aabb),
        neurons=cfg.main_neurons,
        layers=cfg.main_layer,
        geo_feat_dim=cfg.geo_feat_dim,
        n_levels=cfg.n_levels,
        n_features=cfg.n_features,
        log2_hashmap_size=cfg.log2_hashmap_size,
        base_resolution=cfg.base_resolution,
        max_resolution=cfg.max_resolution,
        num_semantic_classes=cfg.num_semantic_classes,
    )


def default_ngp_schedule(cfg: PipelineConfig):
    """The ngp path's cyclic LR, ``lr_base`` → ``lr`` over a quarter of the
    train budget up and down."""
    return cyclic_lr(cfg.lr_base, cfg.lr, max(cfg.training_steps // 4, 1))


def _ngp_optimizer(cfg: PipelineConfig, schedule: Optional[Callable]) -> Adam:
    if cfg.spectral_spectrum_wd > 0:
        raise ValueError(
            "spectral_spectrum_wd decays the spectral field's spectrum; the ngp field has "
            "none (use weight_decay)"
        )
    return make_optimizer(cfg, schedule or default_ngp_schedule(cfg))


def init_ensemble(cfg: PipelineConfig, generator: torch.Generator, device=None) -> EnsembleState:
    """E NGP members from ``generator``, fresh Adam states and empty grids,
    at step 0 (``step.py:107-123``)."""
    ngp_cfg = make_ngp_config(cfg)
    opt = _ngp_optimizer(cfg, None)
    members = [ngp.init_ngp(ngp_cfg, generator, device) for _ in range(cfg.n_ensembles)]
    return EnsembleState(
        members=members, opt=[opt.init(list(m.parameters())) for m in members],
        occ=[init_occ_grid(cfg.aabb, cfg.main_grid_resolution, device) for _ in members],
        step=0,
    )


def make_lattice(cfg: PipelineConfig, device=None) -> torch.Tensor:
    """The march's candidate lattice [n_candidates + 1] on ``device``."""
    return torch.as_tensor(
        candidate_lattice(cfg.n_candidates, cfg.near_plane, cfg.render_step_size,
                          cfg.cone_angle),
        device=device,
    )


def make_member_core(cfg: PipelineConfig, lattice: torch.Tensor,
                     schedule: Optional[Callable] = None,
                     grad_reduce: Optional[Callable] = None):
    """One NGP member's train step (``step.py:134-209``) →
    ``member_core(member, opt_state, batch, step, occ, occ_thre,
    generator=None, occ_draws=None) -> CoreOutput``:
      1. the occupancy update on its cadence (every ``occ_every_n`` steps;
         all cells during warm-up), from the member's density times
         ``render_step_size`` before this step's update; its draws come
         from ``generator`` or ``occ_draws``;
      2. the occupancy-march render of the batch over ``lattice``
         (``make_lattice``, on the batch's device) with ``alpha_thre``
         clamped by the updated grid's mean;
      3. the loss 10·huber(rgb) + huber(depth) / 5 + CE(sem) / 2 and its
         gradients by autograd (the weights kernel's backward on the card);
      4. Adam with the reduction-only NaN guard: a non-finite gradient
         leaves the parameters, both moments and the count as they were.
    ``grad_reduce`` (a list of gradients → a list) is applied to the raw
    gradients before the guard and Adam: the data-parallel phase's mean
    over ``data`` (the JAX core gets it from GSPMD); a NaN on one rank
    reaches every rank through it, so the guard agrees across ranks.
    The member's parameters update in place; the new grid is returned in
    ``CoreOutput.occ``. The core's ``updates_occ`` attribute tells the
    train phase to hand it the grid and the phase's threshold."""
    ngp_cfg = make_ngp_config(cfg)
    opt = _ngp_optimizer(cfg, schedule)

    def member_core(member, opt_state, batch, step, occ, occ_thre, generator=None,
                    occ_draws=None) -> CoreOutput:
        @torch.no_grad()
        def occ_eval_fn(x):
            return ngp.query_density(member, ngp_cfg, x) * cfg.render_step_size

        occ = maybe_update_occ_grid(
            occ, occ_eval_fn, step, occ_thre, every_n=cfg.occ_every_n,
            generator=generator, draws=occ_draws,
            ema_decay=cfg.occ_ema_decay, warmup_steps=cfg.occ_warmup_steps,
        )

        def field_fn(pos, dirs):
            return ngp.forward(member, ngp_cfg, pos, dirs)

        names, params = zip(*member.named_parameters())
        with torch.enable_grad():
            out = render_train(
                field_fn, batch.origins, batch.viewdirs, occ, lattice,
                cfg.max_samples_train, batch.color_bkgd, alpha_thre=cfg.alpha_thre,
                occ_mean=occ.occs.mean(),
            )
            l_rgb = F.huber_loss(out["rgb"], batch.pixels, delta=1.0)
            l_dep = F.huber_loss(out["depth"][:, 0], batch.depth, delta=1.0)
            l_sem = F.cross_entropy(out["sem"], batch.sem.long())
            loss = l_rgb * 10.0 + l_dep / 5.0 + l_sem / 2.0
            grads = torch.autograd.grad(loss, list(params))
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        new_state, bad = opt.step(list(params), grads, opt_state, names=names)
        return CoreOutput(new_state, loss.detach(), l_rgb.detach(), l_dep.detach(),
                          l_sem.detach(), out["n_samples"], bad, occ)

    member_core.updates_occ = True
    return member_core


class TrainStepOutput(NamedTuple):
    """One ensemble step's result: the state and per-member [E] values."""

    state: EnsembleState
    loss: torch.Tensor
    loss_rgb: torch.Tensor
    loss_dep: torch.Tensor
    loss_sem: torch.Tensor
    n_samples: torch.Tensor
    skipped: torch.Tensor


def fetch_ensemble_batch(cfg: PipelineConfig, images, depths, semantics, camtoworlds, K,
                         image_idx: torch.Tensor, generator: Optional[torch.Generator] = None,
                         draws: Optional[dict] = None, members: Optional[Sequence[int]] = None,
                         shard: Optional[Tuple[int, int]] = None) -> List[RayBatch]:
    """One ray batch per member (``step.py:212-222``): member m's
    ``num_rays`` pixels of image ``image_idx[m]``. Every member's pixels
    are drawn (``draws``: ``x``, ``y`` [E, R] and ``bkgd`` [E, 3], or
    ``generator``, member by member), and ``members`` keeps some of them,
    each on its ``shard`` of the rays (``fetch_rays``)."""
    E = len(image_idx)
    members = range(E) if members is None else members
    out = {}
    for m in range(E):
        d = None if draws is None else {k: draws[k][m] for k in ("x", "y", "bkgd")}
        if d is None:
            H, W, dev = images.shape[1], images.shape[2], images.device
            d = {"x": torch.randint(0, W, (cfg.num_rays,), generator=generator, device=dev),
                 "y": torch.randint(0, H, (cfg.num_rays,), generator=generator, device=dev),
                 "bkgd": torch.rand((3,), generator=generator, device=dev)}
        if m in members:
            out[m] = fetch_rays(images, depths, semantics, camtoworlds, K, image_idx[m],
                                cfg.num_rays, training=True, draws=d, shard=shard)
    return [out[m] for m in members]


def make_train_step(cfg: PipelineConfig, lattice: torch.Tensor,
                    schedule: Optional[Callable] = None, mesh=None):
    """One (ngp, occ) ensemble step for given images (``step.py:225-263``)
    → ``step_fn(state, images, depths, semantics, camtoworlds, K, image_idx
    [E], occ_thre, generator=None, draws=None) -> TrainStepOutput``.
    ``draws`` holds ``x``, ``y``, ``bkgd`` as ``fetch_ensemble_batch``
    takes them and ``occ``, one occupancy draw per member (or None), made
    after every member's pixels, as JAX splits its fetch keys before its
    occupancy keys. On ``mesh`` (``parallel/sharding.make_sharded_train_step``)
    the state holds this rank's members, each step runs on this rank's
    rays with its gradients averaged over ``data``, and every rank returns
    all E: losses averaged over ``data``, samples summed over it."""
    from ..parallel.mesh import Mesh

    mesh = mesh or Mesh.single()
    grad_reduce = mesh.mean_data if mesh.n_data > 1 else None
    member_core = make_member_core(cfg, lattice, schedule, grad_reduce)

    def step_fn(state: EnsembleState, images, depths, semantics, camtoworlds, K,
                image_idx: torch.Tensor, occ_thre: float,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> TrainStepOutput:
        E = len(state.members) * mesh.n_ens
        local = mesh.members(E)
        shard = (mesh.data_index, mesh.n_data) if mesh.n_data > 1 else None
        batches = fetch_ensemble_batch(cfg, images, depths, semantics, camtoworlds, K,
                                       image_idx, generator, draws, local, shard)
        if draws is not None:
            occ_draws = draws["occ"]
        else:
            n_cells = state.occ[0].occs.numel()
            occ_draws = [
                _draw(n_cells, n_cells if state.step < cfg.occ_warmup_steps
                      else 2 * (n_cells // 4), generator, images.device)
                if state.step % cfg.occ_every_n == 0 else None
                for _ in range(E)
            ]
        outs = [
            member_core(state.members[j], state.opt[j], batches[j], state.step, state.occ[j],
                        occ_thre, generator=generator, occ_draws=occ_draws[m])
            for j, m in enumerate(local)
        ]
        new_state = state._replace(opt=[o.opt for o in outs], occ=[o.occ for o in outs],
                                   step=state.step + 1)

        def per_member(field, reduce="mean"):
            v = torch.stack([getattr(o, field) for o in outs])
            if reduce == "mean":
                return mesh.mean_data_gather_ens(v)
            return mesh.gather_ens(mesh.sum_data(v))  # counts add up over the rays' shards

        return TrainStepOutput(
            state=new_state, loss=per_member("loss"), loss_rgb=per_member("loss_rgb"),
            loss_dep=per_member("loss_dep"), loss_sem=per_member("loss_sem"),
            n_samples=per_member("n_samples", "sum"), skipped=mesh.gather_ens(
                torch.stack([o.skipped for o in outs])),
        )

    return step_fn
