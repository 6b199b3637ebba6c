"""Ensemble train state and the optimizer.

Port of ``apnerf_tpu/train/step.py``: ``EnsembleState``,
``make_optimizer``'s default branch and ``reset_opt_state``. The
optimizer is ``optax.adam(schedule, eps=cfg.adam_eps)`` written as plain
tensor ops, not ``torch.optim.Adam``, for two reasons:
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

from ..config import PipelineConfig
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


class Adam:
    """``optax.adam``: bias-corrected moments, ``eps`` outside the square
    root, the learning rate read from ``schedule(count)``."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        return AdamState(zeros, zeros.clone(), torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def step(
        self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState
    ) -> Tuple[AdamState, torch.Tensor]:
        """Update ``params`` in place → (new state, bad). ``bad`` is a
        device bool: a gradient leaf held a NaN or an infinity, and then
        the parameters and the returned state equal the old ones."""
        g = torch.cat([x.reshape(-1) for x in grads]).float()
        p = torch.cat([x.reshape(-1) for x in params])
        bad = ~torch.isfinite(g).all()
        count = state.count
        c1 = (count + 1).float()
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        mu_hat = mu / (1 - self.b1 ** c1)
        nu_hat = nu / (1 - self.b2 ** c1)
        upd = -self.schedule(count) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
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
    (``step.py:72-104``, its default branch)."""
    if schedule is None:
        schedule = cyclic_lr(cfg.lr_base, cfg.lr, max(cfg.training_steps // 4, 1))
    if cfg.weight_decay > 0:
        raise NotImplementedError(
            "weight_decay > 0 (optax.adamw) is not ported yet: it is queued with the "
            "mapper loop (ROADMAP.md)"
        )
    if getattr(cfg, "spectral_spectrum_wd", 0.0) > 0:
        raise NotImplementedError(
            "spectral_spectrum_wd > 0 is not ported yet: it is queued with the mapper "
            "loop (ROADMAP.md)"
        )
    return Adam(schedule, eps=cfg.adam_eps)


def reset_opt_state(state: EnsembleState, cfg: PipelineConfig, schedule) -> EnsembleState:
    """Fresh optimizer bookkeeping for a new schedule, and step 0
    (``step.py:126-131``)."""
    opt = make_optimizer(cfg, schedule)
    return state._replace(
        opt=[opt.init(list(m.parameters())) for m in state.members], step=0
    )
