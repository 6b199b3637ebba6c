"""Flagship field configuration, initialization and occupancy update.

Port of the parts of ``apnerf_tpu/train/flagship.py`` that the planning
step needs: ``make_spectral_config``, ``make_prop_config``, the params and
occupancy grids of ``init_flagship_ensemble`` (``:75-97``) as
``init_flagship_params``, and ``make_flagship_occ_update`` (``:333-364``),
whose density queries run through the CUDA field kernel. The optimizer
and the train step belong to the training port.

The ensemble is a Python list of E member modules, not a vmapped axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import PipelineConfig
from ..models import spectral
from ..ops.occupancy import OccGridState, init_occ_grid, update_occ_grid


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
