"""Instant-NGP semantic radiance field, and the density activation the
fields share.

Port of ``apnerf_tpu/models/ngp.py``: ``trunc_exp``, ``NGPConfig``,
``init_ngp``, ``_normalize_positions``, ``query_density``, ``query_rgb``,
``query_semantic`` and ``forward``, and the proposal (density-only)
field of the NGP + proposal trainer: ``NGPDensityConfig``,
``init_ngp_density`` and ``query_density_field``. The field is an ``nn.Module`` whose
parameters carry the JAX tree's names: ``table`` [L, T, F] (the hash
grid), ``mlp_base`` (hash features → 1 + geo features), ``mlp_head`` (SH
degree 4 of the view direction ++ geo features → rgb) and ``mlp_sem``
(geo features → class logits). Everything runs in float32, as
``apply_mlp`` runs it without a compute dtype; the matrix products take
float32 operands because ``torch.backends.cuda.matmul.allow_tf32`` stays
at its default, False (nothing in the port sets it). No kernel of the
port takes this field: the hash gather, its ``index_add_`` backward and
the MLPs are PyTorch ops, as the JAX package leaves them to XLA.
With ``unbounded`` a field reads positions through the scene contraction
(``ops/contraction.py``) and has no in-aabb selector.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import hashgrid
from ..ops.contraction import contract_to_unisphere
from ..ops.sh import sh_encode_deg4
from .nn import MLP, apply_mlp, init_mlp


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` whose gradient is taken at the input clamped to 15, so a
    large raw density cannot produce an infinite gradient."""
    return _TruncExp.apply(x)


class NGPConfig(NamedTuple):
    aabb: Tuple[float, ...]  # (6,)
    neurons: int = 128
    layers: int = 2  # hidden layers of the base MLP
    geo_feat_dim: int = 15
    n_levels: int = 16
    n_features: int = 4
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 4096
    num_semantic_classes: int = 0
    use_viewdirs: bool = True
    unbounded: bool = False

    @property
    def grid(self) -> hashgrid.HashGridConfig:
        return hashgrid.HashGridConfig(
            n_levels=self.n_levels,
            n_features=self.n_features,
            log2_table_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
        )


class NGPField(nn.Module):
    """One member's parameters (the JAX ``init_ngp`` tree)."""

    def __init__(self, table: torch.Tensor, mlp_base: MLP, mlp_head: MLP,
                 mlp_sem: Optional[MLP] = None):
        super().__init__()
        self.table = nn.Parameter(table)
        self.mlp_base = mlp_base
        self.mlp_head = mlp_head
        if mlp_sem is not None:
            self.mlp_sem = mlp_sem

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "NGPField":
        """From a JAX ``init_ngp`` dict of arrays (numpy or tensors)."""
        table = torch.as_tensor(np.array(tree["table"], np.float32), device=device)
        return cls(
            table, MLP.from_tree(tree["mlp_base"], device), MLP.from_tree(tree["mlp_head"], device),
            MLP.from_tree(tree["mlp_sem"], device) if "mlp_sem" in tree else None,
        )


def init_ngp(cfg: NGPConfig, generator: torch.Generator, device=None) -> NGPField:
    """Table U(-1e-4, 1e-4), He-uniform MLP weights and zero biases, drawn
    from ``generator`` in the order table, base, head, semantics."""
    grid = cfg.grid
    table = hashgrid.init_hash_table(grid, generator, device)
    base = init_mlp(
        [grid.out_dim] + [cfg.neurons] * cfg.layers + [1 + cfg.geo_feat_dim], generator, device
    )
    head = init_mlp(
        [(16 if cfg.use_viewdirs else 0) + cfg.geo_feat_dim] + [cfg.neurons // 2] * 2 + [3],
        generator, device,
    )
    sem = None
    if cfg.num_semantic_classes > 0:
        sem = init_mlp(
            [cfg.geo_feat_dim] + [cfg.neurons // 2] * 2 + [cfg.num_semantic_classes],
            generator, device,
        )
    return NGPField(table, base, head, sem)


def _normalize_positions(cfg, x: torch.Tensor):
    """World positions → (unit-cube coordinates, in-aabb selector); an
    unbounded field contracts the scene and selects everything."""
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=x.device)
    if cfg.unbounded:
        return contract_to_unisphere(x, aabb), torch.ones(x.shape[:-1], dtype=torch.bool,
                                                         device=x.device)
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    selector = ((u > 0.0) & (u < 1.0)).all(dim=-1)
    return u, selector


def query_density(field: NGPField, cfg: NGPConfig, x: torch.Tensor, return_feat: bool = False):
    """Density [..., 1] (and geo features [..., G]) at world positions x
    [..., 3]: trunc_exp(raw - 1), zero outside the aabb."""
    batch_shape = x.shape[:-1]
    u, selector = _normalize_positions(cfg, x)
    enc = hashgrid.hash_encode(field.table, u.reshape(-1, 3), cfg.grid)
    h = apply_mlp(field.mlp_base, enc).reshape(batch_shape + (1 + cfg.geo_feat_dim,))
    density = trunc_exp(h[..., :1] - 1.0) * selector[..., None]
    if return_feat:
        return density, h[..., 1:]
    return density


def query_rgb(field: NGPField, cfg: NGPConfig, direction: torch.Tensor, geo_feat: torch.Tensor):
    """RGB in [0, 1] from the view direction and the geo features."""
    batch_shape = geo_feat.shape[:-1]
    g = geo_feat.reshape(-1, cfg.geo_feat_dim)
    h = torch.cat([sh_encode_deg4(direction.reshape(-1, 3)), g], dim=-1) if cfg.use_viewdirs else g
    return torch.sigmoid(apply_mlp(field.mlp_head, h)).reshape(batch_shape + (3,))


def query_semantic(field: NGPField, cfg: NGPConfig, geo_feat: torch.Tensor):
    """Semantic logits from the geo features."""
    batch_shape = geo_feat.shape[:-1]
    logits = apply_mlp(field.mlp_sem, geo_feat.reshape(-1, cfg.geo_feat_dim))
    return logits.reshape(batch_shape + (cfg.num_semantic_classes,))


def forward(field: NGPField, cfg: NGPConfig, positions: torch.Tensor,
            directions: Optional[torch.Tensor] = None):
    """→ (rgb, density[, semantic logits])."""
    density, geo_feat = query_density(field, cfg, positions, return_feat=True)
    rgb = query_rgb(field, cfg, directions, geo_feat)
    if cfg.num_semantic_classes > 0:
        return rgb, density, query_semantic(field, cfg, geo_feat)
    return rgb, density


# -- the proposal (density-only) field -----------------------------------------------------


class NGPDensityConfig(NamedTuple):
    aabb: Tuple[float, ...]
    base_resolution: int = 16
    max_resolution: int = 128
    n_levels: int = 5
    log2_hashmap_size: int = 17
    unbounded: bool = False

    @property
    def grid(self) -> hashgrid.HashGridConfig:
        return hashgrid.HashGridConfig(
            n_levels=self.n_levels,
            n_features=2,
            log2_table_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
        )


class NGPDensityField(nn.Module):
    """The proposal field's parameters (the JAX ``init_ngp_density`` tree):
    ``table`` [L, T, 2] and ``mlp_base`` (hash features → 64 → 1)."""

    def __init__(self, table: torch.Tensor, mlp_base: MLP):
        super().__init__()
        self.table = nn.Parameter(table)
        self.mlp_base = mlp_base

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "NGPDensityField":
        table = torch.as_tensor(np.array(tree["table"], np.float32), device=device)
        return cls(table, MLP.from_tree(tree["mlp_base"], device))


def init_ngp_density(cfg: NGPDensityConfig, generator: torch.Generator,
                     device=None) -> NGPDensityField:
    """Table U(-1e-4, 1e-4), a He-uniform 64-wide MLP with zero biases."""
    grid = cfg.grid
    table = hashgrid.init_hash_table(grid, generator, device)
    return NGPDensityField(table, init_mlp([grid.out_dim, 64, 1], generator, device))


def query_density_field(field: NGPDensityField, cfg: NGPDensityConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Proposal density [..., 1] at world positions x [..., 3]."""
    batch_shape = x.shape[:-1]
    u, selector = _normalize_positions(cfg, x)
    enc = hashgrid.hash_encode(field.table, u.reshape(-1, 3), cfg.grid)
    h = apply_mlp(field.mlp_base, enc).reshape(batch_shape + (1,))
    return trunc_exp(h - 1.0) * selector[..., None]
