"""Spectral semantic radiance field and the proposal density field.

Port of ``apnerf_tpu/models/spectral.py``: the forward routes, the packed
whole-field forwards ``forward_packed`` (the candidate render's, through
``ops/cuda/fused_field_heads.py``) and ``forward_packed_volrend`` (the
evaluation render's, through ``ops/cuda/fused_field_volrend.py``), both
differentiable, and the train step's ``forward_packed_lossgrad``, which
runs the whole main-field render, loss and backward through the CUDA
train-step kernel. The TPU routing gates (``use_packed_*``,
``supports_fused_volrend``, the ``APNERF_*`` switches) are not carried
over: a caller names its route with a plain argument (``trunk=`` of
``query_density`` and ``forward``, ``fused=`` of ``query_density_field``)
and on the card each route's kernels are its path. The encoding is

    enc(x) = [cos(2π x·W + φ), sin(2π x·W + φ)]      W: [3, M]

followed by a ReLU trunk giving density and geometry features, an rgb
head on SH(direction) ⊕ features and a semantic head on the features.

Parameters live in ``nn.Module``s with the JAX layout (``W`` [3, M],
``phase`` [M], MLPs ``w{i}`` [in, out] / ``b{i}`` [out]); the functions
take (params, cfg, ...) as the JAX functions do. ``query_density`` runs
encode + trunk through the CUDA kernel (``ops/cuda/fused_mlp.py``) for a
bf16 field with a 2- or 3-hidden-layer trunk, at any row count: the TPU
path's ``n_rows % 256`` gate (``spectral.py:256``) is not carried over.
Any other field raises on the card and runs the plain chain in its own
dtype for CPU tensors: no route becomes the plain chain on a CUDA tensor.
With ``trunk="mlp"`` the encode stays outside and the trunk alone goes
through the MLP kernel (``_trunk_apply``, ``spectral.py:207-220``). The
encode outside a kernel is ``encode_plain`` under autograd: the JAX
``_enc_bwd`` rounds dproj to bf16 before its reductions and autograd does
not, a difference of bf16 rounding (2^-9 of each term) in dW, dphase and
du that the parity tests' bf16 tolerances absorb.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.fused_field_heads import fused_field_heads
from ..ops.cuda.fused_field_volrend import fused_field_volrend, fused_field_volrend_lossgrad
from ..ops.cuda.fused_mlp import encode_plain, fused_mlp_apply, fused_spectral_field
from ..ops.sh import sh_encode_deg4
from .ngp import trunc_exp
from .nn import MLP, apply_mlp, init_mlp


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class SpectralConfig(NamedTuple):
    aabb: Tuple[float, ...]  # (6,)
    neurons: int = 256  # trunk width
    layers: int = 3  # trunk hidden layers
    geo_feat_dim: int = 15
    n_levels: int = 16  # frequency bands
    freqs_per_level: int = 8  # random directions per band
    base_freq: float = 16.0
    max_freq: float = 4096.0
    num_semantic_classes: int = 0
    use_viewdirs: bool = True
    compute_dtype: str = "bfloat16"  # matmul dtype; f32 accumulation

    @property
    def n_freqs(self) -> int:
        return self.n_levels * self.freqs_per_level

    @property
    def enc_dim(self) -> int:
        return 2 * self.n_freqs

    @property
    def dtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)


class SpectralDensityConfig(NamedTuple):
    aabb: Tuple[float, ...]
    neurons: int = 64
    layers: int = 2
    n_levels: int = 8
    freqs_per_level: int = 4
    base_freq: float = 4.0
    max_freq: float = 256.0
    compute_dtype: str = "bfloat16"

    @property
    def n_freqs(self) -> int:
        return self.n_levels * self.freqs_per_level

    @property
    def enc_dim(self) -> int:
        return 2 * self.n_freqs

    @property
    def dtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)


def _as_param(a, device=None) -> nn.Parameter:
    if torch.is_tensor(a):
        t = a.to(device=device, dtype=torch.float32)
    else:
        t = torch.as_tensor(np.array(a, np.float32), device=device)
    return nn.Parameter(t)


class SpectralField(nn.Module):
    """The main field's parameters: ``W``, ``phase``, ``mlp_base``,
    ``mlp_head`` and, with semantic classes, ``mlp_sem``."""

    def __init__(self, W, phase, mlp_base: MLP, mlp_head: MLP, mlp_sem: Optional[MLP] = None):
        super().__init__()
        self.W = _as_param(W)
        self.phase = _as_param(phase)
        self.mlp_base = mlp_base
        self.mlp_head = mlp_head
        self.mlp_sem = mlp_sem

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "SpectralField":
        sem = tree.get("mlp_sem")
        return cls(
            _as_param(tree["W"], device), _as_param(tree["phase"], device),
            MLP.from_tree(tree["mlp_base"], device),
            MLP.from_tree(tree["mlp_head"], device),
            MLP.from_tree(sem, device) if sem is not None else None,
        )


class SpectralDensityField(nn.Module):
    """The proposal field's parameters: ``W``, ``phase``, ``mlp_base``."""

    def __init__(self, W, phase, mlp_base: MLP):
        super().__init__()
        self.W = _as_param(W)
        self.phase = _as_param(phase)
        self.mlp_base = mlp_base

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "SpectralDensityField":
        return cls(
            _as_param(tree["W"], device), _as_param(tree["phase"], device),
            MLP.from_tree(tree["mlp_base"], device),
        )


def _init_spectrum(cfg, generator, device):
    """Per-band isotropic random directions scaled to a geometric ladder
    of band frequencies, and uniform phases (``spectral.py:70-89``)."""
    scales = np.exp(np.linspace(np.log(cfg.base_freq), np.log(cfg.max_freq), cfg.n_levels))
    dirs = torch.randn(
        (cfg.n_levels, cfg.freqs_per_level, 3), generator=generator, device=generator.device
    ).to(device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=device)
    W = (dirs * scales[:, None, None]).reshape(cfg.n_freqs, 3)
    phase = torch.rand((cfg.n_freqs,), generator=generator, device=generator.device)
    return W.T.contiguous(), (phase * (2 * np.pi)).to(device)


def init_spectral(cfg: SpectralConfig, generator: torch.Generator, device=None) -> SpectralField:
    W, phase = _init_spectrum(cfg, generator, device)
    base = init_mlp(
        [cfg.enc_dim] + [cfg.neurons] * cfg.layers + [1 + cfg.geo_feat_dim], generator, device
    )
    head = init_mlp(
        [(16 if cfg.use_viewdirs else 0) + cfg.geo_feat_dim] + [cfg.neurons // 4] * 2 + [3],
        generator, device,
    )
    sem = None
    if cfg.num_semantic_classes > 0:
        sem = init_mlp(
            [cfg.geo_feat_dim] + [cfg.neurons // 4] * 2 + [cfg.num_semantic_classes],
            generator, device,
        )
    return SpectralField(W, phase, base, head, sem)


def init_spectral_density(
    cfg: SpectralDensityConfig, generator: torch.Generator, device=None
) -> SpectralDensityField:
    W, phase = _init_spectrum(cfg, generator, device)
    base = init_mlp([cfg.enc_dim] + [cfg.neurons] * cfg.layers + [1], generator, device)
    return SpectralDensityField(W, phase, base)


def _normalize(cfg, x: torch.Tensor):
    """Unit-cube coordinates and the in-aabb selector."""
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=x.device)
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    selector = ((u > 0.0) & (u < 1.0)).all(dim=-1)
    return u, selector


def spectral_encode(params, cfg, u: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit-cube coords → [..., 2M] spectral features."""
    return encode_plain(params.W, params.phase, u, cfg.dtype)


def _use_fused_field(cfg, params_mlp: MLP) -> bool:
    """A field the trunk kernels take: bf16 and 2 or 3 hidden layers."""
    return cfg.compute_dtype == "bfloat16" and params_mlp.n_layers in (3, 4)


def _kernel_route(who: str, cfg, params_mlp: MLP, x: torch.Tensor) -> bool:
    """Whether a call that asks for a trunk kernel goes to its wrapper. A
    field the kernels do not take (f32, another depth) runs the plain chain
    in its own dtype for CPU tensors only; on any other device the route
    raises: it never becomes the plain chain on the card."""
    ok = _use_fused_field(cfg, params_mlp)
    if not ok and x.device.type != "cpu":
        raise ValueError(
            f"{who}: the kernel route takes a bfloat16 field with 2 or 3 hidden layers, got "
            f"{cfg.compute_dtype} with {params_mlp.n_layers - 1}")
    return ok


def _trunk_apply(params_mlp: MLP, enc: torch.Tensor, cfg: SpectralConfig, fused: bool):
    """The trunk on given features: the MLP kernel's wrapper when ``fused``
    (``spectral.py:207-220``), else the plain chain."""
    if fused:
        return fused_mlp_apply(params_mlp, enc.contiguous())
    return apply_mlp(params_mlp, enc, compute_dtype=cfg.dtype)


def query_density(params: SpectralField, cfg: SpectralConfig, x: torch.Tensor,
                  return_feat: bool = False, trunk: str = "field"):
    """``trunk`` names the route of encode + trunk: "field", both in the
    field kernel; "mlp", the encode outside and the trunk in the MLP
    kernel. A field neither kernel takes (f32, another depth) runs the
    plain chain for CPU tensors and raises on the card."""
    if trunk not in ("field", "mlp"):
        raise ValueError(f"query_density: unknown trunk route {trunk!r}")
    batch_shape = x.shape[:-1]
    u, selector = _normalize(cfg, x)
    u = u.reshape(-1, 3)
    kernel = _kernel_route(f"query_density(trunk={trunk!r})", cfg, params.mlp_base, u)
    if kernel and trunk == "field":
        h = fused_spectral_field(params.W, params.phase, params.mlp_base, u.contiguous())
    else:
        h = _trunk_apply(params.mlp_base, spectral_encode(params, cfg, u), cfg, kernel)
    h = h.reshape(batch_shape + (1 + cfg.geo_feat_dim,))
    density_raw, geo_feat = h[..., :1], h[..., 1:]
    density = trunc_exp(density_raw - 1.0) * selector[..., None]
    if return_feat:
        return density, geo_feat
    return density


def query_rgb(params: SpectralField, cfg: SpectralConfig, direction, geo_feat):
    batch_shape = geo_feat.shape[:-1]
    feat = geo_feat.reshape(-1, cfg.geo_feat_dim)
    if cfg.use_viewdirs:
        h = torch.cat([sh_encode_deg4(direction.reshape(-1, 3)), feat], dim=-1)
    else:
        h = feat
    rgb = apply_mlp(params.mlp_head, h, compute_dtype=cfg.dtype)
    return torch.sigmoid(rgb).reshape(batch_shape + (3,))


def query_semantic(params: SpectralField, cfg: SpectralConfig, geo_feat):
    batch_shape = geo_feat.shape[:-1]
    logits = apply_mlp(
        params.mlp_sem, geo_feat.reshape(-1, cfg.geo_feat_dim), compute_dtype=cfg.dtype
    )
    return logits.reshape(batch_shape + (cfg.num_semantic_classes,))


def forward(params: SpectralField, cfg: SpectralConfig, positions, directions=None,
            trunk: str = "field"):
    """→ (rgb, density[, sem_logits]); ``trunk`` as in ``query_density``."""
    density, geo_feat = query_density(params, cfg, positions, return_feat=True, trunk=trunk)
    rgb = query_rgb(params, cfg, directions, geo_feat)
    if cfg.num_semantic_classes > 0:
        return rgb, density, query_semantic(params, cfg, geo_feat)
    return rgb, density


def _packed_inputs(cfg: SpectralConfig, positions, rays_d):
    """Flat unit-cube coordinates [N, 3] and per-ray SH features [R, 16], as
    the packed kernels read them."""
    u, _ = _normalize(cfg, positions)
    sh = sh_encode_deg4(rays_d).detach()
    return u.reshape(-1, 3).float().contiguous(), sh.float().contiguous()


def forward_packed(
    params: SpectralField,
    cfg: SpectralConfig,
    positions: torch.Tensor,  # [R, S, 3]
    rays_d: torch.Tensor,  # [R, 3] per-ray directions
) -> torch.Tensor:
    """The whole field in one kernel (``spectral.py:471-497``) → packed
    [R, S, 4 + C] f32: columns 0:3 rgb (sigmoid), 3 density
    (``trunc_exp(x - 1)`` times the in-aabb selector), 4: semantic logits.
    Same math as ``forward``; samples are rows (the JAX function returns
    the TPU's channel-major [4 + C, R, S]). Differentiable in the
    parameters and the positions; the directions get no gradient."""
    R, S = positions.shape[0], positions.shape[1]
    u, sh = _packed_inputs(cfg, positions, rays_d)
    y = fused_field_heads(list(params.parameters()), u, sh, S, cfg.dtype)
    return y.reshape(R, S, y.shape[-1])


def forward_packed_volrend(
    params: SpectralField,
    cfg: SpectralConfig,
    positions: torch.Tensor,  # [R, S, 3]
    rays_d: torch.Tensor,  # [R, 3]
    t0: torch.Tensor,  # [R, S]
    t1: torch.Tensor,  # [R, S]
    miss: torch.Tensor,  # [R] bool, the ray missed the aabb
):
    """The whole field and volume rendering in one call
    (``spectral.py:439-468``) → (acc [R, 5 + C] f32, weights [R, S] f32).
    acc columns: 0:3 Σw·rgb, 3 Σw (opacity), 4 Σw·t_mid (depth numerator),
    5: Σw·sem; the JAX function returns the TPU's [5 + C, R]. Ray misses
    fold into dt, as the unfused ``sigmas * ~miss`` does. Differentiable
    in the parameters and the positions; the directions, t0 and t1 get no
    gradient (``fused_field_volrend.py:670-673``)."""
    R, S = positions.shape[0], positions.shape[1]
    u, sh = _packed_inputs(cfg, positions, rays_d)
    dt = (t1 - t0) * (~miss)[:, None]
    tm = 0.5 * (t0 + t1)
    acc, w = fused_field_volrend(
        list(params.parameters()), u, sh, dt.detach().reshape(-1).float().contiguous(),
        tm.detach().reshape(-1).float().contiguous(), S, cfg.dtype,
    )
    return acc, w.reshape(R, S)


def forward_packed_lossgrad(
    params: SpectralField,
    cfg: SpectralConfig,
    positions: torch.Tensor,  # [R, S, 3]
    rays_d: torch.Tensor,  # [R, 3]
    t0: torch.Tensor,  # [R, S]
    t1: torch.Tensor,  # [R, S]
    miss: torch.Tensor,  # [R] bool
    pixels: torch.Tensor,  # [R, 3] rgb targets in [0, 1]
    depth_gt: torch.Tensor,  # [R]
    sem_labels: torch.Tensor,  # [R] int
    bkgd: Optional[torch.Tensor],  # [3] or None
):
    """The whole train render, loss and backward in one call
    (``spectral.py:386-436``) → (lossrows [3, R] raw per-ray sums, weights
    [R, S] (the proposal loss's detached input), grads keyed like
    ``params``: ``W``, ``phase``, ``mlp_base``, ``mlp_head``, ``mlp_sem``).
    The loss is ``LOSS_WEIGHTS`` on ``loss_terms(lossrows)``
    (``ops/cuda/fused_field_volrend.py``). Not differentiable: the
    gradients are returned. Ray misses fold into dt, as the unfused
    ``sigmas * ~miss`` does."""
    R, S = positions.shape[0], positions.shape[1]
    u, _ = _normalize(cfg, positions)
    sh = sh_encode_deg4(rays_d)
    dt = (t1 - t0) * (~miss)[:, None]
    tm = 0.5 * (t0 + t1)
    if bkgd is None:
        bkgd = torch.zeros(3, device=positions.device)
    lossrows, w, grads = fused_field_volrend_lossgrad(
        list(params.parameters()), u.reshape(-1, 3).float().contiguous(),
        sh.float().contiguous(), dt.reshape(-1).float().contiguous(),
        tm.reshape(-1).float().contiguous(), pixels.float().contiguous(),
        depth_gt.float().contiguous(), sem_labels.to(torch.int32).contiguous(),
        bkgd.float().contiguous(), S, cfg.dtype,
    )
    tree: dict = {}
    for (name, _), g in zip(params.named_parameters(), grads):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = g
    return lossrows, w.reshape(R, S), tree


def grads_in_order(params: nn.Module, tree: dict) -> list:
    """A gradient tree keyed like ``params`` → its leaves in
    ``params.parameters()`` order."""
    out = []
    for name, _ in params.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        out.append(node)
    return out


def query_density_field(params: SpectralDensityField, cfg: SpectralDensityConfig,
                        x: torch.Tensor, fused: bool = False):
    """Proposal density. The plain chain by default, as the JAX package
    runs it; ``fused`` takes encode + trunk through the field kernel, its
    opt-in route (``spectral.py:596-619``): a field that kernel does not
    take (f32, another depth) runs the plain chain for CPU tensors and
    raises on the card."""
    batch_shape = x.shape[:-1]
    u, selector = _normalize(cfg, x)
    dt = cfg.dtype
    u = u.reshape(-1, 3)
    if fused and _kernel_route("query_density_field(fused=True)", cfg, params.mlp_base, u):
        h = fused_spectral_field(params.W, params.phase, params.mlp_base, u.contiguous())
    else:
        proj = (u.to(dt).float() @ params.W.to(dt).float()) * (2 * np.pi) + params.phase
        enc = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
        h = apply_mlp(params.mlp_base, enc, compute_dtype=dt)
    return trunc_exp(h.reshape(batch_shape + (1,)) - 1.0) * selector[..., None]
