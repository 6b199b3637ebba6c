"""Vanilla and time-conditioned NeRF MLP fields.

Port of ``apnerf_tpu/models/mlp.py``:
  * ``sinusoidal_encode``: optional identity ++ sin/cos of x scaled by
    2^[min_deg, max_deg);
  * the vanilla NeRF (``VanillaNeRFConfig``, ``init_vanilla_nerf``,
    ``vanilla_query_density``, ``vanilla_forward``): an 8 × 256 ReLU trunk
    with the encoded position concatenated again at layer 4, a density
    head, and a 1 × 128 rgb head on a bottleneck and the encoded view
    direction; relu density, sigmoid rgb;
  * T-NeRF (``TNeRFConfig``, ``init_tnerf``, ``tnerf_forward``,
    ``tnerf_query_density``): a warp MLP d(x, t) added to the positions
    before the vanilla field, identically zero at t = 0;
  * NDR-TNeRF (``NDRTNeRFConfig``, ``init_ndr_tnerf``, ``_ndr_block``,
    ``ndr_warp``, ``ndr_tnerf_forward``): three SE(2) coupling blocks with
    axis rolls between them before the vanilla field; each block's last
    layers start U(0, 1e-4), so the warp starts near the identity.

Parameters are ``nn.Module``s named as the JAX trees are (``trunk.layer0.w0``,
``sigma``, ``bottleneck``, ``rgb``; ``warp`` and ``base``; ``blocks.0.warp1``,
``time1``, …), so weights carry across by name (``interop.py``). The JAX
package runs these MLPs in XLA, outside any kernel; here they are float32
``torch.matmul`` chains (``models/nn.apply_mlp`` without a compute dtype),
with ``allow_tf32`` left at its default, False.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .nn import MLP, apply_mlp, init_mlp


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """[..., D] → [..., D·(identity + 2·(max_deg - min_deg))]: the sines of
    x·2^k and of x·2^k + π/2, k in [min_deg, max_deg)."""
    if max_deg == min_deg:
        return x
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    enc = torch.sin(torch.cat([xb, xb + 0.5 * np.pi], dim=-1))
    if use_identity:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def _enc_dim(in_dim: int, min_deg: int, max_deg: int, use_identity: bool) -> int:
    return in_dim * (int(use_identity) + (max_deg - min_deg) * 2)


def _tree_module(tree: dict, device=None) -> nn.Module:
    """A JAX tree of MLP dicts (leaves ``w{i}``/``b{i}``) → nested
    ``nn.ModuleDict``s of :class:`MLP`, keyed as the tree."""
    if any(k.startswith("w") and k[1:].isdigit() for k in tree):
        return MLP.from_tree(tree, device)
    return nn.ModuleDict({k: _tree_module(v, device) for k, v in tree.items()})


class VanillaNeRFConfig(NamedTuple):
    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128
    x_min_deg: int = 0
    x_max_deg: int = 10
    d_min_deg: int = 0
    d_max_deg: int = 4

    @property
    def x_enc_dim(self) -> int:
        return _enc_dim(3, self.x_min_deg, self.x_max_deg, True)

    @property
    def d_enc_dim(self) -> int:
        return _enc_dim(3, self.d_min_deg, self.d_max_deg, False)


class VanillaNeRF(nn.Module):
    """``trunk`` (``layer{i}``), ``sigma``, ``bottleneck`` and ``rgb``."""

    def __init__(self, trunk: nn.ModuleDict, sigma: MLP, bottleneck: MLP, rgb: MLP):
        super().__init__()
        self.trunk, self.sigma, self.bottleneck, self.rgb = trunk, sigma, bottleneck, rgb

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "VanillaNeRF":
        return cls(_tree_module(tree["trunk"], device), MLP.from_tree(tree["sigma"], device),
                   MLP.from_tree(tree["bottleneck"], device), MLP.from_tree(tree["rgb"], device))


def init_vanilla_nerf(cfg: VanillaNeRFConfig, generator: torch.Generator,
                      device=None) -> VanillaNeRF:
    """He-uniform weights and zero biases, drawn from ``generator`` in the
    order trunk, sigma, bottleneck, rgb."""
    width, skip = cfg.net_width, cfg.skip_layer
    in_dim = cfg.x_enc_dim
    trunk = nn.ModuleDict()
    for i in range(cfg.net_depth):
        d_in = in_dim if i == 0 else width
        if i > 0 and i % skip == 0:
            d_in += in_dim
        trunk[f"layer{i}"] = init_mlp([d_in, width], generator, device)
    return VanillaNeRF(
        trunk,
        init_mlp([width, 1], generator, device),
        init_mlp([width, width], generator, device),
        init_mlp([width + cfg.d_enc_dim] + [cfg.net_width_condition] * cfg.net_depth_condition
                 + [3], generator, device),
    )


def _trunk(params: VanillaNeRF, cfg: VanillaNeRFConfig, xe: torch.Tensor) -> torch.Tensor:
    h = xe
    for i in range(cfg.net_depth):
        if i > 0 and i % cfg.skip_layer == 0:
            h = torch.cat([h, xe], dim=-1)
        h = torch.relu(apply_mlp(params.trunk[f"layer{i}"], h))
    return h


def vanilla_query_density(params: VanillaNeRF, x: torch.Tensor,
                          cfg: VanillaNeRFConfig = VanillaNeRFConfig()) -> torch.Tensor:
    """relu density [..., 1] at positions x [..., 3]."""
    xe = sinusoidal_encode(x, cfg.x_min_deg, cfg.x_max_deg, True)
    return torch.relu(apply_mlp(params.sigma, _trunk(params, cfg, xe)))


def vanilla_forward(params: VanillaNeRF, x: torch.Tensor,
                    direction: Optional[torch.Tensor] = None,
                    cfg: VanillaNeRFConfig = VanillaNeRFConfig()):
    """→ (rgb [..., 3] sigmoid, sigma [..., 1] relu). Without a direction
    the rgb head reads the first columns of the trunk's output."""
    xe = sinusoidal_encode(x, cfg.x_min_deg, cfg.x_max_deg, True)
    h = _trunk(params, cfg, xe)
    raw_sigma = apply_mlp(params.sigma, h)
    if direction is not None:
        de = sinusoidal_encode(direction, cfg.d_min_deg, cfg.d_max_deg, False)
        raw_rgb = apply_mlp(params.rgb, torch.cat([apply_mlp(params.bottleneck, h), de], dim=-1))
    else:
        raw_rgb = apply_mlp(params.rgb, h[..., : params.rgb.w0.shape[0]])
    return torch.sigmoid(raw_rgb), torch.relu(raw_sigma)


class TNeRFConfig(NamedTuple):
    base: VanillaNeRFConfig = VanillaNeRFConfig()
    warp_depth: int = 4
    warp_width: int = 64
    xt_min_deg: int = 0
    xt_max_deg: int = 4


class TNeRF(nn.Module):
    """``warp`` (enc(x, t) → dx) and ``base`` (a :class:`VanillaNeRF`)."""

    def __init__(self, warp: MLP, base: VanillaNeRF):
        super().__init__()
        self.warp, self.base = warp, base

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "TNeRF":
        return cls(MLP.from_tree(tree["warp"], device), VanillaNeRF.from_tree(tree["base"], device))


def init_tnerf(cfg: TNeRFConfig, generator: torch.Generator, device=None) -> TNeRF:
    in_dim = _enc_dim(4, cfg.xt_min_deg, cfg.xt_max_deg, True)
    warp = init_mlp([in_dim] + [cfg.warp_width] * cfg.warp_depth + [3], generator, device)
    return TNeRF(warp, init_vanilla_nerf(cfg.base, generator, device))


def _time_warp(params: TNeRF, x: torch.Tensor, t: torch.Tensor, cfg: TNeRFConfig) -> torch.Tensor:
    """x + d(x, t), with d ≡ 0 where t == 0."""
    t = torch.broadcast_to(t, x[..., :1].shape)
    enc = sinusoidal_encode(torch.cat([x, t], dim=-1), cfg.xt_min_deg, cfg.xt_max_deg, True)
    dx = apply_mlp(params.warp, enc)
    return x + torch.where(t == 0.0, torch.zeros_like(dx), dx)


def tnerf_forward(params: TNeRF, x: torch.Tensor, t: torch.Tensor,
                  direction: Optional[torch.Tensor] = None,
                  cfg: TNeRFConfig = TNeRFConfig()):
    """Time-warped NeRF → (rgb, sigma); t [..., 1] broadcasts over x."""
    return vanilla_forward(params.base, _time_warp(params, x, t, cfg), direction, cfg.base)


def tnerf_query_density(params: TNeRF, x: torch.Tensor, t: torch.Tensor,
                        cfg: TNeRFConfig = TNeRFConfig()) -> torch.Tensor:
    """Density [..., 1] through the time warp."""
    return vanilla_query_density(params.base, _time_warp(params, x, t, cfg), cfg.base)


# -- NDR-TNeRF: an invertible (coupling-block) deformation --------------------------------


class NDRTNeRFConfig(NamedTuple):
    base: VanillaNeRFConfig = VanillaNeRFConfig()
    n_blocks: int = 3
    width: int = 128
    time_feat: int = 64
    t_min_deg: int = 0
    t_max_deg: int = 4
    uv_min_deg: int = 0
    uv_max_deg: int = 4


class NDRTNeRF(nn.Module):
    """``blocks`` (``"0"``.. each ``warp1``, ``warp2``, ``time1``,
    ``time2``) and ``base`` (a :class:`VanillaNeRF`)."""

    def __init__(self, blocks: nn.ModuleDict, base: VanillaNeRF):
        super().__init__()
        self.blocks, self.base = blocks, base

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "NDRTNeRF":
        return cls(_tree_module(tree["blocks"], device),
                   VanillaNeRF.from_tree(tree["base"], device))


def _near_zero_output(mlp: MLP, generator: torch.Generator) -> MLP:
    """The last layer's weights redrawn U(0, 1e-4), so the warp starts near
    the identity."""
    w = getattr(mlp, f"w{mlp.n_layers - 1}")
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=generator, device=generator.device) * 1e-4)
    return mlp


def init_ndr_tnerf(cfg: NDRTNeRFConfig, generator: torch.Generator,
                   device=None) -> NDRTNeRF:
    t_dim = _enc_dim(1, cfg.t_min_deg, cfg.t_max_deg, True)
    uv_dim = _enc_dim(2, cfg.uv_min_deg, cfg.uv_max_deg, True)
    w_dim = _enc_dim(1, cfg.uv_min_deg, cfg.uv_max_deg, True)
    blocks = nn.ModuleDict()
    for i in range(cfg.n_blocks):
        blocks[str(i)] = nn.ModuleDict({
            # depth-2 lift MLP: (enc(uv), time features) -> dw
            "warp1": _near_zero_output(init_mlp(
                [uv_dim + cfg.time_feat, cfg.width, cfg.width, 1], generator, device), generator),
            # depth-1 SE(2) MLP: (enc(w), time features) -> (theta, t_uv)
            "warp2": _near_zero_output(init_mlp(
                [w_dim + cfg.time_feat, cfg.width, 3], generator, device), generator),
            "time1": init_mlp([t_dim, cfg.time_feat], generator, device),
            "time2": init_mlp([t_dim, cfg.time_feat], generator, device),
        })
    return NDRTNeRF(blocks, init_vanilla_nerf(cfg.base, generator, device))


def _ndr_block(block: nn.ModuleDict, x: torch.Tensor, t_enc: torch.Tensor,
               cfg: NDRTNeRFConfig) -> torch.Tensor:
    """One coupling block: lift w by an MLP of (uv, t), then move uv by the
    inverse of an SE(2) predicted from (w, t)."""
    uv, w = x[..., :2], x[..., 2:]
    enc_uv = sinusoidal_encode(uv, cfg.uv_min_deg, cfg.uv_max_deg, True)
    w = w + apply_mlp(block["warp1"], torch.cat([enc_uv, apply_mlp(block["time1"], t_enc)], dim=-1))
    enc_w = sinusoidal_encode(w, cfg.uv_min_deg, cfg.uv_max_deg, True)
    rt = apply_mlp(block["warp2"], torch.cat([enc_w, apply_mlp(block["time2"], t_enc)], dim=-1))
    theta, trans = rt[..., 0], rt[..., 1:]
    c, s = torch.cos(theta), torch.sin(theta)
    duv = uv - trans
    uv = torch.stack([c * duv[..., 0] + s * duv[..., 1], -s * duv[..., 0] + c * duv[..., 1]],
                     dim=-1)
    return torch.cat([uv, w], dim=-1)


def ndr_warp(params: NDRTNeRF, x: torch.Tensor, t: torch.Tensor,
             cfg: NDRTNeRFConfig = NDRTNeRFConfig()) -> torch.Tensor:
    """The deformation: three coupling blocks with axis rolls between them."""
    t_enc = sinusoidal_encode(torch.broadcast_to(t, x[..., :1].shape), cfg.t_min_deg,
                              cfg.t_max_deg, True)
    x = _ndr_block(params.blocks["0"], x, t_enc, cfg)
    x = x[..., [1, 2, 0]]
    x = _ndr_block(params.blocks["1"], x, t_enc, cfg)
    x = x[..., [2, 0, 1]]
    return _ndr_block(params.blocks["2"], x, t_enc, cfg)


def ndr_tnerf_forward(params: NDRTNeRF, x: torch.Tensor, t: torch.Tensor,
                      direction: Optional[torch.Tensor] = None,
                      cfg: NDRTNeRFConfig = NDRTNeRFConfig()):
    """NDR-warped vanilla NeRF → (rgb, sigma)."""
    return vanilla_forward(params.base, ndr_warp(params, x, t, cfg), direction, cfg.base)
