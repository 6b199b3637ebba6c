"""Plain reference of the flagship's candidate score: a spectral
(random Fourier feature) semantic field with one round of proposal
sampling (mip-NeRF 360, Barron et al. 2022), NeRF's quadrature with the
per-ray variances, and the ensemble's predictive information.

The configuration states its compute dtype (``compute_dtype``, bfloat16
for the flagship): the encoding's inputs (the unit-cube positions and the
frequencies) are rounded to it before their float32 product, as the
configuration defines the encoding. The main field's products run in
float32 with TF32 off (``f32``), or with their operands rounded to float8
(``fp8``, the control). The proposal field's output reaches the score
only through where the main field is sampled, and a sample moved by a
rounding can cross a step of the main encoding's rounded positions, which
changes its high bands outright; so the proposal field follows the
stated bfloat16 contract of its products exactly (``common.mlp``'s
``bf16``), and under the control its operands are rounded to float8. Nothing here imports
the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .common import (TruncExp, aabb_intersect, composite, intrinsics, layers_of, matmul_precision,
                     mlp, pose_matrix, rays_from_pixels, sh_deg4, variance, weights_from_density)


def encode(W, phase, u, dtype: torch.dtype):
    """[cos, sin](2π u·W + φ), u and W rounded to ``dtype``, the product in float32."""
    proj = (u.to(dtype).float() @ W.to(dtype).float()) * (2 * np.pi) + phase
    return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32


def _unit(x, aabb):
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    return u, ((u > 0.0) & (u < 1.0)).all(dim=-1)


def prop_density(p, x, aabb, precision, dtype):
    u, inside = _unit(x, aabb)
    h = mlp(layers_of(p, "prop.mlp_base"), encode(p["prop.W"], p["prop.phase"], u, dtype),
            precision)
    return TruncExp.apply(h - 1.0) * inside[:, None]


def main_field(p, x, d, aabb, precision, dtype):
    """(rgb, density, semantic logits) at points x [N, 3], directions d [N, 3]."""
    u, inside = _unit(x, aabb)
    h = mlp(layers_of(p, "main.mlp_base"), encode(p["main.W"], p["main.phase"], u, dtype),
            precision)
    sigma = TruncExp.apply(h[:, :1] - 1.0) * inside[:, None]
    geo = h[:, 1:]
    rgb = torch.sigmoid(mlp(layers_of(p, "main.mlp_head"), torch.cat([sh_deg4(d), geo], -1),
                            precision))
    return rgb, sigma, mlp(layers_of(p, "main.mlp_sem"), geo, precision)


def inverse_cdf(bins, w, n, vmin, vmax, eps: float = 1e-5):
    """n deterministic draws (midpoints of n equal slices of the mass) from
    the piecewise-constant density ``w`` over the edges ``bins``."""
    R = w.shape[0]
    pdf = w / w.sum(dim=-1, keepdim=True).clamp(min=eps)
    cdf = torch.cat([torch.zeros((R, 1), device=w.device), torch.cumsum(pdf, dim=-1)], dim=-1)
    pad = 1.0 / (2 * n)
    u = torch.linspace(pad, 1.0 - pad, n, device=w.device).expand(R, n) * cdf[:, -1:]
    K = cdf.shape[-1]
    right = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True).clamp(0, K - 1)
    left = (right - 1).clamp(0, K - 1)
    c_l, c_r = cdf.gather(1, left), cdf.gather(1, right)
    b_l, b_r = bins.gather(1, left), bins.gather(1, right)
    span = c_r - c_l
    frac = ((u - c_l) / torch.where(span > eps, span, torch.ones_like(span))).clamp(0.0, 1.0)
    return (b_l + frac * (b_r - b_l)).clamp(vmin, vmax)


def render_view(p, o, d, cfg, aabb, precision) -> Dict[str, torch.Tensor]:
    """One member's render of rays (o, d) [R, 3] with variances, black background."""
    R = o.shape[0]
    near = cfg["near_plane"]
    t_min, t_max = aabb_intersect(o, d, aabb, near=near, far=cfg["far_plane"])
    miss = t_min >= t_max
    lo = torch.where(miss, torch.full_like(t_min, near), t_min.clamp(min=near))
    hi = torch.where(miss, torch.full_like(t_max, near * (1 + 1e-4)), t_max)

    def to_t(s):
        return s * (hi - lo)[:, None] + lo[:, None]

    n_prop, n_main = cfg["num_prop_samples"], cfg["max_samples_unc"]
    s_edges = torch.linspace(0.0, 1.0, n_prop + 1, device=o.device).expand(R, n_prop + 1)
    t_e = to_t(s_edges)
    t0, t1 = t_e[:, :-1], t_e[:, 1:]
    mid = 0.5 * (t0 + t1)
    pts = o[:, None] + mid[..., None] * d[:, None]
    prop_precision = "bf16" if precision == "f32" and _dtype(cfg) == torch.bfloat16 else precision
    sig = prop_density(p, pts.reshape(-1, 3), aabb, prop_precision, _dtype(cfg)).reshape(R, n_prop)
    w_prop = weights_from_density(t0, t1, sig)
    s_new = inverse_cdf(s_edges, w_prop, n_main + 1, s_edges[:, :1].min(), s_edges[:, -1:].max())
    t_e = to_t(torch.sort(s_new, dim=-1).values)
    t0, t1 = t_e[:, :-1], t_e[:, 1:]
    mid = 0.5 * (t0 + t1)
    pts = o[:, None] + mid[..., None] * d[:, None]
    rgb, sigma, sem = main_field(p, pts.reshape(-1, 3), d[:, None].expand(pts.shape).reshape(-1, 3),
                                 aabb, precision, _dtype(cfg))
    sigma = sigma.reshape(R, n_main) * (~miss)[:, None]
    rgb = rgb.reshape(R, n_main, 3)
    w = weights_from_density(t0, t1, sigma)
    out = composite(w, t0, t1, rgb, sem.reshape(R, n_main, -1), torch.zeros(3, device=o.device))
    out["rgb_var"] = variance(w, rgb, torch.einsum("rs,rsc->rc", w, rgb))
    out["depth_var"] = variance(w, mid[..., None], out["depth"])
    return out


def scored_views(n: int) -> np.ndarray:
    """The 40 poses of an n-pose trajectory that are scored: 20 spread over
    the flight, 20 over its closing spin."""
    return np.hstack((np.linspace(0, n - 20, 20), np.linspace(n - 20, n - 1, 20))).astype(int)


def view_rays(poses: np.ndarray, cfg: dict, device):
    """Evenly subsampled rays [V, P, 3] of [V, 7] poses at ``unc_scale``."""
    W, H = cfg["img_w"], cfg["img_h"]
    out_n = int(H * cfg["unc_scale"]) * int(W * cfg["unc_scale"])
    idx = np.round(np.linspace(0, H * W - 1, out_n)).astype(np.int64)
    x = torch.as_tensor(idx % W, dtype=torch.float32, device=device)
    y = torch.as_tensor(idx // W, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(np.stack([pose_matrix(q[:3], q[3:]) for q in poses]),
                          dtype=torch.float32, device=device)
    K = torch.as_tensor(intrinsics(W, H, cfg["hfov"]), device=device)
    return rays_from_pixels(x[None], y[None], c2w[:, None], K)


def _gaussian(var):
    n = var.shape[0]
    cond = (torch.log(2 * np.pi * np.e * var + 1e-4) / 2).mean(dim=0)
    mix = torch.log(2 * np.pi * np.e * (var.sum(dim=0) / n) + 1e-4) / 2
    return (mix - cond).mean()


def _categorical(logits):
    pr = torch.softmax(logits, dim=-1)
    cond = (-((pr + 1e-4) * torch.log(pr + 1e-4)).sum(dim=-1)).mean(dim=0)
    pm = pr.mean(dim=0)
    return ((-((pm + 1e-4) * torch.log(pm + 1e-4)).sum(dim=-1)) - cond).mean()


def _bernoulli(acc):
    def H(q):
        return -(q + 1e-4) * torch.log(q + 1e-4) - (1 - q + 1e-4) * torch.log(1 - q + 1e-4)

    return (H(acc.mean(dim=0)) - H(acc).mean(dim=0)).mean()


RENDERED = ("rgb_var", "depth_var", "sem", "opacity")  # what the scores read


def predictive_information(st: Dict[str, torch.Tensor], dtype=torch.float32) -> List[float]:
    """[rgb, depth, 3 x semantic, 2 x occupancy] of an ensemble's renders
    ``st`` ([E, V, P, ...] each of ``RENDERED``): the mixture's entropy less
    the members' mean entropy, per pixel, averaged; computed in ``dtype``
    (float32 as stated; bfloat16 is the control's step below)."""
    st = {k: st[k].to(dtype) for k in RENDERED}
    return [float(_gaussian(st["rgb_var"])), float(_gaussian(st["depth_var"][..., 0])),
            float(_categorical(st["sem"]) * 3.0), float(_bernoulli(st["opacity"][..., 0]) * 2.0)]


@torch.no_grad()
def render_candidate(cfg: dict, weights: Sequence[Dict[str, torch.Tensor]],
                     trajectory: np.ndarray, precision: str = "f32",
                     ray_share: float = 1.0) -> Dict[str, torch.Tensor]:
    """Every member's render of the candidate's scored views → [E, V, P, ...]
    of ``RENDERED``. ``ray_share`` < 1 plants a fault: each view rendered on
    its first rays only."""
    dev = next(iter(weights[0].values())).device
    aabb = torch.as_tensor(cfg["aabb"], dtype=torch.float32, device=dev)
    o, d = view_rays(trajectory[scored_views(len(trajectory))], cfg, dev)
    keep = int(o.shape[1] * ray_share)
    with matmul_precision(precision):
        per_member = []
        for p in weights:
            views = [render_view(p, o[v, :keep], d[v, :keep], cfg, aabb, precision)
                     for v in range(o.shape[0])]
            per_member.append({k: torch.stack([vw[k] for vw in views]) for k in RENDERED})
    return {k: torch.stack([pm[k] for pm in per_member]) for k in RENDERED}
