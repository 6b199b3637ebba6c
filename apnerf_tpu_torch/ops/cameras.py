"""OpenCV lens distortion and undistortion (pinhole and fisheye).

Port of ``apnerf_tpu/ops/cameras.py``: the forward models, and their
inverses as a fixed count of Newton steps on every point at once, with
the analytic Jacobian; a degenerate Jacobian takes a zero step.

Parameters follow OpenCV:
  * pinhole: N in {0, 1, 2, 4, 8} → {k1, k2, p1, p2, k3, k4, k5, k6},
    zero-padded;
  * fisheye: {k1, k2, k3, k4} (the θ-polynomial model).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_params(params: torch.Tensor, n: int) -> torch.Tensor:
    if params.shape[-1] not in (0, 1, 2, 4, 8):
        raise ValueError(f"lens parameters: {params.shape[-1]} given, not 0, 1, 2, 4 or 8")
    return F.pad(params, (0, n - params.shape[-1])) if params.shape[-1] < n else params


def opencv_lens_distortion(uv: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Distort normalised image coordinates uv [..., 2]."""
    k1, k2, p1, p2, k3, k4, k5, k6 = torch.movedim(_pad_params(params, 8), -1, 0)
    u, v = uv[..., 0], uv[..., 1]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    ratial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    fx = 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    fy = 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return torch.stack([u * ratial + fx, v * ratial + fy], dim=-1)


def _residual_and_jacobian(x, y, xd, yd, params):
    """The distortion residual (fx, fy) at (x, y) against (xd, yd) and its
    2 x 2 Jacobian."""
    k1, k2, p1, p2, k3, k4, k5, k6 = torch.movedim(params, -1, 0)
    r = x * x + y * y
    alpha = 1.0 + r * (k1 + r * (k2 + r * k3))
    beta = 1.0 + r * (k4 + r * (k5 + r * k6))
    d = alpha / beta
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    alpha_r = k1 + r * (2.0 * k2 + r * (3.0 * k3))
    beta_r = k4 + r * (2.0 * k5 + r * (3.0 * k6))
    d_r = (alpha_r * beta - alpha * beta_r) / (beta * beta)
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def opencv_lens_undistortion(uv: torch.Tensor, params: torch.Tensor, eps: float = 1e-6,
                             iters: int = 10) -> torch.Tensor:
    """The inverse of ``opencv_lens_distortion`` by ``iters`` Newton steps
    from the distorted point."""
    if params.shape[-1] == 0:
        return uv
    params = torch.broadcast_to(_pad_params(params, 8), uv.shape[:-1] + (8,))
    x0, y0 = uv[..., 0], uv[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, x0, y0, params)
        denom = fy_x * fx_y - fx_x * fy_y
        ok = denom.abs() > eps
        safe = torch.where(ok, denom, torch.ones_like(denom))
        zero = torch.zeros_like(denom)
        x = x + torch.where(ok, (fx * fy_y - fy * fx_y) / safe, zero)
        y = y + torch.where(ok, (fy * fx_x - fx * fy_x) / safe, zero)
    return torch.stack([x, y], dim=-1)


def _fisheye_params(params: torch.Tensor) -> torch.Tensor:
    if params.shape[-1] != 4:
        raise ValueError(f"fisheye lens parameters: 4 expected, {params.shape[-1]} given")
    return params


def opencv_lens_distortion_fisheye(uv: torch.Tensor, params: torch.Tensor,
                                   eps: float = 1e-10) -> torch.Tensor:
    """Fisheye forward distortion: θ = atan(r) through the θ polynomial."""
    k1, k2, k3, k4 = torch.movedim(_fisheye_params(params), -1, 0)
    u, v = uv[..., 0], uv[..., 1]
    r = torch.sqrt(u * u + v * v)
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return uv * (theta_d / r.clamp(min=eps))[..., None]


def opencv_lens_undistortion_fisheye(uv: torch.Tensor, params: torch.Tensor, eps: float = 1e-6,
                                     iters: int = 10) -> torch.Tensor:
    """The fisheye inverse: θ from θ_d by ``iters`` 1-D Newton steps, then
    the rescale tan(θ) / θ_d."""
    params = torch.broadcast_to(_fisheye_params(params), uv.shape[:-1] + (4,))
    k1, k2, k3, k4 = torch.movedim(params, -1, 0)
    u, v = uv[..., 0], uv[..., 1]
    theta_d = torch.sqrt(u * u + v * v)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        poly = 1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        dpoly = 3 * k1 * t2 + 5 * k2 * t2 * t2 + 7 * k3 * t2 ** 3 + 9 * k4 * t2 ** 4
        f = theta * poly - theta_d
        fp = poly + dpoly
        ok = fp.abs() > eps
        theta = theta - torch.where(ok, f / torch.where(ok, fp, torch.ones_like(fp)),
                                    torch.zeros_like(fp))
    return uv * (torch.tan(theta) / theta_d.clamp(min=eps))[..., None]
