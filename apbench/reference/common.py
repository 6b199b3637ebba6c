"""Plain pieces both references share: rays, the SH encoding, volume
rendering, the MLPs and the precision they compute in.

Plain PyTorch, written from the published methods (NeRF's quadrature,
Instant-NGP's degree-4 SH, mip-NeRF 360's proposal weights) in the layout
the benchmark's weights use. Nothing here imports the measured program.

A precision names how the matrix products run: ``f32`` (float32
operands and sums, TF32 off), ``bf16`` (a bfloat16 field's stated
contract, see ``mlp``), ``tf32`` (the operands rounded to TF32's
10-bit mantissa, to nearest even, and multiplied in float32, as the
card's TF32 mode does: the step below float32) and ``fp8`` (the operands
rounded to float8 e4m3 and multiplied in float32: the step below
bfloat16). Both lower precisions are rounded here, so they read the same
on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PRECISIONS = ("f32", "tf32", "fp8", "bf16")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off for every product inside; the settings restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), b.view(torch.float32), x.float())


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    if precision == "tf32":
        return round_tf32(x)
    return x.float()


def mlp(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor,
        precision: str = "f32") -> torch.Tensor:
    """ReLU hidden layers, a linear output; weights [in, out]. ``bf16`` is the
    mixed-precision contract a bfloat16 field states: the input and every
    hidden output rounded to bfloat16, each hidden bias added in bfloat16,
    the last product summed in float32 and emitted in float32."""
    if precision == "bf16":
        x = x.to(torch.bfloat16)
        for i, (w, b) in enumerate(layers):
            if i == len(layers) - 1:
                return x.float() @ w.to(torch.bfloat16).float() + b
            x = torch.relu(x @ w.to(torch.bfloat16) + b.to(torch.bfloat16))
    x = x.float()
    for i, (w, b) in enumerate(layers):
        x = _operand(x, precision) @ _operand(w, precision) + b.float()
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def layers_of(params: Dict[str, torch.Tensor],
              prefix: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (w, b) pairs ``prefix.w0``, ``prefix.b0``, ... in order."""
    out, i = [], 0
    while f"{prefix}.w{i}" in params:
        out.append((params[f"{prefix}.w{i}"], params[f"{prefix}.b{i}"]))
        i += 1
    return out


class TruncExp(torch.autograd.Function):
    """exp, its gradient taken at the input clamped to 15 (Instant-NGP)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def intrinsics(width: int, height: int, hfov: float) -> np.ndarray:
    focal = 0.5 * width / np.tan(hfov / 2.0)
    return np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def pose_matrix(pos, quat_xyzw) -> np.ndarray:
    """4x4 camera-to-world from a position and an xyzw quaternion."""
    x, y, z, w = [float(v) for v in quat_xyzw]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    T = np.eye(4)
    T[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    T[:3, 3] = np.asarray(pos, dtype=np.float64)
    return T


def rays_from_pixels(x, y, c2w, K) -> Tuple[torch.Tensor, torch.Tensor]:
    """OpenGL pinhole rays through pixel centres → (origins, unit dirs)."""
    dx = (x - K[0, 2] + 0.5) / K[0, 0]
    dy = -(y - K[1, 2] + 0.5) / K[1, 1]
    cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    d = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], cam)
    o = torch.broadcast_to(c2w[..., :3, 3], d.shape)
    return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def sh_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 terms) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


def aabb_intersect(o, d, aabb, near: float = 0.0, far: float = 1e10, miss: float = 1e10):
    """Slab test → (t_min, t_max) [R], clamped to [near, far]; misses get ``miss``."""
    inv = 1.0 / torch.where(d.abs() > 1e-10, d, torch.full_like(d, 1e-10))
    t0 = (aabb[:3] - o) * inv
    t1 = (aabb[3:] - o) * inv
    lo = torch.minimum(t0, t1).amax(dim=-1).clamp(near, far)
    hi = torch.maximum(t0, t1).amin(dim=-1).clamp(near, far)
    hit = lo < hi
    return (torch.where(hit, lo, torch.full_like(lo, miss)),
            torch.where(hit, hi, torch.full_like(hi, miss)))


def weights_from_density(t0, t1, sigmas) -> torch.Tensor:
    """w_i = T_i (1 - exp(-σ_i δ_i)), T_i = exp(-Σ_{j<i} σ_j δ_j)."""
    sd = sigmas * (t1 - t0)
    trans = torch.exp(-(torch.cumsum(sd, dim=-1) - sd))
    return trans * (1.0 - torch.exp(-sd))


def visibility_from_density(t0, t1, sigmas, alpha_thre, early_stop_eps: float = 1e-4):
    """A sample is kept iff its alpha clears the threshold and the
    transmittance over the earlier kept samples stays above the eps."""
    sd = sigmas * (t1 - t0)
    keep_alpha = (1.0 - torch.exp(-sd)) >= alpha_thre
    kept = torch.where(keep_alpha, sd, torch.zeros_like(sd))
    trans = torch.exp(-(torch.cumsum(kept, dim=-1) - kept))
    return keep_alpha & (trans > early_stop_eps)


def composite(w, t0, t1, rgbs, sems=None, bkgd=None) -> Dict[str, torch.Tensor]:
    """Colour, opacity, opacity-normalised depth, semantics per ray."""
    acc = w.sum(dim=-1, keepdim=True)
    rgb = torch.einsum("rs,rsc->rc", w, rgbs)
    depth = torch.einsum("rs,rs->r", w, 0.5 * (t0 + t1))[:, None]
    depth = depth / acc.clamp(min=torch.finfo(torch.float32).eps)
    out = {"rgb": rgb, "opacity": acc, "depth": depth}
    if sems is not None:
        out["sem"] = torch.einsum("rs,rsc->rc", w, sems)
    if bkgd is not None:
        out["rgb"] = out["rgb"] + bkgd * (1.0 - acc)
    return out


def variance(w, values, mean) -> torch.Tensor:
    """Σ_i w_i (v_i - mean)² per ray."""
    diff = values - mean[:, None, :]
    return torch.einsum("rs,rsc->rc", w, diff * diff)
