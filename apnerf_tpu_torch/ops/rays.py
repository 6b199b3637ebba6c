"""Ray generation from camera intrinsics and poses (OpenGL convention).

Port of ``apnerf_tpu/ops/rays.py``: pixel centers offset by +0.5, y
flipped, the camera looks down -z, directions rotated by the c2w rotation
and normalized, origins broadcast from the c2w translation. The host-side
numpy helpers (``make_intrinsics``, ``pose_matrix_from_quat``,
``quat_xyzw_from_matrix``) are the same functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Rays(NamedTuple):
    origins: torch.Tensor  # [..., 3]
    viewdirs: torch.Tensor  # [..., 3]


def make_intrinsics(width: int, height: int, hfov: float = np.pi / 2) -> np.ndarray:
    """Pinhole K from image size and horizontal FOV."""
    focal = 0.5 * width / np.tan(hfov / 2.0)
    return np.array(
        [
            [focal, 0.0, width / 2.0],
            [0.0, focal, height / 2.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def pixel_dirs(x: torch.Tensor, y: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[..., 3] un-normalized camera-frame directions for pixels (x, y)."""
    dx = (x - K[0, 2] + 0.5) / K[0, 0]
    dy = -(y - K[1, 2] + 0.5) / K[1, 1]
    return torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)


def rays_from_pixels(x, y, c2w: torch.Tensor, K: torch.Tensor) -> Rays:
    """Rays through pixels (x, y) of cameras c2w [..., 3|4, 4]."""
    cam_dirs = pixel_dirs(x, y, K)
    rot = c2w[..., :3, :3]
    directions = torch.einsum("...ij,...j->...i", rot, cam_dirs)
    origins = torch.broadcast_to(c2w[..., :3, 3], directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    return Rays(origins=origins, viewdirs=viewdirs)


def image_rays(c2w: torch.Tensor, K: torch.Tensor, width: int, height: int) -> Rays:
    """Full-image ray grid, flattened row-major to [height*width, 3]."""
    dev = c2w.device
    y, x = torch.meshgrid(
        torch.arange(height, device=dev, dtype=torch.float32),
        torch.arange(width, device=dev, dtype=torch.float32),
        indexing="ij",
    )
    return rays_from_pixels(x.reshape(-1), y.reshape(-1), c2w, K)


def subsampled_image_rays(
    c2w: torch.Tensor, K: torch.Tensor, width: int, height: int, scale: float
) -> Rays:
    """Evenly subsampled image rays: the reference's
    ``np.linspace(0, n-1, out_h*out_w).round()`` flat-index subsampling."""
    out_h, out_w = int(height * scale), int(width * scale)
    idx = np.round(np.linspace(0, height * width - 1, out_h * out_w)).astype(np.int64)
    idx = torch.as_tensor(idx, device=c2w.device)
    rays = image_rays(c2w, K, width, height)
    return Rays(origins=rays.origins[idx], viewdirs=rays.viewdirs[idx])


def pose_matrix_from_quat(pos: np.ndarray, quat_xyzw: np.ndarray) -> np.ndarray:
    """4x4 c2w from a position and an xyzw quaternion (host numpy)."""
    x, y, z, w = [float(v) for v in quat_xyzw]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(pos, dtype=np.float64)
    return T


def quat_xyzw_from_matrix(R: np.ndarray) -> np.ndarray:
    """xyzw quaternion from a 3x3 rotation (inverse of
    ``pose_matrix_from_quat``; Shepperd's method, numerically stable for
    every sign pattern of the diagonal). Host-side numpy helper used by
    the replay simulator to express recorded c2w matrices in the facade's
    pose7 convention (``simulator/sim.py:145-151`` carries xyzw quats)."""
    R = np.asarray(R, dtype=np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float64)
    return q / np.linalg.norm(q)
