"""The benchmark's scene: a room of axis-aligned boxes, ray-cast on the
device.

The room is FakeSim's ``default_room`` (the port's ``sim/fake.py``): floor,
ceiling and four walls of 0.2 m, and four furniture boxes placed by a
numpy generator seeded with 3, each with its own class. A pose renders
RGBA (uint8, flat colours shaded by 1 / (1 + 0.08 t)), the Euclidean
depth and the class of the nearest box, in float64 as FakeSim renders
them on the host. ``Room`` answers ``sample_images_from_poses`` as a
simulator does, and keeps every pose it was asked for.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..reference.common import intrinsics, pose_matrix


def default_room(aabb=(-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)):
    """[(min corner, max corner, colour, class)] of the room's boxes."""
    x0, y0, z0, x1, y1, z1 = aabb
    t = 0.2
    boxes = [
        ([x0, y0 - t, z0], [x1, y0, z1], [0.6, 0.6, 0.6], 1),
        ([x0, y1, z0], [x1, y1 + t, z1], [0.9, 0.9, 0.9], 2),
        ([x0 - t, y0, z0], [x0, y1, z1], [0.7, 0.5, 0.4], 3),
        ([x1, y0, z0], [x1 + t, y1, z1], [0.4, 0.5, 0.7], 3),
        ([x0, y0, z0 - t], [x1, y1, z0], [0.5, 0.7, 0.4], 3),
        ([x0, y0, z1], [x1, y1, z1 + t], [0.7, 0.7, 0.3], 3),
    ]
    rng = np.random.RandomState(3)
    cx, cz = (x0 + x1) / 2, (z0 + z1) / 2
    sx, sz = x1 - x0, z1 - z0
    for i in range(4):
        bx = x0 + (0.15 + 0.7 * rng.rand()) * sx
        bz = z0 + (0.15 + 0.7 * rng.rand()) * sz
        if abs(bx - cx) < sx * 0.15 and abs(bz - cz) < sz * 0.15:
            bx += sx * 0.2
        w, d, h = 0.3 + 0.5 * rng.rand(), 0.3 + 0.5 * rng.rand(), 0.4 + 0.9 * rng.rand()
        boxes.append(([bx - w / 2, y0, bz - d / 2], [bx + w / 2, y0 + h, bz + d / 2],
                      list(rng.rand(3) * 0.7 + 0.2), 4 + i))
    return boxes


class Room:
    """Renders the room on ``device`` at ``img_w`` x ``img_h`` and ``hfov``."""

    def __init__(self, aabb, img_w: int, img_h: int, hfov: float, device,
                 bkgd=(1.0, 1.0, 1.0)):
        self.img_w, self.img_h = img_w, img_h
        self.device = torch.device(device)
        self.K = intrinsics(img_w, img_h, hfov)
        boxes = default_room(tuple(aabb))
        f64 = dict(dtype=torch.float64, device=self.device)
        self.mns = torch.tensor([b[0] for b in boxes], **f64)
        self.mxs = torch.tensor([b[1] for b in boxes], **f64)
        self.colors = torch.tensor([b[2] for b in boxes], **f64)
        self.sems = torch.tensor([b[3] for b in boxes], dtype=torch.int32, device=self.device)
        self.bkgd = torch.tensor(bkgd, **f64)
        self.poses: List[np.ndarray] = []
        K = self.K.astype(np.float64)
        x, y = np.meshgrid(np.arange(img_w), np.arange(img_h), indexing="xy")
        dx = (x - K[0, 2] + 0.5) / K[0, 0]
        dy = -(y - K[1, 2] + 0.5) / K[1, 1]
        self._cam = torch.as_tensor(
            np.stack([dx, dy, -np.ones_like(dx)], axis=-1).reshape(-1, 3), **f64)

    def render(self, pose7) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (rgba [H, W, 4] uint8, depth [H, W] float32, class [H, W] int32), on the device."""
        c2w = torch.as_tensor(pose_matrix(pose7[:3], pose7[3:]), dtype=torch.float64,
                              device=self.device)
        R = c2w[:3, :3]
        cam = self._cam
        # the rotation as three products and two sums per component, in
        # the order a 3 x 3 product takes them
        dirs = torch.stack([cam[:, 0] * R[j, 0] + cam[:, 1] * R[j, 1] + cam[:, 2] * R[j, 2]
                            for j in range(3)], dim=-1)
        dirs = dirs / torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
        o = c2w[:3, 3]
        inv = 1.0 / torch.where(dirs.abs() > 1e-12, dirs, torch.full_like(dirs, 1e-12))
        t0 = (self.mns - o)[:, None, :] * inv[None]
        t1 = (self.mxs - o)[:, None, :] * inv[None]
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        valid = tmax > torch.clamp(tmin, min=1e-4)
        entry = torch.where(tmin > 1e-4, tmin, tmax)
        entry = torch.where(valid, entry, torch.full_like(entry, float("inf")))
        best_t, best = entry.min(dim=0)
        miss = torch.isinf(best_t)
        best = torch.where(miss, torch.zeros_like(best), best)
        rgb = torch.where(miss[:, None], self.bkgd, self.colors[best])
        t = torch.where(miss, torch.zeros_like(best_t), best_t)
        rgb = rgb * (1.0 / (1.0 + 0.08 * t))[:, None]
        sem = torch.where(miss, torch.zeros_like(self.sems[best]), self.sems[best])
        rgb8 = torch.clamp(rgb * 255, 0, 255).to(torch.uint8)
        H, W = self.img_h, self.img_w
        rgba = torch.cat([rgb8, torch.full_like(rgb8[:, :1], 255)], dim=-1)
        return rgba.reshape(H, W, 4), t.to(torch.float32).reshape(H, W), sem.reshape(H, W)

    def sample_images_from_poses(self, poses: Sequence):
        """The simulator's facade: host arrays [N, H, W, 4], [N, H, W], [N, H, W]."""
        outs = [self.render(np.asarray(p, dtype=np.float64)) for p in poses]
        self.poses.extend(np.asarray(p, dtype=np.float64) for p in poses)
        return tuple(torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(3))
