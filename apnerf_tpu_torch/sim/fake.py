"""FakeSim, the analytic box-world simulator: its rendering part.

Port of ``apnerf_tpu/sim/fake.py`` (``Box``, ``default_room`` and
``FakeSim``'s ``__init__``, ``_pixel_rays``, ``render_pose`` and
``sample_images_from_poses``, ``:29-243``), numpy on the host as there,
on the port's ``ops/rays.py`` helpers: the JAX module imports JAX
through its own ``ops/rays.py``, and the GPU host has no JAX. It renders
RGB, depth (Euclidean ray length) and semantic images of a room of
boxes, pixel for pixel as the JAX module does. Navigation, path sampling
and the chase-camera views come with the mapper loop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.rays import make_intrinsics, pose_matrix_from_quat


class Box:
    def __init__(self, mn, mx, color, sem, tex_freq: float = 0.0):
        self.mn = np.asarray(mn, dtype=np.float64)
        self.mx = np.asarray(mx, dtype=np.float64)
        self.color = np.asarray(color, dtype=np.float64)
        self.sem = int(sem)
        # checkerboard texture frequency (cells/meter); 0 = flat color
        self.tex_freq = float(tex_freq)


def default_room(aabb=(-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)) -> List[Box]:
    """A room: floor/ceiling/4 walls + furniture boxes with distinct
    semantic classes (0 = void/background)."""
    x0, y0, z0, x1, y1, z1 = aabb
    t = 0.2  # wall thickness
    boxes = [
        Box([x0, y0 - t, z0], [x1, y0, z1], [0.6, 0.6, 0.6], 1),  # floor
        Box([x0, y1, z0], [x1, y1 + t, z1], [0.9, 0.9, 0.9], 2),  # ceiling
        Box([x0 - t, y0, z0], [x0, y1, z1], [0.7, 0.5, 0.4], 3),  # wall -x
        Box([x1, y0, z0], [x1 + t, y1, z1], [0.4, 0.5, 0.7], 3),  # wall +x
        Box([x0, y0, z0 - t], [x1, y1, z0], [0.5, 0.7, 0.4], 3),  # wall -z
        Box([x0, y0, z1], [x1, y1, z1 + t], [0.7, 0.7, 0.3], 3),  # wall +z
    ]
    rng = np.random.RandomState(3)
    cx, cz = (x0 + x1) / 2, (z0 + z1) / 2
    span_x, span_z = (x1 - x0), (z1 - z0)
    for i in range(4):
        bx = x0 + (0.15 + 0.7 * rng.rand()) * span_x
        bz = z0 + (0.15 + 0.7 * rng.rand()) * span_z
        # keep the room center clear for flying
        if abs(bx - cx) < span_x * 0.15 and abs(bz - cz) < span_z * 0.15:
            bx += span_x * 0.2
        w, d, h = (
            0.3 + 0.5 * rng.rand(),
            0.3 + 0.5 * rng.rand(),
            0.4 + 0.9 * rng.rand(),
        )
        boxes.append(
            Box(
                [bx - w / 2, y0, bz - d / 2],
                [bx + w / 2, y0 + h, bz + d / 2],
                rng.rand(3) * 0.7 + 0.2,
                4 + i,
            )
        )
    return boxes


class FakeSim:
    """Analytic simulator: the image-rendering part of the HabitatSim
    facade."""

    def __init__(
        self,
        aabb=(-8.0, 0.0, -8.0, 0.0, 3.0, 0.0),
        img_w: int = 64,
        img_h: int = 64,
        hfov: float = np.pi / 2,
        boxes: Optional[List[Box]] = None,
        bkgd_color=(1.0, 1.0, 1.0),
    ):
        self.aabb = np.asarray(aabb, dtype=np.float64)
        self.img_w, self.img_h = img_w, img_h
        self.K = make_intrinsics(img_w, img_h, hfov)
        self.boxes = boxes if boxes is not None else default_room(aabb)
        self.bkgd = np.asarray(bkgd_color)
        self.num_semantic_classes = max(b.sem for b in self.boxes) + 1
        # box-stacked constants for the vectorized caster
        self._mns = np.stack([b.mn for b in self.boxes])  # [B, 3]
        self._mxs = np.stack([b.mx for b in self.boxes])  # [B, 3]
        self._colors = np.stack([b.color for b in self.boxes])  # [B, 3]
        self._sems = np.array([b.sem for b in self.boxes], dtype=np.int32)
        self._tex = np.array([b.tex_freq for b in self.boxes])

    # ---- core ray casting ----

    def _pixel_rays(self, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        W, H, K = self.img_w, self.img_h, self.K
        x, y = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
        dx = (x - K[0, 2] + 0.5) / K[0, 0]
        dy = -(y - K[1, 2] + 0.5) / K[1, 1]
        dirs = np.stack([dx, dy, -np.ones_like(dx)], axis=-1).reshape(-1, 3)
        dirs = dirs @ c2w[:3, :3].T
        norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
        return np.broadcast_to(c2w[:3, 3], dirs.shape), dirs / norm

    def render_pose(self, pose7: np.ndarray):
        """→ (rgb [H,W,4] uint8, depth [H,W] f32, sem [H,W] int32).

        Box-stacked, pixel-chunked slab test. Bit-identical to the
        original per-box sequential update (tested): origins are constant
        per frame so ``(box.mn - origins) * inv == (box.mn - o) * inv``
        exactly, and the sequential rule "strictly closer box wins, first
        box wins ties" is exactly ``argmin`` over the box axis (first
        minimal index)."""
        c2w = pose_matrix_from_quat(pose7[:3], pose7[3:])
        origins, dirs = self._pixel_rays(c2w)
        n = origins.shape[0]
        o = c2w[:3, 3].astype(np.float64)  # == every row of `origins`
        c0 = self._mns - o  # [B, 3]
        c1 = self._mxs - o  # [B, 3]
        best_t = np.empty(n)
        best_box = np.empty(n, dtype=np.int32)
        inv = 1.0 / np.where(np.abs(dirs) > 1e-12, dirs, 1e-12)
        chunk = 1 << 16  # bounds the [B, chunk, 3] temporaries
        for s in range(0, n, chunk):
            inv_c = inv[s:s + chunk]  # [n_c, 3]
            t0 = c0[:, None, :] * inv_c[None, :, :]  # [B, n_c, 3]
            t1 = c1[:, None, :] * inv_c[None, :, :]
            tmin = np.max(np.minimum(t0, t1), axis=-1)  # [B, n_c]
            tmax = np.min(np.maximum(t0, t1), axis=-1)
            valid = tmax > np.maximum(tmin, 1e-4)
            t_entry = np.where(tmin > 1e-4, tmin, tmax)  # inside-box: exit
            t_entry = np.where(valid, t_entry, np.inf)
            bb = np.argmin(t_entry, axis=0).astype(np.int32)  # first min
            bt = t_entry[bb, np.arange(bb.shape[0])]
            best_box[s:s + chunk] = np.where(np.isinf(bt), -1, bb)
            best_t[s:s + chunk] = bt
        best_t = np.where(best_box < 0, np.inf, best_t)

        miss = best_box < 0
        colors = self._colors
        sems = self._sems
        rgb = np.where(miss[:, None], self.bkgd, colors[best_box])
        tex_freqs = self._tex
        if np.any(tex_freqs > 0):
            # view-consistent 3D checkerboard on the hit point (hard_room
            # scenes): exact, deterministic high-frequency detail
            hit = origins + np.where(miss, 0.0, best_t)[:, None] * dirs
            f = np.where(miss, 0.0, tex_freqs[best_box])
            cells = np.floor(hit * f[:, None]).sum(axis=-1)
            checker = np.where(f > 0, cells % 2.0, 0.5)
            # 0.55/1.0 modulation keeps rgb <= 1 (no uint8 clipping)
            rgb = rgb * (0.55 + 0.45 * checker)[:, None]
        # simple distance shading so the NeRF has view-consistent structure
        shade = 1.0 / (1.0 + 0.08 * np.where(miss, 0.0, best_t))
        rgb = rgb * shade[:, None]
        sem = np.where(miss, 0, sems[best_box]).astype(np.int32)
        depth = np.where(miss, 0.0, best_t).astype(np.float32)
        H, W = self.img_h, self.img_w
        rgba = np.concatenate(
            [
                np.clip(rgb * 255, 0, 255).astype(np.uint8),
                np.full((n, 1), 255, dtype=np.uint8),
            ],
            axis=-1,
        )
        return (
            rgba.reshape(H, W, 4),
            depth.reshape(H, W),
            sem.reshape(H, W),
        )

    def sample_images_from_poses(self, poses):
        rgbs, depths, sems = [], [], []
        for p in poses:
            r, d, s = self.render_pose(np.asarray(p, dtype=np.float64))
            rgbs.append(r)
            depths.append(d)
            sems.append(s)
        return np.array(rgbs), np.array(depths), np.array(sems)
