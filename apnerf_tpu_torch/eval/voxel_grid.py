"""Sparse voxel grid for evaluation (occupancy + semantic point clouds).

The reference's eval scripts import ``occupancy_grid.VoxelGrid`` and
``bresenhan.bresenhamline`` from ``simulator/`` — modules missing from the
shipped snapshot (``scripts/eval/frontier_baseline.py:17-18``; SURVEY.md
§2.1 rows 10-11 "broken-as-shipped"). This is the reconstruction, with the
API those scripts expect:

  * ``VoxelGrid(grid_size, grid_resolution, occupancy)`` — world span
    [-grid_size/2, +grid_size/2] m per axis at ``grid_resolution`` m/cell.
  * ``insert_depth_image(depth [H, W] (NaN = ignore), pose7)`` → bool:
    unproject through the pinhole intrinsics (hfov = pi/2), transform by
    the camera pose, mark hit voxels occupied; in occupancy mode also
    carve the free-space voxels along each ray (3D DDA).
  * ``get_occupancy_grid()`` → 2D top-down [N, N] with 0 = free,
    1 = occupied, -1 = unknown (the convention ``find_frontiers`` checks).
  * ``get_pointcloud()`` → [N, 3] occupied-voxel centers (world).
  * ``initialized`` — True after the first successful insertion.

Storage is sparse (hash sets) — semantic grids are 500 m / 0.1 m ⇒ 5000³
cells, far beyond dense storage.

Port of ``apnerf_tpu/eval/voxel_grid.py``: the same host-only numpy code.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np


def bresenhamline(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """nD integer line voxels from each start to its end (excluding the
    start cell), concatenated. Vectorized DDA — the missing ``bresenhan``
    module's contract."""
    starts = np.atleast_2d(starts).astype(np.int64)
    ends = np.atleast_2d(ends).astype(np.int64)
    out = []
    for s, e in zip(starts, ends):
        delta = e - s
        n = int(np.max(np.abs(delta)))
        if n == 0:
            continue
        t = np.arange(1, n + 1)[:, None] / n
        pts = np.rint(s[None, :] + t * delta[None, :]).astype(np.int64)
        out.append(pts)
    if not out:
        return np.zeros((0, starts.shape[1]), dtype=np.int64)
    return np.concatenate(out, axis=0)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class VoxelGrid:
    def __init__(self, grid_size: float = 100, grid_resolution: float = 0.5,
                 occupancy: bool = True, hfov: float = np.pi / 2,
                 max_depth: float = 10.0, stride: int = 4):
        self.grid_size = grid_size
        self.res = grid_resolution
        self.occupancy = occupancy
        self.hfov = hfov
        self.max_depth = max_depth
        self.stride = stride  # pixel subsampling for insertion speed
        self.n_cells = int(round(grid_size / grid_resolution))
        self.occupied: Set[Tuple[int, int, int]] = set()
        self.free: Set[Tuple[int, int, int]] = set()
        self.initialized = False

    # world (x, y, z) → voxel index
    def _to_voxel(self, pts: np.ndarray) -> np.ndarray:
        return np.floor(
            (pts + self.grid_size / 2.0) / self.res
        ).astype(np.int64)

    def _voxel_center(self, idx: np.ndarray) -> np.ndarray:
        return (idx + 0.5) * self.res - self.grid_size / 2.0

    def insert_depth_image(self, depth: np.ndarray, pose7: np.ndarray) -> bool:
        """Unproject a depth image (NaN pixels skipped) at camera pose7
        (x, y, z, qx, qy, qz, qw; OpenGL camera, -z forward)."""
        depth = np.asarray(depth, dtype=np.float64)
        H, W = depth.shape
        focal = 0.5 * W / np.tan(self.hfov / 2.0)
        s = self.stride
        ys, xs = np.mgrid[0:H:s, 0:W:s]
        d = depth[ys, xs]
        ok = np.isfinite(d) & (d > 1e-3) & (d < self.max_depth)
        if not ok.any():
            return False
        xs, ys, d = xs[ok], ys[ok], d[ok]
        # camera-frame directions (OpenGL, matches ops/rays.py)
        dx = (xs - W / 2.0 + 0.5) / focal
        dy = -(ys - H / 2.0 + 0.5) / focal
        dirs = np.stack([dx, dy, -np.ones_like(dx)], axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        R = _quat_to_matrix(np.asarray(pose7[3:7], dtype=np.float64))
        origin = np.asarray(pose7[:3], dtype=np.float64)
        pts = origin + (dirs @ R.T) * d[:, None]

        vox = self._to_voxel(pts)
        in_grid = np.all((vox >= 0) & (vox < self.n_cells), axis=1)
        vox = vox[in_grid]
        if len(vox) == 0:
            return False
        self.occupied.update(map(tuple, vox))
        if self.occupancy:
            start = self._to_voxel(origin[None, :])[0]
            # carve free space along (subsampled) rays
            carve = vox[:: max(len(vox) // 256, 1)]
            line = bresenhamline(
                np.tile(start, (len(carve), 1)), carve
            )
            for v in map(tuple, line):
                if v not in self.occupied:
                    self.free.add(v)
        self.initialized = True
        return True

    def get_pointcloud(self) -> np.ndarray:
        if not self.occupied:
            return np.zeros((0, 3))
        idx = np.array(sorted(self.occupied))
        return self._voxel_center(idx)

    def get_occupancy_grid(self) -> np.ndarray:
        """Top-down 2D projection over (x, z): 1 occupied, 0 free,
        -1 unknown."""
        grid = -np.ones((self.n_cells, self.n_cells), dtype=np.int8)
        for (x, _, z) in self.free:
            if 0 <= x < self.n_cells and 0 <= z < self.n_cells:
                grid[x, z] = 0
        for (x, _, z) in self.occupied:
            if 0 <= x < self.n_cells and 0 <= z < self.n_cells:
                grid[x, z] = 1
        return grid
