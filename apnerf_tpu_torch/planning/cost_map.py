"""Depth → 2D occupancy/cost maps (host-side numpy).

Capability parity with the reference's LiDAR-style depth scan mapping
(``perception/data_proc/depth_to_grid.py`` and ``update_cost_map`` at
``planning/planning_funcs.py:192-219``): the middle row of a depth image is
treated as a planar scan; rays from the camera cell to each endpoint mark
free cells (0) and the endpoints (plus a 2x2 footprint) mark occupied (1);
unknown stays 0.5.

Implementation is our own: Bresenham as an integer error-accumulator
(same output contract as ``depth_to_grid.py:31-73``), with free-cell
marking batched per scan. A flood-fill alternative matches
``depth_to_grid.py:83-139``.
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np


def bresenham(start: Tuple[int, int], end: Tuple[int, int]) -> np.ndarray:
    """Integer grid cells on the line start→end, inclusive. Same contract
    as ``depth_to_grid.py:31-73``."""
    x1, y1 = int(start[0]), int(start[1])
    x2, y2 = int(end[0]), int(end[1])
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dy) > abs(dx)
    if steep:
        x1, y1, x2, y2 = y1, x1, y2, x2
    swapped = x1 > x2
    if swapped:
        x1, x2 = x2, x1
        y1, y2 = y2, y1
    dx, dy = x2 - x1, y2 - y1
    n = dx + 1
    xs = np.arange(x1, x2 + 1)
    step = 1 if y1 < y2 else -1
    # integer error accumulation reproduces the classic stepping
    ys = y1 + step * ((np.arange(n) * abs(dy) + dx // 2) // max(dx, 1))
    pts = np.stack([ys, xs], axis=1) if steep else np.stack([xs, ys], axis=1)
    if swapped:
        pts = pts[::-1]
    return pts


def generate_ray_casting_grid_map(
    ox: np.ndarray,
    oy: np.ndarray,
    x_w: int,
    y_w: int,
    loc_x: int,
    loc_y: int,
    aabb: np.ndarray,
    xy_resolution: float,
) -> np.ndarray:
    """Occupancy map (0 free / 1 occupied / 0.5 unknown) from scan
    endpoints (``depth_to_grid.py:142-197``). Note the reference's axis
    convention: map x ← world z (aabb[2], aabb[5]), map y ← world x."""
    min_x, min_y = aabb[2], aabb[0]
    occupancy = np.full((x_w, y_w), 0.5)
    for x, y in zip(ox, oy):
        ix = int(round((x - min_x) / xy_resolution))
        iy = int(round((y - min_y) / xy_resolution))
        beam = bresenham((int(loc_x), int(loc_y)), (ix, iy))
        valid = (
            (beam[:, 0] >= 0)
            & (beam[:, 0] < x_w)
            & (beam[:, 1] >= 0)
            & (beam[:, 1] < y_w)
        )
        b = beam[valid]
        occupancy[b[:, 0], b[:, 1]] = 0.0
        for dx_ in (0, 1):
            for dy_ in (0, 1):
                if 0 <= ix + dx_ < x_w and 0 <= iy + dy_ < y_w:
                    occupancy[ix + dx_, iy + dy_] = 1.0
    return occupancy


def flood_fill_free(center: Tuple[int, int], occupancy: np.ndarray) -> None:
    """In-place flood fill of unknown (0.5) cells reachable from center
    (``depth_to_grid.py:108-139``)."""
    sx, sy = occupancy.shape
    fringe = deque([center])
    if occupancy[center] == 0.5:
        occupancy[center] = 0.0
    while fringe:
        nx, ny = fringe.pop()
        for dx_, dy_ in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            x, y = nx + dx_, ny + dy_
            if 0 <= x < sx and 0 <= y < sy and occupancy[x, y] == 0.5:
                occupancy[x, y] = 0.0
                fringe.appendleft((x, y))


def depth_scan_angles(width: int = 640) -> np.ndarray:
    """The reference's yaw-aligned per-column scan angles
    (``scripts/pipeline.py:229-233``): atan of pixel offsets over half-width,
    right half reversed then left half."""
    half = width // 2
    r = np.arctan(np.linspace(0.5, half - 0.5, half) / half)[::-1]
    l = np.arctan(-np.linspace(0.5, half - 0.5, half) / half)
    return np.concatenate([r, l])


def update_cost_map(
    cost_map: np.ndarray,
    depth: np.ndarray,
    angle: np.ndarray,
    g_loc: np.ndarray,
    w_loc: np.ndarray,
    aabb: np.ndarray,
    resolution: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse one depth scan into the 2D cost map
    (``planning_funcs.py:192-219``). Returns (cost_map, visiting_map):
    cost 1 = occupied, 0 = seen-free, 0.5 = unknown; visiting_map counts
    cells newly observed free this scan."""
    ox = np.sin(-angle) * depth + w_loc[0]
    oy = -np.cos(-angle) * depth + w_loc[2]
    occupancy = generate_ray_casting_grid_map(
        ox, oy, cost_map.shape[0], cost_map.shape[1], g_loc[0], g_loc[2],
        aabb, resolution,
    )
    cost_map = np.array(cost_map)
    cost_map[occupancy > 0.9] = 1
    cost_map[occupancy < 0.1] = 0
    visiting_map = np.zeros(cost_map.shape)
    visiting_map[occupancy < 0.1] = 1
    return cost_map, visiting_map
