"""Frontier-exploration baseline policy.

Capability parity with ``scripts/eval/frontier_baseline.py:40-319`` (the
classical comparison policy for the active-perception paper), repaired:
the reference imports missing modules (``occupancy_grid``, ``bresenhan``)
and calls a nonexistent ``sim.sample_path_2p`` — here the dependencies
exist (``eval/voxel_grid.py``) and the path comes from the simulator
facade's ``sample_path``/straight-line fallback.

Works against any Simulator (FakeSim in tests, HabitatSim in production).

Port of ``apnerf_tpu/eval/frontier.py``: the same host-only numpy code.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional

import numpy as np

from .voxel_grid import VoxelGrid


def find_frontiers(grid: np.ndarray) -> np.ndarray:
    """Free cells adjacent to unknown cells (``frontier_baseline.py:52-67``),
    vectorized."""
    free = grid == 0
    unknown = grid == -1
    near_unknown = np.zeros_like(free)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = np.zeros_like(unknown)
            xs = slice(max(dx, 0), grid.shape[0] + min(dx, 0))
            xd = slice(max(-dx, 0), grid.shape[0] + min(-dx, 0))
            ys = slice(max(dy, 0), grid.shape[1] + min(dy, 0))
            yd = slice(max(-dy, 0), grid.shape[1] + min(-dy, 0))
            shifted[xd, yd] = unknown[xs, ys]
            near_unknown |= shifted
    return np.argwhere(free & near_unknown)


# the 6 in-place scan rotations (frontier_baseline.py:129-134)
SCAN_ROTATIONS = np.array(
    [
        [0, 0, 0, 1],
        [0, 0.5, 0, 0.866],
        [0, 0.866, 0, 0.5],
        [0, 1, 0, 0],
        [0, 0.866, 0, -0.5],
        [0, 0.5, 0, -0.866],
    ]
)


def cluster_points(points: np.ndarray, eps: float, min_samples: int):
    """DBSCAN cluster centroids (used for both frontiers and semantic
    object detection)."""
    if len(points) == 0:
        return []
    from sklearn.cluster import DBSCAN

    labels = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(points)
    cents = []
    for lab in np.unique(labels):
        if lab == -1:
            continue
        cents.append(points[labels == lab].mean(axis=0))
    return cents


def detect_objects(
    sem_grids: List[VoxelGrid],
    gt_obj_locs: Dict[int, list],
    det_dist_thresh: float = 0.5,
    cluster_eps: float = 0.2,
) -> List[int]:
    """Per-class detected-object counts: DBSCAN the semantic point clouds,
    greedily match centroids to GT locations within the threshold
    (``frontier_baseline.py:225-272`` / ``eval_pipeline_offline.py:18-71``)."""
    sem_objs = []
    for g in sem_grids:
        if not g.initialized:
            sem_objs.append([])
            continue
        sem_objs.append(
            cluster_points(g.get_pointcloud(), cluster_eps, 1)
        )
    counts = []
    gt_cnt = copy.deepcopy(gt_obj_locs)
    for i, dets in enumerate(sem_objs):
        n = 0
        for d in dets:
            best, best_dist = -1, 10.0
            for k, loc in enumerate(gt_cnt.get(i, [])):
                dist = np.linalg.norm(np.asarray(loc) - d)
                if dist < det_dist_thresh and dist < best_dist:
                    best, best_dist = k, dist
            if best >= 0:
                gt_cnt[i].pop(best)
                n += 1
        counts.append(n)
    return counts


def insert_semantic_views(
    sem_grids: List[VoxelGrid],
    depth: np.ndarray,
    sem: np.ndarray,
    pose7: np.ndarray,
):
    """Per-class depth masking + insertion (``frontier_baseline.py:172-184``:
    class s occupies semantic id s+1)."""
    for s, grid in enumerate(sem_grids):
        masked = depth.astype(np.float64).copy()
        masked[sem != s + 1] = np.nan
        grid.insert_depth_image(masked, pose7)


def load_gt_objects(path: str, num_classes: int):
    """GT object locations per class from ``objects_<scene>.json``
    (``frontier_baseline.py:84-93``)."""
    gt = json.load(open(path))
    locs = {i: [] for i in range(num_classes)}
    nums = {i: 0 for i in range(num_classes)}
    for _tid, obj in gt.items():
        nums[obj["label"]] += 1
        locs[obj["label"]].append(obj["location"])
    return locs, nums


def frontier_exploration(
    sim,
    start_pose: np.ndarray,
    num_steps: int = 20,
    num_classes: int = 28,
    gt_obj_locs: Optional[Dict] = None,
    grid_size: float = 100,
    grid_resolution: float = 0.5,
    det_dist_thresh: float = 0.5,
    max_depth: float = 10.0,
):
    """Run the frontier baseline → (detection counts per step, occ grid).

    Per step: scan 6 rotations at the pose, insert into occupancy +
    semantic grids, find frontier clusters, go to the nearest unvisited
    one (``frontier_baseline.py:156-224``).
    """
    occ_grid = VoxelGrid(grid_size, grid_resolution, occupancy=True,
                         max_depth=max_depth)
    sem_grids = [
        VoxelGrid(500, 0.1, occupancy=False, max_depth=max_depth)
        for _ in range(num_classes)
    ]
    det_per_step = []
    visited = []
    pose = np.asarray(start_pose, dtype=np.float64)
    if pose.shape[0] == 3:
        pose = np.concatenate([pose, [0, 0, 0, 1.0]])

    for _step in range(num_steps):
        for rot in SCAN_ROTATIONS:
            p = np.concatenate([pose[:3], rot])
            _rgbs, depths, sems = sim.sample_images_from_poses([p])
            occ_grid.insert_depth_image(depths[0], p)
            insert_semantic_views(sem_grids, depths[0], sems[0], p)

        if gt_obj_locs is not None:
            det_per_step.append(
                detect_objects(sem_grids, gt_obj_locs, det_dist_thresh)
            )

        grid2d = occ_grid.get_occupancy_grid()
        frontiers = find_frontiers(grid2d)
        if len(frontiers) == 0:
            break
        cents = cluster_points(frontiers.astype(float), eps=1.0,
                               min_samples=3)
        cur_idx = np.array(
            [
                (pose[0] + grid_size / 2) / grid_resolution,
                (pose[2] + grid_size / 2) / grid_resolution,
            ]
        )
        goals = []
        for c in cents:
            key = [round(c[0], 1), round(c[1], 1)]
            if key in visited:
                continue
            goals.append((np.linalg.norm(c - cur_idx), c, key))
        if not goals:
            break
        goals.sort(key=lambda g: g[0])
        _, c, key = goals[0]
        visited.append(key)
        pose = np.array(
            [
                c[0] * grid_resolution - grid_size / 2,
                pose[1],
                c[1] * grid_resolution - grid_size / 2,
                0, 0, 0, 1.0,
            ]
        )
    return det_per_step, occ_grid
