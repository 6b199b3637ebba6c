"""Offline semantic-detection evaluation of saved trajectories.

Capability parity with ``scripts/eval/eval_pipeline_offline.py:18-160``
(repaired — the reference's ``occupancy_grid`` import is missing from its
snapshot): replay a ``data0.npz`` trajectory, insert per-class masked
depth into 28 semantic voxel grids every 30 frames after frame 39, DBSCAN
the point clouds into detections, match against GT object locations, and
emit the detected-count-vs-step curve (monotonic cummax + leading 0, as
the reference post-processes).

Port of ``apnerf_tpu/eval/offline_eval.py``: the same host-only numpy code.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .frontier import detect_objects, insert_semantic_views
from .voxel_grid import VoxelGrid


def _pose7_from_matrix(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [
                (R[2, 1] - R[1, 2]) / s,
                (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s,
                0.25 * s,
            ]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    return np.concatenate([T[:3, 3], q / np.linalg.norm(q)])


def run_eval(
    npz_path: str,
    gt_obj_locs: Dict[int, list],
    num_classes: int = 28,
    num_steps: int = 20,
    warmup_frames: int = 39,
    frames_per_step: int = 30,
    det_dist_thresh: float = 1.0,
    max_depth: float = 10.0,
) -> np.ndarray:
    """→ monotone detected-object-count curve, length ≤ num_steps + 1
    (leading 0)."""
    data = np.load(npz_path, allow_pickle=True)
    depths = data["depths"]
    semantics = data["semantics"]
    cam_poses = data["camtoworlds"]

    sem_grids = [
        VoxelGrid(500, 0.1, occupancy=False, max_depth=max_depth)
        for _ in range(num_classes)
    ]
    det_per_step: List[List[int]] = []
    steps = 0
    for it, (depth, sem, pose_mat) in enumerate(
        zip(depths, semantics, cam_poses)
    ):
        if it > warmup_frames and (it - warmup_frames) % frames_per_step == 0:
            det_per_step.append(
                detect_objects(sem_grids, gt_obj_locs, det_dist_thresh)
            )
            steps += 1
        if steps == num_steps:
            break
        pose7 = _pose7_from_matrix(pose_mat)
        insert_semantic_views(sem_grids, depth, sem, pose7)

    totals = [sum(row) for row in det_per_step]
    for i in range(len(totals) - 1):
        totals[i + 1] = max(totals[i], totals[i + 1])
    return np.insert(np.asarray(totals), 0, 0)
