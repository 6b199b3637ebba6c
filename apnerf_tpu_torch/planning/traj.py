"""Trajectory sampling from the NeRF ensemble's occupancy grids.

Capability parity with ``planning/planning_funcs.py:54-399``:

  * ``sample_traj``: merge the z=8 slice of both ensemble binary grids into
    a 2D obstacle map, dilate with a 3x3 kernel, clear the cells around the
    current pose, sample visit-weighted free goals, Dijkstra a path,
    fit MinSnap (v_avg 0.5), roll out ``SE3Control.update_ref`` at >= 20 Hz,
    convert rotorpy's xzy frame back to habitat xyz with the rotvec
    component remap, and append a 20-pose 360-degree terminal spin.
  * ``get_voxels_between_points`` / ``collision_checker``: Amanatides-Woo
    3D voxel traversal between two points.
  * ``sample_waypoints_from_free_space``, ``world2voxels``/``voxels2world``.

All host-side numpy; the TPU is busy rendering candidate views while this
runs.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .dijkstra import Dijkstra
from .minsnap import MinSnap
from .se3_control import SE3Control


def world2voxels(x: np.ndarray, voxel_grid_size: float = 0.1) -> np.ndarray:
    return np.array(np.asarray(x) // voxel_grid_size, dtype=int)


def voxels2world(idx: np.ndarray, voxel_grid_size: float = 0.1) -> np.ndarray:
    return np.asarray(idx) * voxel_grid_size


def _rotvec_to_quat(rv: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(rv)
    if angle < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = rv / angle
    s = np.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2)])


def _quat_to_rotvec(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q)
    w = np.clip(q[3], -1.0, 1.0)
    angle = 2 * np.arccos(w)
    s = np.sqrt(max(1 - w * w, 0.0))
    if s < 1e-12:
        return np.zeros(3)
    if angle > np.pi:  # shortest representation
        angle -= 2 * np.pi
    return q[:3] / s * angle


def _yaw_quat(angle_deg: float) -> np.ndarray:
    """Quaternion for rotation about +y by angle (xyzw)."""
    a = np.deg2rad(angle_deg) / 2
    return np.array([0.0, np.sin(a), 0.0, np.cos(a)])


def dilate3x3(binary: np.ndarray) -> np.ndarray:
    """3x3 dilation (the reference uses convolve2d with a ones kernel,
    ``planning_funcs.py:247-259``)."""
    out = binary.astype(bool).copy()
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = np.zeros_like(out)
            xs = slice(max(dx, 0), binary.shape[0] + min(dx, 0))
            xd = slice(max(-dx, 0), binary.shape[0] + min(-dx, 0))
            ys = slice(max(dy, 0), binary.shape[1] + min(dy, 0))
            yd = slice(max(-dy, 0), binary.shape[1] + min(-dy, 0))
            shifted[xd, yd] = binary[xs, ys]
            out |= shifted.astype(bool)
    return out.astype(np.int32)


def get_voxels_between_points(
    start_pos, end_pos, current_voxel, end_voxel, voxel_size
) -> List[np.ndarray]:
    """Amanatides–Woo 3D DDA from start to end voxel
    (``planning_funcs.py:97-159``)."""
    cur = np.array(current_voxel, dtype=np.int64)
    view = cur.copy()
    last = np.array(end_voxel, dtype=np.int64)
    start = np.asarray(start_pos, dtype=np.float64)
    end = np.asarray(end_pos, dtype=np.float64)
    ray = end - start
    step = np.where(ray >= 0, 1, -1)
    next_boundary = (cur + step) * voxel_size
    with np.errstate(divide="ignore"):
        t_max = np.where(ray != 0, (next_boundary - start) / ray, np.inf)
        t_delta = np.where(ray != 0, voxel_size / ray * step, np.inf)
    out = []
    range_sq = np.sum(((last - view) * voxel_size) ** 2)
    dist = 0.0
    while dist <= range_sq:
        axis = int(np.argmin(t_max))
        cur[axis] += step[axis]
        t_max[axis] += t_delta[axis]
        out.append(cur.copy())
        dist = np.sum(((cur - view) * voxel_size) ** 2)
    return out


def collision_checker(voxel_grid, flat, voxel_grid_size, aabb) -> bool:
    """Does the straight line start→end of a flat trajectory cross an
    occupied voxel? (``planning_funcs.py:162-179``)."""
    x = flat["x"]
    vidx = world2voxels(x - aabb[:3], voxel_grid_size)
    voxels = np.array(
        get_voxels_between_points(
            x[0], x[-1], vidx[0], vidx[-1], voxel_grid_size
        )
    )
    ch = voxel_grid[0]
    if len(voxels) == 0:
        return False
    return bool(
        ch[
            np.clip(voxels[:, 0], 0, ch.shape[0] - 1),
            np.clip(voxels[:, 1], 0, ch.shape[1] - 1),
            np.clip(voxels[:, 2], 0, ch.shape[2] - 1),
        ].any()
    )


def sample_waypoints_from_free_space(
    voxel_grid, current_state, aabb, voxel_grid_size, N=10, rng=None
):
    """Random free-space waypoints at mid altitude away from the current
    cell (``planning_funcs.py:54-94``)."""
    rng = rng or np.random
    ch = voxel_grid[0]
    free = np.argwhere(ch == 0)
    rel = np.asarray(current_state) - aabb[:3]
    cur = world2voxels(rel, voxel_grid_size)
    vertical = (aabb[5] - aabb[2]) // voxel_grid_size
    keep = (
        (free[:, 2] >= int(vertical / 3))
        & (free[:, 2] <= int(vertical * 2 / 3))
        & (
            (free[:, 0] >= np.clip(cur[0] + 2, 0, ch.shape[0]))
            | (free[:, 0] <= np.clip(cur[0] - 2, 0, ch.shape[0]))
            | (free[:, 1] >= np.clip(cur[1] + 2, 0, ch.shape[1]))
            | (free[:, 1] <= np.clip(cur[1] - 2, 0, ch.shape[1]))
        )
    )
    free = free[keep]
    pick = rng.choice(len(free), N, replace=False)
    return voxels2world(free[pick], voxel_grid_size) + aabb[:3]


def build_path_map(
    voxel_grid: np.ndarray,  # [2, X, Y, Z] (xzy-swapped grids)
    current_voxel: np.ndarray,  # [3] int
    z_slice: int = 8,
) -> np.ndarray:
    """2D obstacle map: union of both members' z-slice, dilated, with the
    current pose's cross cleared (``planning_funcs.py:243-266``)."""
    v_merge = voxel_grid[0, :, :, z_slice].astype(np.int32) + voxel_grid[
        1, :, :, z_slice
    ].astype(np.int32)
    pmap = dilate3x3((v_merge > 1e-4).astype(np.int32))
    vi = current_voxel
    X, Y = pmap.shape
    for dx, dy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
        x, y = vi[1] + dx, vi[0] + dy
        if 0 <= x < X and 0 <= y < Y:
            pmap[x, y] = 0
    return pmap


def sample_traj(
    voxel_grid: np.ndarray,  # [2, X, Y, Z] xzy grids
    current_state: np.ndarray,  # [3] xzy world position
    N_traj: int,
    aabb: np.ndarray,  # xzy-swapped aabb
    cost_map: np.ndarray,
    visiting_map: np.ndarray,
    save_path: Optional[str] = None,
    N_sample_disc: int = 20,
    voxel_grid_size: float = 0.1,
    sim=None,
    rng: Optional[np.random.RandomState] = None,
    flight_height: float = 1.7,
    v_avg: float = 0.5,
    max_attempts: int = 200,
) -> List[np.ndarray]:
    """Sample N_traj candidate trajectories (``planning_funcs.py:222-399``).

    Returns a list of [T, 7] (pos xyz, quat xyzw) pose arrays in habitat
    convention, each ending with a 20-pose 360° spin.
    """
    rng = rng or np.random.RandomState()
    voxel_grid = np.squeeze(voxel_grid)
    v_idx = world2voxels(current_state - aabb[:3], voxel_grid_size)
    pmap = build_path_map(voxel_grid, v_idx)

    # visit-weighted sampling map (planning_funcs.py:268-276): obstacles
    # -1, free cells scored by exp(-(visits - min_visits)/5)
    vm = np.copy(visiting_map).astype(np.float64)
    obstacle = pmap > 1e-4
    if (~obstacle).any():
        free_vals = vm[~obstacle]
        vm[~obstacle] = np.exp(-(free_vals - np.min(free_vals)) / 5)
    vm[obstacle] = -1

    if save_path is not None:
        os.makedirs(os.path.join(save_path, "maps"), exist_ok=True)
        import datetime

        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        np.save(os.path.join(save_path, "maps", f"vmap_{stamp}.npy"), vm)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imshow(vm, vmin=-1, vmax=1)
            plt.plot(v_idx[1], v_idx[0], "r*")
            plt.colorbar()
            plt.savefig(os.path.join(save_path, "maps", f"vmap_{stamp}.png"))
            plt.clf()
        except Exception:
            pass

    dijkstra = Dijkstra(aabb, pmap, voxel_grid_size, 0.05)
    controller = SE3Control()
    free_indices = np.argwhere(vm >= 0)

    trajectories = []
    for _ in range(N_traj):
        flat = None
        for _attempt in range(max_attempts):
            pick = rng.choice(len(free_indices))
            goal_vox = np.append(free_indices[pick], 0)
            goal = voxels2world(goal_vox[None], voxel_grid_size)[0] + aabb[:3]
            goal[2] = 1.5
            crr = current_state - aabb[:3]
            end = goal - aabb[:3]
            path = dijkstra.planning(crr[0], crr[1], end[0], end[1])
            if path is None:
                continue
            rx, ry = list(path[0]), list(path[1])
            rx.reverse()
            ry.reverse()
            waypoints = (
                np.array([rx, ry, np.full(len(rx), flight_height)]).T + aabb[:3]
            )
            yaw = np.linspace(2 * np.pi, 0, len(waypoints))
            traj = MinSnap(points=waypoints, yaw_angles=yaw, v_avg=v_avg)
            if not traj.initialize() or traj.null:
                continue
            t_final = float(np.sum(traj.delta_t))
            n_disc = max(int(t_final * 20), N_sample_disc)
            ts = np.linspace(0, t_final, n_disc + 1)
            flats = [traj.update(t) for t in ts]
            refs = [controller.update_ref(t, f) for t, f in zip(ts, flats)]
            flat = {
                "x": np.array([f["x"] for f in flats]),
                "cmd_q": np.array([r["cmd_q"] for r in refs]),
            }
            break
        if flat is None:
            # fallback: hover in place (keeps the pipeline alive, the
            # reference would spin forever — planning_funcs.py:296-375)
            pose = np.concatenate([current_state[[0, 2, 1]], [0, 0, 0, 1]])
            trajectories.append(np.tile(pose, (N_sample_disc + 20, 1)))
            continue

        # rotorpy works in xzy; swap back to habitat xyz
        # (planning_funcs.py:377-381)
        xzy = flat["x"].copy()
        xzy[:, 1] = flat["x"][:, 2]
        xzy[:, 2] = flat["x"][:, 1]
        # quaternion frame remap via rotvec component shuffle
        # (planning_funcs.py:383-388): (rx, ry, rz) → (-rx, rz, -ry)
        quats = []
        for q in flat["cmd_q"]:
            rv = _quat_to_rotvec(q)
            rv = np.array([-rv[0], rv[2], -rv[1]])
            quats.append(_rotvec_to_quat(rv))
        traj_x_quat = np.hstack([xzy, np.array(quats)])

        # terminal 360° spin (planning_funcs.py:391-396)
        end_pos = traj_x_quat[-1, :3]
        spin = [
            np.concatenate([end_pos, _yaw_quat(ang)])
            for ang in np.linspace(0, 360, 20)
        ]
        traj_x_quat = np.vstack([traj_x_quat, np.array(spin)])
        trajectories.append(traj_x_quat)

    return trajectories
