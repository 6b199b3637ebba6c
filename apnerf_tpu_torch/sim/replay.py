"""ReplaySim — drive the active loop from a recorded trajectory.

A third simulator behind the ``HabitatSim`` facade (``simulator/sim.py:
15-420``), alongside the real Habitat wrapper (``sim/habitat.py``) and the
analytic ``FakeSim``: it serves observations from a **cached recording**
in the reference's ``data<k>.npz`` schema (images/depths/semantics/
camtoworlds/K — ``perception/data_proc/habitat_to_data.py:164-173``).
Any trajectory recorded by the reference pipeline (or by this framework's
``RayDataset.save``) becomes a replayable world: the recorded frames are
the universe of available observations, and every requested camera pose
snaps to the nearest recorded frame.

Why this exists (SURVEY.md §4's "fake simulator replaying cached data0.npz
trajectories"): it is the only way to run the *active loop* against
non-analytic imagery — real Habitat renders, real-robot captures — in an
environment without Habitat or the original scene assets. The reference's
own offline eval replays the same schema host-side
(``scripts/eval/eval_pipeline_offline.py:18-160``); ReplaySim closes the
loop by making the recording drivable end-to-end through
``ActiveNeRFMapper`` (planning included).

Pose snapping: ``ActiveNeRFMapper`` asks its simulator for observations at
poses the *planner* chose; a recording cannot render novel views, so the
mapper first calls :meth:`snap_poses` (when the simulator provides it) and
supervises the NeRF at the TRUE recorded camera of each returned frame —
otherwise frames would be paired with poses they were not captured at.
The match metric is position distance plus ``orient_weight`` times the
chord distance between camera forward axes.

Port of ``apnerf_tpu/sim/replay.py``: the same host-only numpy code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..ops.rays import pose_matrix_from_quat, quat_xyzw_from_matrix


class ReplaySim:
    """Facade-compatible simulator serving frames from a recording.

    Args:
      source: path to a reference-schema ``.npz`` or a dict with keys
        ``images`` [N,H,W,3|4] uint8, ``depths`` [N,H,W] f32,
        ``semantics`` [N,H,W] int, ``camtoworlds`` [N,4,4], ``K`` [3,3].
      orient_weight: meters of position error equivalent to a fully
        opposite viewing direction (chord distance 2).
      nav_radius: a location is "navigable" if some recorded camera sits
        within this distance (the recording is the known-free space).
    """

    def __init__(
        self,
        source: Union[str, dict],
        orient_weight: float = 1.0,
        nav_radius: float = 1.0,
        seed: int = 0,
    ):
        data = np.load(source, allow_pickle=True) if isinstance(
            source, str
        ) else source
        images = np.asarray(data["images"])
        if images.shape[-1] == 3:  # facade contract returns RGBA uint8
            alpha = np.full(images.shape[:-1] + (1,), 255, np.uint8)
            images = np.concatenate([images, alpha], axis=-1)
        self.images = images
        self.depths = np.asarray(data["depths"], dtype=np.float32)
        self.semantics = np.asarray(data["semantics"], dtype=np.int32)
        self.camtoworlds = np.asarray(data["camtoworlds"], dtype=np.float64)
        self.K = np.asarray(data["K"], dtype=np.float32)
        n = len(self.images)
        if not (
            len(self.depths) == len(self.semantics)
            == len(self.camtoworlds) == n > 0
        ):
            raise ValueError("inconsistent or empty recording")
        self.img_h, self.img_w = self.images.shape[1:3]
        self.positions = self.camtoworlds[:, :3, 3]
        # OpenGL camera: forward = -z column
        self.forwards = -self.camtoworlds[:, :3, 2]
        self.pose7s = np.array(
            [
                np.concatenate(
                    [m[:3, 3], quat_xyzw_from_matrix(m[:3, :3])]
                )
                for m in self.camtoworlds
            ]
        )
        self.orient_weight = float(orient_weight)
        self.nav_radius = float(nav_radius)
        self.quad_state = self.pose7s[0].copy()
        self.visited: List[np.ndarray] = []
        self._rng = np.random.RandomState(seed)
        self.num_semantic_classes = int(self.semantics.max()) + 1
        # per-call snap diagnostics (position error meters, frame index)
        self.last_match_err: np.ndarray = np.zeros(0)
        self.last_match_idx: np.ndarray = np.zeros(0, np.int64)

    # ---- pose matching ----

    def match_indices(self, poses: Sequence[np.ndarray]) -> np.ndarray:
        """Nearest recorded frame per requested pose7 [x,y,z,qx,qy,qz,qw]."""
        poses = np.atleast_2d(np.asarray(poses, dtype=np.float64))
        idx = np.empty(len(poses), dtype=np.int64)
        errs = np.empty(len(poses))
        for i, p in enumerate(poses):
            d_pos = np.linalg.norm(self.positions - p[:3], axis=-1)
            fwd = -pose_matrix_from_quat(p[:3], p[3:])[:3, 2]
            d_dir = np.linalg.norm(self.forwards - fwd, axis=-1)
            cost = d_pos + self.orient_weight * 0.5 * d_dir
            idx[i] = int(np.argmin(cost))
            errs[i] = d_pos[idx[i]]
        self.last_match_idx, self.last_match_err = idx, errs
        return idx

    def snap_poses(self, poses: Sequence[np.ndarray]) -> np.ndarray:
        """Recorded pose7 of the frame each requested pose will receive.
        The mapper calls this before ``sample_images_from_poses`` so the
        dataset pairs every frame with its true camera."""
        return self.pose7s[self.match_indices(poses)].copy()

    # ---- HabitatSim facade (simulator/sim.py API) ----

    def sample_images_from_poses(self, poses):
        idx = self.match_indices(poses)
        return (
            self.images[idx].copy(),
            self.depths[idx].copy(),
            self.semantics[idx].copy(),
        )

    def set_quad_state(self, pose):
        self.quad_state = np.asarray(pose, dtype=np.float64)

    def get_quad_state(self):
        return self.quad_state.copy()

    def render_tpv(self, poses, draw_traj: bool = True):
        idx = self.match_indices(np.atleast_2d(np.asarray(poses)))
        return [self.images[i][..., :3].copy() for i in idx]

    def render_top_tpv(self, poses, draw_traj: bool = True):
        return self.render_tpv(poses, draw_traj)

    def check_navigability(self, location) -> bool:
        pt = np.asarray(
            location[0] if np.ndim(location) > 1 else location,
            dtype=np.float64,
        )[:3]
        d = np.linalg.norm(self.positions - pt, axis=-1)
        return bool(d.min() <= self.nav_radius)

    def sample_path(self, curr_loc) -> np.ndarray:
        """Walk the recording: path from the current location to a random
        later recorded camera position (navmesh analogue,
        ``sim.py:385-401``)."""
        cl = np.asarray(curr_loc, dtype=np.float64)[:3]
        start = int(np.argmin(np.linalg.norm(self.positions - cl, axis=-1)))
        end = int(self._rng.randint(start, len(self.positions)))
        pts = self.positions[start : end + 1 : max((end - start) // 8, 1)]
        return np.vstack([cl[None], pts])

    def add_visited_location(self, locations, r: float = 0.001):
        self.visited.extend(np.atleast_2d(np.asarray(locations)))

    def get_2d_point(self, point_3d, sensor_name=None):
        c2w = pose_matrix_from_quat(self.quad_state[:3], self.quad_state[3:])
        w2c = np.linalg.inv(c2w)
        pc = w2c[:3, :3] @ np.asarray(point_3d) + w2c[:3, 3]
        z = -pc[2]
        if z <= 1e-6:
            return np.array([-1, -1])
        u = self.K[0, 0] * pc[0] / z + self.K[0, 2]
        v = -self.K[1, 1] * pc[1] / z + self.K[1, 2]
        return np.array([int(u), int(v)])

    # ---- replay conveniences ----

    def tour_poses(self, n: Optional[int] = None) -> np.ndarray:
        """n evenly-spaced recorded pose7s along the trajectory (all
        frames when n is None) — for scripted replays that follow the
        recording instead of planning."""
        if n is None or n >= len(self.pose7s):
            return self.pose7s.copy()
        idx = np.round(np.linspace(0, len(self.pose7s) - 1, n)).astype(int)
        return self.pose7s[idx].copy()

    def aabb_estimate(self, margin: float = 1.0) -> np.ndarray:
        """Scene bounds guess from camera positions + max recorded depth
        reach (for configs lacking a known aabb)."""
        reach = float(np.percentile(self.depths, 99))
        lo = self.positions.min(axis=0) - reach - margin
        hi = self.positions.max(axis=0) + reach + margin
        return np.array([lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]])
