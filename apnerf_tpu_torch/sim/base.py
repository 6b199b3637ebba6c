"""Simulator interface.

The facade every backend implements — same surface as the reference's
``HabitatSim`` (``simulator/sim.py:15-420``), so the active mapper is
backend-agnostic: the real Habitat engine, or the analytic FakeSim for
tests and CI.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import numpy as np


class Simulator(Protocol):
    def sample_images_from_poses(
        self, poses
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """poses: iterable of [7] (x, y, z, qx, qy, qz, qw) →
        (rgbs [N,H,W,4] uint8, depths [N,H,W] f32, sems [N,H,W] int)."""
        ...

    def set_quad_state(self, pose: np.ndarray) -> None: ...

    def get_quad_state(self) -> np.ndarray: ...

    def render_tpv(self, poses, draw_traj: bool = True): ...

    def render_top_tpv(self, poses, draw_traj: bool = True): ...

    def check_navigability(self, location) -> bool: ...

    def sample_path(self, curr_loc) -> np.ndarray: ...

    def add_visited_location(self, locations, r: float = 0.001) -> None: ...
