"""The one generator of requests: it reads a traffic mix's parameters
(a data file under ``traffic/``) and the run's seed, and hands the
program what it would get from its own caller.

Two kinds of mix exist:
  * ``train``: calls of the mapper's train loop, ``steps_per_call`` steps
    each, at ``planning_step``, after ``warm_steps`` steps of set-up on an
    initial scan of ``initial_views`` views;
  * ``plan``: candidate trajectories, ``candidates_per_call`` a call, each
    ``flight_poses`` poses along a straight flight at ``height`` between
    two points of the room at least ``margin`` from its walls, turning
    once about the vertical as it goes, then a ``spin_poses``-pose spin
    in place, the shape the planner's trajectories take.
Every seed gives the same amount of work; only positions and angles move.
"""

from __future__ import annotations

from typing import List

import numpy as np


def sub_seeds(seed: int) -> dict:
    """Independent 32-bit seeds of a run's parts, from its seed."""
    s = np.random.SeedSequence(int(seed)).generate_state(6)
    return dict(zip(("weights", "draws", "mapper", "traffic", "check", "warm"), map(int, s)))


def _yaw_quat(angle: float) -> np.ndarray:
    return np.array([0.0, np.sin(angle / 2), 0.0, np.cos(angle / 2)])


def candidate(traffic: dict, aabb, seed: int, index: int) -> np.ndarray:
    """One candidate trajectory [flight_poses + spin_poses, 7] (xyz, quat xyzw)."""
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), int(index)])))
    lo = np.asarray(aabb[:3], dtype=np.float64) + traffic["margin"]
    hi = np.asarray(aabb[3:], dtype=np.float64) - traffic["margin"]
    a, b = rng.uniform(lo, hi), rng.uniform(lo, hi)
    a[1] = b[1] = traffic["height"]
    n = traffic["flight_poses"]
    s = np.linspace(0.0, 1.0, n)[:, None]
    pos = a + s * (b - a)
    yaw0 = rng.uniform(0.0, 2 * np.pi)
    flight = [np.concatenate([p, _yaw_quat(yaw0 + 2 * np.pi * (1.0 - t))])
              for p, t in zip(pos, s[:, 0])]
    spin = [np.concatenate([pos[-1], _yaw_quat(np.deg2rad(ang))])
            for ang in np.linspace(0, 360, traffic["spin_poses"])]
    return np.array(flight + spin)


def candidates(traffic: dict, aabb, seed: int, call: int) -> List[np.ndarray]:
    """The candidates of one call."""
    k = traffic["candidates_per_call"]
    return [candidate(traffic, aabb, seed, call * k + j) for j in range(k)]


def scan_poses(origin, n: int, seed: int) -> List[np.ndarray]:
    """The initial scan's poses as the mapper takes them: n yaws 9 degrees
    apart about ``origin``, each jittered by U(-0.2, 0.2) m per axis from a
    numpy generator seeded with ``seed``."""
    rng = np.random.RandomState(seed)
    o = np.asarray(origin, dtype=np.float64)
    return [np.concatenate([o[:3] + rng.uniform(-0.2, 0.2, 3),
                            _yaw_quat(np.deg2rad((9.0 * i) % 360.0))]) for i in range(n)]
