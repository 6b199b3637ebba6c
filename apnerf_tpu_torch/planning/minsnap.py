"""Minimum-snap piecewise-polynomial trajectories (host-side numpy).

Capability parity with the vendored rotorpy ``MinSnap``
(``planning/rotorpy/rotorpy/trajectories/minsnap.py:248-443``): per-axis
7th-order piecewise polynomials through waypoints with continuity of
derivatives 1..6 at interior knots, zero velocity/acceleration/jerk at both
ends, trapezoidal-speed time allocation, yaw linearly re-timed across the
whole path, evaluated as flat outputs (x..snap, yaw, yaw_dot, yaw_ddot).

Re-designed construction: instead of assembling the reference's explicit
8m x 8m row lists, the constraint system is generated from a derivative-
of-monomials operator — same solution (the equality system is square and
full-rank, so the minimizer is the unique feasible point; the reference
also just calls ``np.linalg.solve`` on it, ``minsnap.py:343-350``). No
cvxopt dependency.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _dcoef(order: int, d: int) -> np.ndarray:
    """Coefficient multipliers for the d-th derivative of the monomial
    basis [1, t, ..., t^order]."""
    k = np.arange(order + 1, dtype=np.float64)
    c = np.ones(order + 1)
    for i in range(d):
        c *= np.maximum(k - i, 0)
    return c


def _basis_row(order: int, d: int, t: float) -> np.ndarray:
    """Row evaluating the d-th derivative of the monomial basis at t."""
    k = np.arange(order + 1, dtype=np.float64)
    c = _dcoef(order, d)
    p = np.maximum(k - d, 0)
    tp = np.where(k >= d, t**p, 0.0)
    return c * tp


def _solve_axis(keyframes: np.ndarray, delta_t: np.ndarray) -> Optional[np.ndarray]:
    """Solve one axis → [m, 8] coefficient rows (ascending powers, local
    segment time)."""
    m = len(delta_t)
    K = 8 * m
    A = np.zeros((K, K))
    b = np.zeros(K)
    row = 0
    # waypoint interpolation at segment ends
    for i in range(m):
        A[row, 8 * i : 8 * i + 8] = _basis_row(7, 0, 0.0)
        b[row] = keyframes[i]
        row += 1
        A[row, 8 * i : 8 * i + 8] = _basis_row(7, 0, delta_t[i])
        b[row] = keyframes[i + 1]
        row += 1
    # interior continuity of derivatives 1..6
    for i in range(m - 1):
        for d in range(1, 7):
            A[row, 8 * i : 8 * i + 8] = -_basis_row(7, d, delta_t[i])
            A[row, 8 * (i + 1) : 8 * (i + 1) + 8] = _basis_row(7, d, 0.0)
            row += 1
    # boundary: vel/acc/jerk zero at both ends
    for d in (1, 2, 3):
        A[row, :8] = _basis_row(7, d, 0.0)
        row += 1
        A[row, -8:] = _basis_row(7, d, delta_t[-1])
        row += 1
    assert row == K
    if np.linalg.matrix_rank(A) < K:
        return None
    c = np.linalg.solve(A, b)
    return c.reshape(m, 8)


class MinSnap:
    """points: [N, 3] waypoints; yaw_angles: [N]; v_avg: average speed."""

    def __init__(self, points, yaw_angles=None, v_avg: float = 2.0):
        points = np.asarray(points, dtype=np.float64)
        self.full_points = points
        self.yaw = (
            np.zeros(points.shape[0]) if yaw_angles is None
            else np.asarray(yaw_angles, dtype=np.float64)
        )
        self.v_avg = v_avg
        # drop near-duplicate waypoints (minsnap.py:394-397)
        self.seg_dist = np.linalg.norm(np.diff(points, axis=0), axis=1)
        mask = np.append(True, self.seg_dist > 1e-2)
        self.points = points[mask]
        self.null = False
        self.m = self.points.shape[0] - 1
        self._coef = None  # [4 axes (x,y,z,yaw)][m, 8]
        self.delta_t = None
        self.t_keyframes = None

    def initialize(self) -> bool:
        if self.points.shape[0] < 2:
            # single waypoint → hover (minsnap.py:373-380)
            self.null = True
            self.delta_t = np.zeros((1,))
            self.t_keyframes = np.zeros((2,))
            return True
        m = self.m
        seg_dist = self.seg_dist[self.seg_dist > 1e-2]
        # trapezoidal speed ramp time allocation (minsnap.py:300-307)
        self.delta_t = np.zeros(m)
        vi, cum = 0.0, 0.0
        total = np.sum(seg_dist)
        for i in range(m):
            cum += seg_dist[i]
            vf = min(min(cum, self.v_avg), total - cum)
            self.delta_t[i] = seg_dist[i] * 2 / (vf + vi + 1e-4)
            vi = vf
        self.t_keyframes = np.concatenate([[0], np.cumsum(self.delta_t)])
        # yaw re-timed linearly across total time (minsnap.py:310-316)
        yaw_diff = self.yaw[-1] - self.yaw[0]
        yaw_exec = (
            self.t_keyframes / (self.t_keyframes[-1] + 1e-4) * yaw_diff
            + self.yaw[0]
        )
        axes = []
        for k, kf in enumerate(
            [self.points[:, 0], self.points[:, 1], self.points[:, 2], yaw_exec]
        ):
            c = _solve_axis(np.asarray(kf), self.delta_t)
            if c is None:
                return False
            axes.append(c)
        self._coef = axes
        return True

    def _eval(self, axis: int, seg: int, t: float, d: int) -> float:
        c = self._coef[axis][seg]
        row = _basis_row(7, d, t)
        return float(np.dot(c, row))

    def update(self, t: float) -> Dict[str, np.ndarray]:
        """Flat outputs at time t (``minsnap.py:387-443``)."""
        out = {
            "x": np.zeros(3), "x_dot": np.zeros(3), "x_ddot": np.zeros(3),
            "x_dddot": np.zeros(3), "x_ddddot": np.zeros(3),
            "yaw": 0.0, "yaw_dot": 0.0, "yaw_ddot": 0.0,
        }
        if self.null:
            out["x"] = self.points[0].copy()
            return out
        t = float(np.clip(t, self.t_keyframes[0], self.t_keyframes[-1]))
        seg = 0
        for i in range(len(self.t_keyframes) - 1):
            seg = i
            if self.t_keyframes[i] + self.delta_t[i] >= t:
                break
        tl = t - self.t_keyframes[seg]
        for j in range(3):
            out["x"][j] = self._eval(j, seg, tl, 0)
            out["x_dot"][j] = self._eval(j, seg, tl, 1)
            out["x_ddot"][j] = self._eval(j, seg, tl, 2)
            out["x_dddot"][j] = self._eval(j, seg, tl, 3)
            out["x_ddddot"][j] = self._eval(j, seg, tl, 4)
        out["yaw"] = self._eval(3, seg, tl, 0)
        out["yaw_dot"] = self._eval(3, seg, tl, 1)
        out["yaw_ddot"] = self._eval(3, seg, tl, 2)
        return out
