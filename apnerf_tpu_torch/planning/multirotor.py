"""Multirotor 6-DoF rigid-body dynamics + closed-loop simulate().

Capability parity with rotorpy's vehicle model and simulation loop
(``planning/rotorpy/rotorpy/vehicles/multirotor.py:33-312`` and
``rotorpy/simulate.py:7-238``) — dormant in the reference pipeline (poses
come from differential-flatness outputs, not a dynamics rollout), but a
capability the reference ships. Host-side numpy like the rest of the
planning stack; the physics constants are the public Crazyflie 2.0 data
already used by :mod:`se3_control`.

Differences from rotorpy, documented:
  * integration is fixed-step RK4 instead of scipy ``solve_ivp`` RK45
    (deterministic cost, no scipy dependency in the hot loop; rotorpy
    itself ships a commented-out Euler option);
  * the wind / IMU / mocap / EKF estimation stack (rotorpy's
    ``wind/ imu/ mocap/ estimators/`` — vendored but unused by the
    reference pipeline) is out of scope: ``simulate`` runs vehicle +
    controller + trajectory with the same safety/termination exits.

Port of ``apnerf_tpu/planning/multirotor.py``: the same host-only numpy code.
"""

from __future__ import annotations

import copy
from enum import Enum
from typing import Callable, Dict, Optional

import numpy as np

from .se3_control import CRAZYFLIE_PARAMS

# aerodynamic constants rotorpy adds beyond what SE3 control needs
# (crazyflie_params.py:16-64)
_AERO_DEFAULTS = {
    "c_Dx": 0.5e-2, "c_Dy": 0.5e-2, "c_Dz": 1e-2,
    "k_d": 10.2506e-07, "k_z": 7.553e-07, "k_flap": 0.0,
    "tau_m": 0.005, "motor_noise_std": 0.0,
    "rotor_directions": (1, -1, 1, -1),
}


def quat_dot(quat: np.ndarray, omega: np.ndarray) -> np.ndarray:
    """Quaternion kinematics with unit-norm correction
    (``multirotor.py:11-31``; quat is [x, y, z, w])."""
    q0, q1, q2, q3 = quat
    G = np.array(
        [[q3, q2, -q1, -q0], [-q2, q3, q0, -q1], [q1, -q0, q3, -q2]]
    )
    qd = 0.5 * G.T @ omega
    quat_err = np.sum(quat ** 2) - 1
    return qd - quat_err * 2 * quat


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _hat(s: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -s[2], s[1]], [s[2], 0, -s[0]], [-s[1], s[0], 0]]
    )


class Multirotor:
    """Quadrotor forward dynamics (``multirotor.py:33-312``).

    State dict: x [3], v [3], q [4] (xyzw), w [3], wind [3],
    rotor_speeds [n].
    """

    def __init__(self, quad_params: Optional[Dict] = None, rng=None):
        p = dict(CRAZYFLIE_PARAMS)
        p.update(_AERO_DEFAULTS)
        if quad_params:
            p.update(quad_params)
        self.mass = p["mass"]
        self.inertia = np.array(
            [
                [p["Ixx"], p["Ixy"], p["Ixz"]],
                [p["Ixy"], p["Iyy"], p["Iyz"]],
                [p["Ixz"], p["Iyz"], p["Izz"]],
            ]
        )
        self.inv_inertia = np.linalg.inv(self.inertia)
        self.num_rotors = p["num_rotors"]
        self.rotor_geometry = np.array(
            [p["rotor_pos"][f"r{i+1}"] for i in range(self.num_rotors)]
        )  # [n, 3]
        self.rotor_dir = np.asarray(p["rotor_directions"], dtype=float)
        self.k_eta, self.k_m = p["k_eta"], p["k_m"]
        self.k_d, self.k_z, self.k_flap = p["k_d"], p["k_z"], p["k_flap"]
        self.tau_m = p["tau_m"]
        self.motor_noise = p["motor_noise_std"]
        self.rotor_speed_min = p["rotor_speed_min"]
        self.rotor_speed_max = p["rotor_speed_max"]
        self.rotor_drag_matrix = np.diag([self.k_d, self.k_d, self.k_z])
        self.drag_matrix = np.diag([p["c_Dx"], p["c_Dy"], p["c_Dz"]])
        self.g = 9.81
        self.weight = np.array([0, 0, -self.mass * self.g])
        self.rng = rng or np.random.RandomState(0)
        self.initial_state = {
            "x": np.zeros(3), "v": np.zeros(3),
            "q": np.array([0.0, 0.0, 0.0, 1.0]), "w": np.zeros(3),
            "wind": np.zeros(3),
            "rotor_speeds": np.full(self.num_rotors, 1788.53),
        }

    # -- wrench ---------------------------------------------------------

    def compute_body_wrench(self, body_rates, rotor_speeds, body_airspeed):
        """Net body-frame force/moment from rotors + frame drag
        (``multirotor.py:223-258``), vectorized over rotors."""
        w_hat = _hat(body_rates)
        local_air = body_airspeed[None, :] + (w_hat @ self.rotor_geometry.T).T
        T = np.zeros((self.num_rotors, 3))
        T[:, 2] = self.k_eta * rotor_speeds ** 2
        H = -rotor_speeds[:, None] * (self.rotor_drag_matrix @ local_air.T).T
        TH = T + H
        M_force = np.cross(self.rotor_geometry, TH)
        M_yaw = np.zeros((self.num_rotors, 3))
        M_yaw[:, 2] = self.rotor_dir * self.k_m * rotor_speeds ** 2
        M_flap = -rotor_speeds[:, None] * self.k_flap * np.cross(
            local_air, np.array([0.0, 0.0, 1.0])
        )
        FtotB = TH.sum(axis=0)
        MtotB = (M_force + M_yaw + M_flap).sum(axis=0)
        D = -np.linalg.norm(body_airspeed) * self.drag_matrix @ body_airspeed
        return FtotB + D, MtotB

    # -- ODE ------------------------------------------------------------

    def _s_dot(self, state: Dict, cmd_rotor_speeds: np.ndarray) -> Dict:
        R = _quat_to_matrix(state["q"])
        body_airspeed = R.T @ (state["v"] - state["wind"])
        FtotB, Mtot = self.compute_body_wrench(
            state["w"], state["rotor_speeds"], body_airspeed
        )
        v_dot = (self.weight + R @ FtotB) / self.mass
        w = state["w"]
        w_dot = self.inv_inertia @ (Mtot - _hat(w) @ (self.inertia @ w))
        return {
            "x": state["v"].copy(),
            "v": v_dot,
            "q": quat_dot(state["q"], w),
            "w": w_dot,
            "wind": np.zeros(3),
            "rotor_speeds": (cmd_rotor_speeds - state["rotor_speeds"])
            / self.tau_m,
        }

    def statedot(self, state: Dict, cmd_rotor_speeds, t_step=None) -> Dict:
        """Accelerations at the current state (``multirotor.py:118-133``)."""
        cmd = np.clip(
            np.asarray(cmd_rotor_speeds, dtype=float),
            self.rotor_speed_min, self.rotor_speed_max,
        )
        sd = self._s_dot(state, cmd)
        return {"vdot": sd["v"], "wdot": sd["w"]}

    def step(self, state: Dict, cmd_rotor_speeds, t_step: float) -> Dict:
        """One RK4 step of the rigid-body ODE (``multirotor.py:136-163``;
        rotorpy uses scipy RK45 — fixed-step RK4 keeps cost deterministic)."""
        cmd = np.clip(
            np.asarray(cmd_rotor_speeds, dtype=float),
            self.rotor_speed_min, self.rotor_speed_max,
        )
        keys = ("x", "v", "q", "w", "wind", "rotor_speeds")

        def add(s, d, h):
            return {k: s[k] + h * d[k] for k in keys}

        k1 = self._s_dot(state, cmd)
        k2 = self._s_dot(add(state, k1, t_step / 2), cmd)
        k3 = self._s_dot(add(state, k2, t_step / 2), cmd)
        k4 = self._s_dot(add(state, k3, t_step), cmd)
        new = {
            k: state[k]
            + (t_step / 6) * (k1[k] + 2 * k2[k] + 2 * k3[k] + k4[k])
            for k in keys
        }
        new["q"] = new["q"] / np.linalg.norm(new["q"])
        if self.motor_noise > 0:
            new["rotor_speeds"] = new["rotor_speeds"] + self.rng.normal(
                scale=self.motor_noise, size=self.num_rotors
            )
        return new


# ---------------------------------------------------------------------------
# simulate loop + helpers (rotorpy/simulate.py:7-238)
# ---------------------------------------------------------------------------


class ExitStatus(Enum):
    """Why the simulation stopped (``simulate.py:7-17``)."""

    COMPLETE = "Success: End reached."
    TIMEOUT = "Timeout: Simulation end time reached."
    INF_VALUE = "Failure: Your controller returned inf motor speeds."
    NAN_VALUE = "Failure: Your controller returned nan motor speeds."
    OVER_SPEED = "Failure: speed exceeded 100 m/s."
    OVER_SPIN = "Failure: spin exceeded 100 rad/s."
    FLY_AWAY = "Failure: position error exceeded 20 m."
    COLLISION = "Failure: collision."


def merge_dicts(dicts_in):
    """List of state dicts → dict of stacked arrays (``simulate.py:142-155``)."""
    out = {}
    for k in dicts_in[0].keys():
        out[k] = np.array([d[k] for d in dicts_in])
    return out


def time_exit(time: float, t_final: float):
    """(``simulate.py:189-196``)"""
    return ExitStatus.TIMEOUT if time >= t_final else None


def sanitize_control_dic(control_dic: Dict) -> Dict:
    """Flatten control outputs to consistent shapes (``simulate.py:220-227``)."""
    control_dic["cmd_motor_speeds"] = np.asarray(
        control_dic["cmd_motor_speeds"], float
    ).ravel()
    for k in ("cmd_q", "cmd_w", "cmd_moment"):
        if k in control_dic:
            control_dic[k] = np.asarray(control_dic[k], float).ravel()
    return control_dic


def sanitize_trajectory_dic(trajectory_dic: Dict) -> Dict:
    """(``simulate.py:229-238``)"""
    for k in ("x", "x_dot", "x_ddot", "x_dddot", "x_ddddot"):
        if k in trajectory_dic:
            trajectory_dic[k] = np.asarray(trajectory_dic[k], float).ravel()
    return trajectory_dic


def _safety_exit(state, flat, control):
    """Numeric blow-up / runaway guards (``simulate.py:198-218``)."""
    if np.any(np.isinf(control["cmd_motor_speeds"])):
        return ExitStatus.INF_VALUE
    if np.any(np.isnan(control["cmd_motor_speeds"])):
        return ExitStatus.NAN_VALUE
    if np.linalg.norm(state["v"]) > 100:
        return ExitStatus.OVER_SPEED
    if np.linalg.norm(state["w"]) > 100:
        return ExitStatus.OVER_SPIN
    if np.linalg.norm(state["x"] - flat["x"]) > 20:
        return ExitStatus.FLY_AWAY
    return None


def _traj_end_exit(initial_state, trajectory):
    """Terminate near hover at the trajectory end (``simulate.py:158-187``)."""
    xf = trajectory.update(np.inf)["x"]
    min_time = 1.0 if np.array_equal(initial_state["x"], xf) else 0.0

    def exit_fn(time, state):
        if time >= min_time:
            if (
                np.linalg.norm(state["x"] - xf) < 0.02
                and np.linalg.norm(state["v"]) <= 0.02
            ):
                return ExitStatus.COMPLETE
        return None

    return exit_fn


def simulate(
    initial_state: Dict,
    vehicle: Multirotor,
    controller,
    trajectory,
    t_final: float,
    t_step: float = 1 / 500,
    terminate: Optional[Callable] = None,
):
    """Closed-loop rollout: trajectory → controller → dynamics
    (``simulate.py:18-140`` minus the wind/IMU/mocap/estimator stack the
    reference never exercises).

    Returns (time [N], state dict, control dict, flat dict, exit_status).
    """
    initial_state = {k: np.array(v, dtype=float) for k, v in initial_state.items()}
    if terminate is None:
        normal_exit = _traj_end_exit(initial_state, trajectory)
    elif terminate is False:
        normal_exit = lambda t, s: None
    else:
        normal_exit = terminate

    time = [0.0]
    state = [copy.deepcopy(initial_state)]
    flat = [sanitize_trajectory_dic(trajectory.update(time[-1]))]
    control = [sanitize_control_dic(controller.update(time[-1], state[-1], flat[-1]))]

    exit_status = None
    while True:
        exit_status = exit_status or _safety_exit(state[-1], flat[-1], control[-1])
        exit_status = exit_status or normal_exit(time[-1], state[-1])
        exit_status = exit_status or time_exit(time[-1], t_final)
        if exit_status:
            break
        time.append(time[-1] + t_step)
        state.append(
            vehicle.step(state[-1], control[-1]["cmd_motor_speeds"], t_step)
        )
        flat.append(sanitize_trajectory_dic(trajectory.update(time[-1])))
        control.append(
            sanitize_control_dic(controller.update(time[-1], state[-1], flat[-1]))
        )

    return (
        np.array(time),
        merge_dicts(state),
        merge_dicts(control),
        merge_dicts(flat),
        exit_status,
    )
