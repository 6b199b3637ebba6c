"""Geometric SE(3) differential-flatness feed-forward controller.

Capability parity with rotorpy's ``SE3Control.update_ref``
(``planning/rotorpy/rotorpy/controllers/quadrotor_control.py:66-186``):
from flat outputs (accel/jerk/snap, yaw and derivatives) compute the
reference attitude quaternion cmd_q, body rates cmd_w, angular acceleration
cmd_a, thrust, moments, and motor speeds under the perfect-tracking
assumption (R = R_des). The feedback ``update`` (``:188-275``) is included
for full API parity.

The pipeline consumes only cmd_q (``planning_funcs.py:357-388``).
Quaternion math is implemented locally (xyzw convention, matching scipy).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Crazyflie 2.0 physical constants (public bitcraze data, same sources as
# rotorpy/vehicles/crazyflie_params.py:16-64)
_D = 0.043
_S2 = 0.70710678118
CRAZYFLIE_PARAMS = {
    "mass": 0.03,
    "Ixx": 1.43e-5, "Iyy": 1.43e-5, "Izz": 2.89e-5,
    "Ixy": 0.0, "Ixz": 0.0, "Iyz": 0.0,
    "num_rotors": 4,
    "rotor_pos": {
        "r1": _D * np.array([_S2, _S2, 0]),
        "r2": _D * np.array([_S2, -_S2, 0]),
        "r3": _D * np.array([-_S2, -_S2, 0]),
        "r4": _D * np.array([-_S2, _S2, 0]),
    },
    "k_eta": 2.3e-08,
    "k_m": 7.8e-10,
    "rotor_speed_min": 0,
    "rotor_speed_max": 2500,
}


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def _matrix_from_quat(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) → rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )


class SE3Control:
    G = 9.81

    def __init__(self, quad_params: Dict = CRAZYFLIE_PARAMS):
        p = quad_params
        self.mass = p["mass"]
        self.inertia = np.array(
            [
                [p["Ixx"], p["Ixy"], p["Ixz"]],
                [p["Ixy"], p["Iyy"], p["Iyz"]],
                [p["Ixz"], p["Iyz"], p["Izz"]],
            ]
        )
        self.k_eta, self.k_m = p["k_eta"], p["k_m"]
        self.num_rotors = p["num_rotors"]
        k = self.k_m / self.k_eta
        cols = [
            np.cross(p["rotor_pos"][key], np.array([0, 0, 1.0]))[:2].reshape(-1, 1)
            for key in p["rotor_pos"]
        ]
        self.f_to_TM = np.vstack(
            [
                np.ones((1, self.num_rotors)),
                np.hstack(cols),
                np.array(
                    [k * (-1) ** i for i in range(self.num_rotors)]
                ).reshape(1, -1),
            ]
        )
        self.TM_to_f = np.linalg.inv(self.f_to_TM)
        # feedback gains (quadrotor_control.py:52-55)
        self.kp_pos = np.array([6.5, 6.5, 15])
        self.kd_pos = np.array([4.0, 4.0, 9])
        self.kp_att = 544.0
        self.kd_att = 46.64

    def update_ref(self, t: float, flat: Dict) -> Dict:
        """Reference commands from flat outputs, perfect-tracking
        (``quadrotor_control.py:66-186``)."""
        e3 = np.array([0.0, 0.0, 1.0])
        acc = np.asarray(flat["x_ddot"], dtype=np.float64) + self.G * e3
        F_des = self.mass * acc
        u1 = np.linalg.norm(F_des)
        b3 = acc / np.linalg.norm(acc)
        yaw = float(flat["yaw"])
        c1 = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        b2 = np.cross(b3, c1)
        b2 = b2 / np.linalg.norm(b2)
        b1 = np.cross(b2, b3)
        R_des = np.stack([b1, b2, b3]).T

        jerk = np.asarray(flat["x_dddot"], dtype=np.float64)
        snap = np.asarray(flat["x_ddddot"], dtype=np.float64)
        dot_u1 = float(np.dot(b3, self.mass * jerk))
        hw = self.mass / u1 * jerk
        p = float(np.dot(-hw, b2))
        q = float(np.dot(hw, b1))
        r = (
            (1 - np.dot(e3, b1) ** 2) * flat["yaw_dot"]
            - np.dot(e3, b2) * q
        ) / np.dot(e3, b3)
        omega = np.array([p, q, r])
        pq_dot = (
            self.mass / u1 * (np.stack([-b2, b1]) @ snap.reshape(-1, 1))
            - 2 * dot_u1 / u1 * np.vstack([p, q])
            + r * np.vstack([q, -p])
        ).flatten()
        b_dot = R_des @ _skew(omega)
        r_dot = -(
            np.dot(e3, b_dot[:, 2]) * r
            + np.dot(e3, b_dot[:, 1]) * q
            + np.dot(e3, b2) * pq_dot[1]
            + 2 * np.dot(e3, b1) * np.dot(e3, b_dot[:, 0]) * flat["yaw_dot"]
            + (np.dot(e3, b1) ** 2 - 1) * flat.get("yaw_ddot", 0.0)
        ) / np.dot(e3, b3)
        alpha = np.array([pq_dot[0], pq_dot[1], r_dot])

        u2 = self.inertia @ alpha + np.cross(omega, self.inertia @ omega)
        TM = np.array([u1, u2[0], u2[1], u2[2]])
        forces = self.TM_to_f @ TM
        speeds = np.sign(forces) * np.sqrt(np.abs(forces) / self.k_eta)
        return {
            "cmd_motor_speeds": speeds,
            "cmd_thrust": u1,
            "cmd_moment": u2,
            "cmd_q": _quat_from_matrix(R_des),
            "cmd_w": omega,
            "cmd_a": alpha,
        }

    def update(self, t: float, state: Dict, flat: Dict) -> Dict:
        """Geometric SE(3) feedback (``quadrotor_control.py:188-275``):
        PD position error → desired force; thrust = projection on the
        CURRENT body z; attitude error via the vee map; moments from
        attitude/rate PD. Unlike ``update_ref`` this stabilizes the true
        attitude dynamics."""
        x = np.asarray(state["x"], dtype=np.float64)
        v = np.asarray(state["v"], dtype=np.float64)
        q = np.asarray(state["q"], dtype=np.float64)
        w = np.asarray(state["w"], dtype=np.float64)

        pos_err = x - np.asarray(flat["x"], dtype=np.float64)
        vel_err = v - np.asarray(flat["x_dot"], dtype=np.float64)
        F_des = self.mass * (
            -self.kp_pos * pos_err
            - self.kd_pos * vel_err
            + np.asarray(flat["x_ddot"], dtype=np.float64)
            + np.array([0.0, 0.0, self.G])
        )

        R = _matrix_from_quat(q)
        b3 = R @ np.array([0.0, 0.0, 1.0])
        u1 = float(np.dot(F_des, b3))

        b3_des = F_des / np.linalg.norm(F_des)
        yaw = float(flat["yaw"])
        c1 = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        b2_des = np.cross(b3_des, c1)
        b2_des = b2_des / np.linalg.norm(b2_des)
        b1_des = np.cross(b2_des, b3_des)
        R_des = np.stack([b1_des, b2_des, b3_des]).T

        S_err = 0.5 * (R_des.T @ R - R.T @ R_des)
        att_err = np.array([-S_err[1, 2], S_err[0, 2], -S_err[0, 1]])
        w_des = np.array([0.0, 0.0, float(flat["yaw_dot"])])
        w_err = w - w_des
        u2 = self.inertia @ (-self.kp_att * att_err - self.kd_att * w_err)

        TM = np.array([u1, u2[0], u2[1], u2[2]])
        forces = self.TM_to_f @ TM
        speeds = np.sign(forces) * np.sqrt(np.abs(forces) / self.k_eta)
        return {
            "cmd_motor_speeds": speeds,
            "cmd_thrust": u1,
            "cmd_moment": u2,
            "cmd_q": _quat_from_matrix(R_des),
        }
