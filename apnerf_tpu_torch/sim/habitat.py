"""Habitat-Sim backend facade (import-gated).

Same public surface as the reference wrapper (``simulator/sim.py:15-420``):
two agents (quad with rgb + chase-cam sensors; sampling agent with
rgb/depth/semantic sensors), navmesh recompute, quad GLB model, pose-based
observation sampling, chase-cam and top-down visualization renders with
trajectory dots, navmesh path sampling.

Habitat-Sim is an external C++ engine and stays host-side; the device never
sees it (SURVEY.md §2.3). This module imports lazily so the rest of the
framework works without habitat installed — tests use FakeSim.

Port of ``apnerf_tpu/sim/habitat.py``: the same host-only numpy code.
"""

from __future__ import annotations

import numpy as np


def pose7_to_state_quat(pose) -> tuple:
    """[x y z qx qy qz qw] → (position [3], normalized quaternion in
    habitat's (w, x, y, z) order). Pure numpy — the testable core of
    ``_agent_state`` (⇔ reference ``simulator/sim.py:145-151`` which
    normalizes and reorders the same way)."""
    pose = np.asarray(pose, dtype=np.float64)
    pos = pose[:3].copy()
    q = pose[3:7]
    n = np.linalg.norm(q)
    if n == 0:
        raise ValueError("zero quaternion")
    q = q / n
    return pos, np.array([q[3], q[0], q[1], q[2]])


def look_at_quaternion(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Rotation (w, x, y, z) of a camera at ``eye`` looking at ``target``
    with -z forward (the GL/habitat convention). Pure-numpy equivalent of
    ``mn.Quaternion.from_matrix(mn.Matrix4.look_at(...).rotation())`` used
    by the chase cam (⇔ reference ``simulator/sim.py:263-273``)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    back = eye - target  # +z axis (camera looks down -z)
    back = back / np.linalg.norm(back)
    right = np.cross(up, back)
    rn = np.linalg.norm(right)
    if rn < 1e-12:  # looking straight up/down: pick an arbitrary right
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / rn
    true_up = np.cross(back, right)
    R = np.stack([right, true_up, back], axis=1)  # columns = x, y, z axes
    # matrix → quaternion (w, x, y, z), Shepperd's method
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
    return np.array([w, x, y, z])


TOP_DOWN_CAMERA_QUAT = np.array([-7.07106781e-01, 7.07106781e-01, 0.0, 0.0])
"""(w, x, y, z) straight-down camera rotation used by the top-down chase
cam (⇔ reference ``simulator/sim.py:330-333``)."""


def _require_habitat():
    try:
        import habitat_sim  # noqa: F401

        return habitat_sim
    except ImportError as e:  # pragma: no cover - env without habitat
        raise ImportError(
            "habitat_sim is not installed. Install habitat-sim==0.2.5 (conda) "
            "to drive real HSSD scenes, or use apnerf_tpu_torch.sim.fake.FakeSim."
        ) from e


class HabitatSim:
    """Two-agent Habitat wrapper (``simulator/sim.py:15-118``)."""

    def __init__(self, scene, scene_dataset_config_file, img_w, img_h,
                 quad_asset_dir: str = "./simulator/assets/quad"):
        habitat_sim = _require_habitat()
        self._hs = habitat_sim
        self.img_w, self.img_h = img_w, img_h
        self.ex_poses = []

        sim_cfg = habitat_sim.SimulatorConfiguration()
        sim_cfg.scene_id = scene
        if scene_dataset_config_file:
            sim_cfg.scene_dataset_config_file = scene_dataset_config_file
        sim_cfg.pbr_image_based_lighting = True  # sim.py:67

        def cam(uuid, sensor_type, position=(0, 0, 0), orientation=None):
            spec = habitat_sim.CameraSensorSpec()
            spec.uuid = uuid
            spec.sensor_type = sensor_type
            spec.resolution = [img_h, img_w]
            spec.position = list(position)
            if orientation is not None:
                spec.orientation = list(orientation)
            return spec

        ST = habitat_sim.SensorType
        quad_cfg = habitat_sim.agent.AgentConfiguration()
        quad_cfg.sensor_specifications = [
            cam("color_sensor", ST.COLOR),
            cam("third_person_view", ST.COLOR, (0.0, 0.5, 1.0), (-0.5, 0, 0)),
        ]
        sample_cfg = habitat_sim.agent.AgentConfiguration()
        sample_cfg.sensor_specifications = [
            cam("sample_rgb_sensor", ST.COLOR),
            cam("sample_depth_sensor", ST.DEPTH),
            cam("sample_sem_sensor", ST.SEMANTIC),
        ]
        self._sim = habitat_sim.Simulator(
            habitat_sim.Configuration(sim_cfg, [quad_cfg, sample_cfg])
        )
        self.quad_agent = self._sim.initialize_agent(0)
        self.sample_agent = self._sim.initialize_agent(1)

        state = habitat_sim.AgentState()
        state.position = np.zeros(3)
        self.quad_agent.set_state(state)

        self._sim.recompute_navmesh(
            self._sim.pathfinder, habitat_sim.NavMeshSettings()
        )

        # attach the quad model to the agent node (sim.py:46-54)
        try:
            rigid_mgr = self._sim.get_rigid_object_manager()
            tmpl_mgr = self._sim.get_object_template_manager()
            tid = tmpl_mgr.load_configs(quad_asset_dir)[0]
            tmpl = tmpl_mgr.get_template_by_id(tid)
            tmpl.scale = np.array([0.1, 0.1, 0.1])
            tmpl_mgr.register_template(tmpl)
            self.quad_obj = rigid_mgr.add_object_by_template_id(
                tid, self._sim.agents[0].scene_node
            )
        except Exception:
            self.quad_obj = None

    # ---- states ----

    def _agent_state(self, pose):
        habitat_sim = self._hs
        st = habitat_sim.AgentState()
        pos, q_wxyz = pose7_to_state_quat(pose)
        st.position = pos
        import quaternion  # numpy-quaternion, habitat dependency

        st.rotation = quaternion.quaternion(*q_wxyz)
        return st

    def set_quad_state(self, pose):
        self.quad_agent.set_state(self._agent_state(pose))

    def set_sample_state(self, pose):
        self.sample_agent.set_state(self._agent_state(pose))

    def get_quad_state(self):
        st = self.quad_agent.get_state()
        r = st.rotation
        return np.concatenate([np.asarray(st.position), [r.x, r.y, r.z, r.w]])

    def reset(self):
        self.set_quad_state(np.array([0, 0, 0, 0, 0, 0, 1.0]))

    # ---- observation sampling (sim.py:169-200) ----

    def sample_images_from_poses(self, poses):
        self.set_quad_state(np.array([999.0, 999.0, 999.0, 0, 0, 0, 1.0]))
        rgbs, depths, sems = [], [], []
        for pose in poses:
            self.set_sample_state(pose)
            obs = self._sim.get_sensor_observations(1)
            rgbs.append(obs["sample_rgb_sensor"])
            depths.append(obs["sample_depth_sensor"])
            sems.append(obs["sample_sem_sensor"])
        return np.array(rgbs), np.array(depths), np.array(sems)

    # ---- visualization renders (sim.py:247-383) ----

    def _chase_cam_render(self, pose, top_down: bool):
        import magnum as mn

        self.set_quad_state(pose)
        st = self.quad_agent.get_state()
        if top_down:
            cam_pos = np.copy(st.position)
            cam_pos[1] += 3.0
            st.sensor_states["third_person_view"].position = cam_pos
            st.sensor_states["third_person_view"].rotation = np.quaternion(
                *TOP_DOWN_CAMERA_QUAT
            )
        else:
            cam_pos = st.sensor_states["third_person_view"].position
            cam_pos[1] = st.position[1] + 0.5
            rot = look_at_quaternion(cam_pos, st.position)
            st.sensor_states["third_person_view"].position = cam_pos
            st.sensor_states["third_person_view"].rotation = np.quaternion(
                *rot
            )
        self.quad_agent.set_state(st, infer_sensor_states=False)
        return self._sim.get_sensor_observations(0)["third_person_view"]

    def _render_views(self, poses, draw_traj, top_down):
        import cv2

        poses = np.asarray(poses)
        traj = poses[:, :3]
        n = len(traj)
        images = []
        for pose in poses:
            tpv = self._chase_cam_render(pose, top_down)
            if draw_traj:
                traj = traj[1:]
                for i, tp in enumerate(reversed(traj)):
                    pt = self.get_2d_point(tp, "third_person_view")
                    if not (
                        0 <= pt[0] < tpv.shape[1] and 0 <= pt[1] < tpv.shape[0]
                    ):
                        continue
                    c = i / n
                    color = (int((1 - c) * 255), 0, int(c * 255))
                    try:
                        tpv = cv2.circle(tpv, (int(pt[0]), int(pt[1])), 5,
                                         color, -1)
                    except cv2.error as err:  # sim.py:302-307
                        print(f"[Error]: {err}")
            images.append(cv2.cvtColor(tpv, cv2.COLOR_BGR2RGB))
        return images

    def render_tpv(self, poses, draw_traj: bool = True):
        return self._render_views(poses, draw_traj, top_down=False)

    def render_top_tpv(self, poses, draw_traj: bool = True):
        return self._render_views(poses, draw_traj, top_down=True)

    # ---- navmesh ----

    def check_navigability(self, location) -> bool:
        return self._sim.pathfinder.is_navigable(location[0])

    def sample_path(self, curr_loc, max_tries: int = 1000) -> np.ndarray:
        habitat_sim = self._hs
        cl = np.copy(np.asarray(curr_loc, dtype=np.float64))
        cl[2] = cl[1]
        for _ in range(max_tries):
            target = self._sim.pathfinder.get_random_navigable_point()
            path = habitat_sim.ShortestPath()
            cl[1] = target[1]
            path.requested_start = cl
            path.requested_end = target
            if self._sim.pathfinder.find_path(path):
                return np.array(path.points)
        raise RuntimeError("no navigable path found")

    def add_visited_location(self, locations, r: float = 0.001):
        self._sim.add_trajectory_object("final1", locations, radius=r)

    def get_2d_point(self, point_3d, sensor_name):
        import magnum as mn

        cam = self._sim._sensors[sensor_name]._sensor_object.render_camera
        p = cam.projection_matrix.transform_point(
            cam.camera_matrix.transform_point(point_3d)
        )
        pt = mn.Vector2(p[0], -p[1]) / cam.projection_size()[0]
        pt += mn.Vector2(0.5)
        pt *= cam.viewport
        return np.array([pt[0], pt[1]]).astype(int)
