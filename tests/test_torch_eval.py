"""The port's offline evaluation (``eval/``) and vehicle model
(``planning/multirotor.py``), held to the JAX package on the CPU.

They are the same host-only numpy code in both packages, so every result
is held exactly (``==`` / ``np.array_equal``, dicts key by key), on the
cases of ``tests/test_eval.py``, ``tests/test_point_cloud.py`` and
``tests/test_multirotor.py`` and on seeded random inputs beside them; the
invariants those files check are checked on the port's results too.
"""

import json

import numpy as np
import pytest
import torch

from apnerf_tpu.eval import frontier as j_fr
from apnerf_tpu.eval import offline_eval as j_off
from apnerf_tpu.eval import point_cloud as j_pc
from apnerf_tpu.eval import voxel_grid as j_vg
from apnerf_tpu.planning import minsnap as j_ms
from apnerf_tpu.planning import multirotor as j_mr
from apnerf_tpu.planning import se3_control as j_se3
from apnerf_tpu.sim.fake import FakeSim as JaxFakeSim
from apnerf_tpu_torch.eval import frontier as t_fr
from apnerf_tpu_torch.eval import offline_eval as t_off
from apnerf_tpu_torch.eval import point_cloud as t_pc
from apnerf_tpu_torch.eval import voxel_grid as t_vg
from apnerf_tpu_torch.ops.rays import pose_matrix_from_quat
from apnerf_tpu_torch.planning import minsnap as t_ms
from apnerf_tpu_torch.planning import multirotor as t_mr
from apnerf_tpu_torch.planning import se3_control as t_se3
from apnerf_tpu_torch.sim.fake import FakeSim

AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run PyTorch on one CPU thread, restored after: the
    suite runs several test processes at once, and many small ops on a
    pool of threads per process oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(a, b, path="out"):
    """Exact equality of nested results (arrays, dicts, sequences, scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, (set, frozenset)):
        assert a == b, path
    elif hasattr(a, "name") and hasattr(a, "value"):  # the two packages' enums
        assert (a.name, a.value) == (b.name, b.value), path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


def _grid_state(vg):
    return dict(pc=vg.get_pointcloud(), initialized=vg.initialized,
                **({"occ": vg.get_occupancy_grid()} if vg.occupancy else {}))


# -- eval/voxel_grid.py ---------------------------------------------------------------------------


def test_bresenhamline_equals_jax():
    cases = [(np.array([[0, 0, 0]]), np.array([[5, 0, 0]])),
             (np.array([[0, 0, 0]]), np.array([[3, 3, 3]]))]
    rng = np.random.RandomState(0)
    cases += [(rng.randint(-20, 20, (1, 3)), rng.randint(-20, 20, (1, 3))) for _ in range(30)]
    for s, e in cases:
        same(t_vg.bresenhamline(s, e), j_vg.bresenhamline(s, e))
    assert list(t_vg.bresenhamline(*cases[0])[-1]) == [5, 0, 0]


@pytest.mark.parametrize("occupancy", [True, False])
def test_voxel_grid_equals_jax(occupancy):
    grids = [m.VoxelGrid(grid_size=20, grid_resolution=0.5, occupancy=occupancy, stride=2)
             for m in (t_vg, j_vg)]
    rng = np.random.RandomState(1)
    depths = [np.full((32, 32), 2.0), rng.uniform(0.5, 6.0, (32, 32)),
              np.where(rng.rand(32, 32) < 0.3, np.nan, rng.uniform(0.5, 6.0, (32, 32)))]
    poses = [np.array([0.0, 1.0, 0.0, 0, 0, 0, 1.0]),
             np.array([0.5, 1.2, -0.3, 0, np.sin(0.4), 0, np.cos(0.4)]),
             np.concatenate([rng.randn(3), rng.randn(4)])]
    for d, p in zip(depths, poses):
        assert grids[0].insert_depth_image(d, p) == grids[1].insert_depth_image(d, p)
        same(_grid_state(grids[0]), _grid_state(grids[1]))
    if occupancy:
        g = grids[0].get_occupancy_grid()
        assert (g == 0).sum() > 0 and (g == 1).sum() > 0 and (g == -1).sum() > 0
    # an all-NaN image inserts nothing in either
    fresh = [m.VoxelGrid(grid_size=20, grid_resolution=0.5, occupancy=False) for m in (t_vg, j_vg)]
    nan = np.full((16, 16), np.nan)
    assert not fresh[0].insert_depth_image(nan, poses[0])
    assert not fresh[1].insert_depth_image(nan, poses[0])
    assert not fresh[0].initialized


# -- eval/frontier.py -----------------------------------------------------------------------------


def test_find_frontiers_and_gt_objects_equal_jax(tmp_path):
    grid = -np.ones((10, 10), dtype=np.int8)
    grid[4:7, 4:7] = 0
    rng = np.random.RandomState(2)
    for g in (grid, rng.randint(-1, 2, (24, 17)).astype(np.int8)):
        same(t_fr.find_frontiers(g), j_fr.find_frontiers(g))
    assert len(t_fr.find_frontiers(grid)) == 8
    p = tmp_path / "objects_test.json"
    json.dump({"1": {"label": 2, "location": [1, 2, 3]},
               "2": {"label": 2, "location": [4, 5, 6]},
               "3": {"label": 0, "location": [0, 0, 0]}}, open(p, "w"))
    same(t_fr.load_gt_objects(str(p), 4), j_fr.load_gt_objects(str(p), 4))


def test_detect_objects_equals_jax():
    depth = np.full((8, 8), 1.0)
    depth[:4] = np.nan
    counts = []
    for m, vgm in ((t_fr, t_vg), (j_fr, j_vg)):
        vg = vgm.VoxelGrid(grid_size=20, grid_resolution=0.1, occupancy=False, stride=1)
        vg.insert_depth_image(depth, np.array([0, 0, 0, 0, 0, 0, 1.0]))
        gt = {0: [[0.0, -0.3, -1.0]], 1: []}
        counts.append(m.detect_objects([vg, vgm.VoxelGrid(20, 0.1, False)], gt,
                                       det_dist_thresh=1.0, cluster_eps=0.5))
    same(*counts)
    assert counts[0][0] >= 1 and counts[0][1] == 0


def test_frontier_exploration_equals_jax():
    out = []
    for m, sim_cls in ((t_fr, FakeSim), (j_fr, JaxFakeSim)):
        sim = sim_cls(aabb=AABB, img_w=32, img_h=32)
        det, occ = m.frontier_exploration(
            sim, np.array([-2.0, 1.5, -2.0]), num_steps=2, num_classes=8,
            gt_obj_locs={i: [] for i in range(8)}, grid_size=20, grid_resolution=0.25,
            max_depth=8.0,
        )
        out.append((det, _grid_state(occ)))
    same(*out)
    g = out[0][1]["occ"]
    assert (g == 1).sum() > 0 and (g == 0).sum() > 0 and len(out[0][0]) >= 1


# -- eval/offline_eval.py -------------------------------------------------------------------------


def test_run_eval_equals_jax(tmp_path):
    sim = FakeSim(aabb=AABB, img_w=32, img_h=32)
    poses, mats = [], []
    for ang in np.linspace(0, 2 * np.pi, 12, endpoint=False):
        p = np.array([-2.0, 1.5, -2.0, 0, np.sin(ang / 2), 0, np.cos(ang / 2)])
        poses.append(p)
        mats.append(pose_matrix_from_quat(p[:3], p[3:]))
    rgbs, depths, sems = sim.sample_images_from_poses(poses)
    npz = tmp_path / "data0.npz"
    np.savez(npz, images=rgbs[..., :3], depths=depths, semantics=sems,
             camtoworlds=np.array(mats), K=sim.K, bootstrap_indices=np.array([]))
    gt = {i: [] for i in range(8)}
    for b in sim.boxes:
        if b.sem >= 4:
            gt[b.sem - 1].append(((b.mn + b.mx) / 2).tolist())
    kw = dict(num_classes=8, num_steps=3, warmup_frames=3, frames_per_step=3,
              det_dist_thresh=1.5, max_depth=8.0)
    curve = t_off.run_eval(str(npz), gt, **kw)
    same(curve, j_off.run_eval(str(npz), gt, **kw))
    assert curve[0] == 0 and np.all(np.diff(curve) >= 0) and curve[-1] >= 1
    for T in mats[:4]:
        same(t_off._pose7_from_matrix(T), j_off._pose7_from_matrix(T))


# -- eval/point_cloud.py --------------------------------------------------------------------------


def _write_test_ply(path):
    """``tests/test_point_cloud.py``'s two triangles, object ids 1 and 7."""
    verts = [(0, 0, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0), (1, 1, 0), (0, 1, 1)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 6\n"
                "property float x\nproperty float y\nproperty float z\n"
                "element face 2\nproperty list uchar int vertex_indices\n"
                "property int object_id\nend_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        f.write("3 0 1 2 1\n3 3 4 5 7\n")


@pytest.mark.parametrize("colors,res", [({1: (1.0, 0.0, 0.0)}, 0.2),
                                        ({1: (0, 1, 0), 7: (0, 0, 1)}, 0.15)])
def test_point_cloud_equals_jax(tmp_path, colors, res):
    mesh = str(tmp_path / "mesh.ply")
    _write_test_ply(mesh)
    same(t_pc.read_ply(mesh), j_pc.read_ply(mesh))
    outs = [str(tmp_path / f"cloud_{k}.ply") for k in "tj"]
    pts, cols = t_pc.build_point_cloud_from_mesh(mesh, colors, out_path=outs[0],
                                                 sampling_resolution=res)
    same((pts, cols), j_pc.build_point_cloud_from_mesh(mesh, colors, out_path=outs[1],
                                                       sampling_resolution=res))
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()
    same(t_pc.read_ply(outs[0]), j_pc.read_ply(outs[0]))
    z = pts[:, 2]
    assert np.all((np.abs(z) < 1e-9) | (np.abs(z + 1) < 1e-9))
    rng = np.random.RandomState(3)
    p, c = rng.randn(50, 3), rng.rand(50, 3)
    t_pc.write_ply_points(outs[0], p, c)
    j_pc.write_ply_points(outs[1], p, c)
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()


# -- planning/multirotor.py -----------------------------------------------------------------------


def _hover_state(veh):
    s = {k: np.array(v, dtype=float) for k, v in veh.initial_state.items()}
    s["rotor_speeds"] = np.full(
        veh.num_rotors, np.sqrt(veh.mass * veh.g / (veh.num_rotors * veh.k_eta)))
    return s


@pytest.mark.parametrize("noise", [0.0, 5.0])
def test_multirotor_steps_equal_jax(noise):
    """``tests/test_multirotor.py``'s single-step cases, and a noisy rollout
    drawn from the same ``rng``: identical states."""
    vehs = [m.Multirotor({"motor_noise_std": noise}, rng=np.random.RandomState(7))
            for m in (t_mr, j_mr)]
    for a in ("mass", "inertia", "inv_inertia", "rotor_geometry", "rotor_dir", "initial_state"):
        same(getattr(vehs[0], a), getattr(vehs[1], a), a)
    rng = np.random.RandomState(4)
    states = [_hover_state(vehs[0]), _hover_state(vehs[1])]
    same(*states)
    w_h = states[0]["rotor_speeds"]
    for v, s in zip(vehs, states):
        s["rotor_speeds"] = np.zeros(4)
    same(*(v.statedot(s, np.zeros(4)) for v, s in zip(vehs, states)))
    same(*(v.step(s, np.full(4, 1e9), 0.01) for v, s in zip(vehs, states)))
    for rates, speeds in (((0, 0, 0), (1000.0,) * 4), ((0.1, -0.2, 0.3), (1200, 1000, 1200, 1000))):
        same(*(v.compute_body_wrench(np.array(rates, float), np.array(speeds, float), np.zeros(3))
               for v in vehs))
    for _ in range(25):
        cmd = w_h + rng.normal(0, 300, 4)
        states = [v.step(s, cmd, 1 / 500) for v, s in zip(vehs, states)]
        same(*states)
    for q, w in ((np.array([0.0, 0, 0, 1]), np.zeros(3)), (rng.randn(4), rng.randn(3))):
        same(t_mr.quat_dot(q, w), j_mr.quat_dot(q, w))


def test_simulate_equals_jax():
    """The closed-loop rollout of ``tests/test_multirotor.py`` (MinSnap +
    SE3 control + dynamics), each package on its own planner stack."""
    points = np.array([[0.0, 0, 0], [0.4, 0.2, 0.1], [0.8, 0.0, 0.2]])
    runs = []
    for ms, se3, mr in ((t_ms, t_se3, t_mr), (j_ms, j_se3, j_mr)):
        traj = ms.MinSnap(points, v_avg=0.5)
        assert traj.initialize()
        veh = mr.Multirotor()
        runs.append(mr.simulate(_hover_state(veh), veh, se3.SE3Control(), traj, t_final=8.0,
                                t_step=1 / 500))
    same(*runs)
    t, state, control, _, status = runs[0]
    assert status in (t_mr.ExitStatus.COMPLETE, t_mr.ExitStatus.TIMEOUT)
    assert np.linalg.norm(state["x"][-1] - points[-1]) < 0.1
    assert control["cmd_motor_speeds"].shape == (len(t), 4)
    dicts = [{"a": np.arange(3)}, {"a": np.arange(3) + 1}]
    same(t_mr.merge_dicts(dicts), j_mr.merge_dicts(dicts))
    assert t_mr.time_exit(5.0, 4.0) is t_mr.ExitStatus.TIMEOUT and t_mr.time_exit(3.0, 4.0) is None
    c = {"cmd_motor_speeds": [[1.0, 2], [3, 4]], "cmd_q": [[0, 0, 0, 1]]}
    same(t_mr.sanitize_control_dic(c), j_mr.sanitize_control_dic(c))
