"""The port's replay simulator, its quaternion helper and ``replay_eval``,
held to the JAX package on the CPU.

``quat_xyzw_from_matrix`` and ``ReplaySim`` are the same numpy code in
both packages, so they are held exactly (``==``): the quaternion on
rotations that take each of Shepperd's four branches, and every answer of
``ReplaySim`` on one recording written by the port's ``RayDataset.save``
from a FakeSim tour (the recording of ``tests/test_replay.py``). The
port's mapper then runs ``tests/test_replay.py``'s loop on that recording
with ``device="cpu"``: every supervised camera is a recorded one within
1e-5, before planning and after it. ``replay_eval.main`` runs at cut sizes
and prints one JSON line with finite errors.
"""

import json

import numpy as np
import pytest
import torch

from apnerf_tpu.ops.rays import quat_xyzw_from_matrix as j_quat
from apnerf_tpu.sim.replay import ReplaySim as JaxReplay
from apnerf_tpu_torch.data.dataset import RayDataset
from apnerf_tpu_torch.ops.rays import pose_matrix_from_quat, quat_xyzw_from_matrix
from apnerf_tpu_torch.sim.fake import FakeSim
from apnerf_tpu_torch.sim.replay import ReplaySim

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


def _branch(R):
    """Which of Shepperd's four cases ``quat_xyzw_from_matrix`` takes."""
    if np.trace(R) > 0:
        return 0
    if R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        return 1
    return 2 if R[1, 1] >= R[2, 2] else 3


def _rotations():
    rng = np.random.RandomState(0)
    quats = list(rng.randn(40, 4))
    # half turns about x, y and z take the three trace <= 0 branches
    quats += [np.array(q, float) for q in ((1, 0, 0, 0.05), (0, 1, 0, 0.05), (0, 0, 1, 0.05))]
    return [pose_matrix_from_quat(np.zeros(3), q)[:3, :3] for q in quats]


def test_quat_from_matrix_equals_jax_on_every_branch():
    rots = _rotations()
    assert {_branch(R) for R in rots} == {0, 1, 2, 3}
    for R in rots:
        q = quat_xyzw_from_matrix(R)
        assert np.array_equal(q, j_quat(R))
        # the round trip through the port's inverse, to 1e-12
        np.testing.assert_allclose(pose_matrix_from_quat(np.zeros(3), q)[:3, :3], R,
                                   rtol=0, atol=1e-12)
    # a 4x4 pose is read by its rotation block
    T = pose_matrix_from_quat(np.array([1.0, 2.0, 3.0]), np.array([0.1, 0.7, -0.2, 0.6]))
    assert np.array_equal(quat_xyzw_from_matrix(T), j_quat(T))


def record_tour(tmp, n=14, img=32):
    """``tests/test_replay.py``'s FakeSim ring, written by the port's
    ``RayDataset.save`` → (npz path, [n, 7] poses)."""
    sim = FakeSim(aabb=AABB, img_w=img, img_h=img)
    poses = []
    for i in range(n):
        ang = np.deg2rad(360.0 * i / n)
        pos = np.array([-2.0 + 0.8 * np.cos(ang), 1.5, -2.0 + 0.8 * np.sin(ang)])
        quat = np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)])
        poses.append(np.concatenate([pos, quat]))
    imgs, deps, sems = sim.sample_images_from_poses(poses)
    mats = np.array([pose_matrix_from_quat(p[:3], p[3:]) for p in poses])
    ds = RayDataset(training=True, save_fp=str(tmp), width=img, height=img, max_images=n,
                    device="cpu")
    ds.update_data(imgs[..., :3], deps, sems, mats)
    return ds.save(), np.array(poses)


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    return record_tour(tmp_path_factory.mktemp("rec"))


def test_replay_sim_equals_jax(recording):
    npz, poses = recording
    t, j = ReplaySim(npz, nav_radius=2.0, seed=4), JaxReplay(npz, nav_radius=2.0, seed=4)
    for a in ("images", "depths", "semantics", "camtoworlds", "K", "pose7s", "forwards"):
        assert np.array_equal(getattr(t, a), getattr(j, a)), a
    assert (t.num_semantic_classes, t.img_h, t.img_w) == (j.num_semantic_classes, j.img_h,
                                                          j.img_w)
    rng = np.random.RandomState(1)
    asked = np.concatenate([poses[:, :3] + rng.normal(0, 0.3, (14, 3)),
                            rng.randn(14, 4)], axis=1)
    asked = np.concatenate([poses, asked])
    assert np.array_equal(t.match_indices(asked), j.match_indices(asked))
    assert np.array_equal(t.last_match_err, j.last_match_err)
    assert np.array_equal(t.snap_poses(asked), j.snap_poses(asked))
    for n in (None, 5, 14, 30):
        assert np.array_equal(t.tour_poses(n), j.tour_poses(n))
    for margin in (1.0, 0.0):
        assert np.array_equal(t.aabb_estimate(margin), j.aabb_estimate(margin))
    for p in asked[:, :3]:
        for q in (p, p + np.array([3.0, 0, 0]), [p]):
            assert t.check_navigability(q) == j.check_navigability(q)
    # sample_path draws from the seeded generator: the same seed, the same walks
    for p in asked[:6, :3]:
        assert np.array_equal(t.sample_path(p), j.sample_path(p))
    # observations bit-equal, recorded frames exactly
    got, want = t.sample_images_from_poses(asked), j.sample_images_from_poses(asked)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    data = np.load(npz, allow_pickle=True)
    assert np.array_equal(got[0][:14, ..., :3], data["images"])
    assert np.array_equal(got[0][..., 3], np.full(got[0].shape[:-1], 255, np.uint8))
    for a, b in zip(t.render_tpv(asked[:3]), j.render_tpv(asked[:3])):
        assert np.array_equal(a, b)
    t.set_quad_state(poses[2]), j.set_quad_state(poses[2])
    for pt in (poses[2, :3] - np.array([0, 0, 1.0]), poses[2, :3] + np.array([0.3, 0.1, 2.0])):
        assert np.array_equal(t.get_2d_point(pt), j.get_2d_point(pt))
    assert np.array_equal(t.get_quad_state(), j.get_quad_state())
    with pytest.raises(ValueError, match="inconsistent"):
        ReplaySim({k: data[k][:2] if k == "depths" else data[k]
                   for k in ("images", "depths", "semantics", "camtoworlds", "K")})


def test_mapper_on_replay_supervises_recorded_cameras(recording, tmp_path):
    """``tests/test_replay.py``'s loop on the port's mapper, on the CPU."""
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.config import PipelineConfig

    npz, poses = recording
    rs = ReplaySim(npz, nav_radius=2.0)
    cfg = PipelineConfig(
        save_path=str(tmp_path), aabb=AABB, near_plane=0.1, main_grid_size=0.25,
        planning_step=1, num_traj=2, sample_disc=10, training_steps=10,
        n_ensembles=2, img_w=rs.img_w, img_h=rs.img_h, num_rays=64, max_samples_train=16,
        max_samples_test=16, num_semantic_classes=rs.num_semantic_classes, max_images=64,
        spectral_neurons=32, spectral_freqs_per_level=2, prop_neurons=16,
        test_loc=(tuple(poses[0, :3]), tuple(poses[5, :3])), global_origin=tuple(poses[0]),
    )
    m = ActiveNeRFMapper(cfg, rs, save_path=str(tmp_path / "out"), seed=3, eval_scale=0.25,
                         unc_scale=0.25, max_samples_unc=16, checkpoint_every=10_000,
                         device="cpu")
    m.initialization(initial_samples=6)
    rec = np.array([pose_matrix_from_quat(p[:3], p[3:]) for p in poses])

    def assert_recorded():
        got = m.train_dataset.camtoworlds[: m.train_dataset.size].double().numpy()
        for c2w in got:
            assert min(np.abs(rec - c2w).max(axis=(1, 2))) < 1e-5

    assert_recorded()
    n0 = m.train_dataset.size
    m.nerf_training(10, initial_train=True, planning_step=-1)
    assert m.planning(1, training_steps_per_step=6) >= 1
    assert m.train_dataset.size > n0
    assert np.isfinite(np.asarray(m.errors_hist, dtype=float)).all()
    assert_recorded()


def test_replay_eval_main_prints_finite_rows(recording, tmp_path, capsys):
    from apnerf_tpu_torch import replay_eval

    npz, _ = recording
    rows = replay_eval.main([
        "--npz", npz, "--steps", "6", "--planning-steps", "1", "--init-samples", "4",
        "--holdout", "7", "--num-rays", "32", "--samples", "8", "--out", str(tmp_path / "r"),
        "--aabb", *map(str, AABB), "--device", "cpu",
    ])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["frames"] == 14 and out["held_out_views"] == 2
    assert out["errors"] == rows and len(rows) >= 2
    assert all(np.isfinite([r["psnr"], r["depth_mse"], r["sem_ce"]]).all() for r in rows)
    assert replay_eval.parse_args(["--npz", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            replay_eval.main(["--npz", npz, "--out", str(tmp_path / "c")])
