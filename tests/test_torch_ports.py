"""Parity of the port's small host-side pieces with the JAX package's, on
seeded inputs: the planner copies and the native library (exact
equality: they are copies), ``multistep_lr``, Adam with weight decay and
with the spectrum-only decay against optax, ``RayDataset``'s
``resample_data`` / ``save`` / ``load`` (both packages read what the
other saved), the metrics, FakeSim's planner facade, and the CLI's
defaults.

Tolerances: numpy-only copies compare exactly. The optimizer compares at
rtol 1e-6 / atol 1e-7 (float32, the same formulas in another order).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.native import lib as j_native
from apnerf_tpu.planning import cost_map as j_cm
from apnerf_tpu.planning import dijkstra as j_dj
from apnerf_tpu.planning import minsnap as j_ms
from apnerf_tpu.planning import se3_control as j_se3
from apnerf_tpu.planning import traj as j_traj
from apnerf_tpu.sim import fake as j_fake
from apnerf_tpu.train import schedule as j_sched
from apnerf_tpu.train import step as j_step
from apnerf_tpu.utils import metrics as j_metrics
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.native import lib as t_native
from apnerf_tpu_torch.planning import cost_map as t_cm
from apnerf_tpu_torch.planning import dijkstra as t_dj
from apnerf_tpu_torch.planning import minsnap as t_ms
from apnerf_tpu_torch.planning import se3_control as t_se3
from apnerf_tpu_torch.planning import traj as t_traj
from apnerf_tpu_torch.sim import fake as t_fake
from apnerf_tpu_torch.train import schedule as t_sched
from apnerf_tpu_torch.train import step as t_step
from apnerf_tpu_torch.utils import metrics as t_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.as_tensor(np.array(a))


# -- planner copies ---------------------------------------------------------------------


@pytest.mark.parametrize("start,end", [((4, 4), (6, 10)), ((5, 0), (0, 0)), ((3, 9), (11, 2)),
                                       ((7, 7), (7, 7)), ((0, 5), (9, 6))])
def test_bresenham_equal(start, end):
    np.testing.assert_array_equal(t_cm.bresenham(start, end), j_cm.bresenham(start, end))


def test_cost_map_equal():
    rng = np.random.RandomState(0)
    aabb = np.array([0.0, 0.0, 0.0, 4.0, 4.0, 4.0])
    np.testing.assert_array_equal(t_cm.depth_scan_angles(48), j_cm.depth_scan_angles(48))
    cost_t = cost_j = np.full((20, 20), 0.5)
    for _ in range(3):
        depth = rng.uniform(0.3, 2.5, 16)
        angle = rng.uniform(0, 2 * np.pi, 16)
        w_loc = np.array([rng.uniform(1, 3), 1.0, rng.uniform(1, 3)])
        g_loc = np.array((w_loc - aabb[:3]) // 0.2, dtype=int)
        cost_t, vis_t = t_cm.update_cost_map(cost_t, depth, angle, g_loc, w_loc, aabb, 0.2)
        cost_j, vis_j = j_cm.update_cost_map(cost_j, depth, angle, g_loc, w_loc, aabb, 0.2)
        np.testing.assert_array_equal(cost_t, cost_j)
        np.testing.assert_array_equal(vis_t, vis_j)
    assert (cost_t == 0).sum() > 0 and (cost_t == 1).sum() > 0


@pytest.mark.parametrize("use_native", [False, True])
def test_dijkstra_equal(use_native):
    rng = np.random.RandomState(3)
    pmap = (rng.rand(30, 30) < 0.2).astype(np.int32)
    pmap[2, 2] = pmap[25, 25] = 0
    aabb = np.array([0.0, 0.0, 0.0, 3.0, 3.0, 3.0])
    p_t = t_dj.Dijkstra(aabb, pmap, 0.1, 0.05).planning(0.2, 0.2, 2.5, 2.5, use_native=use_native)
    p_j = j_dj.Dijkstra(aabb, pmap, 0.1, 0.05).planning(0.2, 0.2, 2.5, 2.5, use_native=use_native)
    assert p_t is not None and p_j is not None
    np.testing.assert_array_equal(np.asarray(p_t), np.asarray(p_j))
    wall = np.zeros((10, 10), dtype=np.int32)
    wall[5, :] = 1
    unit = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    assert t_dj.Dijkstra(unit, wall, 0.1, 0.05).planning(0.2, 0.5, 0.8, 0.5) is None


def test_minsnap_and_se3_equal():
    pts = np.array([[0, 0, 1], [1, 0, 1], [2, 1, 1], [3, 1, 1.5]], dtype=float)
    yaw = np.linspace(2 * np.pi, 0, 4)
    m_t, m_j = t_ms.MinSnap(pts, yaw, v_avg=1.0), j_ms.MinSnap(pts, yaw, v_avg=1.0)
    assert m_t.initialize() and m_j.initialize()
    c_t, c_j = t_se3.SE3Control(), j_se3.SE3Control()
    for t in np.linspace(0.0, 3.0, 7):
        f_t, f_j = m_t.update(t), m_j.update(t)
        assert set(f_t) == set(f_j)
        for k in f_t:
            np.testing.assert_array_equal(np.asarray(f_t[k]), np.asarray(f_j[k]))
        r_t, r_j = c_t.update_ref(t, f_t), c_j.update_ref(t, f_j)
        assert set(r_t) == set(r_j)
        for k in r_t:
            np.testing.assert_array_equal(np.asarray(r_t[k]), np.asarray(r_j[k]))


def test_traj_helpers_and_sample_traj_equal():
    b = (np.random.RandomState(1).rand(9, 9) < 0.2).astype(np.int32)
    np.testing.assert_array_equal(t_traj.dilate3x3(b), j_traj.dilate3x3(b))
    x = np.array([0.31, 1.27, 2.05])
    np.testing.assert_array_equal(t_traj.world2voxels(x, 0.2), j_traj.world2voxels(x, 0.2))
    X = Y = 30
    grids = np.zeros((2, X, Y, 16), dtype=bool)
    for g in (grids[:, 0, :, 8], grids[:, -1, :, 8], grids[:, :, 0, 8], grids[:, :, -1, 8]):
        g[...] = True
    grids[:, 12:15, 18:21, 6:10] = True
    kw = dict(voxel_grid=grids, current_state=np.array([3.0, 3.0, 1.5]), N_traj=3,
              aabb=np.array([0.0, 0.0, 0.0, 6.0, 6.0, 3.2]), cost_map=np.full((X, Y), 0.5),
              visiting_map=np.zeros((X, Y)), N_sample_disc=20, voxel_grid_size=0.2)
    tr_t = t_traj.sample_traj(rng=np.random.RandomState(0), **kw)
    tr_j = j_traj.sample_traj(rng=np.random.RandomState(0), **kw)
    assert len(tr_t) == len(tr_j) == 3
    for a, b_ in zip(tr_t, tr_j):
        np.testing.assert_array_equal(a, b_)


def test_native_library_equal_and_built_outside_the_package():
    """The port's loader builds into ``build/``, never beside its source,
    and its entry points give what the JAX package's give."""
    assert t_native.is_available() == j_native.is_available()
    if not t_native.is_available():
        pytest.skip("no C++ compiler on this host: the pure-Python planner runs")
    so = t_native.library_path()
    assert so.exists() and so.parent == t_native.BUILD_DIR
    assert so.parent.resolve() == (os.path.join(REPO, "build") and so.parent.resolve())
    pkg = os.path.join(REPO, "apnerf_tpu_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith((".so", ".o"))]
    assert t_native.backend() == "native"
    rng = np.random.RandomState(5)
    obstacle = (rng.rand(24, 24) < 0.25).astype(np.uint8)
    obstacle[1, 1] = obstacle[20, 20] = 0
    a, b = (m.dijkstra_plan_native(obstacle, 1, 1, 20, 20) for m in (t_native, j_native))
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    ox, oy = np.array([2.0, 3.0, 1.0]), np.array([3.8, 2.0, 0.4])
    occ = [m.raycast_update_native(np.full((20, 20), 0.5), ox, oy, 10, 10, 0.0, 0.0, 0.2)
           for m in (t_native, j_native)]
    np.testing.assert_array_equal(occ[0], occ[1])
    args = (np.array([0.05, 0.12, 0.07]), np.array([0.93, 0.41, 0.88]),
            np.array([0, 1, 0], dtype=np.int32), np.array([9, 4, 8], dtype=np.int32), 0.1)
    np.testing.assert_array_equal(t_native.voxel_traverse_native(*args),
                                  j_native.voxel_traverse_native(*args))


def test_native_fallback_when_unavailable(monkeypatch):
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", True)
    assert t_native.backend() == "python"
    d = t_dj.Dijkstra(np.array([0, 0, 0, 1.0, 1.0, 1.0]), np.zeros((10, 10), np.int32), 0.1, 0.05)
    assert d.planning(0.2, 0.2, 0.8, 0.8) is not None


# -- metrics, FakeSim's facade ------------------------------------------------------------


def test_metrics_equal():
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 6, 6, 3)), rng.random((2, 6, 6, 3))
    logits, labels = rng.normal(size=(2, 6, 6, 5)), rng.integers(0, 5, (2, 6, 6))
    assert t_metrics.psnr(a, b) == j_metrics.psnr(a, b)
    assert t_metrics.psnr(a, a) == float("inf")
    assert t_metrics.depth_mse(a[..., 0], b[..., 0]) == j_metrics.depth_mse(a[..., 0], b[..., 0])
    assert t_metrics.semantic_ce(logits, labels) == j_metrics.semantic_ce(logits, labels)
    pred = np.argmax(logits, -1)
    assert t_metrics.miou(pred, labels, 5) == j_metrics.miou(pred, labels, 5)
    lp = t_metrics.lpips_vgg(a[0], b[0])  # gated: NaN without the lpips package
    assert np.isnan(lp) or lp >= 0


def test_fakesim_facade_equal():
    kw = dict(aabb=(-4.0, 0.0, -4.0, 0.0, 3.0, 0.0), img_w=12, img_h=12, seed=3)
    s_t, s_j = t_fake.FakeSim(**kw), j_fake.FakeSim(**kw)
    assert s_t.num_semantic_classes == s_j.num_semantic_classes
    pose = np.array([-2.0, 1.5, -2.0, 0.0, 0.38, 0.0, 0.92])
    for fn in ("render_tpv", "render_top_tpv"):
        a, b = getattr(s_t, fn)(pose[None]), getattr(s_j, fn)(pose[None])
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for loc in ([-2.0, 1.5, -2.0], [-9.0, 1.5, -2.0], [-1.0, 0.2, -3.0], [-3.5, 1.0, -0.5]):
        assert s_t.check_navigability(loc) == s_j.check_navigability(loc)
    np.testing.assert_array_equal(s_t.sample_path(pose), s_j.sample_path(pose))
    s_t.set_quad_state(pose)
    s_j.set_quad_state(pose)
    np.testing.assert_array_equal(s_t.get_quad_state(), s_j.get_quad_state())
    pt = np.array([-1.0, 1.0, -3.0])
    np.testing.assert_array_equal(s_t.get_2d_point(pt), s_j.get_2d_point(pt))
    s_t.add_visited_location(pt)
    assert len(s_t.visited) == 1
    hard_t, hard_j = t_fake.hard_room(n_clutter=5), j_fake.hard_room(n_clutter=5)
    assert len(hard_t) == len(hard_j) == 11
    for x, y in zip(hard_t, hard_j):
        np.testing.assert_array_equal(x.mn, y.mn)
        np.testing.assert_array_equal(x.color, y.color)
        assert (x.sem, x.tex_freq) == (y.sem, y.tex_freq)


# -- schedule, optimizer -------------------------------------------------------------------


def test_multistep_lr():
    counts = np.arange(0, 120, 7)
    j_sched_fn = j_sched.multistep_lr(6e-3, [30, 80])
    ref = np.array([float(j_sched_fn(jnp.asarray(c))) for c in counts])
    sched = t_sched.multistep_lr(6e-3, [30, 80])
    got = np.array([float(sched(T(c))) for c in counts])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert float(sched(29)) == pytest.approx(6e-3) and float(sched(80)) == pytest.approx(6e-5)


class _Member(torch.nn.Module):
    """A stand-in with the flagship member's parameter names."""

    def __init__(self, tree):
        super().__init__()
        self.main = torch.nn.ParameterDict({k: torch.nn.Parameter(T(v))
                                            for k, v in tree["main"].items()})
        self.prop = torch.nn.ParameterDict({k: torch.nn.Parameter(T(v))
                                            for k, v in tree["prop"].items()})


@pytest.mark.parametrize("option", ["weight_decay", "spectral_spectrum_wd"])
def test_adam_weight_decay_matches_optax(option):
    rng = np.random.default_rng(4)
    tree = {"main": {"W": rng.normal(size=(3, 4)), "phase": rng.normal(size=(4,)),
                     "w0": rng.normal(size=(8, 5))},
            "prop": {"W": rng.normal(size=(3, 2)), "phase": rng.normal(size=(2,))}}
    tree = {k: {n: v.astype(np.float32) for n, v in sub.items()} for k, sub in tree.items()}
    cfg = PipelineConfig(**{option: 0.1})
    from apnerf_tpu_torch.config import PipelineConfig as PortConfig

    j_opt = j_step.make_optimizer(cfg, j_sched.cyclic_lr(6e-4, 6e-3, 2))
    t_opt = t_step.make_optimizer(PortConfig(**{option: 0.1}), t_sched.cyclic_lr(6e-4, 6e-3, 2))
    member = _Member(tree)
    names, params = zip(*member.named_parameters())
    pj, sj = {k: {n: jnp.asarray(v) for n, v in sub.items()} for k, sub in tree.items()}, None
    sj = j_opt.init(pj)
    st = t_opt.init(list(params))
    for _ in range(3):
        g = {k: {n: rng.normal(size=v.shape).astype(np.float32) for n, v in sub.items()}
             for k, sub in tree.items()}
        upd, sj = j_opt.update({k: {n: jnp.asarray(v) for n, v in s.items()} for k, s in g.items()},
                               sj, pj)
        pj = optax.apply_updates(pj, upd)
        grads = [T(g[n.split(".")[0]][n.split(".")[1]]) for n in names]
        st, bad = t_opt.step(list(params), grads, st, names=names)
        assert not bool(bad)
        for n, p in zip(names, params):
            k, leaf = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k][leaf]), rtol=1e-6,
                                       atol=1e-7)
    # the decay did something, and the spectrum-only one only on main.W / main.phase
    plain = t_step.Adam(t_sched.cyclic_lr(6e-4, 6e-3, 2), eps=1e-15)
    assert t_opt.weight_decay == 0.1 and plain.weight_decay == 0.0
    if option == "spectral_spectrum_wd":
        assert [n for n in names if t_opt.decay_mask(n, None)] == ["main.W", "main.phase"]
        with pytest.raises(ValueError, match="names"):
            t_opt.step(list(params), grads, st)


# -- dataset persistence --------------------------------------------------------------------


def _filled(mod, n=10, **kw):
    rng = np.random.default_rng(0)
    ds = mod.RayDataset(True, num_rays=16, num_models=3, width=6, height=5, max_images=32, **kw)
    ds.update_data(rng.integers(0, 255, (n, 5, 6, 3)), rng.random((n, 5, 6)),
                   rng.integers(0, 7, (n, 5, 6)), rng.normal(size=(n, 4, 4)))
    return ds


def _arrays(ds):
    return {k: np.asarray(getattr(ds, k)[: ds.size].cpu() if torch.is_tensor(getattr(ds, k))
                          else getattr(ds, k)[: ds.size])
            for k in ("images", "depths", "semantics", "camtoworlds")}


def test_dataset_resample_matches_jax():
    d_t, d_j = _filled(t_ds, device="cpu"), _filled(j_ds)
    d_t.resample_data()
    d_j.resample_data()
    assert d_t.size == d_j.size == 7
    for k, v in _arrays(d_j).items():
        np.testing.assert_array_equal(_arrays(d_t)[k], v)
    for a, b in zip(d_t.bootstrap_indices, d_j.bootstrap_indices):
        np.testing.assert_array_equal(a, b)
    assert float(d_t.images[7:].sum()) == 0.0


def test_dataset_save_load_cross_packages(tmp_path):
    d_t = _filled(t_ds, device="cpu", save_fp=str(tmp_path / "t"))
    d_j = _filled(j_ds, save_fp=str(tmp_path / "j"))
    p_t, p_j = d_t.save(), d_j.save()
    with np.load(p_t, allow_pickle=True) as a, np.load(p_j, allow_pickle=True) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "bootstrap_indices":
                np.testing.assert_array_equal(a[k], b[k])
    from_j = t_ds.RayDataset.load(p_j, num_models=3, device="cpu")  # the port reads JAX's
    from_t = j_ds.RayDataset.load(p_t, num_models=3)  # JAX reads the port's
    for ds in (from_j, from_t):
        assert ds.size == 10
        for k, v in _arrays(d_j).items():
            np.testing.assert_array_equal(_arrays(ds)[k], v)
        for a, b in zip(ds.bootstrap_indices, d_j.bootstrap_indices):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="save_fp"):
        _filled(t_ds, device="cpu").save()


# -- the CLI ------------------------------------------------------------------------------------


def test_cli_parse_args_defaults():
    from apnerf_tpu.active import pipeline as j_cli
    from apnerf_tpu_torch.active import pipeline as t_cli

    a_t, a_j = vars(t_cli.parse_args([])), vars(j_cli.parse_args([]))
    for k in ("sem_num", "habitat_scene", "habitat_config_file", "sim", "config", "seed", "mesh"):
        assert a_t[k] == a_j[k], k
    assert a_t["device"] == "cuda" and a_t["viz"] is False and a_t["profile"] is None
    assert set(a_t) - set(a_j) == {"device", "viz"}
    assert set(a_j) - set(a_t) == {"platform"}
    assert t_cli.parse_args(["--mesh", "2,1"]).mesh == j_cli.parse_args(["--mesh", "2,1"]).mesh
    got = t_cli.parse_args(["--sim", "fake", "--sem-num", "29", "--device", "cpu", "--seed", "3"])
    assert (got.sim, got.sem_num, got.device, got.seed) == ("fake", 29, "cpu", 3)
    # --sim habitat builds sim/habitat.py's facade, which needs habitat_sim
    with pytest.raises(ImportError, match="habitat_sim is not installed"):
        t_cli.build_mapper(t_cli.parse_args(["--sim", "habitat", "--device", "cpu"]))


def test_cli_builds_the_mapper_as_the_jax_cli_does(tmp_path):
    """``--sem-num 0`` takes FakeSim's own class count, a given count is
    kept; the default device is CUDA and fails without one."""
    from apnerf_tpu_torch.active import pipeline as t_cli

    import yaml

    with open(os.path.join(REPO, "configs", "config_faketiny.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(save_path=str(tmp_path / "runs"))  # the file's own is outside the checkout
    cfg_path = str(tmp_path / "faketiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    m = t_cli.build_mapper(t_cli.parse_args(["--sim", "fake", "--config", cfg_path,
                                             "--device", "cpu"]))
    assert m.cfg.num_semantic_classes == m.sim.num_semantic_classes
    assert m.device.type == "cpu" and m.save_viz is False
    m = t_cli.build_mapper(t_cli.parse_args(["--sim", "fake", "--config", cfg_path,
                                             "--device", "cpu", "--sem-num", "29"]))
    assert m.cfg.num_semantic_classes == 29 and (m.cfg.img_w, m.cfg.num_traj) == (48, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.build_mapper(t_cli.parse_args(["--sim", "fake", "--config", cfg_path]))
