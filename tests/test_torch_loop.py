"""The active mapping loop of the port on FakeSim, on the CPU at a tiny
size, and against the JAX mapper.

Mirrors of ``tests/test_active_pipeline.py`` run on the port with
``device="cpu"`` (initialization, training and evaluation, the planning
loop and its artifacts, checkpoint round trip, resume, both
divergence-guard cases), and the port's mapper held to the JAX mapper
where the result is host-deterministic: the same seed gives the same
initial poses, FakeSim images, cost map and test poses (exact); an
injected occupancy grid gives the same candidate trajectories (exact);
the same parameters give the same evaluation row (rtol 2e-2 on PSNR,
depth MSE and CE: a bf16 field, renders that differ by rounding flips);
a checkpoint written by either package loads in the other with
parameters, Adam moments, counts and step exact.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig as JaxConfig
from apnerf_tpu.sim.fake import FakeSim as JaxFakeSim
from apnerf_tpu_torch import interop
from apnerf_tpu_torch.config import PipelineConfig
from apnerf_tpu_torch.sim.fake import FakeSim

AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)
KW = dict(seed=9, eval_scale=0.25, unc_scale=0.15, max_samples_unc=32, checkpoint_every=10_000)


def tiny_cfg(cls, tmp):
    return cls(
        save_path=str(tmp), aabb=AABB, near_plane=0.1, main_grid_size=0.25,
        planning_step=2, num_traj=2, sample_disc=10, training_steps=40,
        render_step_size=0.05, n_ensembles=2, img_w=48, img_h=48, num_rays=128,
        max_samples_train=24, max_samples_test=48, n_levels=4, base_resolution=4,
        max_resolution=32, geo_feat_dim=7, num_semantic_classes=8, max_images=256,
        occ_warmup_steps=8, spectral_neurons=32, spectral_freqs_per_level=2, prop_neurons=16,
        test_loc=((-2.0, 1.5, -2.0), (-1.0, 1.5, -3.0)),
        global_origin=(-2.0, 1.5, -2.0, 0.0, 0.0, 0.0, 1.0),
    )


def new_mapper(tmp, name, **kw):
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    cfg = tiny_cfg(PipelineConfig, tmp)
    sim = FakeSim(aabb=AABB, img_w=cfg.img_w, img_h=cfg.img_h)
    return ActiveNeRFMapper(cfg, sim, save_path=str(tmp / name), device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("loop")


@pytest.fixture(scope="module")
def mapper(tmp):
    m = new_mapper(tmp, "out", save_viz=True)
    m.initialization(initial_samples=8)
    return m


@pytest.fixture(scope="module")
def jax_mapper(tmp):
    from apnerf_tpu.active.mapper import ActiveNeRFMapper as JaxMapper

    cfg = tiny_cfg(JaxConfig, tmp)
    sim = JaxFakeSim(aabb=AABB, img_w=cfg.img_w, img_h=cfg.img_h)
    m = JaxMapper(cfg, sim, save_path=str(tmp / "jax"), **KW)
    m.initialization(initial_samples=8)
    return m


def test_initialization(mapper):
    assert len(mapper.train_dataset) == 8
    assert len(mapper.test_dataset) == 8  # 2 loc x 4 quat
    # the cost map saw free space around the origin
    assert (mapper.cost_map == 0).sum() > 0
    assert mapper.visiting_map.sum() > 0
    assert mapper.train_dataset.images.device.type == "cpu"


def test_initialization_matches_jax(mapper, jax_mapper):
    """Same seed: the same scan poses, FakeSim observations, cost map,
    visiting map and test poses, exactly."""
    for ds_t, ds_j in ((mapper.train_dataset, jax_mapper.train_dataset),
                       (mapper.test_dataset, jax_mapper.test_dataset)):
        assert ds_t.size == ds_j.size == 8
        for k in ("images", "depths", "semantics", "camtoworlds"):
            np.testing.assert_array_equal(
                getattr(ds_t, k)[:8].numpy(), np.asarray(getattr(ds_j, k)[:8]), err_msg=k)
        for a, b in zip(ds_t.bootstrap_indices, ds_j.bootstrap_indices):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mapper.cost_map, jax_mapper.cost_map)
    np.testing.assert_array_equal(mapper.visiting_map, jax_mapper.visiting_map)
    np.testing.assert_array_equal(mapper._test_poses, jax_mapper._test_poses)
    assert mapper.steps_per_call == jax_mapper.steps_per_call == 40


def test_sample_candidates_match_jax(mapper, jax_mapper):
    """An injected occupancy grid and equal host generators give equal
    candidate trajectories from both planners."""
    res = mapper.cfg.main_grid_resolution
    binaries = np.zeros((2,) + tuple(res), dtype=bool)
    binaries[:, 0], binaries[:, -1] = True, True
    binaries[:, :, :, 0], binaries[:, :, :, -1] = True, True
    binaries[:, 9:11, :, 4:7] = True  # a pillar
    state = mapper.global_origin[:3].copy()
    rng_t, rng_j = mapper.rng, jax_mapper.rng
    try:
        mapper.rng, jax_mapper.rng = np.random.RandomState(5), np.random.RandomState(5)
        c_t = mapper._sample_candidates(binaries, state)
        c_j = jax_mapper._sample_candidates(binaries, state)
    finally:
        mapper.rng, jax_mapper.rng = rng_t, rng_j
    assert len(c_t) == len(c_j) == mapper.cfg.num_traj
    for a, b in zip(c_t, c_j):
        np.testing.assert_array_equal(a, b)


def test_evaluation_row_matches_jax(mapper, jax_mapper):
    """Both mappers evaluate the same parameters on the same test set."""
    saved = mapper.state
    try:
        mapper.members = interop.params_from_jax(
            jax.tree.map(np.asarray, jax_mapper.state.params), "cpu")
        row_t = mapper._evaluate(0)
        row_j = jax_mapper._evaluate(0)
    finally:
        mapper.state = saved
        mapper.errors_hist.clear()
        mapper.metrics_ext_hist.clear()
    assert row_t[0] == row_j[0] == 0.0 and np.isfinite(row_t).all()
    np.testing.assert_allclose(row_t[1:], row_j[1:], rtol=2e-2)
    # the prediction dumps of an evaluation (save_viz is on in this fixture)
    assert os.path.exists(os.path.join(mapper.save_path, "prediction", "p0_0_rgb.png"))


def test_training_reduces_loss_and_evaluates(mapper):
    losses = mapper.nerf_training(60, initial_train=True, planning_step=-1)
    assert len(losses) == 60 and losses[-1] < losses[0]
    assert len(mapper.errors_hist) == 1
    ps, depth_err, sem_ce = mapper.errors_hist[0][1:]
    assert np.isfinite(ps) and np.isfinite(depth_err) and np.isfinite(sem_ce)
    assert mapper.state.step == 60 and len(mapper.learning_rate_lst) == 2
    log = mapper.throughput_log[-1]
    assert log["steps"] == 60 and log["samples_per_sec"] > 0 and "overlapped" not in log
    assert mapper.loss_hist[-1] == losses
    # the occupancy update ran after each chunk
    assert all(bool(o.binaries.any()) for o in mapper.state.occ)


def test_uncertainty_scoring(mapper):
    traj = np.tile(np.array([-2.0, 1.5, -2.0, 0, 0, 0, 1.0]), (40, 1))
    n0 = len(mapper.trajector_uncertainty_list[0])
    pi = mapper.probablistic_uncertainty(traj, step=1)
    assert np.isfinite(pi)
    comps = mapper.trajector_uncertainty_list[0].pop()
    assert len(mapper.trajector_uncertainty_list[0]) == n0
    assert len(comps) == 4 and all(np.isfinite(c) for c in comps)


def test_planning_loop_and_artifacts(mapper):
    n_before = len(mapper.train_dataset)
    evals_before = len(mapper.errors_hist)
    steps = mapper.planning(mapper.cfg.planning_step, training_steps_per_step=20)
    assert steps == 2
    assert len(mapper.train_dataset) == n_before + 40 * steps  # 40 poses per step
    assert mapper.state.step == 60 + 20 * steps
    # evaluation is due after planning step 1 (and not after 2)
    assert [r[0] for r in mapper.errors_hist[evals_before:]] == [1.0]
    assert [e.get("overlapped") for e in mapper.throughput_log[-2:]] == [True, True]
    assert all(len(u) == mapper.cfg.num_traj for u in mapper.trajector_uncertainty_list)
    mapper.save_artifacts()
    out = mapper.save_path
    for rel in ("errors.npy", "uncertainty.npy", "metrics_ext.npy", "throughput.json",
                "checkpoints/model_0.npz", "checkpoints/model_1.npz", "maps"):
        assert os.path.exists(os.path.join(out, rel)), rel
    # per-step viz artifacts in the reference layout
    assert os.path.exists(os.path.join(out, "viz", "0.png"))
    assert os.path.exists(os.path.join(out, "viz", "top", "0.png"))
    for sub in ("gt_rgb", "gt_dep", "gt_sem", "pd_rgb", "pd_dep", "pd_sem", "pd_occ"):
        assert os.path.exists(os.path.join(out, "viz", "fpv", sub, "0.png")), sub
        assert os.path.exists(os.path.join(out, "viz", "fpv", sub, "79.png")), sub
    with open(os.path.join(out, "throughput.json")) as f:
        assert len(json.load(f)) == len(mapper.throughput_log)
    assert np.load(os.path.join(out, "errors.npy")).shape == (len(mapper.errors_hist), 4)
    # the train dataset npz has the reference schema
    npz = glob.glob(os.path.join(out, "train", "data0.npz"))
    assert npz
    data = np.load(npz[0], allow_pickle=True)
    for k in ("images", "depths", "semantics", "camtoworlds", "K", "bootstrap_indices"):
        assert k in data


def test_planning_serial_mode(mapper):
    """Strict alternation: one step, the train phase read back in the call."""
    cfg = mapper.cfg
    n_before, step_before = len(mapper.train_dataset), mapper.state.step
    try:
        mapper.cfg = dataclasses.replace(cfg, planning_step=1)
        mapper.overlap_planning = False
        mapper.trajector_uncertainty_list = [[]]
        assert mapper.planning(1, training_steps_per_step=10) == 1
    finally:
        mapper.cfg, mapper.overlap_planning = cfg, True
        mapper.trajector_uncertainty_list = [[] for _ in range(cfg.planning_step)]
    assert len(mapper.train_dataset) == n_before + 40
    assert mapper.state.step == step_before + 10
    assert "overlapped_host_seconds" in mapper.throughput_log[-1]  # the viz hook ran


def _assert_same_state(a, b):
    assert a.step == b.step
    for ma, mb in zip(a.members, b.members):
        for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), n
    for oa, ob in zip(a.occ, b.occ):
        assert torch.equal(oa.occs, ob.occs) and torch.equal(oa.binaries, ob.binaries)
    for oa, ob in zip(a.opt, b.opt):
        assert torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
        assert int(oa.count) == int(ob.count)


def test_checkpoint_roundtrip(mapper, tmp):
    mapper.save_checkpoints()
    m2 = new_mapper(tmp, "out_2", seed=1)
    assert not torch.equal(m2.members[0].main.W, mapper.members[0].main.W)
    m2.load_checkpoints(os.path.join(mapper.save_path, "checkpoints"))
    # parameters, grids, Adam moments, counts and the step survive exactly
    _assert_same_state(mapper.state, m2.state)
    assert int(m2.state.opt[0].count) > 0 and float(m2.state.opt[0].nu.abs().sum()) > 0
    assert all(p.requires_grad for p in m2.members[0].parameters())


def test_checkpoints_cross_packages(mapper, jax_mapper, tmp):
    """The JAX mapper loads what the port wrote and the port what the JAX
    mapper wrote: parameters, optimizer leaves and step exact."""
    mapper.save_checkpoints()
    jax_mapper.load_checkpoints(os.path.join(mapper.save_path, "checkpoints"))
    assert int(jax_mapper.state.step) == mapper.state.step
    got = jax.tree.map(np.asarray, jax_mapper.state.params)
    for i, member in enumerate(mapper.members):
        for name, p in member.named_parameters():
            node = got
            for key in name.split("."):
                node = node[key]
            np.testing.assert_array_equal(node[i], p.detach().numpy(), err_msg=name)
        leaves_j = [np.asarray(x)[i] for x in jax.tree_util.tree_leaves(jax_mapper.state.opt_state)]
        leaves_t = interop.opt_leaves(member, mapper.state.opt[i])
        assert len(leaves_j) == len(leaves_t)
        for a, b in zip(leaves_t, leaves_j):
            np.testing.assert_array_equal(a, b)
        assert int(leaves_j[0]) == int(mapper.state.opt[i].count) > 0
    np.testing.assert_array_equal(np.asarray(jax_mapper.state.occ.binaries),
                                  mapper.binaries_host())

    # the other way, from a JAX state whose optimizer leaves are all distinct
    rng = np.random.default_rng(0)
    noisy = jax.tree.map(
        lambda x: jnp.asarray(rng.random(x.shape), x.dtype) if x.dtype == jnp.float32
        else jnp.full(x.shape, 17, x.dtype), jax_mapper.state.opt_state)
    jax_mapper.state = jax_mapper.state._replace(opt_state=noisy, step=jnp.asarray(123))
    jax_mapper.save_checkpoints()
    m2 = new_mapper(tmp, "from_jax", seed=4)
    m2.load_checkpoints(os.path.join(jax_mapper.save_path, "checkpoints"))
    assert m2.state.step == 123
    for i, member in enumerate(m2.members):
        leaves_j = [np.asarray(x)[i] for x in jax.tree_util.tree_leaves(noisy)]
        for a, b in zip(interop.opt_leaves(member, m2.state.opt[i]), leaves_j):
            np.testing.assert_array_equal(a, b)
        assert int(m2.state.opt[i].count) == 17
    for a, b in zip(m2.members, mapper.members):
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_resume_continues_training(mapper, tmp):
    """Kill and resume: a fresh mapper that loads the checkpoint keeps
    training, Adam moments intact."""
    mapper.save_checkpoints()
    m2 = new_mapper(tmp, "resume", seed=3)
    m2.load_checkpoints(os.path.join(mapper.save_path, "checkpoints"))
    m2.train_dataset = mapper.train_dataset
    m2.test_dataset = mapper.test_dataset
    m2._test_poses = mapper._test_poses
    step_before = m2.state.step
    count_before = int(m2.state.opt[0].count)
    losses = m2.nerf_training(10, planning_step=1, evaluate=False)
    assert m2.state.step == step_before + 10
    assert int(m2.state.opt[0].count) == count_before + 10
    assert all(np.isfinite(l) for l in losses)


def _nan_members(state):
    with torch.no_grad():
        for m in state.members:
            for p in m.parameters():
                p.mul_(float("nan"))


def _run_guarded_refit(mapper, stub_phase):
    orig, orig_fn, orig_sched = mapper._make_phase, mapper.train_phase_fn, mapper._schedule
    try:
        mapper._make_phase = stub_phase
        return mapper.nerf_training(100, final_train=True, evaluate=False)
    finally:
        mapper._make_phase, mapper.train_phase_fn, mapper._schedule = orig, orig_fn, orig_sched


def test_final_refit_divergence_guard(mapper):
    """A loss explosion in the refit rolls back to the best state and
    restarts at a cut LR. Members update in place here, so the stub ruins
    the live parameters and the guard must bring back its own copy."""
    calls = {"n": 0}
    E = mapper.cfg.n_ensembles
    rollbacks = mapper.refit_rollbacks

    def stub_phase(cfg, schedule=None):
        def phase(state, *args):
            chunk = args[8]
            calls["n"] += 1
            if calls["n"] == 3:
                _nan_members(state)
                return state, torch.full((chunk, E), 1e6)
            loss = 1.0 - 0.01 * calls["n"]
            return state._replace(step=state.step + chunk), torch.full((chunk, E), loss)

        return phase

    losses = _run_guarded_refit(mapper, stub_phase)
    # the exploded chunk was rolled back and redone: no 1e6 in the curve
    assert len(losses) == 100 and max(losses) < 10.0
    assert calls["n"] >= -(-100 // mapper.steps_per_call) + 1
    assert mapper.refit_rollbacks == rollbacks + 1
    assert all(bool(torch.isfinite(p).all()) for m in mapper.members for p in m.parameters())


def test_final_refit_guard_stops_after_repeat_divergence(mapper):
    """Two LR cuts that both diverge again stop the refit at the best state."""
    calls = {"n": 0}
    E = mapper.cfg.n_ensembles

    def stub_phase(cfg, schedule=None):
        def phase(state, *args):
            chunk = args[8]
            calls["n"] += 1
            if calls["n"] >= 2:
                _nan_members(state)
                return state, torch.full((chunk, E), float("nan"))
            return state._replace(step=state.step + chunk), torch.full((chunk, E), 0.5)

        return phase

    losses = _run_guarded_refit(mapper, stub_phase)
    assert len(losses) < 100 and calls["n"] == 4  # one good chunk, three that diverge
    assert all(bool(torch.isfinite(p).all()) for m in mapper.members for p in m.parameters())


def test_mapper_options_that_are_not_ported(tmp):
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    # mark_invisible is ported (tests/test_torch_ngp.py); a pair of field and
    # sampler that neither package wires still raises
    cfg = dataclasses.replace(tiny_cfg(PipelineConfig, tmp), sampler_type="occ")
    with pytest.raises(ValueError, match="supported"):
        ActiveNeRFMapper(cfg, None, save_path=str(tmp / "x"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ActiveNeRFMapper(tiny_cfg(PipelineConfig, tmp), None, save_path=str(tmp / "y"))


@pytest.mark.parametrize("with_variance", [True, False])
def test_renderer_routes_by_device_alone(tmp, monkeypatch, with_variance):
    """Off the CPU a field whose member core takes the combined kernel
    renders through the packed kernels, from its configuration alone (not
    by catching a kernel's refusal); one without semantic classes, which
    the JAX package renders through its plain branch, renders through
    ``spectral.forward`` there too. On the CPU the plain field renders. The
    meta device stands in for the card."""
    from apnerf_tpu_torch.active import mapper as mapper_mod

    seen = []

    def capture(field_fn, prop_fn, rays_o, rays_d, aabb, **kw):
        seen.append((kw["field_packed_fn"] is not None, kw["field_packed_vr_fn"] is not None))
        return {"rgb": torch.zeros(rays_o.shape[0], 3, device=rays_o.device)}

    monkeypatch.setattr(mapper_mod, "render_rays_prop", capture)
    for classes in (8, 0):
        cfg = dataclasses.replace(tiny_cfg(PipelineConfig, tmp), num_semantic_classes=classes)
        m = mapper_mod.ActiveNeRFMapper(cfg, None, save_path=str(tmp / "route"), device="cpu",
                                        **KW)
        for device, packed in (("cpu", False), ("meta", classes > 0)):
            m.device = torch.device(device)
            render = m._build_ensemble_renderer(16, with_variance=with_variance)
            rays = torch.zeros(1, 4, 3, device=device)
            seen.clear()
            out = render(m.members, m.occ, rays, rays, torch.ones(3, device=device))
            assert out["rgb"].shape == (2, 1, 4, 3)
            assert seen == [(packed and with_variance, packed and not with_variance)] * 2


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_unsupported_field_raises_on_the_card(tmp):
    """A field at widths the packed kernels do not take (here 8 frequencies
    and a 32-wide trunk) raises on the card: no render falls back to the
    plain field there."""
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    cfg = tiny_cfg(PipelineConfig, tmp)
    m = ActiveNeRFMapper(cfg, None, save_path=str(tmp / "card"), device="cuda", **KW)
    rays = m._pose7_to_grid_rays(np.asarray([m.global_origin]), 4, 4)
    for render in (m._render_unc, m._render_eval):
        with pytest.raises(ValueError):
            render(m.members, m.occ, rays.origins, rays.viewdirs, torch.ones(3, device="cuda"))
