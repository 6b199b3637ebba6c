"""The planning step as a whole: the JAX mapper against the port's mapper
with the same weights, on the CPU at a tiny size.

Both mappers render one candidate trajectory in 40 views with each of the
two members (with variance) and score it by predictive information.
Tolerances on the four PI terms: 1e-5 relative for a float32 field
(same algorithm, different summation orders; measured <= 7e-7) and 2e-3
relative for the shipping bf16 field (bf16 rounding flips of individual
features, see ``tests/test_torch_fields.py``; measured <= 1.4e-4).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu_torch.interop import load_member_npz, params_from_jax

AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = [
    "apnerf_tpu_torch",
    "apnerf_tpu_torch.config",
    "apnerf_tpu_torch.interop",
    "apnerf_tpu_torch.ops.rays",
    "apnerf_tpu_torch.ops.sh",
    "apnerf_tpu_torch.ops.grid_march",
    "apnerf_tpu_torch.ops.hashgrid",
    "apnerf_tpu_torch.ops.volrend",
    "apnerf_tpu_torch.ops.pdf",
    "apnerf_tpu_torch.ops.occupancy",
    "apnerf_tpu_torch.ops.cuda.build",
    "apnerf_tpu_torch.ops.cuda.fused_mlp",
    "apnerf_tpu_torch.ops.cuda.volrend_cuda",
    "apnerf_tpu_torch.ops.cuda.fused_field_volrend",
    "apnerf_tpu_torch.ops.cuda.fused_field_heads",
    "apnerf_tpu_torch.ops.cuda.launch",
    "apnerf_tpu_torch.ops.cuda.field_train",
    "apnerf_tpu_torch.models.nn",
    "apnerf_tpu_torch.models.ngp",
    "apnerf_tpu_torch.models.spectral",
    "apnerf_tpu_torch.models.propnet",
    "apnerf_tpu_torch.models.mlp",
    "apnerf_tpu_torch.ops.contraction",
    "apnerf_tpu_torch.ops.cameras",
    "apnerf_tpu_torch.data.nerf_synthetic",
    "apnerf_tpu_torch.data.dnerf_synthetic",
    "apnerf_tpu_torch.data.colmap",
    "apnerf_tpu_torch.data.nerf_360",
    "apnerf_tpu_torch.train.examples",
    "apnerf_tpu_torch.train_ngp_occ",
    "apnerf_tpu_torch.render.prop_renderer",
    "apnerf_tpu_torch.render.renderer",
    "apnerf_tpu_torch.quality",
    "apnerf_tpu_torch.train.schedule",
    "apnerf_tpu_torch.train.step",
    "apnerf_tpu_torch.train.phase",
    "apnerf_tpu_torch.train.flagship",
    "apnerf_tpu_torch.data.dataset",
    "apnerf_tpu_torch.sim.fake",
    "apnerf_tpu_torch.bench",
    "apnerf_tpu_torch.active.uncertainty",
    "apnerf_tpu_torch.active.mapper",
    "apnerf_tpu_torch.active.pipeline",
    "apnerf_tpu_torch.planning.cost_map",
    "apnerf_tpu_torch.planning.dijkstra",
    "apnerf_tpu_torch.planning.minsnap",
    "apnerf_tpu_torch.planning.se3_control",
    "apnerf_tpu_torch.planning.traj",
    "apnerf_tpu_torch.native",
    "apnerf_tpu_torch.native.lib",
    "apnerf_tpu_torch.utils.metrics",
    "apnerf_tpu_torch.sim.base",
    "apnerf_tpu_torch.viz.render_views",
    "apnerf_tpu_torch.viz.make_video",
    "apnerf_tpu_torch.viz.interactive",
    "apnerf_tpu_torch.sim.replay",
    "apnerf_tpu_torch.sim.habitat",
    "apnerf_tpu_torch.replay_eval",
    "apnerf_tpu_torch.eval",
    "apnerf_tpu_torch.eval.voxel_grid",
    "apnerf_tpu_torch.eval.point_cloud",
    "apnerf_tpu_torch.eval.frontier",
    "apnerf_tpu_torch.eval.offline_eval",
    "apnerf_tpu_torch.planning.multirotor",
    "apnerf_tpu_torch.parallel",
    "apnerf_tpu_torch.parallel.mesh",
    "apnerf_tpu_torch.parallel.launch",
    "apnerf_tpu_torch.parallel.sharding",
    "apnerf_tpu_torch.parallel.runs",
    "apnerf_tpu_torch.dryrun",
    "chip_smoke",
]


def tiny_cfg(tmp):
    return PipelineConfig(
        save_path=str(tmp), aabb=AABB, near_plane=0.1, main_grid_size=0.25,
        planning_step=2, num_traj=2, sample_disc=10, img_w=48, img_h=48,
        max_samples_test=48, n_levels=4, base_resolution=4, max_resolution=32,
        geo_feat_dim=7, num_semantic_classes=8, spectral_neurons=32,
        spectral_freqs_per_level=2, prop_neurons=16, n_ensembles=2,
        render_step_size=0.05, occ_warmup_steps=8,
        global_origin=(-2.0, 1.5, -2.0, 0.0, 0.0, 0.0, 1.0),
    )


def trajectory(n=30, seed=0):
    """A synthetic [n, 7] flight through the box, yawing as it goes."""
    rng = np.random.default_rng(seed)
    pos = np.linspace([-3.2, 1.4, -3.0], [-0.8, 1.6, -1.2], n) + rng.normal(0, 0.02, (n, 3))
    yaw = np.linspace(0, 2 * np.pi, n)
    quat = np.stack([np.zeros(n), np.sin(yaw / 2), np.zeros(n), np.cos(yaw / 2)], -1)
    return np.hstack([pos, quat])


@pytest.fixture(scope="module")
def mappers(tmp_path_factory):
    from apnerf_tpu.active.mapper import ActiveNeRFMapper as JaxMapper
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper as TorchMapper

    tmp = tmp_path_factory.mktemp("slice")
    cfg = tiny_cfg(tmp)
    kw = dict(seed=9, unc_scale=0.15, max_samples_unc=32)
    jm = JaxMapper(cfg, None, save_path=str(tmp / "jax"), **kw)
    tm = TorchMapper(cfg, None, save_path=str(tmp / "torch"), device="cpu", **kw)
    tm.members = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    return jm, tm


def _set_dtype(m, dtype):
    m.spectral_cfg = m.spectral_cfg._replace(compute_dtype=dtype)
    m.prop_cfg = m.prop_cfg._replace(compute_dtype=dtype)
    m._render_unc = m._build_ensemble_renderer(m.max_samples_unc, with_variance=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_uncertainty_matches_jax(mappers, dtype):
    jm, tm = mappers
    for m in (jm, tm):
        _set_dtype(m, dtype)
    traj = trajectory()
    pj = [float(v) for v in jm.dispatch_uncertainty(traj)]
    pt = [float(v) for v in tm.dispatch_uncertainty(traj)]
    assert all(np.isfinite(pt)) and all(abs(v) > 0 for v in pt)
    rel = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(pt, pj, rtol=rel, atol=1e-7)


def test_renderer_without_variance_matches_jax(mappers):
    """The no-variance ensemble renderer (the eval render's), float32."""
    jm, tm = mappers
    for m in (jm, tm):
        _set_dtype(m, "float32")
    n = jm.cfg.max_samples_test
    rj = jm._pose7_to_rays(trajectory()[:3], 0.15)
    rt = tm._pose7_to_rays(trajectory()[:3], 0.15)
    bk = np.ones(3, np.float32)
    oj = jm._build_ensemble_renderer(n, with_variance=False)(
        jm.state.params, jm.state.occ, rj.origins, rj.viewdirs, bk
    )
    ot = tm._build_ensemble_renderer(n, with_variance=False)(
        tm.members, tm.occ, rt.origins, rt.viewdirs, torch.ones(3)
    )
    assert set(ot) == set(oj) and "rgb_var" not in ot
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=1e-4, atol=1e-5)


def test_candidate_rays_match_jax(mappers):
    jm, tm = mappers
    poses = trajectory()[:5]
    rj, rt = jm._pose7_to_rays(poses, 0.15), tm._pose7_to_rays(poses, 0.15)
    np.testing.assert_allclose(rt.origins.numpy(), np.asarray(rj.origins), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt.viewdirs.numpy(), np.asarray(rj.viewdirs), rtol=1e-5, atol=1e-6)
    gj, gt = jm._pose7_to_grid_rays(poses, 6, 8), tm._pose7_to_grid_rays(poses, 6, 8)
    np.testing.assert_allclose(gt.viewdirs.numpy(), np.asarray(gj.viewdirs), rtol=1e-5, atol=1e-6)


def test_score_candidates_picks_the_most_informative(mappers):
    _, tm = mappers
    _set_dtype(tm, "bfloat16")
    cands = [trajectory(30, seed=s) for s in range(3)]
    cands[1] = cands[1].copy()
    cands[1][:, :3] += [0.0, 0.0, 5.0]  # flies outside the box: empty views
    n_before = len(tm.trajector_uncertainty_list[0])
    chosen, fly = tm._score_candidates(cands, 1)
    comps = np.asarray(tm.trajector_uncertainty_list[0][n_before:])
    assert comps.shape == (3, 4) and np.isfinite(comps).all()
    best = int(np.argmax(comps.sum(axis=1)))
    assert chosen is cands[best] and fly.shape == (40, 7)


def test_sample_candidates_runs_the_planner(mappers):
    _, tm = mappers
    binaries = np.zeros((2,) + tuple(tm.occ[0].binaries.shape), bool)
    cands = tm._sample_candidates(binaries, tm.global_origin[:3].copy())
    assert len(cands) == tm.cfg.num_traj
    assert all(c.shape[1] == 7 and np.isfinite(c).all() for c in cands)


def test_load_member_npz_roundtrip(mappers):
    """A JAX-written checkpoint (``save_checkpoints``) loads into the port
    with numpy only: every parameter and both occupancy arrays identical,
    through ``load_member_npz`` and through ``load_checkpoints``."""
    jm, _ = mappers
    jm.save_checkpoints()
    ckpt = os.path.join(jm.save_path, "checkpoints")
    member, occs, binaries = load_member_npz(os.path.join(ckpt, "model_0.npz"))
    ref = jax.tree.map(lambda a: np.asarray(a)[0], jm.state.params)
    got = {k: v.numpy() for k, v in member.state_dict().items()}
    flat = {
        ".".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]
    }
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    np.testing.assert_array_equal(occs.numpy(), np.asarray(jm.state.occ.occs[0]))
    np.testing.assert_array_equal(binaries.numpy(), np.asarray(jm.state.occ.binaries[0]))

    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    tm2 = ActiveNeRFMapper(jm.cfg, None, save_path=jm.save_path + "_t", device="cpu")
    tm2.load_checkpoints(ckpt)
    for a, b in zip(tm2.members[1].parameters(), params_from_jax(
            jax.tree.map(np.asarray, jm.state.params))[1].parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert tm2.occ[1].binaries.dtype == torch.bool


def test_ngp_occ_path_not_ported(tmp_path):
    """The (ngp, occ) oracle path is ported: the mapper builds it; every
    pair but it and (spectral, prop) still raises."""
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.models.ngp import NGPField

    cfg = dataclasses.replace(tiny_cfg(tmp_path), field_type="ngp", sampler_type="occ")
    m = ActiveNeRFMapper(cfg, None, save_path=str(tmp_path / "o"), device="cpu")
    assert all(isinstance(f, NGPField) for f in m.members)
    for pair in (("ngp", "prop"), ("spectral", "occ")):
        cfg = dataclasses.replace(tiny_cfg(tmp_path), field_type=pair[0], sampler_type=pair[1])
        with pytest.raises(ValueError, match="supported"):
            ActiveNeRFMapper(cfg, None, save_path=str(tmp_path / "o"), device="cpu")


def test_port_config_is_the_pipeline_config():
    """The port keeps its own copy of the config: another class with the
    same fields, types and defaults, whose ``load_scene_config`` loads
    every ``configs/*.yaml`` to the values the JAX package's loads."""
    import glob

    from apnerf_tpu.config import load_scene_config as jax_load
    from apnerf_tpu_torch.config import PipelineConfig as PortConfig
    from apnerf_tpu_torch.config import load_scene_config as port_load

    assert PortConfig is not PipelineConfig
    assert PortConfig.__module__ == "apnerf_tpu_torch.config"
    fields = lambda c: [(f.name, f.type, f.default) for f in dataclasses.fields(c)]
    assert fields(PortConfig) == fields(PipelineConfig)
    yamls = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(yamls) >= 5
    for path in yamls:
        a, b = dataclasses.asdict(jax_load(path)), dataclasses.asdict(port_load(path))
        assert a == b, path
        assert dataclasses.asdict(jax_load(path, num_semantic_classes=7)) == dataclasses.asdict(
            port_load(path, num_semantic_classes=7))
    cfg_j, cfg_t = jax_load(yamls[0]), port_load(yamls[0])
    assert cfg_t.main_grid_resolution == cfg_j.main_grid_resolution
    assert cfg_t.focal == cfg_j.focal
    for ps in (-10, -1, 0, 4, 5, 9):
        assert cfg_t.occ_thre_for_phase(ps) == cfg_j.occ_thre_for_phase(ps)


def test_port_sources_import_nothing_of_the_jax_package():
    """No file of the port, nor ``chip_smoke.py``, has an import line that
    names ``jax`` or ``apnerf_tpu`` (``apnerf_tpu_torch`` is the port)."""
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|apnerf_tpu)(?![\w])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "apnerf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert pat.search("from apnerf_tpu.config import x") and pat.search("  import jax.numpy")
    assert not pat.search("from apnerf_tpu_torch.config import x")


def test_slice_modules_import_no_jax():
    """Every slice module imports without JAX and without anything of the
    JAX package (a fresh interpreter: this one already holds both)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'optax', 'apnerf_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'optax.', 'apnerf_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'apnerf_tpu_torch.active.pipeline' in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
