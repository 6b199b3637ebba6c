"""The mesh-mode mapper, ``--mesh`` and the dry run of the port
(``apnerf_tpu_torch/active/mapper.py``'s ``mesh=``,
``active/pipeline.py``, ``dryrun.py``) on the CPU, ``gloo`` ranks started
by ``parallel/launch.py``.

The loop is ``tests/test_torch_loop.py``'s tiny configuration cut to one
planning step of 12 train steps (12 + 12 + 60 refit steps), on an
8-view scan, run whole by ``pipeline()``: unsharded in this process on
one PyTorch thread (as every rank runs), then on a (2, 1) and a (2, 2)
mesh. Checks, each with its tolerance:
  * (2, 1): every rank's evaluation rows, losses, predictive information,
    supervised cameras and images and final members equal the unsharded
    loop's, bit for bit (a rank does its member's unsharded arithmetic);
  * (2, 2): the same cameras and observations exactly (the chosen
    trajectory is a discrete choice the data split does not move here),
    and the evaluation rows within rtol 5e-2 (PSNR, depth MSE, CE of a
    bf16 field trained 84 steps on gradients averaged over two halves of
    its rays, whose rounding Adam amplifies where a gradient is near zero;
    at 140 steps the semantic CE of the last row read 2.3e-2 off);
  * on every mesh, every rank saw the same observations and holds the
    same results;
  * rank 0's checkpoints load into an unsharded mapper with every member's
    parameters, Adam moments, grids and step bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from apnerf_tpu_torch.config import PipelineConfig
from apnerf_tpu_torch.parallel import runs
from apnerf_tpu_torch.parallel.launch import launch
from apnerf_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)
KW = dict(seed=9, eval_scale=0.25, unc_scale=0.15, max_samples_unc=32, checkpoint_every=10_000)


def _cfg(tmp):
    return PipelineConfig(
        save_path=str(tmp), aabb=AABB, near_plane=0.1, main_grid_size=0.25,
        planning_step=1, num_traj=2, sample_disc=10, training_steps=12,
        render_step_size=0.05, n_ensembles=2, img_w=48, img_h=48, num_rays=128,
        max_samples_train=24, max_samples_test=48, n_levels=4, base_resolution=4,
        max_resolution=32, geo_feat_dim=7, num_semantic_classes=8, max_images=256,
        occ_warmup_steps=8, spectral_neurons=32, spectral_freqs_per_level=2, prop_neurons=16,
        test_loc=((-2.0, 1.5, -2.0), (-1.0, 1.5, -3.0)),
        global_origin=(-2.0, 1.5, -2.0, 0.0, 0.0, 0.0, 1.0),
    )


def _job(tmp, name):
    cfg = _cfg(tmp)
    return dict(cfg=cfg, save_path=str(tmp / name),
                sim=dict(aabb=AABB, img_w=cfg.img_w, img_h=cfg.img_h), **KW)


bits = runs.same_bits  # an array (or a rank's digest of one) against an array


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = runs.loop_job(Mesh.single(), **_job(tmp, "single"))
    finally:
        torch.set_num_threads(n)
    return tmp, ref, {
        shape: launch(runs.jobs, *shape, [(runs.loop_job, _job(tmp, f"mesh{shape[0]}{shape[1]}"))],
                      device="cpu", quiet=True, timeout=300)
        for shape in ((2, 1), (2, 2))
    }


def _ranks(loops, shape):
    return [r[0] for r in loops[2][shape]]


def test_every_rank_sees_the_same_loop(loops):
    for shape in ((2, 1), (2, 2)):
        ranks = _ranks(loops, shape)
        for r in ranks[1:]:  # the gathered members travel back as digests
            for k in ("images", "camtoworlds", "errors_hist", "params", "occs"):
                assert bits(r[k], ranks[0][k]), (shape, k)
            assert r["loss_hist"] == ranks[0]["loss_hist"]
            assert r["uncertainty"] == ranks[0]["uncertainty"]


def test_mesh_2_1_repeats_the_unsharded_loop(loops):
    _, ref, _ = loops
    r = _ranks(loops, (2, 1))[0]
    assert len(ref["errors_hist"]) == 3 and np.isfinite(ref["errors_hist"]).all()
    for k in ("errors_hist", "images", "camtoworlds", "params", "mu", "count", "occs", "binaries"):
        assert bits(r[k], ref[k]), k
    assert r["loss_hist"] == ref["loss_hist"] and r["uncertainty"] == ref["uncertainty"]
    assert len(ref["camtoworlds"]) == 8 + 40  # the scan and one flown trajectory


def test_mesh_2_2_follows_the_unsharded_loop(loops):
    _, ref, _ = loops
    r = _ranks(loops, (2, 2))[0]
    assert bits(r["camtoworlds"], ref["camtoworlds"]) and bits(r["images"], ref["images"])
    np.testing.assert_allclose(r["errors_hist"], ref["errors_hist"], rtol=5e-2)


def test_rank_0_checkpoints_reload_unsharded(loops):
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.sim.fake import FakeSim

    tmp, _, _ = loops
    for shape in ((2, 1), (2, 2)):
        job = _job(tmp, f"reload{shape[0]}{shape[1]}")
        m = ActiveNeRFMapper(job["cfg"], FakeSim(**job["sim"]), save_path=job["save_path"],
                             device="cpu", **KW)
        m.load_checkpoints(os.path.join(tmp, f"mesh{shape[0]}{shape[1]}", "checkpoints"))
        got, r = runs.state_arrays(m.state), _ranks(loops, shape)[0]
        for k in ("params", "mu", "count", "occs", "binaries", "step"):
            assert bits(got[k], r[k]), (shape, k)
        files = sorted(os.listdir(os.path.join(tmp, f"mesh{shape[0]}{shape[1]}")))
        assert "errors.npy" in files and "checkpoints" in files


def test_cli_mesh_2_1(tmp_path):
    """``--mesh 2,1 --device cpu`` on ``config_faketiny.yaml``, cut to 10
    train steps a phase: exits 0 with finite rows."""
    with open(os.path.join(REPO, "configs", "config_faketiny.yaml")) as f:
        doc = yaml.safe_load(f)
    doc.update(save_path=str(tmp_path / "runs"), training_steps=10)
    cfg = tmp_path / "faketiny_cut.yaml"
    cfg.write_text(yaml.safe_dump(doc))
    out = subprocess.run(
        [sys.executable, "-m", "apnerf_tpu_torch.active.pipeline", "--sim", "fake", "--config",
         str(cfg), "--mesh", "2,1", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend gloo" in out.stdout and "done; artifacts in" in out.stdout
    (run,) = os.listdir(tmp_path / "runs")
    errors = np.load(tmp_path / "runs" / run / "errors.npy")
    assert len(errors) >= 3 and np.isfinite(errors).all()


def test_dryrun_multichip_4():
    from apnerf_tpu_torch import dryrun

    ranks = dryrun.dryrun_multichip(4, device="cpu")
    assert len(ranks) == 4 and ranks[0]["shape"] == {"ens": 2, "data": 2}
    for r in ranks:
        assert r["losses"].shape == (2, 2) and np.isfinite(r["losses"]).all()
        assert np.array_equal(r["losses"], ranks[0]["losses"])
        assert len(r["errors_hist"]) == 2 and np.isfinite(np.asarray(r["errors_hist"])).all()


def test_dryrun_entries():
    from apnerf_tpu_torch import dryrun

    for make in (dryrun.entry, dryrun._legacy_occ_entry):
        fn, args = make("cpu")
        loss = fn(*args)
        params = list(args[0].parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        assert torch.isfinite(loss) and any(g is not None and g.abs().sum() > 0 for g in grads)
