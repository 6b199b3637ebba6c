"""The harness on the CPU at tiny sizes: cells found by name, ``correct``
broken by each fault a cell can have, the JAX stack never loaded, no
result without a card."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apbench import run as harness

REPO = harness.HERE.parent
SEED = 2**31 + 977
TINY = {
    "ngp_occ.train": {"config": {"n_levels": 4, "log2_hashmap_size": 12, "max_resolution": 64,
                                 "main_neurons": 16, "img_w": 40, "img_h": 40, "num_rays": 64,
                                 "max_samples_train": 16, "n_candidates": 512, "max_images": 64,
                                 "occ_every_n": 4, "occ_warmup_steps": 4},
                      "traffic": {"warm_steps": 12, "steps_per_call": 4}},
    "flagship.plan": {"config": {"spectral_neurons": 32, "n_levels": 4,
                                 "spectral_freqs_per_level": 4, "img_w": 40, "img_h": 40,
                                 "max_samples_unc": 16, "num_prop_samples": 8,
                                 "prop_neurons": 16},
                      "traffic": {"checked": 2, "check_span": 2}},
}


def _run(cell, limits=None, root=harness.HERE):
    bench = harness.load_json(root.parent / "BENCHMARK.json")
    torch.manual_seed(0)
    return harness.run_cell(bench, cell, SEED, 0.5, False, "cpu", root=root,
                            overrides={**TINY[cell], "limits": limits or {}})


@pytest.fixture(scope="module")
def sound():
    """Each cell's sound tiny run, and limits at twice its readings: this
    size's own, since the cells' limits are set at their full size."""
    out = {}
    for cell in TINY:
        r = _run(cell)
        out[cell] = (r, {k: 2 * c["value"] + 1e-12 for k, c in r["compared"].items()})
    return out


def _halve_batch(monkeypatch):
    from apnerf_tpu_torch.train import phase

    fetch = phase.fetch_rays

    def half(*a, **kw):
        b = fetch(*a, **kw)  # the rays' fields, then the background
        return type(b)(*[t[: t.shape[0] // 2] for t in b[:-1]], b[-1])

    monkeypatch.setattr(phase, "fetch_rays", half)


def _keep_state(monkeypatch):
    from apnerf_tpu_torch.train import step

    monkeypatch.setattr(step.Adam, "step", lambda self, params, grads, state, names=None:
                        (state, torch.zeros((), dtype=torch.bool)))


def _halve_rays(monkeypatch):
    from apnerf_tpu_torch.active import mapper

    rays = mapper.ActiveNeRFMapper._pose7_to_rays

    def half(self, poses, scale):
        r = rays(self, poses, scale)
        n = r.origins.shape[1] // 2
        return type(r)(r.origins[:, :n], r.viewdirs[:, :n])

    monkeypatch.setattr(mapper.ActiveNeRFMapper, "_pose7_to_rays", half)


def _alter_answer(monkeypatch):
    from apnerf_tpu_torch.active import mapper

    pi = mapper.predictive_information

    def altered(**kw):
        p = pi(**kw)
        return p._replace(sem=p.sem * (2.0 / 3.0))  # the semantic term weighted 2, not 3

    monkeypatch.setattr(mapper, "predictive_information", altered)


def _scale_renders(monkeypatch, where):
    """The candidate render's outputs scaled by 1.25 at ``where`` ([E, V, P]
    indices), as the scores and the check read them."""
    from apnerf_tpu_torch.active import mapper

    build = mapper.ActiveNeRFMapper._build_ensemble_renderer

    def built(self, max_samples, with_variance):
        render = build(self, max_samples, with_variance)
        if not with_variance:
            return render

        def wrong(*args, **kw):
            out = dict(render(*args, **kw))
            for k in ("rgb_var", "depth_var", "sem", "opacity"):
                v = out[k].clone()
                v[where(v)] *= 1.25
                out[k] = v
            return out

        return wrong

    monkeypatch.setattr(mapper.ActiveNeRFMapper, "_build_ensemble_renderer", built)


def _scale_one_view(monkeypatch):
    _scale_renders(monkeypatch, lambda v: (0, 7))


def _scale_a_third_of_the_rays(monkeypatch):
    _scale_renders(monkeypatch, lambda v: (slice(None), slice(None),
                                           slice(v.shape[2] - v.shape[2] // 3, None)))


FAULTS = [("ngp_occ.train", _keep_state), ("ngp_occ.train", _halve_batch),
          ("flagship.plan", _halve_rays), ("flagship.plan", _alter_answer),
          ("flagship.plan", _scale_one_view), ("flagship.plan", _scale_a_third_of_the_rays)]


def test_apbench_sound_tiny_runs_are_correct(sound):
    for cell, (r, _) in sound.items():
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, (cell, r)
        assert list(r)[-1] == "compared"
        assert {"setup_s"} < set(r["metrics"]), r["metrics"]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f.__name__[1:] for _, f in FAULTS])
def test_apbench_a_fault_makes_the_run_incorrect(cell, fault, sound, monkeypatch):
    fault(monkeypatch)
    r = _run(cell, sound[cell][1])
    assert not r["correct"], r["compared"]


def test_apbench_a_workload_added_as_a_file_is_found_by_name(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "apbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(REPO / "BENCHMARK.json")
    cell = dict(bench["workloads"][0], name="ngp_occ.train_copy")
    bench["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_json(harness.HERE / "workloads" / "ngp_occ.train.json")
    (tmp_path / "apbench" / "workloads" / "ngp_occ.train_copy.json").write_text(json.dumps(spec))
    code = ("import json, sys; from pathlib import Path; from apbench import run as h; "
            "from apbench.tests.test_apbench_harness import TINY; "
            "b = h.load_json(Path('BENCHMARK.json')); "
            "r = h.run_cell(b, 'ngp_occ.train_copy', 5, 0.3, False, 'cpu', "
            "overrides=TINY['ngp_occ.train']); "
            "print(json.dumps({'here': str(h.HERE), 'correct': r['correct'], "
            "'forbidden': h.forbidden_modules()}))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["here"]).resolve() == (tmp_path / "apbench").resolve()
    assert got["correct"] and got["forbidden"] == []


def test_apbench_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "apbench.run", "--workload", "flagship.plan",
                          "--seed", "3", "--seconds", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_apbench_dry_run_loads_nothing_of_the_jax_stack():
    code = ("from pathlib import Path; from apbench import run as h; "
            "from apbench.tests.test_apbench_harness import TINY; "
            "b = h.load_json(Path('BENCHMARK.json')); "
            "[h.run_cell(b, c, 9, 0.2, t, 'cpu', overrides=TINY[c]) "
            "for c in TINY for t in (False, True)]; "
            "print(sorted({k.split('.')[0] for k in __import__('sys').modules}))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "apnerf_tpu_torch" in loaded  # the top-level names are compared whole
    assert not loaded & {"jax", "jaxlib", "flax", "apnerf_tpu"}, loaded


def test_apbench_reference_imports_nothing_of_the_program():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"apnerf_tpu_torch", "apnerf_tpu", "jax", "jaxlib", "apbench"}, \
                (path.name, names)
