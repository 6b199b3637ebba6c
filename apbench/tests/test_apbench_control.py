"""The controls of ``correct`` and the faults each cell's limits are
held against, read beside the program's own readings.

The control is the plain reference put in the program's place and run a
precision below the configuration's: TF32 for the float32 ``ngp_occ``
cell, float8 for the bfloat16 ``flagship_spectral_prop`` cell; each
reading is the cell's comparison of it against the reference in the
stated precision, on the inputs a run of that seed gets. Beside it the
planted faults: for the train cell half the batch (the mean over the
rest) and a state left unchanged; for the plan cell half of each view's
rays, and the program's own renders scaled by ``SCALE`` on one member's
view, on the last ``SOME_RAYS`` of every view's rays, or on its last
``LAST_RAYS``. The plan cell's control also scores its renders in
bfloat16, the step below the scores' stated float32.

Each seed drives the program through the cell's set-up and a short
window (one call of the train cell, the plan cell's ``check_span``
calls), as a run does, and reads the program's numbers, the control's
and the faults'. The train cell's later steps start from the program's
state after its window, so the control and the faults there follow the
same state. On the chip, at the cell's own size (one JSON line a seed):

    python -m apbench.tests.test_apbench_control --cell ngp_occ.train --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from types import SimpleNamespace

import pytest
import torch

from apbench import generator
from apbench.drivers import plan, train
from apbench.reference import spectral_plan
from apbench.run import HERE, load_json, part

TINY = {
    "ngp_occ.train": ({"n_levels": 4, "log2_hashmap_size": 12, "max_resolution": 64,
                       "main_neurons": 16, "img_w": 40, "img_h": 40, "num_rays": 64,
                       "max_samples_train": 16, "n_candidates": 512, "max_images": 64,
                       "occ_every_n": 4, "occ_warmup_steps": 4},
                      {"warm_steps": 6, "steps_per_call": 2}),
    "flagship.plan": ({"spectral_neurons": 32, "n_levels": 4, "spectral_freqs_per_level": 4,
                       "img_w": 40, "img_h": 40, "max_samples_unc": 16, "num_prop_samples": 8,
                       "prop_neurons": 16},
                      {"checked": 2, "check_span": 2}),
}
SCALE = 1.25
SOME_RAYS = 0.3
LAST_RAYS = 256
QUANTILES = (0.9, 0.95, 0.98, 0.99, 0.995, 0.999)


def _cell(name: str, config=None, traffic=None):
    cell = {c["name"]: c for c in load_json(HERE.parent / "BENCHMARK.json")["workloads"]}[name]
    cfg = {**part("configs", cell["config"]), **(config or {})}
    return (cfg, {**part("traffic", cell["traffic"]), **(traffic or {})},
            part("workloads", name)["limits"])


def _program(name: str, seed: int, device, config, traffic, calls: int):
    """A run of the cell's driver: set-up, ``calls`` requests, the window's
    close (``after_window``)."""
    cfg, traffic, _ = _cell(name, config, traffic)
    run = SimpleNamespace(cfg=cfg, traffic=traffic, seeds=generator.sub_seeds(seed),
                          device=torch.device(device), trace_on=False)
    driver = {"ngp_occ.train": train, "flagship.plan": plan}[name]
    driver.setup(run)
    for _ in range(calls):
        driver.request(run)
    run.work = driver.work(run, calls)
    driver.after_window(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return run


def _as_readings(ref: dict) -> dict:
    return {"losses": ref["losses"], "grad1": ref["grad1"], "params": ref["params"]}


def train_readings(seed: int, device, config=None, traffic=None) -> dict:
    run = _program("ngp_occ.train", seed, device, config, traffic, 1)
    out = {"program": train.compare(run)}
    for label in ("reference", "control", "half_batch", "unchanged"):
        out[label] = {}
    for late, suffix, start in ((False, "", run.weights),
                                (True, "_late", run.late_start["params"])):
        ref = train.follow_reference(run, late=late)
        same = {"losses": ref["losses"],
                "grad1": [{k: torch.zeros_like(v) for k, v in g.items()} for g in ref["grad1"]],
                "params": start}
        got = {"reference": _as_readings(ref), "unchanged": same,
               "control": _as_readings(train.follow_reference(run, "tf32", late=late)),
               "half_batch": _as_readings(train.follow_reference(run, half_batch=True,
                                                                 late=late))}
        for label, readings in got.items():
            out[label].update(train.gaps(readings, start, ref, suffix))
    return out


def _scaled(renders: dict, where) -> dict:
    out = {}
    for k, v in renders.items():
        v = v.clone()
        v[where] *= SCALE
        out[k] = v
    return out


def plan_readings(seed: int, device, config=None, traffic=None) -> dict:
    """The control renders with float8 operands and scores in bfloat16; the
    quantiles ``QUANTILES`` of the views' gaps are read beside the
    compared 99th (``q<quantile>``)."""
    run = _program("flagship.plan", seed, device, config, traffic,
                   _cell("flagship.plan", config, traffic)[1]["check_span"])
    cfg = run.cfg
    pi = spectral_plan.predictive_information
    out = {"program": plan.compare(run)}
    for traj, terms, got in run.scored:
        if got is None:
            continue
        ref = spectral_plan.render_candidate(cfg, run.weights, traj)
        P = ref["opacity"].shape[2]
        control = spectral_plan.render_candidate(cfg, run.weights, traj, "fp8")
        cases = {
            "program": (got, terms),
            "reference": (ref, pi(ref)),
            "control": (control, pi(control, torch.bfloat16)),
            "half_rays": (spectral_plan.render_candidate(cfg, run.weights, traj, ray_share=0.5),
                          None),
            "one_view": (_scaled(got, (0, 7)), None),
            "some_rays": (_scaled(got, (slice(None), slice(None),
                                        slice(P - int(SOME_RAYS * P), None))), None),
            "last_rays": (_scaled(got, (slice(None), slice(None),
                                        slice(max(P - LAST_RAYS, P // 2), None))), None),
        }
        for label, (renders, t) in cases.items():
            r = out.setdefault(label, {})
            stats = dict(zip(("render_median_rel", "render_view_q99_rel"),
                             plan.render_gaps(renders, ref)))
            stats.update({f"q{q}": plan.render_gaps(renders, ref, q)[1] for q in QUANTILES})
            stats["score_rel"] = plan.score_gap(t if t is not None else pi(renders), pi(renders))
            for k, v in stats.items():
                if label != "program" or k not in r:
                    r[k] = max(r.get(k, 0.0), v)
    return out


READINGS = {"ngp_occ.train": train_readings, "flagship.plan": plan_readings}
FAULTS = {"ngp_occ.train": ("control", "half_batch", "unchanged"),
          "flagship.plan": ("control", "half_rays", "one_view", "some_rays", "last_rays")}


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", sorted(READINGS))
def test_apbench_reference_reads_nought_against_itself_and_the_faults_do_not(cell):
    torch.manual_seed(0)
    out = READINGS[cell](7, "cpu", *TINY[cell])
    limits = _cell(cell)[2]
    assert set(limits) <= set(out["program"]), (out["program"], limits)
    assert all(v == 0.0 for v in out["reference"].values()), out["reference"]
    for label in FAULTS[cell]:
        assert max(out[label].values()) > 0.0, (label, out[label])


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(READINGS))
def test_apbench_control_fails_the_cell_at_its_size(cell, card):
    limits = _cell(cell)[2]
    for seed in (11, 12, 13):
        out = READINGS[cell](seed, card)
        assert not _fails(out["program"], limits), (seed, out["program"], limits)
        assert not _fails(out["reference"], limits)
        for label in FAULTS[cell]:
            assert _fails(out[label], limits), (seed, label, out[label], limits)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True, choices=sorted(READINGS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    limits = _cell(args.cell)[2]
    for seed in args.seeds:
        t = time.perf_counter()
        out = READINGS[args.cell](seed, "cuda")
        print(json.dumps({"cell": args.cell, "seed": seed, "readings": out, "limits": limits,
                          "fails": {k: _fails(v, limits) for k, v in out.items()},
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
