"""Full-budget quality rows: one path of the mapper trained on FakeSim and
scored on held-out views.

Port of the single-process harness of ``scripts/quality_headtohead.py``
(``build_mapper``, ``run_path``, ``:35-113``): FakeSim at 640² on the
aabb (-8, 0, -8, 0, 3, 0), ``default_room`` or ``hard_room``; the
mapper's 39-view initial scan with ``max_images=64``; 2 members × 2048
rays × 128 samples and FakeSim's 29 (or the hard room's) classes; 16 test
poses (4 locations × 4 yaws); the step budget as 100-step
``nerf_training(initial_train=True, evaluate=False)`` calls with
``checkpoint_every=10**9``, then ``_evaluate(-1)``. The budget is also
``training_steps``, so the cyclic LR spans the whole run.

Milestone evaluations share the run: ``_evaluate`` renders without
drawing from the mapper's generator (the occupancy march and the
proposal sampler's test mode are deterministic), so an evaluation after
step 200 leaves every later draw as it was
(``tests/test_torch_ngp.py::test_evaluation_draws_nothing``).

    python -m apnerf_tpu_torch.quality --path ngp+occ --scene default --seed 9 \\
        --steps 2000 --milestones 200,500,1000

prints one JSON row per evaluation (the device named in each) and runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

AABB = (-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)
CENTER = (-4.0, 1.5, -4.0)
PATHS = {"ngp+occ": ("ngp", "occ"), "spectral+prop": ("spectral", "prop")}


def held_out_poses():
    """4 held-out locations up to 0.9 m from the scan point × 4 yaws."""
    loc = tuple(
        (CENTER[0] + dx, CENTER[1], CENTER[2] + dz)
        for dx, dz in ((0.3, -0.4), (-0.5, 0.2), (0.8, 0.6), (-0.2, -0.9))
    )
    quat = tuple(
        (0.0, float(np.sin(a / 2)), 0.0, float(np.cos(a / 2))) for a in (0.7, 2.1, 3.9, 5.2)
    )
    return loc, quat


def build_mapper(path: str, steps: int, img: int = 640, seed: int = 9, scene: str = "default",
                 device="cuda", overrides: Optional[dict] = None):
    """→ (a mapper after its initial scan, its configuration)."""
    from .active.mapper import ActiveNeRFMapper
    from .config import PipelineConfig
    from .sim.fake import FakeSim, hard_room

    field_type, sampler_type = PATHS[path]
    boxes = hard_room(aabb=AABB) if scene == "hard" else None
    sim = FakeSim(aabb=AABB, img_w=img, img_h=img, boxes=boxes)
    loc, quat = held_out_poses()
    cfg = PipelineConfig(**{**dict(
        aabb=AABB, num_semantic_classes=sim.num_semantic_classes, n_ensembles=2,
        max_images=64, img_w=img, img_h=img, training_steps=steps,
        field_type=field_type, sampler_type=sampler_type,
        global_origin=CENTER + (0.0, 0.0, 0.0, 1.0), test_loc=loc, test_quat=quat,
        num_rays=2048, max_samples_train=128, max_samples_test=256,
    ), **(overrides or {})})
    save = tempfile.mkdtemp(prefix=f"quality_{field_type}_")
    mapper = ActiveNeRFMapper(cfg, sim, save_path=save, seed=seed, device=device,
                              checkpoint_every=10**9)
    mapper.initialization()
    return mapper, cfg


def _row(mapper, path, scene, seed, step, train_s, cfg) -> dict:
    _, p, dmse, ce = mapper.errors_hist[-1]
    _, lp, mi = mapper.metrics_ext_hist[-1]
    dev = mapper.device
    return dict(
        path=path, scene=scene, seed=seed, steps=step, psnr=p, depth_mse=dmse, sem_ce=ce,
        lpips=lp, miou=mi, train_s=train_s,
        samples_per_s=step * cfg.n_ensembles * cfg.num_rays * cfg.max_samples_train
        / max(train_s, 1e-9),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    )


def run_path(path: str, steps: int, img: int = 640, seed: int = 9, scene: str = "default",
             milestones: Sequence[int] = (), device="cuda", overrides: Optional[dict] = None,
             out=print):
    """Train ``steps`` steps in 100-step calls, evaluate at each milestone
    and at the end → the rows, each also handed to ``out`` as one JSON
    line. ``train_s`` counts the train calls' wall time alone."""
    mapper, cfg = build_mapper(path, steps, img, seed=seed, scene=scene, device=device,
                               overrides=overrides)
    marks = sorted(set(int(m) for m in milestones if 0 < int(m) < steps)) + [steps]
    rows, done, train_s = [], 0, 0.0
    while done < steps:
        sl = min(100, steps - done, marks[0] - done)
        t0 = time.perf_counter()
        losses = mapper.nerf_training(sl, initial_train=True, evaluate=False)
        train_s += time.perf_counter() - t0
        done += sl
        print(f"   {done}/{steps} loss={losses[-1]:.4f} ({train_s:.1f} s)", flush=True)
        if done == marks[0]:
            marks.pop(0)
            mapper._evaluate(-1)
            rows.append(_row(mapper, path, scene, seed, done, train_s, cfg))
            out(json.dumps(rows[-1]))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", choices=sorted(PATHS), required=True)
    p.add_argument("--scene", choices=("default", "hard"), default="default")
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--milestones", type=str, default="",
                   help="comma-separated steps to evaluate at inside the run")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    milestones = [int(m) for m in args.milestones.split(",") if m]
    return run_path(args.path, args.steps, seed=args.seed, scene=args.scene,
                    milestones=milestones, device=args.device)


if __name__ == "__main__":
    main()
