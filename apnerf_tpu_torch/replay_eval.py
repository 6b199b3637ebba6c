"""Replay a recorded trajectory (reference ``data<k>.npz`` schema) through
the active-perception mapper and report quality on held-out recorded views.

Port of ``scripts/replay_eval.py``: the same flags, plus ``--device``.
Point it at any recording made by the reference pipeline
(``habitat_to_data.py:164-173``) or by ``RayDataset.save`` and the full
loop — init scan, ensemble training, planning, flying, retraining — runs
against the recorded frames through ``sim/replay.ReplaySim`` (every
supervised pose snaps to a recorded camera). Held-out eval: every
``--holdout``-th frame becomes a test view.

    python -m apnerf_tpu_torch.replay_eval --npz path/to/data0.npz \\
        [--steps 500] [--planning-steps 3] [--holdout 8] [--out runs/replay] \\
        [--device cpu]

prints one JSON line with PSNR / depth-MSE / sem-CE per evaluation, writes
the standard artifact layout under ``--out``, and runs on the card unless
``--device cpu`` is given. ``main(argv)`` returns the rows, ``run(args)``
the rows and the mapper.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", required=True)
    ap.add_argument("--steps", type=int, default=500, help="train steps per phase")
    ap.add_argument("--planning-steps", type=int, default=3)
    ap.add_argument("--init-samples", type=int, default=12)
    ap.add_argument("--holdout", type=int, default=8,
                    help="every k-th frame is a held-out test view")
    ap.add_argument("--out", default="runs/replay")
    ap.add_argument("--aabb", type=float, nargs=6, default=None,
                    help="scene aabb (x0 y0 z0 x1 y1 z1); estimated from "
                         "the recording when omitted")
    ap.add_argument("--num-rays", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the run (cpu runs the kernels' plain versions)")
    return ap.parse_args(argv)


def build_mapper(args, mesh=None):
    """→ (the mapper on a ``ReplaySim`` of ``args.npz``, the sim, the
    held-out frame indices); on ``mesh`` (``parallel/mesh.py``) the
    mesh-mode mapper, one per rank, each rank on its own ``ReplaySim``."""
    from .active.mapper import ActiveNeRFMapper
    from .config import PipelineConfig
    from .sim.replay import ReplaySim

    sim = ReplaySim(args.npz, nav_radius=2.0)
    n = len(sim.pose7s)
    test_idx = np.arange(0, n, max(args.holdout, 2))
    aabb = np.asarray(args.aabb) if args.aabb else sim.aabb_estimate()
    if args.aabb is None:
        print(
            "WARNING: no --aabb given — using an aabb ESTIMATED from the "
            "recorded camera frustums. Oversized estimates train well but "
            "have been observed to destabilize the final LR-restarted "
            "refit (the mapper's divergence guard rolls back if that "
            "happens). Pass the scene aabb from the recording's YAML when "
            "available.",
            flush=True,
        )
    print(f"recording: {n} frames {sim.img_w}x{sim.img_h}, "
          f"{sim.num_semantic_classes} classes, aabb {np.round(aabb, 2)}")
    cfg = PipelineConfig(
        save_path=args.out,
        aabb=tuple(float(a) for a in aabb),
        img_w=sim.img_w, img_h=sim.img_h,
        num_rays=args.num_rays,
        max_samples_train=args.samples,
        max_samples_test=args.samples,
        num_semantic_classes=sim.num_semantic_classes,
        planning_step=args.planning_steps,
        training_steps=args.steps,
        max_images=max(n + 64, 128),
        # held-out recorded cameras as the test grid (poses snap exactly)
        test_loc=tuple(tuple(sim.pose7s[i, :3]) for i in test_idx),
        test_quat=(tuple(sim.pose7s[test_idx[0], 3:]),),
        global_origin=tuple(sim.pose7s[0]),
    )
    mapper = ActiveNeRFMapper(cfg, sim, save_path=args.out, seed=9, device=args.device,
                              mesh=mesh)
    return mapper, sim, test_idx


def run(args, mesh=None):
    """The replay loop of ``args`` (on ``mesh``, when given) → (its rows,
    the mapper), printing the JSON line."""
    m, sim, test_idx = build_mapper(args, mesh)
    m.initialization(initial_samples=args.init_samples)
    m.nerf_training(args.steps, initial_train=True, planning_step=-1)
    m._evaluate(planning_step=0)
    steps_done = m.planning(args.planning_steps, training_steps_per_step=args.steps)
    m._evaluate(planning_step=steps_done + 1)
    m.save_artifacts()

    errs = np.asarray(m.errors_hist, dtype=float)
    rows = [
        {"planning_step": r[0], "psnr": r[1], "depth_mse": r[2], "sem_ce": r[3]}
        for r in errs.tolist()
    ]
    print(json.dumps({
        "npz": args.npz, "frames": int(len(sim.pose7s)),
        "held_out_views": int(len(test_idx)),
        "planning_steps_run": int(steps_done),
        "errors": rows,
    }))
    return rows, m


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
