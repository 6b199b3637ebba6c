"""CLI entry: python -m apnerf_tpu_torch.active.pipeline

Port of ``apnerf_tpu/active/pipeline.py``: ``--sem-num``,
``--habitat-scene``, ``--habitat-config-file``, ``--sim {habitat,fake}``,
``--config``, ``--seed`` and ``--profile`` as there. ``--device``
(default ``cuda``) takes the place of ``--platform``; ``--viz`` turns on
the PNG dumps that the JAX mapper always writes (they need ``imageio``).
``--sim habitat`` builds ``sim/habitat.py``'s facade, which needs
``habitat_sim`` and says so without it. ``--profile DIR`` runs the loop
under ``torch.profiler`` (CPU activity, and CUDA on the card) and writes
a Chrome trace into DIR. ``--mesh ENS,DATA`` runs the loop on an (ens,
data) mesh of ``ENS × DATA`` ranks (``parallel/``): the parent builds the
kernels, launches the ranks (``parallel/launch.py``), and each rank builds
its mapper on the mesh and runs ``pipeline()``; rank 0 writes the
artifacts. The run is on the card unless ``--device cpu`` is given:
without a CUDA device the default fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import random

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sem-num", type=int, default=0, help="number of semantic classes")
    p.add_argument("--habitat-scene", type=str, default="102344250")
    p.add_argument(
        "--habitat-config-file", type=str,
        default=str(
            pathlib.Path.cwd()
            / "data/scene_datasets/hssd-hab/hssd-hab.scene_dataset_config.json"
        ),
    )
    p.add_argument("--sim", choices=["habitat", "fake"], default="habitat")
    p.add_argument("--config", type=str, default=None,
                   help="scene YAML path (reference schema)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (cpu runs the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--viz", action="store_true",
                   help="write the visualisation and prediction PNGs (needs imageio)")
    p.add_argument(
        "--profile", type=str, default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to DIR "
        "(view with chrome://tracing or Perfetto)",
    )
    p.add_argument(
        "--mesh", type=str, default=None, metavar="ENS,DATA",
        help="run the active loop on an (ens, data) mesh of ENS x DATA ranks, e.g. --mesh 2,1: "
        "members over ens, rays over data (one process per rank; ranks share a device when "
        "there are fewer devices than ranks)",
    )
    return p.parse_args(argv)


def build_mapper(args, mesh=None):
    from ..config import PipelineConfig, load_scene_config
    from .mapper import ActiveNeRFMapper

    cfg_path = args.config or f"configs/config_{args.habitat_scene}.yaml"
    if pathlib.Path(cfg_path).exists():
        cfg = load_scene_config(cfg_path, num_semantic_classes=args.sem_num)
    else:
        cfg = PipelineConfig(num_semantic_classes=args.sem_num)

    if args.sim == "fake":
        from ..sim.fake import FakeSim

        sim = FakeSim(aabb=tuple(cfg.aabb), img_w=cfg.img_w, img_h=cfg.img_h, hfov=cfg.hfov)
        if args.sem_num == 0:
            cfg = dataclasses.replace(cfg, num_semantic_classes=sim.num_semantic_classes)
    else:
        from ..sim.habitat import HabitatSim

        sim = HabitatSim(args.habitat_scene, args.habitat_config_file, cfg.img_w, cfg.img_h)
    return ActiveNeRFMapper(cfg, sim, seed=args.seed, device=args.device, save_viz=args.viz,
                            mesh=mesh)


def profile_run(fn, out_dir: str, device) -> str:
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity too on the
    card) → the path of the Chrome trace written into ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        fn()
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def run(args, mesh=None):
    """Build the mapper (on ``mesh``, when given) and run the loop → the
    mapper."""
    random.seed(args.seed)
    np.random.seed(args.seed)
    mapper = build_mapper(args, mesh)
    if args.profile:
        out = args.profile if mesh is None else os.path.join(args.profile, f"rank{mesh.rank}")
        profile_run(mapper.pipeline, out, mapper.device)
    else:
        mapper.pipeline()
    return mapper


def _mesh_rank(mesh, args) -> dict:
    """One rank of ``--mesh``: the loop on the mesh → what rank 0 reports."""
    mapper = run(args, mesh)
    return {"save_path": mapper.save_path, "throughput_log": mapper.throughput_log,
            "errors_hist": mapper.errors_hist, "loss_hist": mapper.loss_hist}


def main(argv=None):
    """The loop of ``argv`` → its mapper, or with ``--mesh`` the report of
    every rank (``_mesh_rank``)."""
    args = parse_args(argv)
    if args.mesh:
        from ..parallel.launch import launch

        n_ens, n_data = (int(v) for v in args.mesh.split(","))
        ranks = launch(_mesh_rank, n_ens, n_data, args, device=args.device)
        log, save_path, result = ranks[0]["throughput_log"], ranks[0]["save_path"], ranks
    else:
        mapper = run(args)
        log, save_path, result = mapper.throughput_log, mapper.save_path, mapper
    if log:
        print(
            f"throughput: {log[-1]['samples_per_sec']:.3e} samples/s, "
            f"{log[-1]['rays_per_sec']:.3e} rays/s"
        )
    print(f"done; artifacts in {save_path}")
    return result


if __name__ == "__main__":
    main()
