"""What the benchmark takes from the measured program: its configuration
type and the mapper, built as its command line builds them, with the
benchmark's weights and draw seed handed in."""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..scene.room import Room
from ..weights import load_into, make_ensemble


def pipeline_config(cfg: dict):
    """The program's ``PipelineConfig`` from a configuration file's keys
    (keys it does not have, such as the mapper's, are the benchmark's)."""
    from apnerf_tpu_torch.config import PipelineConfig

    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    kw = {}
    for k, v in cfg.items():
        if k in names:
            if isinstance(v, list):
                v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
            kw[k] = v
    return PipelineConfig(**kw)


def build_mapper(run, save_path: str):
    """The mapper on the run's device with the benchmark's weights, its
    scene and, for its train draws, the benchmark's draw seed."""
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    cfg = run.cfg
    room = Room(cfg["aabb"], cfg["img_w"], cfg["img_h"], cfg["hfov"], run.device)
    mapper = ActiveNeRFMapper(
        pipeline_config(cfg), room, save_path=save_path, seed=run.seeds["mapper"],
        eval_scale=cfg["eval_scale"], unc_scale=cfg["unc_scale"],
        max_samples_unc=cfg["max_samples_unc"], device=run.device,
    )
    weights = make_ensemble(cfg, run.seeds["weights"], run.device)
    for member, leaves in zip(mapper.members, weights):
        load_into(member, leaves)
    mapper.generator.manual_seed(run.seeds["draws"])
    return mapper, room, weights


def to_host(leaves: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def log(stage: str) -> None:
    """A set-up stage's end on standard error, in seconds of the process."""
    from ..run import process_age_s

    print(f"set-up: {stage} at {process_age_s():.2f} s", file=sys.stderr, flush=True)
