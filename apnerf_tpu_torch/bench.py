"""The port's train bench: flagship ensemble training throughput on one
NVIDIA GPU, with the quality canary.

    python -m apnerf_tpu_torch.bench [--route lossgrad|volrend|packed|field|trunk]
                                     [--fused-prop]

The protocol of the root ``bench.py`` (``:71-226``), which stays JAX-only:
a FakeSim 39-view scan at 640², the training configuration (2 members ×
2048 rays × 128 samples, 29 classes, the shipping field), training from
step 1000, one warm-up chunk, then ``N_CALLS`` timed chunks of
``STEPS_PER_CALL`` steps, each followed by the occupancy update. Then
member 0 renders 4 held-out views at 160² with 256 samples and the mean
PSNR against FakeSim's images is the canary, gated at the root bench's
15.44 − 1.5 = 13.94 dB. Prints one JSON line with the root bench's keys
(``value`` in samples/s, ``vs_baseline`` against the TITAN RTX envelope
of 1.95e7 samples/s) plus the step and occupancy-update times and the
route. ``--route`` picks the member core's train route (``train/
flagship.py``: the default ``lossgrad`` is the combined train-step kernel,
the others differentiate through the render kernels' own backwards) and
``--fused-prop`` takes the proposal field through the field kernel. A run
without a CUDA device fails: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import PipelineConfig
from .data.dataset import RayDataset
from .models import spectral
from .ops.rays import image_rays, make_intrinsics, pose_matrix_from_quat
from .render.prop_renderer import render_rays_prop
from .sim.fake import FakeSim
from .train.flagship import (
    ROUTES,
    init_flagship_ensemble,
    make_flagship_occ_update,
    make_flagship_train_phase,
    make_prop_config,
    make_spectral_config,
)
from .train.phase import pools_from_dataset
from .train.step import EnsembleState

BASELINE_SAMPLES_PER_SEC = 20000 * 262144 / 269.0  # ≈ 1.95e7
STEPS_PER_CALL = 100
N_CALLS = 4
AABB = (-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)
CANARY_ANCHOR_PSNR = 15.44
CANARY_TOL = 1.5
CANARY_MIN_PSNR = round(CANARY_ANCHOR_PSNR - CANARY_TOL, 2)
OCC_THRE = 1e-3


def bench_config() -> PipelineConfig:
    return PipelineConfig(
        aabb=AABB, num_semantic_classes=29, n_ensembles=2, num_rays=2048,
        max_samples_train=128, max_images=64, img_w=640, img_h=640,
    )


def scan_poses(n: int = 39):
    """The scan's poses around the room center (``bench.py:86-95``)."""
    rng = np.random.RandomState(0)
    center = np.array([-4.0, 1.5, -4.0])
    poses, mats = [], []
    for i in range(n):
        ang = np.deg2rad(9.0 * i)
        pos = center + rng.uniform(-0.2, 0.2, 3)
        quat = np.array([0, np.sin(ang / 2), 0, np.cos(ang / 2)])
        poses.append(np.concatenate([pos, quat]))
        mats.append(pose_matrix_from_quat(pos, quat))
    return center, poses, np.array(mats)


def canary_poses(center):
    base = np.concatenate([center + [0.3, 0.0, -0.4], [0, np.sin(2.1 / 2), 0, np.cos(2.1 / 2)]])
    return [base] + [
        np.concatenate([center + [dx, 0.0, dz], [0, np.sin(a / 2), 0, np.cos(a / 2)]])
        for dx, dz, a in ((-0.5, 0.2, 0.7), (0.8, 0.6, 3.9), (-0.2, -0.9, 5.2))
    ]


@torch.no_grad()
def canary_psnrs(member, cfg: PipelineConfig, sim: FakeSim, center, device) -> list:
    """PSNR of member 0's 160² renders (256 samples, white background)
    against FakeSim's images, one per canary view."""
    s_cfg, p_cfg = make_spectral_config(cfg), make_prop_config(cfg)
    oh = ow = 160
    K_s = torch.as_tensor(make_intrinsics(ow, oh, cfg.hfov), device=device)
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=device)
    ys = (np.arange(oh) * cfg.img_h) // oh
    xs = (np.arange(ow) * cfg.img_w) // ow
    out = []
    for pose in canary_poses(center):
        c2w = torch.as_tensor(pose_matrix_from_quat(pose[:3], pose[3:]), dtype=torch.float32,
                              device=device)
        rays = image_rays(c2w, K_s, ow, oh)
        outs = render_rays_prop(
            lambda p, d: spectral.forward(member.main, s_cfg, p, d),
            lambda p: spectral.query_density_field(member.prop, p_cfg, p),
            rays.origins, rays.viewdirs, aabb, num_samples=256,
            num_prop_samples=cfg.num_prop_samples, near_plane=cfg.near_plane,
            render_bkgd=torch.ones(3, device=device), stratified=False,
        )
        pd = outs["rgb"].reshape(oh, ow, 3).double().cpu().numpy()
        g_img, _, _ = sim.sample_images_from_poses([pose])
        gt = np.asarray(g_img[0])[..., :3][np.ix_(ys, xs)] / 255.0
        mse = float(np.mean((pd - gt) ** 2))
        out.append(-10.0 * np.log10(max(mse, 1e-12)))
    return out


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it (a card set
    below its maximum runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError:  # no nvidia-smi on this host
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


class BenchData(NamedTuple):
    """The scan every run trains on; one scan serves several runs."""

    sim: FakeSim
    center: np.ndarray
    dataset: RayDataset


class BenchRun(NamedTuple):
    result: dict  # the JSON line's keys
    state: EnsembleState  # after the timed chunks
    dataset: RayDataset
    losses: torch.Tensor  # [steps, E]: the warm-up chunk's, then the timed chunks'


def make_data(device) -> BenchData:
    """FakeSim's 39-view scan at the bench configuration, on ``device``."""
    cfg = bench_config()
    sim = FakeSim(aabb=AABB, img_w=cfg.img_w, img_h=cfg.img_h)
    center, poses, mats = scan_poses()
    images, depths, sems = sim.sample_images_from_poses(poses)
    ds = RayDataset(
        training=True, num_rays=cfg.num_rays, num_models=cfg.n_ensembles,
        width=cfg.img_w, height=cfg.img_h, max_images=cfg.max_images, device=device,
    )
    ds.update_data(images[..., :3], depths, sems, mats)
    return BenchData(sim, center, ds)


def run(device="cuda", timed=None, route: str = "lossgrad", fused_prop: bool = False,
        n_calls: int = N_CALLS, data: Optional[BenchData] = None) -> BenchRun:
    """The whole protocol on the member core's ``route``. ``timed``, when
    given, is a context-manager factory entered around exactly the timed
    chunks (``chip_smoke.py`` counts kernel launches there); ``n_calls``
    cuts the number of timed chunks; ``data`` reuses a scan (``make_data``)
    instead of rendering it again."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA device, and none is available")
    cfg = bench_config()
    sim, center, ds = data if data is not None else make_data(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_flagship_ensemble(cfg, gen, device)._replace(step=1000)
    phase_fn = make_flagship_train_phase(cfg, route=route, fused_prop=fused_prop)
    occ_update_fn = make_flagship_occ_update(cfg)
    pools, counts = pools_from_dataset(ds)

    def run_chunk(state):
        t0 = time.perf_counter()
        state, losses = phase_fn(
            state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K,
            pools, counts, ds.size, STEPS_PER_CALL, False, gen,
        )
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        occ = occ_update_fn(state.members, state.occ, state.step, OCC_THRE, generator=gen)
        torch.cuda.synchronize(device)
        return state._replace(occ=occ), losses, t1 - t0, time.perf_counter() - t1

    state, losses, _, _ = run_chunk(state)  # warm-up
    float(losses.sum())
    all_losses = [losses]
    t_phase = t_occ = 0.0
    with timed() if timed is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in range(n_calls):
            state, losses, tp, to = run_chunk(state)
            all_losses.append(losses)
            t_phase, t_occ = t_phase + tp, t_occ + to
        final_loss = float(losses[-5:].mean())
        dt = time.perf_counter() - t0
    n_steps = STEPS_PER_CALL * n_calls
    samples_per_step = cfg.n_ensembles * cfg.num_rays * cfg.max_samples_train
    value = samples_per_step * n_steps / dt
    views = canary_psnrs(state.members[0], cfg, sim, center, device)
    psnr = float(np.mean(views))
    result = {
        "metric": "flagship_ensemble_train_throughput",
        "value": value,
        "unit": "samples/sec",
        "vs_baseline": value / BASELINE_SAMPLES_PER_SEC,
        "psnr_100steps": psnr,
        "psnr_views": views,
        "psnr_canary_min": CANARY_MIN_PSNR,
        "canary_ok": bool(psnr >= CANARY_MIN_PSNR),
        "final_loss": final_loss,
        "ms_per_step": dt / n_steps * 1e3,
        "phase_ms_per_step": t_phase / n_steps * 1e3,
        "occ_update_s_per_chunk": t_occ / n_calls,
        "timed_steps": n_steps,
        "route": route,
        "fused_prop": fused_prop,
        "device": torch.cuda.get_device_name(device),
        "power_limit": power_limit(),
    }
    return BenchRun(result, state, ds, torch.cat(all_losses))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--route", choices=ROUTES, default="lossgrad",
                        help="the member core's train route")
    parser.add_argument("--fused-prop", action="store_true",
                        help="the proposal field through the field kernel too")
    args = parser.parse_args(argv)
    result = run(route=args.route, fused_prop=args.fused_prop).result
    print(json.dumps(result))
    if not np.isfinite(result["final_loss"]):
        print("FAILED: the final loss is not finite", file=sys.stderr)
        return 1
    if not result["canary_ok"]:
        print(f"CANARY FAILED: psnr {result['psnr_100steps']:.2f} < {CANARY_MIN_PSNR}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
