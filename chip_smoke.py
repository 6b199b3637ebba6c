"""Drive the PyTorch port's planning step once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the device, its power limit and the kernels' build from
     ``apnerf_tpu_torch/csrc`` into ``build/``;
  2. the field kernel (encode + trunk) against its plain PyTorch version
     at the main-path shape, the occupancy grid's ragged shape and a
     2-hidden-layer trunk;
  3. the weights kernel against its plain version at the main field's and
     the proposal field's [rays, samples];
  4. the main path at the shipping ``PipelineConfig()`` with seeded random
     weights: the warm-up occupancy update over every cell, the planner's
     candidate trajectories, and every candidate rendered in 40 views by
     both members and scored by predictive information. Kernel launch
     counts are read over exactly this phase. The first two candidates are
     then scored again with the plain versions in place of both kernels,
     and one candidate's scoring is traced with ``torch.profiler`` for
     device time by kernel and the device's idle share.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit, and before that one JSON object
with each kernel's launches, error and times. Any failure exits non-zero
before those lines.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# field kernel: max-abs error / max-abs of the plain output, per case. With
# zero biases the kernel and the plain version round the same f32 sums to
# bf16; with random biases they differ by the bias convention (the plain
# version adds the bias in bf16 after rounding, the kernel in f32 before).
K1_TOL_ZERO_BIAS = 1e-5
K1_TOL_RANDOM_BIAS = 1e-2
K2_TOL = 1e-5  # max-abs error; float32 weights in [0, 1]
PI_RTOL = 2e-2  # PI terms, kernels against plain versions; bf16 rounding flips
N_VIEWS = 40


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``inner``
    back-to-back calls, the median of ``reps`` such windows."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a GPU")

    # ---- 1. device and build -------------------------------------------------
    from apnerf_tpu_torch.ops.cuda import build

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.relative_to(build.REPO_ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.models.nn import init_mlp
    from apnerf_tpu_torch.ops import volrend
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field, fused_spectral_field_plain
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = PipelineConfig()
    mapper = ActiveNeRFMapper(
        cfg, None, save_path=os.path.join(build.BUILD_DIR, "chip_smoke_run"), seed=9,
        device=dev,
    )
    main_field = mapper.members[0].main
    R = int(cfg.img_h * mapper.unc_scale) * int(cfg.img_w * mapper.unc_scale)
    S, Sp = mapper.max_samples_unc, cfg.num_prop_samples
    n_cells = int(np.prod(cfg.main_grid_resolution))
    records = {}

    # ---- 2. field kernel against its plain version ----------------------------
    def random_bias_trunk(widths):
        mlp = init_mlp(widths, gen, dev)
        for _, b in mlp.layers():
            b.copy_(torch.randn(b.shape, generator=gen, device=dev) * 0.1)
        return mlp

    with torch.inference_mode():
        trunk = main_field.mlp_base  # init_mlp leaves its biases at zero
        widths = [w.shape[0] for w, _ in trunk.layers()] + [trunk.layers()[-1][0].shape[1]]
        cases = [
            ("main path", R * S, trunk, K1_TOL_ZERO_BIAS),
            ("occupancy grid", n_cells, trunk, K1_TOL_ZERO_BIAS),
            ("main path, random biases", R * S, random_bias_trunk(widths), K1_TOL_RANDOM_BIAS),
            ("2-hidden-layer trunk, random biases", R * Sp,
             random_bias_trunk([widths[0], 256, 256, 16]), K1_TOL_RANDOM_BIAS),
        ]
        for label, N, mlp, tol in cases:
            u = torch.rand((N, 3), generator=gen, device=dev)
            args_ = (main_field.W, main_field.phase, mlp, u)
            y = fused_spectral_field(*args_)
            torch.cuda.synchronize()
            yp = fused_spectral_field_plain(*args_)
            if not (torch.isfinite(y).all() and y.shape == yp.shape):
                fail(f"field kernel ({label}): non-finite or misshapen output")
            abs_err = float((y - yp).abs().max())
            rel = abs_err / max(float(yp.abs().max()), 1e-12)
            ms = cuda_ms(lambda: fused_spectral_field(*args_))
            pms = cuda_ms(lambda: fused_spectral_field_plain(*args_))
            print(f"field kernel [{label}] N={N} layers={mlp.n_layers - 1}: "
                  f"err/scale {rel:.3e} (tol {tol}) max_abs {abs_err:.3e} | "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
            if not rel <= tol:
                fail(f"field kernel ({label}) disagrees with its plain version: {rel}")
            if label == "main path":
                records["fused_spectral_field"] = (abs_err, ms, pms)

        # ---- 3. weights kernel against its plain version ------------------------
        for n_s in (S, Sp):
            edges = torch.sort(
                torch.rand((R, n_s + 1), generator=gen, device=dev) * 20.0 + 0.1, dim=-1
            ).values
            t0_, t1_ = edges[:, :-1].contiguous(), edges[:, 1:].contiguous()
            sig = torch.rand((R, n_s), generator=gen, device=dev) * 2.0
            got = fused_render_weights(t0_, t1_, sig)
            torch.cuda.synchronize()
            ref = fused_render_weights_plain(t0_, t1_, sig)
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            ms = cuda_ms(lambda: fused_render_weights(t0_, t1_, sig))
            pms = cuda_ms(lambda: fused_render_weights_plain(t0_, t1_, sig))
            print(f"weights kernel [{R}, {n_s}]: max_abs {abs_err:.3e} (tol {K2_TOL}) | "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
            if not abs_err <= K2_TOL:
                fail(f"weights kernel disagrees with its plain version: {abs_err}")
            if n_s == S:
                records["fused_render_weights"] = (abs_err, ms, pms)
    torch.cuda.synchronize()

    # ---- 4. the main path -------------------------------------------------------
    # The planner's loader rebuilds its tracked library in place when the
    # library's mtime is older than its source's, as a fresh checkout can
    # leave it. It loads a copy in build/ instead, so the checkout's files
    # stay as they are; the hash check below holds it to that.
    from apnerf_tpu.native import lib as planner_lib

    so = planner_lib._SO
    so_hash = sha256(so)
    if os.path.getmtime(so) < os.path.getmtime(planner_lib._SRC):
        print("planner: the tracked native library is older than its source; "
              "loading a copy from build/", flush=True)
    planner_lib._SO = str(build.BUILD_DIR / "libplanning_core.so")
    shutil.copyfile(so, planner_lib._SO)  # a new file, so newer than the source

    fused_spectral_field.launches = 0
    fused_render_weights.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    mapper.occ = mapper._occ_update_fn(
        mapper.members, mapper.occ, mapper.step, cfg.occ_thre_for_phase(-1),
        generator=mapper.generator,
    )
    binaries = mapper.binaries_host()
    t_occ = time.perf_counter() - t_start
    t1 = time.perf_counter()
    candidates = mapper._sample_candidates(binaries, mapper.global_origin[:3].copy())
    t_plan = time.perf_counter() - t1
    t2 = time.perf_counter()
    chosen, fly = mapper._score_candidates(candidates, 1)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t2
    launches = {
        "fused_spectral_field": fused_spectral_field.launches,
        "fused_render_weights": fused_render_weights.launches,
    }
    comps = np.asarray(mapper.trajector_uncertainty_list[0])
    best = int(np.argmax(comps.sum(axis=1)))
    n_c = len(candidates)
    print(f"main path: occupancy {binaries.mean():.4f} of {binaries.size} cells occupied; "
          f"{n_c} candidates, lengths {[len(c) for c in candidates]}", flush=True)
    for i, c in enumerate(comps):
        print(f"  candidate {i:2d}: PI rgb {c[0]:.6e} depth {c[1]:.6e} sem {c[2]:.6e} "
              f"occ {c[3]:.6e} total {c.sum():.6e}")
    print(f"  chosen candidate: {best}")
    print(f"  wall: occupancy update {t_occ:.3f} s | sample_traj {t_plan:.3f} s | "
          f"render + score {t_score:.3f} s ({t_score / max(n_c, 1) * 1e3:.1f} ms per candidate)")
    print(f"  launches: {launches}", flush=True)
    renders = n_c * cfg.n_ensembles * N_VIEWS
    if n_c != cfg.num_traj:
        fail(f"expected {cfg.num_traj} candidates, got {n_c}")
    if comps.shape != (n_c, 4) or not np.isfinite(comps).all():
        fail("non-finite or misshapen PI terms")
    if chosen is not candidates[best] or fly.shape != (N_VIEWS, 7):
        fail("the chosen trajectory is not the most informative candidate")
    if launches["fused_spectral_field"] != cfg.n_ensembles + renders:
        fail(f"field kernel launched {launches['fused_spectral_field']} times, "
             f"expected {cfg.n_ensembles + renders}")
    if launches["fused_render_weights"] != 2 * renders:
        fail(f"weights kernel launched {launches['fused_render_weights']} times, "
             f"expected {2 * renders}")
    if sha256(so) != so_hash:
        fail("the planner rebuilt its tracked native library")

    # the first two candidates again, with both kernels replaced by their
    # plain versions (the comparison is outside the counted run)
    spectral.fused_spectral_field = fused_spectral_field_plain
    volrend.fused_render_weights = fused_render_weights_plain
    try:
        plain = np.asarray([
            [float(v) for v in mapper.dispatch_uncertainty(candidates[i])] for i in range(2)
        ])
    finally:
        spectral.fused_spectral_field = fused_spectral_field
        volrend.fused_render_weights = fused_render_weights
    rel = np.abs(plain - comps[:2]) / np.maximum(np.abs(plain), 1e-12)
    print(f"  PI of candidates 0-1 with plain versions: max rel diff {rel.max():.3e} "
          f"(tol {PI_RTOL})", flush=True)
    if not rel.max() <= PI_RTOL:
        fail(f"PI with kernels disagrees with the plain versions: {rel.max()}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        mapper.dispatch_uncertainty(candidates[0]).total.item()
        t_p = time.perf_counter() - t_p
    # device-side events are the kernels and copies themselves
    busy = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    ) / 1e6
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    print(f"profiled candidate: wall {t_p:.4f} s, device busy {busy:.4f} s "
          f"({busy / t_p:.1%}), idle share {1 - busy / t_p:.1%}", flush=True)

    kernels = [
        {"name": "fused_spectral_field", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:383"},
        {"name": "fused_render_weights", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/volrend_pallas.py:128"},
    ]
    for k in kernels:
        err, ms, pms = records[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=err, ms=ms, plain_ms=pms)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
