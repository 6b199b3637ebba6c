"""Drive the PyTorch port's planning step, train step and whole active
mapping loop on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --modes    # and phase 12

Phases, each of which must pass:
  1. the device, its power limit and the kernels' build from
     ``apnerf_tpu_torch/csrc`` into ``build/``;
  2. the field kernel (encode + trunk) against its plain PyTorch version
     at the main-path shape, the occupancy grid's ragged shape and a
     2-hidden-layer trunk;
  3. the weights kernel against its plain version at the main field's and
     the proposal field's [rays, samples];
  4. the planning step at the shipping ``PipelineConfig()`` with 4
     candidates (the loop of phase 10 runs the full 20, twice) and seeded
     random weights: the warm-up occupancy update over every cell, the
     planner's candidate trajectories, and every candidate rendered in 40
     views by both members and scored by predictive information. Kernel
     launch counts are read over exactly this phase. The first two
     candidates are then scored again with the plain versions in place of
     the kernels, and one candidate's scoring is traced with
     ``torch.profiler`` for device time by kernel and the device's idle
     share;
  5. the weights kernel's backward against autograd through its plain
     version at [2048, 64] (the proposal level of a train step) and
     [4096, 256];
  6. the train-step kernel against its plain version at the train shape
     (2048 rays x 128 samples, the shipping main field, 29 classes) with
     seeded random weights, zero-initialised and random biases: loss
     terms and rows, weights and every gradient leaf;
  7. the train path: ``apnerf_tpu_torch.bench``'s protocol in process
     (FakeSim 39-view scan at 640^2, 2 members x 2048 rays x 128 samples,
     a warm-up chunk and 4 timed chunks of 100 steps, each with the
     occupancy update, then the 4-view canary). Kernel launch counts are
     read over exactly the timed chunks and checked exactly. Then one
     member step from the trained state on the kernels, against the
     autograd branch on the plain versions (loss, update and the gradient
     recovered from Adam's first moment), and one member step traced
     with ``torch.profiler``;
  8. the packed field kernel against its plain version at the candidate
     render's shape (4096 rays x 256 samples, 29 classes), zero and random
     biases, limits per output (rgb, sigma, logits), each limit shown to
     catch a zeroed and a negated output;
  9. the fused field-and-render kernel against its plain version at the
     evaluation's shape (25,600 rays x 256 samples) and at 4096 x 512,
     zero and random biases, some rays missing the box, limits per group
     of per-ray sums and on the weights, each shown to catch a corruption;
 10. the active mapping loop through its CLI entry,
     ``apnerf_tpu_torch.active.pipeline.main --sim fake --sem-num 29
     --device cuda --config build/chip_smoke_loop.yaml``: the values of
     ``configs/config_fakeprod.yaml`` (640^2, full field, 20 candidates)
     with the depth cut to 2 planning steps of 100 train steps (so 100 +
     2 x 100 + 500 train steps) and two test locations. PNG dumps are off.
     It checks finite losses that fall, every artifact, checkpoints that
     reload bit for bit, exact launch counts of every kernel and finite
     evaluation rows, and prints per-phase wall times;
 11. inside the loop's renders, the kernel route against the plain route:
     the first candidate of a planning step (predictive information) and
     one evaluation view (per-ray outputs);
 12. (``--modes`` only) two planning steps of 4 candidates in the
     overlapped and in the serial mode, wall time of each.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit, and before that one JSON object
with each kernel's launches, error and times. Any failure exits non-zero
before those lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
# cells of the occupancy grid of phase 10's scene: (8, 3, 8) m at 0.2 m
LOOP_GRID_CELLS = 40 * 15 * 40
# weights-kernel backward: max-abs error / max-abs of the plain output, per
# gradient (f32; the two sum the suffix in different orders). About 2x the
# readings on an H100 (PERF.md).
K2_BWD_TOL = 4e-7
# train-step kernel against its plain version, per bias case: (weights
# max-abs, loss terms relative, gradient leaves err / leaf max-abs, leaves
# with their own limit), each about 2x the readings on an H100 (PERF.md;
# the inputs are seeded and both sides deterministic, so the readings
# repeat exactly). With zero biases the two differ by where they round to
# bf16 (the kernel rounds the per-sample products, the per-ray cotangents
# and the head inputs, as Pallas does; autograd does not). With random
# biases they also differ by the bias convention (the plain version adds
# hidden biases in bf16 after rounding, the kernel in f32 before), which
# moves the spectrum's gradients (W, phase: sums over all rows with
# cancellation) by ~1e-1 of their scale and the first trunk layer's by
# ~2e-2.
K6_TOL = {
    "zero biases": (6e-7, 3e-5, 1e-2, {}),
    "random biases": (6e-3, 3e-4, 1.5e-2, {"W": 2e-1, "phase": 1.6e-1, "mlp_base.w0": 4e-2}),
}
# one member step from the trained state with the kernels against one
# with their plain versions, each tensor's err / max-abs: the loss
# (relative), the update (new - old parameters) and the gradient the
# step took, recovered from Adam's first moment. About 2x the largest
# reading over six batches from one trained state on an H100; with the
# train-step kernel's gradients zeroed (negated) the same comparison
# reads 0.75 (1.47) for the update and 1 (2) for the gradient (PERF.md).
STEP_LOSS_RTOL = 2.5e-4
STEP_UPDATE_TOL = 2e-1
STEP_GRAD_TOL = 3e-2


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


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, n_bytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time (ms) the card could take: the larger of operations
    over their peak rate and bytes (inputs read once, outputs written
    once) over the memory rate → (ms, which one)."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def field_macs(M: int, H: int, n_hidden: int, G: int, hh: int, C: int) -> int:
    """Multiply-adds of one main-field row: encode, trunk, both heads."""
    trunk = 2 * M * H + (n_hidden - 1) * H * H + H * (1 + G)
    heads = (16 + G) * hh + hh * hh + hh * 3 + G * hh + hh * hh + hh * C
    return 3 * M + trunk + heads


def field_weight_bytes(field) -> int:
    return sum(p.numel() * 4 for p in field.parameters())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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

    from apnerf_tpu_torch import native
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.models.nn import init_mlp
    from apnerf_tpu_torch.ops import volrend
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
        fused_field_heads,
        fused_field_heads_plain,
    )
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field, fused_spectral_field_plain
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_plain,
    )

    # the planner's native library builds into build/ at first use; its
    # pure-Python path is the planner's own fallback, but this host has a
    # compiler, so here it must be the native one
    planner = native.backend()
    print(f"planner backend: {planner} ({native.lib.library_path().name})", flush=True)
    if planner != "native":
        fail("the planner's native library did not build on this host")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # 4 candidates here: the loop of phase 10 runs the full 20, twice
    cfg = dataclasses.replace(PipelineConfig(), num_traj=4)
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
            ("the loop's occupancy grid", LOOP_GRID_CELLS, trunk, K1_TOL_ZERO_BIAS),
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
            if label == "the loop's occupancy grid":
                # the shape the main path gives it: every cell of the loop's
                # grid, once per member per chunk. Encode + trunk
                # multiply-adds; u read, y written, the weights read
                M, H = main_field.W.shape[1], widths[1]
                macs = 3 * M + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
                w_bytes = 4 * sum(p.numel() for p in mlp.parameters()) + 16 * M
                records["fused_spectral_field"] = (
                    abs_err, ms, pms, bound(2 * macs * N, N * (12 + 4 * widths[-1]) + w_bytes))

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
                # 3 f32 inputs and 3 f32 outputs per sample; ~12 f32 operations
                # (two exp, the scan) per sample
                records["fused_render_weights"] = (
                    abs_err, ms, pms, bound(12 * R * n_s, 24 * R * n_s, PEAK_F32_FLOPS))
    torch.cuda.synchronize()

    # ---- 4. the planning step ------------------------------------------------------
    counters = all_counters()
    reset_counts(counters)
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
    launches = read_counts(counters)
    comps = np.asarray(mapper.trajector_uncertainty_list[0])
    best = int(np.argmax(comps.sum(axis=1)))
    n_c = len(candidates)
    print(f"planning step: occupancy {binaries.mean():.4f} of {binaries.size} cells occupied; "
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
    expected = dict.fromkeys(launches, 0)
    expected.update(
        fused_spectral_field=cfg.n_ensembles,  # the occupancy update
        fused_field_heads=renders,  # the main field of every render
        fused_render_weights=2 * renders,  # proposal and main weights
    )
    if launches != expected:
        fail(f"planning step launch counts {launches}, expected {expected}")

    # the first two candidates again, with the kernels replaced by their
    # plain versions (the comparison is outside the counted run)
    with plain_routes():
        plain = np.asarray([
            [float(v) for v in mapper.dispatch_uncertainty(candidates[i])] for i in range(2)
        ])
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
    del mapper

    # ---- 5-7. the train step's kernels and the train path ------------------------
    records["fused_render_weights_bwd"] = phase_k2_bwd(dev)
    records["fused_field_volrend_lossgrad"] = phase_k6(dev)
    phase_train(dev)

    # ---- 8-9. the render kernels against their plain versions ---------------------
    records["fused_field_heads"] = phase_k4(dev)
    records["fused_field_volrend"] = phase_k5(dev)

    # ---- 10-11. the loop through the CLI, and its renders on both routes ----------
    loop_mapper, launches = phase_loop(dev)
    phase_loop_routes(loop_mapper)
    if "--modes" in argv:
        phase_modes(loop_mapper)

    kernels = [
        {"name": "fused_spectral_field", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:383"},
        {"name": "fused_render_weights", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/volrend_pallas.py:128"},
        {"name": "fused_render_weights_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/volrend_pallas.py:107"},
        {"name": "fused_field_volrend_lossgrad", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_field_volrend.py:920"},
        {"name": "fused_field_heads", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_heads.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_field_heads.py:480"},
        {"name": "fused_field_volrend", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_field_volrend.py:629"},
    ]
    for k in kernels:
        err, ms, pms, (bound_ms, bound_by) = records[k["name"]]
        # launches: over the loop of phase 10, the main path. No single
        # PyTorch call computes any of these functions, so no library time.
        k.update(launches=launches[k["name"]], max_abs_err=err, ms=ms, plain_ms=pms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def all_counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import fused_field_heads
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import (
        fused_field_volrend,
        fused_field_volrend_lossgrad,
    )
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_bwd,
    )

    return {f.__name__: f for f in (
        fused_spectral_field, fused_render_weights, fused_render_weights_bwd,
        fused_field_volrend_lossgrad, fused_field_heads, fused_field_volrend)}


def reset_counts(counters):
    for f in counters.values():
        f.launches = 0


def read_counts(counters):
    return {name: f.launches for name, f in counters.items()}


@contextlib.contextmanager
def plain_routes():
    """Every forward kernel of the render paths replaced by its plain
    version where the port's modules look it up."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops import volrend
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import fused_field_heads_plain
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import fused_field_volrend_plain
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field_plain
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

    saved = (spectral.fused_spectral_field, spectral.fused_field_heads,
             spectral.fused_field_volrend, volrend.fused_render_weights)
    spectral.fused_spectral_field = fused_spectral_field_plain
    spectral.fused_field_heads = fused_field_heads_plain
    spectral.fused_field_volrend = fused_field_volrend_plain
    volrend.fused_render_weights = fused_render_weights_plain
    try:
        yield
    finally:
        (spectral.fused_spectral_field, spectral.fused_field_heads,
         spectral.fused_field_volrend, volrend.fused_render_weights) = saved


def _errs(got, ref):
    """(max-abs error, its ratio to the reference's max-abs)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def _generator(dev, seed):
    """A phase's own generator, so its inputs do not depend on what the
    phases before it drew."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def phase_k2_bwd(dev):
    """The weights kernel's backward against autograd through its plain
    version → (max-abs error at the proposal shape, kernel ms, plain ms,
    bound)."""
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights_bwd,
        fused_render_weights_plain,
    )

    gen = _generator(dev, 5)
    record = None
    for R, n_s in ((2048, 64), (4096, 256)):
        edges = torch.sort(torch.rand((R, n_s + 1), generator=gen, device=dev) * 20.0 + 0.1,
                           dim=-1).values
        t0_, t1_ = edges[:, :-1].contiguous(), edges[:, 1:].contiguous()
        sig = torch.rand((R, n_s), generator=gen, device=dev) * 2.0
        g = torch.randn((R, n_s), generator=gen, device=dev)
        got = fused_render_weights_bwd(t0_, t1_, sig, g)
        torch.cuda.synchronize()
        leaves = [x.clone().requires_grad_(True) for x in (sig, t0_, t1_)]
        w, _, _ = fused_render_weights_plain(leaves[1], leaves[2], leaves[0])
        ref = torch.autograd.grad(w, leaves, g, retain_graph=True)
        errs = [_errs(a, b) for a, b in zip(got, ref)]
        if not all(np.isfinite(e[0]) for e in errs):
            fail(f"weights backward [{R}, {n_s}]: non-finite output")
        ms = cuda_ms(lambda: fused_render_weights_bwd(t0_, t1_, sig, g))
        pms = cuda_ms(lambda: torch.autograd.grad(w, leaves, g, retain_graph=True))
        print(f"weights backward [{R}, {n_s}]: max_abs dsigma {errs[0][0]:.3e} dt0 "
              f"{errs[1][0]:.3e} dt1 {errs[2][0]:.3e} | err/scale {errs[0][1]:.3e} "
              f"{errs[1][1]:.3e} {errs[2][1]:.3e} (tol {K2_BWD_TOL}) | kernel {ms:.4f} ms, "
              f"plain (autograd backward) {pms:.4f} ms", flush=True)
        if not max(e[1] for e in errs) <= K2_BWD_TOL:
            fail(f"weights backward [{R}, {n_s}] disagrees with autograd")
        if n_s == 64:
            # 4 f32 inputs and 3 f32 outputs per sample; ~30 f32 operations
            record = (max(e[0] for e in errs), ms, pms,
                      bound(30 * R * n_s, 28 * R * n_s, PEAK_F32_FLOPS))
    return record


def _k6_inputs(gen, dev, R, S, n_classes, aabb):
    lo, hi = torch.tensor(aabb[:3], device=dev), torch.tensor(aabb[3:], device=dev)
    span = hi - lo
    pos = lo - 0.1 * span + torch.rand((R, S, 3), generator=gen, device=dev) * 1.2 * span
    dirs = torch.randn((R, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    edges = torch.sort(torch.rand((R, S + 1), generator=gen, device=dev) * 2.9 + 0.1,
                       dim=-1).values
    t0_, t1_ = edges[:, :-1].contiguous(), edges[:, 1:].contiguous()
    miss = (torch.arange(R, device=dev) % 17) == 0
    pix = torch.rand((R, 3), generator=gen, device=dev)
    dgt = torch.rand((R,), generator=gen, device=dev) * 4.0
    lab = torch.randint(0, n_classes, (R,), generator=gen, device=dev)
    bk = torch.tensor([0.2, 0.3, 0.4], device=dev)
    return pos, dirs, t0_, t1_, miss, pix, dgt, lab, bk


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def phase_k6(dev):
    """The train-step kernel against its plain version at the train shape
    → (max-abs error of the weights, kernel ms, plain ms, bound), zero
    biases."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 6)
    cfg = bench.bench_config()
    s_cfg = make_spectral_config(cfg)
    R, S = cfg.num_rays, cfg.max_samples_train
    field = spectral.init_spectral(s_cfg, gen, dev)
    inputs = _k6_inputs(gen, dev, R, S, cfg.num_semantic_classes, cfg.aabb)
    record = None
    for case, (w_tol, l_tol, g_tol, leaf_tol) in K6_TOL.items():
        if case == "random biases":
            with torch.no_grad():
                for name, p in field.named_parameters():
                    if name.split(".")[-1].startswith("b"):
                        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)

        def kernel():
            return spectral.forward_packed_lossgrad(field, s_cfg, *inputs)

        def plain():
            spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad_plain
            try:
                return spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
            finally:
                spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad

        lk, wk, gk = kernel()
        torch.cuda.synchronize()
        lp, wp, gp = plain()
        w_err, _ = _errs(wk, wp)
        l_errs = [
            abs(float(lk[i].sum()) - float(lp[i].sum())) / max(abs(float(lp[i].sum())), 1e-30)
            for i in range(3)
        ]
        fk, fp = _flat(gk), _flat(gp)
        if set(fk) != set(fp):
            fail(f"train-step kernel gradient keys differ: {sorted(set(fk) ^ set(fp))}")
        g_errs = {k: _errs(fk[k], fp[k]) for k in fp}
        finite = all(torch.isfinite(t).all() for t in [lk, wk, *fk.values()])
        ms = cuda_ms(kernel, reps=5, inner=3)
        pms = cuda_ms(plain, reps=5, inner=3)
        print(f"train-step kernel [{case}] R={R} S={S}: weights max_abs {w_err:.3e} "
              f"(tol {w_tol}) | loss terms rel rgb {l_errs[0]:.3e} depth {l_errs[1]:.3e} "
              f"sem {l_errs[2]:.3e} (tol {l_tol}) | kernel {ms:.3f} ms, plain {pms:.3f} ms",
              flush=True)
        print("  loss terms kernel " + " ".join(f"{float(lk[i].sum()):.6e}" for i in range(3))
              + " plain " + " ".join(f"{float(lp[i].sum()):.6e}" for i in range(3))
              + " | loss rows err/scale "
              + " ".join(f"{_errs(lk[i], lp[i])[1]:.3e}" for i in range(3)))
        over = []
        for k, (e, r) in g_errs.items():
            tol = leaf_tol.get(k, g_tol)
            print(f"  grad {k:20s} max_abs {e:.3e} err/scale {r:.3e} (tol {tol}) "
                  f"scale {float(fp[k].abs().max()):.3e}")
            if not r <= tol:
                over.append(k)
        print(f"  worst gradient err/scale {max(r for _, r in g_errs.values()):.3e}",
              flush=True)
        if not finite:
            fail(f"train-step kernel ({case}): non-finite output")
        if not (w_err <= w_tol and max(l_errs) <= l_tol and not over):
            fail(f"train-step kernel ({case}) disagrees with its plain version"
                 + (f" (gradient leaves {over})" if over else ""))
        if case == "zero biases":
            # forward 2 and backward 4 operations per multiply-add (dX and
            # dW); u, dt, t_mid read and the weights written per sample, the
            # parameters read and their gradients written
            macs = field_macs(s_cfg.n_freqs, s_cfg.neurons, s_cfg.layers, s_cfg.geo_feat_dim,
                              s_cfg.neurons // 4, s_cfg.num_semantic_classes)
            n_bytes = R * S * (12 + 8 + 4) + R * (64 + 24) + 2 * field_weight_bytes(field)
            record = (w_err, ms, pms, bound(6 * macs * R * S, n_bytes))
    return record


def _step_inputs(dev, ds, seed):
    """A train batch from image 5 and the proposal sampling's draw."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.data.dataset import fetch_rays

    cfg = bench.bench_config()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    batch = fetch_rays(ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K,
                       torch.tensor(5, device=dev), cfg.num_rays, generator=g)
    noise = torch.rand((cfg.num_rays, cfg.max_samples_train + 1), generator=g, device=dev)
    return batch, noise


def compare_member_step(dev, state, ds, seed):
    """One member step of member 0 from ``state`` on a batch drawn with
    ``seed``: the combined-kernel branch on the kernels against the
    autograd branch with the plain versions in place of the kernels →
    (loss relative error, worst update err/scale, worst gradient
    err/scale), each over the member's tensors. The gradient is recovered
    from Adam's first moment, g = (mu' - b1 mu) / (1 - b1)."""
    import copy

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops import volrend
    from apnerf_tpu_torch.ops.cuda.fused_mlp import (
        fused_spectral_field,
        fused_spectral_field_plain,
    )
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_plain,
    )
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    cfg = bench.bench_config()
    batch, noise = _step_inputs(dev, ds, seed)
    old = state.members[0]
    opt0 = state.opt[0]

    def one_step(core):
        member = copy.deepcopy(old)
        out = core(member, AdamState(*(t.clone() for t in opt0)), batch, state.step,
                   noise=noise)
        return member, out

    mk, ok = one_step(make_flagship_member_core(cfg))
    spectral.fused_spectral_field = fused_spectral_field_plain
    volrend.fused_render_weights = fused_render_weights_plain
    try:
        mp, op_ = one_step(make_flagship_member_core(cfg, lossgrad=False))
    finally:
        spectral.fused_spectral_field = fused_spectral_field
        volrend.fused_render_weights = fused_render_weights
    if bool(ok.skipped) or bool(op_.skipped):
        fail("the member step met a non-finite gradient")
    b1 = 0.9
    sizes = [p.numel() for p in old.parameters()]
    gk = torch.split((ok.opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
    gp = torch.split((op_.opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
    loss_rel = abs(float(ok.loss) - float(op_.loss)) / abs(float(op_.loss))
    rows = []
    for i, ((name, p0), a, b) in enumerate(zip(old.named_parameters(), mk.parameters(),
                                               mp.parameters())):
        _, ru = _errs(a.detach() - p0.detach(), b.detach() - p0.detach())
        eg, rg = _errs(gk[i], gp[i])
        if gp[i].numel() == 1:
            # a one-element leaf (the proposal field's output bias) has no scale
            # of its own: its gradient is one sum over every sample, and near a
            # sign change the ratio to itself reads anything (6.5e-4, 2.7e-3 and
            # 3.6e-1 in three runs on an H100). Held at its layer's scale, the
            # larger max-abs of its weight's gradient and its own.
            rg = eg / max(float(gp[i].abs().max()), float(gp[i - 1].abs().max()), 1e-30)
        rows.append((name, ru, rg))
    worst_u = max(r[1] for r in rows)
    worst_g = max(r[2] for r in rows)
    print(f"  member step (batch seed {seed}), kernels vs plain versions: loss "
          f"{float(ok.loss):.6f} vs {float(op_.loss):.6f} (rel {loss_rel:.3e}, tol "
          f"{STEP_LOSS_RTOL}); update worst err/scale {worst_u:.3e} (tol {STEP_UPDATE_TOL}); "
          f"gradient worst err/scale {worst_g:.3e} (tol {STEP_GRAD_TOL})", flush=True)
    for name, ru, rg in rows:
        print(f"    {name:24s} update {ru:.3e} gradient {rg:.3e}")
    return loss_rel, worst_u, worst_g


def phase_train(dev):
    """The bench protocol in process, launch counts over its timed chunks,
    then one member step with the kernels against one with their plain
    versions. → the timed chunks' launch counts."""
    import copy

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_bwd,
    )
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    counters = (fused_spectral_field, fused_render_weights, fused_render_weights_bwd,
                fvr.fused_field_volrend_lossgrad)
    counts = {}

    @contextlib.contextmanager
    def timed():
        for c in counters:
            c.launches = 0
        yield
        counts.update({c.__name__: c.launches for c in counters})

    t_start = time.perf_counter()
    run = bench.run(dev, timed=timed)
    res = run.result
    print(f"train path: {json.dumps(res)}", flush=True)
    print(f"  wall of the whole protocol {time.perf_counter() - t_start:.1f} s; "
          f"{res['value']:.6e} samples/s, {res['ms_per_step']:.3f} ms per step "
          f"(phase {res['phase_ms_per_step']:.3f}), occupancy update "
          f"{res['occ_update_s_per_chunk']:.4f} s per chunk, final loss {res['final_loss']:.6f}, "
          f"canary {res['psnr_100steps']:.3f} dB (gate {res['psnr_canary_min']})", flush=True)
    print(f"  launches over the timed chunks: {counts}", flush=True)
    if not np.isfinite(res["final_loss"]):
        fail("the train path's final loss is not finite")
    if not res["canary_ok"]:
        fail(f"canary {res['psnr_100steps']} below {res['psnr_canary_min']}")
    cfg = bench.bench_config()
    E, n = cfg.n_ensembles, res["timed_steps"]
    expected = {
        "fused_field_volrend_lossgrad": E * n,  # one per member step
        "fused_render_weights_bwd": E * n,  # the proposal loss's gradient
        "fused_render_weights": 2 * E * n,  # proposal sampling + its recompute
        "fused_spectral_field": E * bench.N_CALLS,  # the occupancy update per chunk
    }
    if counts != expected:
        fail(f"train path launch counts {counts}, expected {expected}")

    # one member step from the trained state: the combined-kernel branch on
    # the kernels against the autograd branch on the plain versions
    state, ds = run.state, run.dataset
    loss_rel, worst_u, worst_g = compare_member_step(dev, state, ds, seed=123)
    if not (loss_rel <= STEP_LOSS_RTOL and worst_u <= STEP_UPDATE_TOL
            and worst_g <= STEP_GRAD_TOL):
        fail("the member step with the kernels disagrees with the plain versions")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, noise = _step_inputs(dev, ds, 123)
    core = make_flagship_member_core(cfg)
    member = copy.deepcopy(state.members[0])
    opt = AdamState(*(t.clone() for t in state.opt[0]))
    core(member, opt, batch, state.step, noise=noise)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        float(core(member, opt, batch, state.step, noise=noise).loss)
        t_p = time.perf_counter() - t_p
    busy = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    ) / 1e6
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    print(f"profiled member step: wall {t_p * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, "
          f"idle share {1 - busy / t_p:.1%}", flush=True)
    return counts


# packed field kernel against its plain version, err / max-abs of the plain
# output, per output and bias case; about 2x the readings on an H100
# (PERF.md). A zeroed output reads 1 and a negated one 2 on the same scale.
K4_TOL = {
    "zero biases": {"rgb": 6e-3, "sigma": 1e-6, "sem": 6e-3},
    "random biases": {"rgb": 2e-2, "sigma": 2e-2, "sem": 1.5e-2},
}
# fused field-and-render kernel against its plain version: the weights'
# max-abs error, and err / max-abs of the plain output per group of per-ray
# sums; about 2x the readings on an H100 (PERF.md)
K5_TOL = {
    "zero biases": {"weights": 4e-7, "rgb": 7e-4, "opacity": 6e-4, "depth": 4e-4, "sem": 7e-4},
    "random biases": {"weights": 6e-3, "rgb": 6e-3, "opacity": 4e-3, "depth": 5e-3,
                      "sem": 1e-2},
}
# one evaluation view of the trained loop, kernel route against plain route,
# per output (rgb and opacity absolute, depth and logits over the plain
# output's max-abs): (99.9th percentile over rays, mean over rays). The
# trained weights have biases, so the two bias conventions meet, and they
# differ from run to run (the proposal loss's backward uses atomics). The
# single worst ray is heavy-tailed (4e-3 to 5.4e-2 over six runs on an H100,
# PERF.md) and is printed, not held. The percentile read 1.3e-3 to 1.4e-3
# and is held to 4e-3 (3x, since the mean moved by 1.7x between runs); the
# mean read 1.2e-4 to 2.0e-4 and is held to 2e-3. Each limit is shown at run
# time to catch a zeroed and a negated output (they read 0.2 to 2).
LOOP_VIEW_TOL = {"rgb": (4e-3, 2e-3), "opacity": (4e-3, 2e-3), "depth": (4e-3, 2e-3),
                 "sem": (4e-3, 2e-3)}


def _set_random_biases(field, gen, dev):
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.split(".")[-1].startswith("b"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)


def _render_inputs(gen, dev, R, S, aabb):
    """Sample positions 10 % past the box on every side, unit directions,
    sorted interval edges, and every 17th ray marked as missing the box."""
    lo, hi = torch.tensor(aabb[:3], device=dev), torch.tensor(aabb[3:], device=dev)
    span = hi - lo
    pos = lo - 0.1 * span + torch.rand((R, S, 3), generator=gen, device=dev) * 1.2 * span
    dirs = torch.randn((R, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    edges = torch.sort(torch.rand((R, S + 1), generator=gen, device=dev) * 2.9 + 0.1,
                       dim=-1).values
    miss = (torch.arange(R, device=dev) % 17) == 0
    return pos, dirs, edges[:, :-1].contiguous(), edges[:, 1:].contiguous(), miss


def _check_groups(label, got, ref, groups, tols, absolute=()):
    """Hold ``got`` to ``ref`` per column group; show that each limit
    catches a zeroed and a negated group. → {group: reading}."""
    readings = {}
    for name, cols in groups.items():
        g, r = got[..., cols], ref[..., cols]
        err, rel = _errs(g, r)
        reading = err if name in absolute else rel
        zeroed = _errs(torch.zeros_like(g), r)[0 if name in absolute else 1]
        negated = _errs(-g, r)[0 if name in absolute else 1]
        readings[name] = reading
        print(f"  {label} {name:8s} max_abs {err:.3e} err/scale {rel:.3e} (tol {tols[name]}"
              f"{' abs' if name in absolute else ''}); zeroed reads {zeroed:.3e}, "
              f"negated {negated:.3e}")
        if not torch.isfinite(g).all():
            fail(f"{label}: non-finite {name}")
        if not reading <= tols[name]:
            fail(f"{label}: {name} disagrees with the plain version: {reading}")
        if not (zeroed > tols[name] and negated > tols[name]):
            fail(f"{label}: the limit on {name} would pass a zeroed or negated output")
    return readings


def phase_k4(dev):
    """The packed field kernel against its plain version at the candidate
    render's shape → (max-abs error of rgb with zero biases, kernel ms,
    plain ms, bound)."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
        fused_field_heads,
        fused_field_heads_plain,
    )
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 8)
    cfg = PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    R, S, C = 4096, 256, cfg.num_semantic_classes
    field = spectral.init_spectral(s_cfg, gen, dev)
    pos, dirs, _, _, _ = _render_inputs(gen, dev, R, S, cfg.aabb)
    groups = {"rgb": slice(0, 3), "sigma": slice(3, 4), "sem": slice(4, 4 + C)}
    record = None
    with torch.inference_mode():
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        for case, tols in K4_TOL.items():
            if case == "random biases":
                _set_random_biases(field, gen, dev)
            leaves = list(field.parameters())
            yk = fused_field_heads(leaves, u, sh, S)
            torch.cuda.synchronize()
            yp = fused_field_heads_plain(leaves, u, sh, S)
            ms = cuda_ms(lambda: fused_field_heads(leaves, u, sh, S), reps=5, inner=5)
            pms = cuda_ms(lambda: fused_field_heads_plain(leaves, u, sh, S), reps=5, inner=3)
            print(f"packed field kernel [{case}] N={R * S} ({R} x {S}) C={C}: kernel "
                  f"{ms:.3f} ms, plain {pms:.3f} ms", flush=True)
            if yk.shape != yp.shape:
                fail(f"packed field kernel ({case}): misshapen output {tuple(yk.shape)}")
            readings = _check_groups(f"packed field [{case}]", yk, yp, groups, tols)
            if case == "zero biases":
                macs = field_macs(s_cfg.n_freqs, s_cfg.neurons, s_cfg.layers, s_cfg.geo_feat_dim,
                                  s_cfg.neurons // 4, C)
                n_bytes = R * S * (12 + 4 * (4 + C)) + R * 64 + field_weight_bytes(field)
                record = (_errs(yk[..., :3], yp[..., :3])[0], ms, pms,
                          bound(2 * macs * R * S, n_bytes))
            del yk, yp, readings
        # no quiet way round the kernel on the card: an f32 field raises
        try:
            fused_field_heads(leaves, u, sh, S, torch.float32)
        except ValueError as e:
            print(f"packed field kernel: f32 compute on the card raises ({e})")
        else:
            fail("the packed field wrapper took an f32 field on the card without its kernel")
    return record


def phase_k5(dev):
    """The fused field-and-render kernel against its plain version at the
    evaluation's shape and at S = 512 → (max-abs error of the weights with
    zero biases at the evaluation's shape, kernel ms, plain ms, bound)."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import (
        FWD_CHUNK_ROWS,
        fused_field_volrend,
        fused_field_volrend_plain,
    )
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 9)
    cfg = PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    C = cfg.num_semantic_classes
    groups = {"rgb": slice(0, 3), "opacity": slice(3, 4), "depth": slice(4, 5),
              "sem": slice(5, 5 + C)}
    record = None
    for R, S in ((25600, 256), (4096, 512)):
        field = spectral.init_spectral(s_cfg, gen, dev)
        pos, dirs, t0_, t1_, miss = _render_inputs(gen, dev, R, S, cfg.aabb)
        with torch.inference_mode():
            u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
            dt = ((t1_ - t0_) * (~miss)[:, None]).reshape(-1).contiguous()
            tm = (0.5 * (t0_ + t1_)).reshape(-1).contiguous()
            del pos
            for case, tols in K5_TOL.items():
                if case == "random biases":
                    _set_random_biases(field, gen, dev)
                leaves = list(field.parameters())
                acc_k, w_k = fused_field_volrend(leaves, u, sh, dt, tm, S)
                torch.cuda.synchronize()
                acc_p, w_p = fused_field_volrend_plain(leaves, u, sh, dt, tm, S)
                ms = cuda_ms(lambda: fused_field_volrend(leaves, u, sh, dt, tm, S),
                             reps=3, inner=3)
                pms = cuda_ms(lambda: fused_field_volrend_plain(leaves, u, sh, dt, tm, S),
                              reps=3, inner=2)
                chunks = -(-R // max(FWD_CHUNK_ROWS // S, 1))
                print(f"fused field-and-render kernel [{case}] R={R} S={S} C={C} "
                      f"({chunks} ray chunks per call): kernel {ms:.3f} ms, plain "
                      f"{pms:.3f} ms", flush=True)
                if acc_k.shape != acc_p.shape or w_k.shape != w_p.shape:
                    fail(f"fused field-and-render kernel ({case}): misshapen output")
                label = f"field-and-render [{case}, {R} x {S}]"
                _check_groups(label, acc_k, acc_p, groups, tols)
                _check_groups(label, w_k[:, None], w_p[:, None], {"weights": slice(0, 1)},
                              tols, absolute=("weights",))
                missed = acc_k[miss]
                if float(missed.abs().max()) != 0.0 or float(w_k.reshape(R, S)[miss].abs().max()):
                    fail(f"{label}: a ray that misses the box has weight")
                if case == "zero biases" and S == 256:
                    macs = field_macs(s_cfg.n_freqs, s_cfg.neurons, s_cfg.layers,
                                      s_cfg.geo_feat_dim, s_cfg.neurons // 4, C)
                    # u, dt, t_mid read and the weights written per sample; SH
                    # read and the sums written per ray; the parameters read
                    n_bytes = (R * S * (12 + 8 + 4) + R * (64 + 4 * (5 + C))
                               + field_weight_bytes(field))
                    record = (_errs(w_k, w_p)[0], ms, pms, bound(2 * macs * R * S, n_bytes))
                del acc_k, w_k, acc_p, w_p
        del u, sh, dt, tm
        torch.cuda.empty_cache()
    return record


LOOP_ARTIFACTS = (
    "train/data0.npz", "test/data0.npz", "uncertainty.npy", "errors.npy", "metrics_ext.npy",
    "throughput.json", "checkpoints/model_0.npz", "checkpoints/model_1.npz",
)
LOOP_TEST_LOC = [[-3.7, 1.5, -4.4], [-4.5, 1.5, -3.8]]
LOOP_TIMED = ("initialization", "nerf_training", "_sample_candidates", "_score_candidates",
              "_observe_and_update", "_evaluate_start", "_evaluate_finish", "save_artifacts")


@contextlib.contextmanager
def _timed_methods(cls, names, log):
    """Host wall time and calls of ``cls``'s methods ``names`` → ``log``."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                calls, seconds = log.get(name, (0, 0.0))
                log[name] = (calls + 1, seconds + time.perf_counter() - t)
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def phase_loop(dev):
    """The active mapping loop through its CLI entry at full width and cut
    depth → (the finished mapper, the loop's launch counts)."""
    import yaml

    from apnerf_tpu_torch.active import pipeline
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.ops.cuda import build

    with open(build.REPO_ROOT / "configs" / "config_fakeprod.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(planning_step=2, training_steps=100, test_loc=LOOP_TEST_LOC,
               save_path=str(build.BUILD_DIR / "chip_smoke_loop"))
    cfg_path = build.BUILD_DIR / "chip_smoke_loop.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    try:
        import imageio  # noqa: F401
        has_imageio = True
    except ImportError:
        has_imageio = False
    print(f"loop: {cfg_path.name} = config_fakeprod.yaml with planning_step 2, training_steps "
          f"100 and 2 test locations; PNG dumps off (imageio "
          f"{'present' if has_imageio else 'absent'} on this host)", flush=True)

    counters = all_counters()
    walls = {}
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed_methods(ActiveNeRFMapper, LOOP_TIMED, walls):
        mapper = pipeline.main(["--sim", "fake", "--sem-num", "29", "--device", str(dev),
                                "--config", str(cfg_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    cfg = mapper.cfg
    print(f"loop: {wall:.1f} s of wall; host wall by method (calls, seconds): "
          + ", ".join(f"{k} ({c}, {s:.2f})" for k, (c, s) in walls.items()), flush=True)
    print(f"  throughput log: {json.dumps(mapper.throughput_log)}")
    print(f"  launches: {counts}")
    for row, ext in zip(mapper.errors_hist, mapper.metrics_ext_hist):
        print(f"  evaluation at planning step {row[0]:.0f}: PSNR {row[1]:.4f} dB, depth MSE "
              f"{row[2]:.6f}, semantic CE {row[3]:.6f}, LPIPS {ext[1]}, mIoU {ext[2]:.6f}")
    chunk_means = [float(np.mean(phase[i:i + 100])) for phase in mapper.loss_hist
                   for i in range(0, len(phase), 100)]
    print(f"  chunk-mean losses: {' '.join(f'{m:.4f}' for m in chunk_means)}; refit "
          f"rollbacks {mapper.refit_rollbacks}", flush=True)

    E, T = cfg.n_ensembles, cfg.training_steps
    if (cfg.num_semantic_classes, cfg.num_traj, cfg.img_w, cfg.num_rays) != (29, 20, 640, 2048):
        fail("the loop did not run at the full width")
    if not np.isfinite(chunk_means).all() or len(chunk_means) != 8:
        fail(f"the loop's losses are not finite, or not 8 chunks: {chunk_means}")
    if not chunk_means[-1] < chunk_means[0]:
        fail("the last chunk's mean loss is not under the first's")
    missing = [a for a in LOOP_ARTIFACTS if not os.path.exists(os.path.join(mapper.save_path, a))]
    if missing:
        fail(f"the loop left no {missing}")
    rows = np.asarray(mapper.errors_hist)
    if rows.shape != (3, 4) or not np.isfinite(rows).all():
        fail(f"expected 3 finite evaluation rows, got {rows}")
    if [r[0] for r in mapper.errors_hist] != [-1.0, 1.0, -10.0]:
        fail(f"evaluations at {[r[0] for r in mapper.errors_hist]}, expected -1, 1, -10")
    if not np.isfinite([m[2] for m in mapper.metrics_ext_hist]).all():
        fail("non-finite mIoU")
    if len(mapper.train_dataset) != 39 + 2 * N_VIEWS:
        fail(f"the train dataset holds {len(mapper.train_dataset)} images")

    # launches: 100 + 2 x 100 + 500 train steps in 8 chunks, 2 planning steps of
    # 20 candidates x 40 views x E members, 3 evaluations of 8 views x E members
    # (one wrapper call per view; each call runs its rays in chunks). A chunk
    # that the refit's divergence guard threw away ran its train steps and no
    # occupancy update; the mapper counts those steps.
    steps = sum(len(phase) for phase in mapper.loss_hist)
    chunks = len(chunk_means)
    ran = steps + mapper.refit_discarded_steps
    if steps != 8 * T or mapper.refit_discarded_steps != mapper.refit_rollbacks * 100:
        fail(f"the loop kept {steps} train steps and discarded "
             f"{mapper.refit_discarded_steps} in {mapper.refit_rollbacks} rollbacks")
    renders = 2 * cfg.num_traj * N_VIEWS * E
    eval_renders = 3 * len(mapper._test_poses) * E
    expected = {
        "fused_field_volrend_lossgrad": E * ran,
        "fused_render_weights_bwd": E * ran,
        "fused_spectral_field": E * chunks,  # the occupancy update
        "fused_field_heads": renders,
        "fused_field_volrend": eval_renders,
        # proposal sampling and its recompute per member step, proposal and
        # main weights per candidate render, proposal weights per evaluation render
        "fused_render_weights": 2 * E * ran + 2 * renders + eval_renders,
    }
    if counts != expected:
        fail(f"loop launch counts {counts}, expected {expected}")

    # the checkpoints reproduce the members bit for bit
    m2 = ActiveNeRFMapper(cfg, mapper.sim, save_path=mapper.save_path + "_reload", seed=1,
                          device=dev)
    m2.load_checkpoints(os.path.join(mapper.save_path, "checkpoints"))
    same = m2.state.step == mapper.state.step
    for a, b in zip(mapper.state.members, m2.state.members):
        same &= all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    for a, b in zip(mapper.state.occ, m2.state.occ):
        same &= torch.equal(a.occs, b.occs) and torch.equal(a.binaries, b.binaries)
    for a, b in zip(mapper.state.opt, m2.state.opt):
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"  checkpoints reload bit for bit: {bool(same)} (step {m2.state.step})", flush=True)
    if not same:
        fail("load_checkpoints does not reproduce the members")
    return mapper, counts


def phase_loop_routes(mapper):
    """Inside the trained loop's renders, the kernel route against the
    plain route: the first candidate of a planning step and one
    evaluation view."""
    candidates = mapper._sample_candidates(mapper.binaries_host(), mapper.current_pose[:3])
    pi_k = np.asarray([float(v) for v in mapper.dispatch_uncertainty(candidates[0])])
    with plain_routes():
        pi_p = np.asarray([float(v) for v in mapper.dispatch_uncertainty(candidates[0])])
    rel = np.abs(pi_k - pi_p) / np.maximum(np.abs(pi_p), 1e-12)
    print(f"loop renders: candidate 0 PI kernels {pi_k.tolist()} plain {pi_p.tolist()} "
          f"max rel diff {rel.max():.3e} (tol {PI_RTOL})", flush=True)
    if not rel.max() <= PI_RTOL:
        fail(f"the trained loop's PI with kernels disagrees with the plain versions: {rel}")

    oh, ow = mapper._eval_size(mapper.eval_scale)
    rays = mapper._pose7_to_grid_rays(mapper._test_poses[:1], oh, ow)
    white = torch.ones(3, device=mapper.device)
    st = mapper.state
    out_k = mapper._render_eval(st.members, st.occ, rays.origins, rays.viewdirs, white)
    with plain_routes():
        out_p = mapper._render_eval(st.members, st.occ, rays.origins, rays.viewdirs, white)
    for name, (tol_q, tol_mean) in LOOP_VIEW_TOL.items():
        got, ref = out_k[name].float(), out_p[name].float()
        scale = 1.0 if name in ("rgb", "opacity") else max(float(ref.abs().max()), 1e-30)

        def reading(x):
            diff = (x - ref).abs().reshape(-1) / scale
            return float(torch.quantile(diff, 0.999)), float(diff.mean()), float(diff.max())

        q, mean, worst = reading(got)
        corrupt = {"zeroed": reading(torch.zeros_like(got)), "negated": reading(-got)}
        print(f"  evaluation view {name:8s} p99.9 {q:.3e} (tol {tol_q}), mean {mean:.3e} "
              f"(tol {tol_mean}), worst ray {worst:.3e}, scale {scale:.3e}; "
              + ", ".join(f"{k} reads p99.9 {v[0]:.3e} mean {v[1]:.3e}"
                          for k, v in corrupt.items()))
        if not (q <= tol_q and mean <= tol_mean):
            fail(f"the evaluation view's {name} with kernels disagrees with the plain route")
        if not all(v[0] > tol_q and v[1] > tol_mean for v in corrupt.values()):
            fail(f"the limits on the evaluation view's {name} would pass a zeroed or "
                 "negated output")


def phase_modes(mapper):
    """Two planning steps of 4 candidates and 100 train steps each, in the
    overlapped and in the serial mode, from the loop's trained state."""
    mapper.cfg = dataclasses.replace(mapper.cfg, num_traj=4)
    for overlap in (True, False, False, True):
        mapper.overlap_planning = overlap
        mapper.trajector_uncertainty_list = [[] for _ in range(mapper.cfg.planning_step)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapper.planning(mapper.cfg.planning_step, mapper.cfg.training_steps)
        torch.cuda.synchronize()
        print(f"planning modes: overlap_planning={overlap}: {time.perf_counter() - t0:.2f} s "
              f"for 2 steps of 4 candidates and 100 train steps", flush=True)


if __name__ == "__main__":
    sys.exit(main())
