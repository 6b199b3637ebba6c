"""Drive the PyTorch port's planning step, train step and whole active
mapping loop on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below but 12
    python3 chip_smoke.py --modes    # and phase 12
    python3 chip_smoke.py --field-kernels   # phase 1, then only the main
                                     # field's kernels and their times

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
     terms and rows, weights and every gradient leaf, and two runs of the
     same inputs that agree to the last bit;
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
     overlapped and in the serial mode, wall time of each;
 13. the backwards of the render and trunk kernels against autograd
     through their plain versions at the train shape (2048 x 128 rows, 29
     classes; the field kernel's also at the proposal field's 2048 x 64
     rows with 32 frequencies and a 2 x 64 trunk), zero and random biases,
     every gradient leaf and du / dx, each limit shown to catch a zeroed
     and a negated gradient, from the cotangents a train loss hands each
     of them: the fused field-and-render kernel's (with a real cotangent
     of the weights), the packed field kernel's, the field kernel's, and
     the MLP kernel forward and backward at [262,144, 256] with x in bf16
     and in f32;
 14. the member core's four other train routes (``volrend``, ``packed``,
     ``field``, ``field`` again with the proposal field through the field
     kernel too, ``trunk``): the bench protocol at full width on the scan
     of phase 7, one warm-up and one timed chunk of 100 steps each, ms per
     step, a finite falling loss, exact launch counts, one member step of
     the route against the same route on the plain versions (the main
     field's tensors and the proposal field's each at their limits), and
     one member step traced.
 15. (``--diagnose`` only) for the routes ``packed`` and ``volrend``, one
     member step with the forward kernels and the plain backwards between
     the two sides of phase 14's comparison: how much of a difference is
     the backward kernel's and how much the forwards'.
Phases 13 to 15 run after phase 9. ``--field-kernels`` runs phase 1 and
the kernel comparisons of phases 6, 8, 9 and 13's two render backwards,
prints one line of times for each and no ``ok`` line: for comparing two
trees in one call.

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
    # the host-side mirrors of the field kernels' layouts, against the kernels' own
    from apnerf_tpu_torch.ops.cuda import field_images

    lib = build.library()
    for n_hidden in (2, 3):
        mirror = (field_images.fwd_smem_bytes(n_hidden), field_images.bwd_smem_bytes(),
                  field_images.dw_smem_bytes(), field_images.n_bias(n_hidden))
        own = tuple(lib.apnerf_field_layout(which, n_hidden) for which in range(4))
        if mirror != own or max(own[:3]) > field_images.MAX_SMEM:
            fail(f"field kernel layouts {own} differ from their mirrors {mirror}")
    print(f"field kernels: shared memory forward / backward / dW {own[:3]} bytes of "
          f"{field_images.MAX_SMEM}", flush=True)

    if "--field-kernels" in argv:
        return field_kernels_alone(dev)

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
    bench_run = phase_train(dev)

    # ---- 8-9. the render kernels against their plain versions ---------------------
    records["fused_field_heads"] = phase_k4(dev)
    records["fused_field_volrend"] = phase_k5(dev)

    # ---- 13-14. the kernels' backwards and the train routes that run them ----------
    records["fused_field_volrend_bwd"] = phase_render_bwd(dev, "volrend")
    records["fused_field_heads_bwd"] = phase_render_bwd(dev, "heads")
    records["fused_spectral_field_bwd"] = phase_k1_bwd(dev)
    records["fused_mlp_apply"], records["fused_mlp_apply_bwd"] = phase_k3(dev)
    route_launches = phase_routes(dev, bench_run)
    if "--diagnose" in argv:
        phase_backward_alone(dev, bench_run)
    del bench_run

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
        {"name": "fused_field_volrend_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_field_volrend.py:598"},
        {"name": "fused_field_heads_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_heads.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_field_heads.py:438"},
        {"name": "fused_spectral_field_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:348"},
        {"name": "fused_mlp_apply", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:433"},
        {"name": "fused_mlp_apply_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:292"},
    ]
    for k in kernels:
        err, ms, pms, (bound_ms, bound_by), *rel = records[k["name"]]
        # launches: over the main path that runs the kernel: the loop of phase
        # 10, or for the kernels of the train routes the timed chunk of its
        # route in phase 14. No single PyTorch call computes any of these
        # functions (a whole field, a render, its backward, a whole MLP with
        # the bf16 contract), so no library time.
        n = launches[k["name"]] or route_launches.get(k["name"], 0)
        if n == 0:
            fail(f"no main path launched {k['name']}")
        k.update(launches=n, max_abs_err=err, ms=ms, plain_ms=pms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        if rel:
            # a backward's leaves differ in scale by orders of magnitude, so its
            # max-abs error is that of the largest leaf: the worst error over
            # its own leaf's max-abs says how far the kernel is off
            k["max_err_over_leaf_scale"] = rel[0]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def field_kernels_alone(dev) -> int:
    """(``--field-kernels`` only) The main field's five kernels against
    their plain versions at their main shapes and nothing else, one line
    each, then the packed field kernel's launch alone with the weights
    repacked once: the short run for comparing two trees in one call. Prints
    no ``ok`` line."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import build, fused_field_heads as ffh
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    for name, phase in (
        ("fused_field_heads", lambda: phase_k4(dev)),
        ("fused_field_volrend_lossgrad", lambda: phase_k6(dev)),
        ("fused_field_volrend", lambda: phase_k5(dev)),
        ("fused_field_heads_bwd", lambda: phase_render_bwd(dev, "heads")),
        ("fused_field_volrend_bwd", lambda: phase_render_bwd(dev, "volrend")),
    ):
        err, ms, pms, (bound_ms, _), *_ = phase()
        print(f"field kernels alone: {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound_ms:.4f} ms, max_abs_err {err:.3e}", flush=True)
    gen = _generator(dev, 8)
    cfg = PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    R, S = 4096, 256
    field = spectral.init_spectral(s_cfg, gen, dev)
    pos, dirs, _, _, _ = _render_inputs(gen, dev, R, S, cfg.aabb)
    with torch.inference_mode():
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        fld = ffh.prepare_field("fused_field_heads", list(field.parameters()), dev)
        y = torch.empty((R * S, 4 + fld.C), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch():
            if ffh.launch_field_rows(build.library(), fld, u.data_ptr(), sh.data_ptr(),
                                     y.data_ptr(), R * S, S, stream) != 0:
                fail("the packed field kernel did not launch")

        print(f"field kernels alone: fused_field_heads without the wrapper (weights repacked "
              f"once) N={R * S}: {cuda_ms(launch):.4f} ms", flush=True)
    print(nvidia_smi())
    return 0


def all_counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
        fused_field_heads,
        fused_field_heads_bwd,
    )
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import (
        fused_field_volrend,
        fused_field_volrend_bwd,
        fused_field_volrend_lossgrad,
    )
    from apnerf_tpu_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply,
        fused_mlp_apply_bwd,
        fused_spectral_field,
        fused_spectral_field_bwd,
    )
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_bwd,
    )

    return {f.__name__: f for f in (
        fused_spectral_field, fused_render_weights, fused_render_weights_bwd,
        fused_field_volrend_lossgrad, fused_field_heads, fused_field_volrend,
        fused_field_volrend_bwd, fused_field_heads_bwd, fused_spectral_field_bwd,
        fused_mlp_apply, fused_mlp_apply_bwd)}


def reset_counts(counters):
    for f in counters.values():
        f.launches = 0


def read_counts(counters):
    return {name: f.launches for name, f in counters.items()}


@contextlib.contextmanager
def plain_routes():
    """Every kernel of the render and train paths replaced by its plain
    version where the port's modules look it up (autograd then goes through
    the plain versions, so no backward kernel runs either)."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops import volrend
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import fused_field_heads_plain
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import fused_field_volrend_plain
    from apnerf_tpu_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply_plain,
        fused_spectral_field_plain,
    )
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

    saved = (spectral.fused_spectral_field, spectral.fused_mlp_apply, spectral.fused_field_heads,
             spectral.fused_field_volrend, volrend.fused_render_weights)
    spectral.fused_spectral_field = fused_spectral_field_plain
    spectral.fused_mlp_apply = fused_mlp_apply_plain
    spectral.fused_field_heads = fused_field_heads_plain
    spectral.fused_field_volrend = fused_field_volrend_plain
    volrend.fused_render_weights = fused_render_weights_plain
    try:
        yield
    finally:
        (spectral.fused_spectral_field, spectral.fused_mlp_apply, spectral.fused_field_heads,
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
        # nothing is accumulated across blocks in an order that the timing
        # decides: a second run gives the same bits
        lk2, wk2, gk2 = kernel()
        again = _flat(gk2)
        same = (torch.equal(lk, lk2) and torch.equal(wk, wk2)
                and all(torch.equal(v, again[k]) for k, v in _flat(gk).items()))
        print(f"train-step kernel [{case}]: two runs bit-identical: {same}", flush=True)
        if not same:
            fail(f"train-step kernel ({case}): two runs of the same inputs differ")
        del lk2, wk2, gk2, again
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


def compare_member_step(dev, state, ds, seed, route="lossgrad", fused_prop=False,
                        tols=(STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_GRAD_TOL), prop_tols=None):
    """One member step of member 0 from ``state`` on a batch drawn with
    ``seed``: ``route`` on the kernels against the same route with the
    plain versions in place of the kernels (for the combined-kernel branch,
    whose plain version returns gradients too, against the autograd branch
    ``field`` on the plain versions). Holds the loss (relative) to
    ``tols[0]`` and every tensor's update and gradient (err / max-abs) to
    ``tols[1:]``; ``prop_tols``, where given, are the (update, gradient)
    limits of the proposal field's tensors. → (loss relative error, worst
    update and worst gradient over the main field's tensors, the same over
    the proposal field's). The gradient is recovered from Adam's first
    moment, g = (mu' - b1 mu) / (1 - b1)."""
    import copy

    from apnerf_tpu_torch import bench
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

    mk, ok = one_step(make_flagship_member_core(cfg, route, fused_prop=fused_prop))
    with plain_routes():
        mp, op_ = one_step(make_flagship_member_core(
            cfg, "field" if route == "lossgrad" else route, fused_prop=fused_prop))
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
    limits = {"main": tuple(tols[1:]), "prop": tuple(prop_tols or tols[1:])}
    worst = {
        part: (max(r[1] for r in rows if r[0].startswith(part)),
               max(r[2] for r in rows if r[0].startswith(part)))
        for part in limits
    }
    print(f"  member step on route {route}{' with fused_prop' if fused_prop else ''} (batch seed "
          f"{seed}), kernels vs plain versions: loss {float(ok.loss):.6f} vs "
          f"{float(op_.loss):.6f} (rel {loss_rel:.3e}, tol {tols[0]}); "
          + "; ".join(
              f"{part} field: update worst err/scale {worst[part][0]:.3e} (tol "
              f"{limits[part][0]}), gradient {worst[part][1]:.3e} (tol {limits[part][1]})"
              for part in limits), flush=True)
    for name, ru, rg in rows:
        print(f"    {name:24s} update {ru:.3e} gradient {rg:.3e}")
    over = [part for part in limits
            if not (worst[part][0] <= limits[part][0] and worst[part][1] <= limits[part][1])]
    if not loss_rel <= tols[0] or over:
        fail(f"the member step on route {route} with the kernels disagrees with the plain "
             f"versions (loss {loss_rel:.3e}, tensors of {over or 'no'} field over their limits)")
    return loss_rel, worst["main"], worst["prop"]


def phase_train(dev):
    """The bench protocol in process, launch counts over its timed chunks,
    then one member step with the kernels against one with their plain
    versions. → the bench's data and run (phase 14 trains on the same scan)."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_bwd,
    )

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
    data = bench.make_data(dev)
    run = bench.run(dev, timed=timed, data=data)
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
    compare_member_step(dev, state, ds, seed=123)

    profile_member_step(dev, state, ds, "lossgrad")
    return data, run


def profile_member_step(dev, state, ds, route, fused_prop=False, rows=20):
    """One member step of ``route`` from ``state`` traced with
    ``torch.profiler``: device time by kernel and the device's idle share."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    batch, noise = _step_inputs(dev, ds, 123)
    core = make_flagship_member_core(bench.bench_config(), route, fused_prop=fused_prop)
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
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows))
    print(f"profiled member step on route {route}: wall {t_p * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / t_p:.1%}", flush=True)


# A member step of each autograd route on its kernels against the same route
# on the plain versions: (loss relative, update err/scale, gradient
# err/scale) for every tensor, as for the combined-kernel branch above, and
# for the proposal field's tensors where they have limits of their own.
# About 2x one reading on an H100 (PERF.md; the readings repeated to the
# last digit over three runs at this depth). A zeroed (negated) gradient
# reads 0.75 (1.47) for the update and 1 (2) for the gradient, over every
# limit here. With ``fused_prop`` the two sides sample from proposal
# densities that differ by the bias convention, so they render other
# samples: the main field's tensors read higher than without, and the
# proposal field's, whose gradients come through the proposal loss alone,
# highest.
ROUTE_STEP_TOL = {
    ("volrend", False): ((4e-4, 3.5e-1, 3.2e-2), None),
    ("packed", False): ((2.5e-4, 2e-1, 9e-2), None),
    ("field", False): ((STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_GRAD_TOL), None),
    ("field", True): ((3e-4, 2e-1, 9e-2), (1e-1, 2.2e-1)),
    ("trunk", False): ((STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_GRAD_TOL), None),
}


def phase_routes(dev, bench_run):
    """The member core's four autograd routes through the bench protocol on
    the scan of the train path's phase, depth cut to one warm-up and one
    timed chunk each → the launch counts of each route's own kernels over
    its timed chunk."""
    from apnerf_tpu_torch import bench

    data, _ = bench_run
    cfg = bench.bench_config()
    E = cfg.n_ensembles
    counters = all_counters()
    own = {}
    # (route, the proposal field through the field kernel too, the route's
    # own kernels); the field route runs twice, the second time with the
    # proposal field along, so the field kernel's backward runs at both of
    # its shapes on a train path
    for route, fused_prop, kernels in (
        ("volrend", False, ("fused_field_volrend", "fused_field_volrend_bwd")),
        ("packed", False, ("fused_field_heads", "fused_field_heads_bwd")),
        ("field", False, ("fused_spectral_field", "fused_spectral_field_bwd")),
        ("field", True, ("fused_spectral_field", "fused_spectral_field_bwd")),
        ("trunk", False, ("fused_mlp_apply", "fused_mlp_apply_bwd")),
    ):
        counts = {}

        @contextlib.contextmanager
        def timed():
            reset_counts(counters)
            yield
            counts.update(read_counts(counters))

        t_start = time.perf_counter()
        run = bench.run(dev, timed=timed, route=route, fused_prop=fused_prop, n_calls=1,
                        data=data)
        res = run.result
        n = res["timed_steps"]
        first, last = float(run.losses[:10].mean()), float(run.losses[-10:].mean())
        print(f"train route {route}{' with fused_prop' if fused_prop else ''}: "
              f"{res['ms_per_step']:.3f} ms per step (phase {res['phase_ms_per_step']:.3f}) over "
              f"{n} timed steps, {res['value']:.6e} samples/s; loss {first:.6f} over the first "
              f"10 steps of the warm-up chunk, {last:.6f} over the last 10 timed steps, final "
              f"{res['final_loss']:.6f}; canary {res['psnr_100steps']:.3f} dB after "
              f"{n + bench.STEPS_PER_CALL} steps (not gated at this depth); wall "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"  launches over the timed chunk: {counts}", flush=True)
        if not (torch.isfinite(run.losses).all() and np.isfinite(res["final_loss"])):
            fail(f"train route {route}: a loss is not finite")
        if not last < first:
            fail(f"train route {route}: the loss did not fall ({first} -> {last})")
        # per member step: the proposal level's weights, forward and backward,
        # on every route; the main weights' too where the route renders with
        # the weights kernel; the route's own kernels once each, the field
        # kernel once more per member for the occupancy update of the chunk
        main_w = 0 if route == "volrend" else 1
        expected = dict.fromkeys(counts, 0)
        expected.update(fused_render_weights=(1 + main_w) * E * n,
                        fused_render_weights_bwd=(1 + main_w) * E * n,
                        fused_spectral_field=E)
        for k in kernels:
            expected[k] = expected.get(k, 0) + E * n
        if fused_prop:  # the proposal field's sampling pass, forward and backward
            expected["fused_spectral_field"] += E * n
            expected["fused_spectral_field_bwd"] += E * n
        if counts != expected:
            fail(f"train route {route} launch counts {counts}, expected {expected}")
        own.update({k: counts[k] for k in kernels})

        tols, prop_tols = ROUTE_STEP_TOL[route, fused_prop]
        compare_member_step(dev, run.state, run.dataset, seed=123, route=route,
                            fused_prop=fused_prop, tols=tols, prop_tols=prop_tols)
        profile_member_step(dev, run.state, run.dataset, route, fused_prop, rows=10)
        del run
        torch.cuda.empty_cache()
    return own


@contextlib.contextmanager
def plain_backwards():
    """The packed field kernel and the fused field-and-render kernel keep
    their forward kernels and take the plain backward on the same
    cotangents, where ``models/spectral.py`` looks them up."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr

    def hybrid(forward, backward_plain, n_rest):
        class Hybrid(torch.autograd.Function):
            @staticmethod
            def forward(ctx, n_leaves, *args):
                ctx.n = n_leaves
                ctx.save_for_backward(*args)
                leaves, rest = list(args[:n_leaves]), args[n_leaves:]
                with torch.no_grad():
                    return forward(leaves, *rest[:n_rest], int(rest[n_rest]))

            @staticmethod
            def backward(ctx, *gs):
                args = ctx.saved_tensors
                leaves, rest = list(args[:ctx.n]), args[ctx.n:]
                gs = [None if g is None else g.contiguous() for g in gs]
                grads, du = backward_plain(leaves, *rest[:n_rest], int(rest[n_rest]), *gs,
                                           ctx.needs_input_grad[1 + ctx.n])
                return (None, *grads, du, *[None] * n_rest)

        def call(leaves, *rest_and_dtype):
            *rest, S = rest_and_dtype[:n_rest + 1]
            return Hybrid.apply(len(leaves), *leaves, *rest, torch.tensor(S))

        return call

    saved = spectral.fused_field_heads, spectral.fused_field_volrend
    spectral.fused_field_heads = hybrid(ffh.fused_field_heads, ffh.fused_field_heads_bwd_plain, 2)
    spectral.fused_field_volrend = hybrid(fvr.fused_field_volrend,
                                          fvr.fused_field_volrend_bwd_plain, 4)
    try:
        yield
    finally:
        spectral.fused_field_heads, spectral.fused_field_volrend = saved


def phase_backward_alone(dev, bench_run, routes=("packed", "volrend")):
    """(``--diagnose`` only) Where a route's member step differs from the
    same route on the plain versions: one step from a state trained for 200
    steps with the kernels (A), with the forward kernels and the plain
    backwards (B) and with the plain versions (C), the gradient of every
    tensor, err / max-abs: A against B is the backward kernel alone on
    equal cotangents, B against C the two forwards."""
    import copy

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    cfg = bench.bench_config()
    for route in routes:
        run = bench.run(dev, route=route, n_calls=1, data=bench_run[0])
        state = run.state
        old, opt0 = state.members[0], state.opt[0]
        sizes = [p.numel() for p in old.parameters()]
        for seed in (123, 7):
            batch, noise = _step_inputs(dev, run.dataset, seed)

            def gradients():
                out = make_flagship_member_core(cfg, route)(
                    copy.deepcopy(old), AdamState(*(t.clone() for t in opt0)), batch,
                    state.step, noise=noise)
                return torch.split((out.opt.mu - 0.9 * opt0.mu) / 0.1, sizes)

            ga = gradients()
            with plain_backwards():
                gb = gradients()
            with plain_routes():
                gc = gradients()
            print(f"route {route}, batch seed {seed}: gradient err / max-abs, kernels (A), "
                  f"forward kernels with plain backwards (B), plain versions (C)")
            for (name, _), a, b, c in zip(old.named_parameters(), ga, gb, gc):
                if name.startswith("main"):
                    print(f"    {name:24s} A-C {_errs(a, c)[1]:.3e}  B-C {_errs(b, c)[1]:.3e}  "
                          f"A-B {_errs(a, b)[1]:.3e}")
        del run
        torch.cuda.empty_cache()


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


# The backwards of the render kernels and of the trunk kernels against
# autograd through their plain versions, per gradient leaf: err / max-abs of
# the plain gradient, (default limit, leaves with their own limit), about 2x
# the readings on an H100 (PERF.md; seeded inputs, both sides deterministic).
# A zeroed gradient reads 1 and a negated one 2 on this scale, and each
# limit is checked at run time to lie under both. The cotangents are those a
# train step hands each backward (``_loss_cotangents``): a loss's, with
# structure across rows, as the train-step kernel's are. With zero biases
# the two sides differ by the bf16 rounding points (per-ray cotangents, head
# inputs, cotangents between layers). With random biases they also differ
# by the bias convention (the plain versions add hidden biases in bf16 after
# rounding, the kernels in f32 before), which flips the ReLU mask of units
# near zero: the spectrum's gradients (sums over all rows with
# cancellation) and the per-sample position gradient read highest.
BWD_TOL = {
    "fused_field_volrend_bwd": {
        "zero biases": (1e-2, {}),
        "random biases": (2e-2, {"W": 1.5e-1, "phase": 1.4e-1, "mlp_base.w0": 9e-2,
                                 "du": 1.7e-1}),
    },
    "fused_field_heads_bwd": {
        "zero biases": (1.2e-2, {"du": 2e-2}),
        "random biases": (2e-2, {"W": 2.2e-1, "phase": 2.1e-1, "mlp_base.w0": 1.1e-1,
                                 "du": 3e-1}),
    },
    "fused_spectral_field_bwd": {
        "zero biases": (1.2e-2, {}),
        "random biases": (2e-2, {"W": 1.7e-1, "phase": 1.7e-1, "w0": 1e-1, "w1": 4e-2,
                                 "du": 2e-1}),
    },
    "fused_spectral_field_bwd, proposal field": {
        "zero biases": (1.4e-2, {}),
        "random biases": (2.4e-2, {"W": 1.6e-1, "phase": 1.5e-1, "du": 2.4e-1}),
    },
    "fused_mlp_apply_bwd": {
        "zero biases": (1.2e-2, {}),
        "random biases": (2e-2, {"w0": 1.1e-1, "w1": 3e-2, "dx": 3e-1}),
    },
}
K3_FWD_TOL = {"zero biases": 1e-5, "random biases": 1e-2}  # as the field kernel's


def _check_grads(label, names, got, ref, tol, leaf_tol):
    """Hold each gradient to its plain version on the leaf's scale and show
    that its limit catches a zeroed and a negated gradient → (the largest
    max-abs error, the largest err / leaf scale)."""
    over, worst_abs, worst_rel = [], 0.0, 0.0
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not torch.isfinite(g.float()).all():
            fail(f"{label}: gradient {name} is misshapen or not finite")
        err, rel = _errs(g, r)
        lim = leaf_tol.get(name, tol)
        zeroed, negated = _errs(torch.zeros_like(g), r)[1], _errs(-g, r)[1]
        print(f"  grad {name:20s} max_abs {err:.3e} err/scale {rel:.3e} (tol {lim}) scale "
              f"{float(r.float().abs().max()):.3e}; zeroed reads {zeroed:.3e}, negated "
              f"{negated:.3e}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if not rel <= lim:
            over.append(name)
        if not (zeroed > lim and negated > lim):
            fail(f"{label}: the limit on {name} would pass a zeroed or negated gradient")
    print(f"  worst gradient err/scale {worst_rel:.3e}", flush=True)
    if over:
        fail(f"{label} disagrees with autograd through its plain version (leaves {over})")
    return worst_abs, worst_rel


def _train_inputs(dev, seed):
    """The bench configuration's main field with seeded weights and one
    train step's per-sample inputs at the train shape → (generator, config,
    field config, field, (u [N, 3], sh [R, 16], dt [N], t_mid [N]))."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, seed)
    cfg = bench.bench_config()
    s_cfg = make_spectral_config(cfg)
    field = spectral.init_spectral(s_cfg, gen, dev)
    pos, dirs, t0_, t1_, miss = _render_inputs(
        gen, dev, cfg.num_rays, cfg.max_samples_train, cfg.aabb)
    with torch.no_grad():
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        dt = ((t1_ - t0_) * (~miss)[:, None]).reshape(-1).contiguous()
        tm = (0.5 * (t0_ + t1_)).reshape(-1).contiguous()
    return gen, cfg, s_cfg, field, (u, sh, dt, tm)


def _loss_cotangents(leaves, u, sh, dt, tm, S, n_classes, seed):
    """The cotangents a train step hands each backward, at the plain
    forward's values → (g_acc [R, 5 + C] and g_w [N], of the per-ray sums
    and the weights; g_y [N, 4 + C], of the packed field output; g_h [N, 1 +
    G], of the trunk's output), each the one before it taken back through
    the plain ops. The loss is the train loss (``LOSS_WEIGHTS`` on huber
    rgb, huber depth and cross entropy against seeded targets) plus a term
    on the weights themselves, so g_w is a real cotangent as the proposal
    loss's would be."""
    import torch.nn.functional as F

    from apnerf_tpu_torch.models.ngp import trunc_exp
    from apnerf_tpu_torch.models.nn import apply_layers
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import split_leaves
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import LOSS_WEIGHTS
    from apnerf_tpu_torch.ops.cuda.fused_mlp import encode_plain
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

    dev, N, bf16 = u.device, u.shape[0], torch.bfloat16
    R = N // S
    gen = _generator(dev, seed)
    pix = torch.rand((R, 3), generator=gen, device=dev)
    dgt = torch.rand((R,), generator=gen, device=dev) * 4.0
    lab = torch.randint(0, n_classes, (R,), generator=gen, device=dev)
    bk = torch.tensor([0.2, 0.3, 0.4], device=dev)
    W, phase, trunk, head, semh = split_leaves([t.detach() for t in leaves])
    with torch.enable_grad():
        h = apply_layers(trunk, encode_plain(W, phase, u, bf16), bf16).detach()
        h.requires_grad_(True)
        geo = h[:, 1:]
        sigma = trunc_exp(h[:, 0] - 1.0) * ((u > 0.0) & (u < 1.0)).all(dim=-1)
        x = torch.cat([sh.repeat_interleave(S, dim=0), geo], dim=-1)
        y = torch.cat([torch.sigmoid(apply_layers(head, x, bf16)), sigma[:, None],
                       apply_layers(semh, geo, bf16)], dim=-1)
        y_in = y.detach().requires_grad_(True)
        w = fused_render_weights_plain(
            torch.zeros((R, S), device=dev), dt.reshape(R, S), y_in[:, 3].reshape(R, S)
        )[0].reshape(N)
        per_sample = torch.cat([y_in[:, :3] * w[:, None], w[:, None], (w * tm)[:, None],
                                y_in[:, 4:] * w[:, None]], dim=-1)
        acc = per_sample.reshape(R, S, -1).sum(dim=1)
        acc_in, w_in = (t.detach().requires_grad_(True) for t in (acc, w))
        op = acc_in[:, 3:4]
        depth = acc_in[:, 4] / op[:, 0].clamp(min=torch.finfo(torch.float32).eps)
        terms = (F.huber_loss(acc_in[:, :3] + bk * (1.0 - op), pix, delta=1.0),
                 F.huber_loss(depth, dgt, delta=1.0), F.cross_entropy(acc_in[:, 5:], lab))
        shifted = w.detach().reshape(R, S).roll(1, dims=1).reshape(N)
        loss = sum(c * t for c, t in zip(LOSS_WEIGHTS, terms)) + ((w_in - shifted) ** 2).sum() / R
        g_acc, g_w = torch.autograd.grad(loss, (acc_in, w_in))
        (g_y,) = torch.autograd.grad((acc, w), y_in, (g_acc, g_w))
        (g_h,) = torch.autograd.grad(y, h, g_y)
    return g_acc.contiguous(), g_w.contiguous(), g_y.contiguous(), g_h.contiguous()


def phase_render_bwd(dev, which):
    """The backward of the fused field-and-render kernel (``which`` =
    "volrend": from cotangents of the per-ray sums and of the weights) or
    of the packed field kernel ("heads": from the packed cotangent) against
    autograd through its plain version at the train shape, every leaf and
    du → (largest max-abs error with zero biases, kernel ms, plain ms,
    bound, largest err / leaf scale)."""
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr

    seed = 13 if which == "volrend" else 14
    gen, cfg, s_cfg, field, (u, sh, dt, tm) = _train_inputs(dev, seed)
    R, S, C = cfg.num_rays, cfg.max_samples_train, cfg.num_semantic_classes
    N = R * S
    name = "fused_field_volrend_bwd" if which == "volrend" else "fused_field_heads_bwd"
    names = [n for n, _ in field.named_parameters()] + ["du"]
    record = None
    for case, (tol, leaf_tol) in BWD_TOL[name].items():
        if case == "random biases":
            _set_random_biases(field, gen, dev)
        leaves = list(field.parameters())
        g_acc, g_w, g_y, _ = _loss_cotangents(leaves, u, sh, dt, tm, S, C, seed)
        if which == "volrend":  # with a real cotangent of the weights
            def kernel():
                return fvr.fused_field_volrend_bwd(leaves, u, sh, dt, tm, S, g_acc, g_w, True)

            def plain():
                return fvr.fused_field_volrend_bwd_plain(leaves, u, sh, dt, tm, S, g_acc, g_w,
                                                         True)

            # the cotangents read, du written, beside the train-step kernel's bytes
            extra = N * (4 + 12) + R * 4 * (5 + C)
        else:
            def kernel():
                return ffh.fused_field_heads_bwd(leaves, u, sh, S, g_y, True)

            def plain():
                return ffh.fused_field_heads_bwd_plain(leaves, u, sh, S, g_y, True)

            extra = N * (4 * (4 + C) + 12) - N * 8  # no dt, t_mid
        gk, duk = kernel()
        torch.cuda.synchronize()
        gp, dup = plain()
        ms = cuda_ms(kernel, reps=5, inner=3)
        pms = cuda_ms(plain, reps=3, inner=2)
        print(f"{name} [{case}] R={R} S={S} C={C}: kernel {ms:.3f} ms, plain (forward and "
              f"backward under autograd) {pms:.3f} ms", flush=True)
        worst, rel = _check_grads(f"{name} [{case}]", names, [*gk, duk], [*gp, dup], tol,
                                  leaf_tol)
        if case == "zero biases":
            # the recompute (2 operations per multiply-add) and two products
            # per layer (4); per-sample inputs read once, parameters read and
            # their gradients written
            macs = field_macs(s_cfg.n_freqs, s_cfg.neurons, s_cfg.layers, s_cfg.geo_feat_dim,
                              s_cfg.neurons // 4, C)
            n_bytes = N * (12 + 8) + R * 64 + 2 * field_weight_bytes(field) + extra
            record = (worst, ms, pms, bound(6 * macs * N, n_bytes), rel)
        del gk, duk, gp, dup, g_acc, g_w, g_y
    torch.cuda.empty_cache()
    return record


def _proposal_cotangent(prop, u, R, Sp, seed):
    """The cotangent a proposal-matching loss hands the proposal field's
    raw output [N, 1]: the squared distance of its render weights to seeded
    per-ray histograms, taken back through the plain ops."""
    from apnerf_tpu_torch.models.ngp import trunc_exp
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field_plain
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

    dev = u.device
    gen = _generator(dev, seed)
    edges = torch.sort(torch.rand((R, Sp + 1), generator=gen, device=dev) * 2.9 + 0.1,
                       dim=-1).values
    target = torch.rand((R, Sp), generator=gen, device=dev)
    target = 0.9 * target / target.sum(dim=-1, keepdim=True)
    with torch.enable_grad():
        h = fused_spectral_field_plain(prop.W, prop.phase, prop.mlp_base, u).detach()
        h.requires_grad_(True)
        w, _, _ = fused_render_weights_plain(
            edges[:, :-1], edges[:, 1:], trunc_exp(h[:, 0] - 1.0).reshape(R, Sp))
        (g,) = torch.autograd.grad(((w - target) ** 2).sum() / R, h)
    return g.contiguous()


def phase_k1_bwd(dev):
    """The backward of the field kernel (encode + trunk) against autograd
    through its plain version, at the main trunk's train shape and at the
    proposal field's → (largest max-abs error with zero biases, kernel ms,
    plain ms, bound, largest err / leaf scale) at the main trunk's shape."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm
    from apnerf_tpu_torch.train.flagship import make_prop_config

    gen, cfg, s_cfg, field, (u, sh, dt, tm) = _train_inputs(dev, 15)
    R, S, Sp = cfg.num_rays, cfg.max_samples_train, cfg.num_prop_samples
    p_cfg = make_prop_config(cfg)
    prop = spectral.init_spectral_density(p_cfg, gen, dev)
    u_prop = torch.rand((R * Sp, 3), generator=gen, device=dev)
    record = None
    for label, module, u_ in (("main trunk", field, u), ("proposal field", prop, u_prop)):
        main = label == "main trunk"
        tols = BWD_TOL["fused_spectral_field_bwd" if main
                       else "fused_spectral_field_bwd, proposal field"]
        W, phase, mlp = module.W, module.phase, module.mlp_base
        layers = mlp.layers()
        widths = [w.shape[0] for w, _ in layers] + [layers[-1][0].shape[1]]
        N = u_.shape[0]
        for case, (tol, leaf_tol) in tols.items():
            if case == "random biases":
                _set_random_biases(module, gen, dev)
            if main:
                g = _loss_cotangents(list(field.parameters()), u, sh, dt, tm, S,
                                     cfg.num_semantic_classes, 15)[3]
            else:
                g = _proposal_cotangent(prop, u_, R, Sp, 15)

            def flatten(out):
                dW, dphase, grads, du = out
                return [dW, dphase, *grads, du]

            gk = flatten(fm.fused_spectral_field_bwd(W, phase, layers, u_, g, True))
            torch.cuda.synchronize()
            gp = flatten(fm.fused_spectral_field_bwd_plain(W, phase, layers, u_, g, True))
            ms = cuda_ms(lambda: fm.fused_spectral_field_bwd(W, phase, layers, u_, g, True),
                         reps=5, inner=3)
            pms = cuda_ms(lambda: fm.fused_spectral_field_bwd_plain(W, phase, layers, u_, g, True),
                          reps=3, inner=2)
            print(f"fused_spectral_field_bwd [{label}, {case}] N={N} widths {widths}: kernel "
                  f"{ms:.3f} ms, plain (forward and backward under autograd) {pms:.3f} ms",
                  flush=True)
            names = ["W", "phase"] + [n for n, _ in mlp.named_parameters()] + ["du"]
            worst, rel = _check_grads(f"fused_spectral_field_bwd [{label}, {case}]", names, gk,
                                      gp, tol, leaf_tol)
            if main and case == "zero biases":
                macs = 3 * W.shape[1] + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
                w_bytes = 4 * sum(p.numel() for p in mlp.parameters()) + 16 * W.shape[1]
                # u and g read, du written per row; parameters read, gradients written
                n_bytes = N * (12 + 4 * widths[-1] + 12) + 2 * w_bytes
                record = (worst, ms, pms, bound(6 * macs * N, n_bytes), rel)
            del gk, gp, g
    torch.cuda.empty_cache()
    return record


def phase_k3(dev):
    """The MLP kernel, forward and backward, against its plain version at
    the main trunk's train shape: x [262,144, 256] the spectral features of
    a train step's positions, in bf16 and in f32 → (forward record, backward
    record), each (max-abs error with zero biases, kernel ms, plain ms,
    bound; the backward's also its largest err / leaf scale), for the bf16
    x."""
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm

    gen, cfg, s_cfg, field, (u, sh, dt, tm) = _train_inputs(dev, 16)
    N, S = u.shape[0], cfg.max_samples_train
    mlp = field.mlp_base
    layers = mlp.layers()
    widths = [w.shape[0] for w, _ in layers] + [layers[-1][0].shape[1]]
    with torch.no_grad():
        xs = [fm.encode_plain(field.W, field.phase, u, dtype).contiguous()
              for dtype in (torch.bfloat16, torch.float32)]
    fwd_record = bwd_record = None
    for case, (tol, leaf_tol) in BWD_TOL["fused_mlp_apply_bwd"].items():
        if case == "random biases":
            _set_random_biases(field, gen, dev)
        g = _loss_cotangents(list(field.parameters()), u, sh, dt, tm, S,
                             cfg.num_semantic_classes, 16)[3]
        for x in xs:
            kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
            with torch.no_grad():
                yk = fm.fused_mlp_apply(mlp, x)
                torch.cuda.synchronize()
                yp = fm.fused_mlp_apply_plain(mlp, x)
                f_err, f_rel = _errs(yk, yp)
                f_ms = cuda_ms(lambda: fm.fused_mlp_apply(mlp, x), reps=5, inner=5)
                f_pms = cuda_ms(lambda: fm.fused_mlp_apply_plain(mlp, x), reps=5, inner=3)
            zeroed, negated = _errs(torch.zeros_like(yk), yp)[1], _errs(-yk, yp)[1]
            f_tol = K3_FWD_TOL[case]
            print(f"fused_mlp_apply [{kind} x, {case}] N={N} widths {widths}: err/scale "
                  f"{f_rel:.3e} (tol {f_tol}) max_abs {f_err:.3e}; zeroed reads {zeroed:.3e}, "
                  f"negated {negated:.3e} | kernel {f_ms:.3f} ms, plain {f_pms:.3f} ms",
                  flush=True)
            if not (torch.isfinite(yk).all() and yk.shape == yp.shape and f_rel <= f_tol):
                fail(f"fused_mlp_apply ({kind} x, {case}) disagrees with its plain version")
            if not (zeroed > f_tol and negated > f_tol):
                fail("the limit on fused_mlp_apply would pass a zeroed or negated output")
            gk, dxk = fm.fused_mlp_apply_bwd(layers, x, g, True)
            torch.cuda.synchronize()
            gp, dxp = fm.fused_mlp_apply_bwd_plain(layers, x, g, True)
            if dxk.dtype != x.dtype:
                fail(f"fused_mlp_apply_bwd: dx is {dxk.dtype} for a {x.dtype} x")
            ms = cuda_ms(lambda: fm.fused_mlp_apply_bwd(layers, x, g, True), reps=5, inner=3)
            pms = cuda_ms(lambda: fm.fused_mlp_apply_bwd_plain(layers, x, g, True),
                          reps=3, inner=2)
            print(f"fused_mlp_apply_bwd [{kind} x, {case}]: kernel {ms:.3f} ms, plain (forward "
                  f"and backward under autograd) {pms:.3f} ms", flush=True)
            names = [n for n, _ in mlp.named_parameters()] + ["dx"]
            worst, rel = _check_grads(f"fused_mlp_apply_bwd [{kind} x, {case}]", names,
                                      [*gk, dxk], [*gp, dxp], tol, leaf_tol)
            if kind == "bf16" and case == "zero biases":
                macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
                w_bytes = 4 * sum(p.numel() for p in mlp.parameters())
                xb = x.element_size() * widths[0]
                fwd_record = (f_err, f_ms, f_pms,
                              bound(2 * macs * N, N * (xb + 4 * widths[-1]) + w_bytes))
                # x and g read, dx written per row; parameters read, gradients written
                bwd_record = (worst, ms, pms,
                              bound(6 * macs * N, N * (2 * xb + 4 * widths[-1]) + 2 * w_bytes),
                              rel)
            del yk, yp, gk, dxk, gp, dxp
        del g
    torch.cuda.empty_cache()
    return fwd_record, bwd_record


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
    expected = dict.fromkeys(counts, 0)  # no backward kernel runs on the default route
    expected.update({
        "fused_field_volrend_lossgrad": E * ran,
        "fused_render_weights_bwd": E * ran,
        "fused_spectral_field": E * chunks,  # the occupancy update
        "fused_field_heads": renders,
        "fused_field_volrend": eval_renders,
        # proposal sampling and its recompute per member step, proposal and
        # main weights per candidate render, proposal weights per evaluation render
        "fused_render_weights": 2 * E * ran + 2 * renders + eval_renders,
    })
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
