"""Drive the PyTorch port's planning step, train step and whole active
mapping loop, on both of its paths, on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below but 12
    python3 chip_smoke.py --modes    # and phase 12
    python3 chip_smoke.py --field-kernels   # phase 1, then only the tile's
                                     # kernels and their times
    python3 chip_smoke.py --tree DIR --field-kernels   # the same against the
                                     # package of another checkout in DIR

Phases, each of which must pass:
  1. the device, its power limit and the kernels' build from
     ``apnerf_tpu_torch/csrc`` into ``build/``;
  2. the field kernel (encode + trunk, on the field's wgmma tile) against
     its plain PyTorch version at the main-path shape, the occupancy
     grids' ragged shapes (163,268 and 24,000 rows) and a 2-hidden-layer
     trunk, each limit shown to catch a zeroed and a negated output;
  3. the weights kernel against its plain version at the main field's and
     the proposal field's [rays, samples], with its own device time from
     ``torch.profiler`` beside the CUDA-event window, its device time with
     its inputs out of L2 (64 MB written between launches), the device
     time of an empty kernel launched the same way (the launch floor) and
     its bound at 16 B a sample (what it moves) beside 24 B (when it also
     wrote T and alpha); then at S = 1, 33, 130 and 1024 (every lane-span
     instance's edge, the scalar accesses) and on rows off the 16-byte
     boundary; each limit shown to catch a zeroed and a negated output;
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
     version, dsigma alone at [2048, 64] (the proposal loss of a train
     step) and with and without dt0, dt1 at [4096, 256], its device time
     from the profiler beside the window, L2 cold and beside the launch
     floor, bounds at 20 B a sample (28 B with dt), as in phase 3; then
     both ways at the widths and on the misaligned rows of phase 3;
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
     with the depth cut to 1 planning step of 100 train steps (so 100 +
     100 + 500 train steps) and two test locations. PNG dumps are off.
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
     field's tensors and the proposal field's each at their limits; with
     the proposal field through the field kernel, its update against the
     same step with that kernel's plain backward on the same cotangents),
     and one member step traced.
 15. (``--diagnose`` only) for the routes ``packed`` and ``volrend``, one
     member step with the forward kernels and the plain backwards between
     the two sides of phase 14's comparison: how much of a difference is
     the backward kernel's and how much the forwards'.
 16. fields on each of the tile's four instances (trunk width H in 64,
     128, 256, 512, heads H / 4; M = 32, 64, 128, 256 frequencies) and one
     between two (M = 48, H = 96, zero-padded to 128) at 512 rays x 128
     samples and 375 x 64 (24,000 rows), zero and random biases: K4 fwd, K5
     fwd, K6, K4 bwd, K5 bwd and the field kernel's backward against their
     plain versions, each limit shown to catch a zeroed and a negated
     output, and two runs of K6 at (64, 128) that agree to the last bit;
     then the field kernel and the MLP kernel, forward and backward, at
     seven trunks (the 512 instance, 256 frequencies, inputs of 512 and
     1472, outputs of 17, 32 and 64, widths between two instances), at
     65,536 and 24,000 rows;
 17. one member step at ``spectral_neurons=128`` on the default route,
     from members trained one chunk of 100 steps on the kernels, against
     the autograd branch on the plain versions;
 18. the whole loop through the CLI at ``configs/config_faketiny.yaml``
     (M = 32, the tile's (32, 256) instance) on the card, under
     ``--profile``: finite falling losses, finite evaluation rows, exact
     launch counts, and a Chrome trace that names the train-step kernel's
     and the evaluation render's kernels.
 19. the ngp+occ path (``PipelineConfig()``'s hash grid, 2 x 128 base MLP,
     29 classes, 2 members x 2048 x 128) on the train path's scan: the
     weights kernel forward at [2048, 128], [4096, 256] and [2048, 512] and
     backward (dsigma alone, as the path asks) at [2048, 128] on intervals
     of a real occupancy march, sigma 0 on padded samples, against its
     plain version, L2 cold and beside the launch floor; two chunks of 100 member steps, the second timed with
     exact launch counts; one member step on the kernels against the same
     step with the weights kernel's plain version (loss, every tensor's
     update and gradient, the occupancy grid exactly) and its launches, 1
     forward + 1 backward; one member step traced;
 20. the ngp+occ loop through the CLI: ``config_fakeprod.yaml``'s values
     with ``field_type: ngp`` and ``sampler_type: occ``, its depth cut to 1
     planning step of ``NGP_LOOP_TRAJ`` candidates and 100 train steps (100 +
     100 + 500 train steps, 3
     evaluations): finite falling losses, finite evaluation rows, exact
     launch counts of the weights kernel.
 21. the four example trainers (``train/examples.py``) on an analytic scene
     built here in numpy (three spheres and two boxes inside the aabb ±1.5,
     RGBA with a transparent background, 100 train and 8 test views of
     400^2 on a sphere of radius 4 at NeRF-Synthetic's camera_angle_x):
     NGP + occupancy at the sizes of ``scripts/train_ngp_occ.py`` through
     ``apnerf_tpu_torch.train_ngp_occ.train`` (1100 steps of 4096 rays; ms
     per step over the last chunk of 100, ray-samples and visible samples
     per second and the visible rate over the TITAN RTX yardstick's
     1.95e7, the held-out PSNR over the background alone by
     ``TRAINER_PSNR_MARGIN``); NGP + proposal (unbounded, 'lindisp', near
     0.2, far 1e3), the MLP NeRF and T-NeRF for 100 steps each (a warm-up
     and a timed chunk of 50); for each, exact launches of the weights
     kernel over the timed chunk, one step on the kernels against the same
     step with its plain version (loss, every update and gradient, the
     occupancy grid exactly; each limit failed by a zeroed and a negated
     K2; for NGP + proposal each gradient limit plus the plain step's own
     spread against K2's float64 witness, ``_step_passes``) and K2 forward
     and backward on the intervals the trainer gave it (with dt0, dt1 where
     they carry the proposal field's gradient); the
     count of T-NeRF runs whose density died, over 16 seeds of 48 steps;
     then one forward and backward of NDR-TNeRF at ``NDRTNeRFConfig()`` on 2^17
     points.
 22. the replay loop: a FakeSim ring of ``REPLAY_FRAMES`` inward-facing
     views at ``config_fakeprod.yaml``'s width (640^2) written by
     ``RayDataset.save``, then ``apnerf_tpu_torch.replay_eval`` on it at the
     flagship's full width (2 members x 2048 rays x 128 samples, 3 x 256
     trunk, the recording's classes), its depth cut to 100 train steps a
     phase and 1 planning step: every supervised camera a recorded one to
     1e-5, finite error rows, exact launch counts, wall by method.
 23. the visualisation renders on phase 22's mapper: ``render_comparison``
     on 2 held-out recorded poses, ``walkthrough`` of 4 frames and the
     viewer's scripted keys "wasd", with exact launch counts; each NeRF
     panel equal to ``_render_eval``'s output on the same rays through the
     colour maps, and those renders against the plain route within phase
     9's limits for the fused field-and-render kernel (on the 99.9th
     percentile over rays).
 24. the mesh (``parallel/``) at full width on ranks that share the card:
     the sharded flagship phase (phase 7's sizes, 20 steps from the bench's
     trained state, then the chunk's occupancy update) and ngp+occ phase
     (phase 19's, 10 steps from its trained state) on (2, 1) and (1, 2)
     meshes, each against the unsharded phase in this process on the same
     draws and weights ((2, 1) to one member step's limits, (1, 2) to JAX's
     shard_map bounds, the ngp+occ phase to ``NGP_STEP_TOL``), with exact
     launches per rank; 4 candidates of 40 views x 4096 x 256 rendered on
     both meshes, bit for bit against the unsharded render; ms per ensemble
     step on each mesh, the render's wall, the backend and device map.
 25. the mesh-mode mapper: phase 22's replay loop on a (2, 1) mesh at its
     settings (the same trajectory as phase 22, its rows reported against
     phase 22's, every camera a recorded one, exact launches per rank, rank
     0's checkpoints reloaded into an unsharded mapper bit for bit), then
     ``--mesh 2,1`` at ``config_faketiny.yaml`` and ``python -m
     apnerf_tpu_torch.dryrun 4`` as subprocesses, each exiting 0 with
     finite rows.
 26. the field tile past 64 classes and 15 geometry features: K4 fwd and
     bwd, K5 fwd and bwd and K6 against their plain versions at (H, geo,
     classes) = (256, 31, 101), (256, 47, 256), (512, 31, 150) and (64, 15,
     65), each on its tier (T_out, C_pad) of the trunk output and the
     semantic output, at 512 x 128 rows, zero and random biases, each limit
     shown to catch a zeroed and a negated output; K4 fwd, K5 fwd and K6 at
     the candidate render's, the evaluation's and the train step's shapes
     with the main path's wide field (``config_fakeprod.yaml``'s widths,
     ``geo_feat_dim: 31``, 101 classes), times and bounds; the bench
     protocol at that field's full width (a warm-up and a timed chunk of
     100 steps on phase 7's scan, exact launches, ms per step beside phase
     7's), one member step against the plain versions and one traced.
 27. the tile's last tier and its widest instance: fields past the set
     (1025 classes, 64 geometry features, a 2048-wide trunk, 512
     frequencies on a 1024-wide one) raise from K4's, K5's and K6's
     wrappers before any launch; K4 fwd and bwd, K5 fwd and bwd, K6 and K1
     bwd against their plain versions on the tier (64, 1024) at every
     instance ((256, 63, 847), (64, 48, 257), (128, 63, 1024), (512, 63,
     1000)), on the 1024 instance ((1024, 15, 29), (1024, 63, 1024)) and at
     a 300-wide trunk on the 512 instance, 512 x 128 rows, zero and random
     biases, each limit shown to catch a zeroed and a negated output; K1
     and K3 forward and backward on 1024-wide trunks (and K1 at H = 300);
     K6's kernels' device time with the 847-class, geo-63 field; the bench
     protocol (a warm-up and a timed chunk of 100 steps, exact launches, a
     finite falling loss) at that field and at a 1024-wide trunk; then
     ``apnerf_tpu_torch.active.pipeline.main --sem-num 847`` at
     ``config_fakeprod.yaml``'s width with ``geo_feat_dim: 63`` and
     ``spectral_neurons: 1024``, its depth cut to 1 planning step of 4
     candidates, 20 train steps a phase and one test location: finite
     losses and rows, exact launches.
Phases 13 to 17, 26, 27, 19 and 24 run after phase 9, phases 18, 20 to 23
and 25 after phase 11. Phase 1 also holds the host's mirrors of the tile's
shared-memory layouts to the kernels' own at every instance and tier. ``--field-kernels`` runs phase 1 and the
kernel comparisons of phases 6, 8, 9 and 13 (the two render backwards and
the trunk kernels forward and backward), K1 fwd at 1,048,576 rows, the
packed field kernel's launch alone, the device time of K6's kernels and
a sha256 of the shipping field's kernels' outputs on seeded inputs,
prints one line of times for each and no ``ok`` line: for comparing two trees in
one call. ``--prop-states N`` runs phase 1, then phase 21's NGP + proposal
step comparison at N trained states against each reference of
``K2_REFERENCES`` (``probe_prop_states``) and no ``ok`` line. With ``--tree
DIR`` it runs against the package (and builds the
kernels) of the checkout in DIR, whose layout mirrors it does not check:
the same script times an older tree and this one.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit, before that one JSON object with
each kernel's launches, error and times (the weights kernel's rows also
its launches over the ngp+occ loop and over phase 21's timed chunks, and
its times at each trainer's shape; the main field's kernels the tile's
instances and phases 26 and 27's readings), and before that the smoke's total
wall time. Any failure exits non-zero
before those lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
K2_TOL = 1e-5  # max-abs error against the plain version in float64; weights in [0, 1]
PI_RTOL = 2e-2  # PI terms, kernels against plain versions; bf16 rounding flips
N_VIEWS = 40
# cells of the occupancy grid of phase 10's scene: (8, 3, 8) m at 0.2 m
LOOP_GRID_CELLS = 40 * 15 * 40
# weights-kernel backward: max-abs error / max-abs of the plain output in
# float64, per gradient. 1.6x the largest reading on an H100 (2.5e-7,
# PERF.md).
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


def k1_fwd_bound(M: int, mlp, N: int):
    """The field kernel's (encode + trunk) bound at N rows: its multiply-adds;
    u read, y written, the weights and the spectrum read."""
    layers = mlp.layers()
    widths = [w.shape[0] for w, _ in layers] + [layers[-1][0].shape[1]]
    macs = 3 * M + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    w_bytes = 4 * sum(p.numel() for p in mlp.parameters()) + 16 * M
    return bound(2 * macs * N, N * (12 + 4 * widths[-1]) + w_bytes)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a GPU")
    tree = argv[argv.index("--tree") + 1] if "--tree" in argv else None
    if tree is not None:
        if "--field-kernels" not in argv:
            fail("--tree runs with --field-kernels only")
        sys.path.insert(0, os.path.abspath(tree))

    # ---- 1. device and build -------------------------------------------------
    t_smoke = time.perf_counter()
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

    if tree is None:
        check_layouts()

    if "--field-kernels" in argv:
        return field_kernels_alone(dev, widest=tree is None)
    if "--prop-states" in argv:
        return probe_prop_states(dev, int(argv[argv.index("--prop-states") + 1]))

    from apnerf_tpu_torch import native
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.models.nn import init_mlp
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
        fused_field_heads,
        fused_field_heads_plain,
    )
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field, fused_spectral_field_plain

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
            if label == "main path" or label == "main path, random biases":
                # the limit catches a zeroed and a negated output
                zeroed, negated = _errs(torch.zeros_like(y), yp)[1], _errs(-y, yp)[1]
                print(f"field kernel [{label}]: zeroed reads {zeroed:.3e}, negated "
                      f"{negated:.3e} (tol {tol})", flush=True)
                if not (zeroed > tol and negated > tol):
                    fail("the limit on the field kernel would pass a zeroed or negated output")
            ms = cuda_ms(lambda: fused_spectral_field(*args_))
            pms = cuda_ms(lambda: fused_spectral_field_plain(*args_))
            bnd = k1_fwd_bound(main_field.W.shape[1], mlp, N)
            print(f"field kernel [{label}] N={N} layers={mlp.n_layers - 1}: "
                  f"err/scale {rel:.3e} (tol {tol}) max_abs {abs_err:.3e} | "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})",
                  flush=True)
            if not rel <= tol:
                fail(f"field kernel ({label}) disagrees with its plain version: {rel}")
            if label == "the loop's occupancy grid":
                # the shape the main path gives it: every cell of the loop's
                # grid, once per member per chunk
                records["fused_spectral_field"] = (abs_err, ms, pms, bnd)

    # ---- 3. weights kernel against its plain version ------------------------------
    records["fused_render_weights"] = phase_k2_fwd(dev, R, S, Sp)

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

    # ---- 16-17. the tile's other widths ---------------------------------------------
    phase_widths(dev)
    phase_member_widths(dev, bench_run)
    # ---- 26. the tile past 64 classes and 15 geometry features ----------------------
    wide_records, wide_times, wide_bench, wide_launches = phase_wide(dev, bench_run)
    # ---- 27. the tile's last tier: past 47 geometry features and 256 classes ------------
    widest_times, widest_bench, widest_launches, widest_k6_ms = phase_widest(dev, bench_run)
    # ---- 19. the ngp+occ path's weights-kernel shapes and member step ---------------
    ngp_state = phase_ngp_step(dev, bench_run)
    # ---- 24. the sharded train phases and render on ranks that share the card ---------
    mesh_launches = phase_mesh(dev, bench_run, ngp_state)
    del bench_run, ngp_state

    # ---- 10-11. the loop through the CLI, and its renders on both routes ----------
    loop_mapper, launches = phase_loop(dev)
    phase_loop_routes(loop_mapper)
    if "--modes" in argv:
        phase_modes(loop_mapper)
    del loop_mapper
    # ---- 18. the loop at config_faketiny.yaml's widths ------------------------------
    phase_faketiny(dev)
    # ---- 20. the ngp+occ loop through the CLI ------------------------------------------
    ngp_launches = phase_ngp_loop(dev)
    # ---- 21. the example trainers ----------------------------------------------------------
    trainer_launches, trainer_k2 = phase_trainers(dev)
    # ---- 22-23. the replay loop, and the visualisation renders on its mapper -----------
    replay_mapper = phase_replay(dev)
    phase_viz(replay_mapper)
    # ---- 25. the mesh-mode mapper on phase 22's recording, --mesh and the dry run ------
    phase_mesh_loop(dev, replay_mapper)
    del replay_mapper

    kernels = [
        {"name": "fused_spectral_field", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/field_tile.cuh",
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
         "source": "apnerf_tpu_torch/csrc/fused_field_volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:348"},
        {"name": "fused_mlp_apply", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/field_tile.cuh",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:433"},
        {"name": "fused_mlp_apply_bwd", "route": "cuda",
         "source": "apnerf_tpu_torch/csrc/fused_field_volrend.cu",
         "replaces": "apnerf_tpu/ops/pallas/fused_mlp.py:292"},
    ]
    for k in kernels:
        err, ms, pms, (bound_ms, bound_by), *rel = records[k["name"]]
        if rel and isinstance(rel[-1], dict):
            # the weights kernels' device times: warm, L2-cold, and the launch floor
            k.update(rel.pop())
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
        if ngp_launches[k["name"]]:
            k["ngp_loop_launches"] = ngp_launches[k["name"]]
        if mesh_launches.get(k["name"]):
            # each rank's launches over phase 24's sharded flagship phase on (2, 1)
            k["mesh_rank_launches"] = mesh_launches[k["name"]]
        if k["name"] in WIDE_KERNELS:
            # the tile's instances (H, T_out, C_pad) this kernel runs on;
            # phase 26: the 101-class, geo-31 field at the main path's shape
            # (ms, bound and error as in the row; launches over its member
            # step's timed chunk), the fields of WIDE_FIELDS at 512 x 128
            # (ms); phase 27: the fields of WIDEST_FIELDS at 512 x 128 (ms),
            # the 847-class, geo-63 field's member step and K6's device time
            # at the bench shape, launches over its loop
            from apnerf_tpu_torch.ops.cuda import field_images

            k["instances"] = [[h, t, c] for h in field_images.WIDTHS
                              for t, c in field_images.TIERS]
            wide = {"geo": WIDE_GEO, "classes": WIDE_CLASSES,
                    "launches": wide_launches.get(k["name"], 0)}
            if k["name"] in wide_records:
                err, ms, pms, (bound_ms, bound_by), *device = wide_records[k["name"]]
                wide.update(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound_ms,
                            bound_by=bound_by, **(device[0] if device else {}))
            if k["name"] == "fused_field_volrend_lossgrad":
                wide["member_step_ms"] = wide_bench["ms_per_step"]
            wide["ms_512x128"] = {str(list(f)): t[k["name"]] for f, t in wide_times.items()
                                  if k["name"] in t}
            k["wide"] = wide
            widest = {"geo": WIDEST_GEO, "classes": WIDEST_CLASSES,
                      "launches": widest_launches.get(k["name"], 0),
                      "ms_512x128": {str(list(f)): t[k["name"]] for f, t in widest_times.items()
                                     if k["name"] in t}}
            if k["name"] == "fused_field_volrend_lossgrad":
                widest.update(member_step_ms=widest_bench[0]["ms_per_step"],
                              member_step_ms_1024=widest_bench[1]["ms_per_step"],
                              device_ms=widest_k6_ms)
            k["widest"] = widest
        if k["name"] in trainer_launches:
            # launches over the timed chunks of phase 21's four trainers, and the
            # kernel at each trainer's shape (times as in the row, bound from these inputs)
            k["trainer_launches"] = trainer_launches[k["name"]]
            k["trainer_shapes"] = {
                label: recs[k["name"] == "fused_render_weights_bwd"]
                for label, recs in trainer_k2.items()}
    print(f"smoke total: {time.perf_counter() - t_smoke:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def check_layouts():
    """The host-side mirrors of the field kernels' layouts, against the
    kernels' own, at every instance, tier and depth, for the whole field's
    trunk output and a wide trunk's, with and without the encode."""
    from apnerf_tpu_torch.ops.cuda import build, field_images

    lib = build.library()
    for h in field_images.WIDTHS:
        for (t_out, c_tile), n_hidden in ((t, n) for t in field_images.TIERS for n in (2, 3)):
            for t_pad, mp in ((t_out, 128), (t_out, 32), (128, 256), (64, 0)):
                mirror = (field_images.fwd_smem_bytes(h, n_hidden, t_out, c_tile),
                          field_images.bwd_smem_bytes(h), field_images.dw_smem_bytes(),
                          field_images.n_bias(h, n_hidden, t_pad, mp))
                own = tuple(lib.apnerf_field_layout(which, h, n_hidden, t_out if which == 0
                                                    else t_pad, mp, c_tile)
                            for which in range(4))
                if mirror != own or max(own[:3]) > field_images.MAX_SMEM:
                    fail(f"field kernel layouts {own} at H={h} layers={n_hidden} tier "
                         f"{(t_out, c_tile)} t_pad={t_pad} mp={mp} differ from their mirrors "
                         f"{mirror}")
            print(f"field kernels H={h} tier {(t_out, c_tile)} layers={n_hidden}: shared memory "
                  f"forward / backward / dW {own[:3]} bytes of {field_images.MAX_SMEM}",
                  flush=True)


def field_kernels_alone(dev, widest=True) -> int:
    """(``--field-kernels`` only) The tile's nine kernels against their
    plain versions at their main shapes and nothing else, one line each
    (the trunk kernels at the main trunk's shape; the proposal field's
    shape is printed by their phase), the field kernel (K1 fwd) at
    1,048,576 rows, then the packed field kernel's launch alone with the
    weights repacked once, K6's kernels' device time and the digests of
    the shipping kernels' outputs: the short run for comparing two trees in
    one call; with ``widest`` (this tree's package) then the last tier and
    the 1024 instance at three fields of phase 27 (``WIDEST_FIELDS``).
    Prints no ``ok`` line."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    for name, phase in (
        ("fused_field_heads", lambda: phase_k4(dev)),
        ("fused_field_volrend_lossgrad", lambda: phase_k6(dev)),
        ("fused_field_volrend", lambda: phase_k5(dev)),
        ("fused_field_heads_bwd", lambda: phase_render_bwd(dev, "heads")),
        ("fused_field_volrend_bwd", lambda: phase_render_bwd(dev, "volrend")),
        ("fused_spectral_field_bwd", lambda: phase_k1_bwd(dev)),
        (("fused_mlp_apply", "fused_mlp_apply_bwd"), lambda: phase_k3(dev)),
    ):
        records = phase()
        for name_, record in ((name, records),) if isinstance(name, str) else zip(name, records):
            err, ms, pms, (bound_ms, _), *_ = record
            print(f"field kernels alone: {name_}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms, max_abs_err {err:.3e}", flush=True)
    k6_device_time(dev)
    shipping_digests(dev)
    gen = _generator(dev, 8)
    cfg = PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    R, S = 4096, 256
    field = spectral.init_spectral(s_cfg, gen, dev)
    with torch.inference_mode():
        from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field

        u1 = torch.rand((R * S, 3), generator=gen, device=dev)
        k1 = lambda: fused_spectral_field(field.W, field.phase, field.mlp_base, u1)
        print(f"field kernels alone: fused_spectral_field N={R * S}: "
              f"{cuda_ms(k1, reps=5, inner=5):.4f} ms, bound "
              f"{k1_fwd_bound(field.W.shape[1], field.mlp_base, R * S)[0]:.4f} ms", flush=True)
        del u1
    k4_launch_ms(dev)
    if widest:
        phase_widths(dev, (WIDEST_FIELDS[0],) + WIDEST_FIELDS[4:6], shapes=WIDTH_SHAPES[:1],
                     tols=_widest_tols)
    print(nvidia_smi())
    return 0


def shipping_digests(dev):
    """(``--field-kernels`` only) The shipping field's kernels on seeded
    inputs at the train shape, one sha256 of each kernel's outputs: the same
    digests from two trees say their kernels give the same bits."""
    import hashlib

    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm

    gen, cfg, s_cfg, field, (u, sh, dt, tm) = _train_inputs(dev, 21)
    _set_random_biases(field, gen, dev)
    leaves = list(field.parameters())
    R, S, C = cfg.num_rays, cfg.max_samples_train, cfg.num_semantic_classes
    inputs = _k6_inputs(gen, dev, R, S, C, cfg.aabb)
    g_acc, g_w, g_y, g_h = _loss_cotangents(leaves, u, sh, dt, tm, S, C, 21)
    layers = field.mlp_base.layers()

    def lossgrad():
        lossrows, w, grads = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
        return [lossrows, w, *_flat(grads).values()]

    def heads_bwd():
        grads, du = ffh.fused_field_heads_bwd(leaves, u, sh, S, g_y, True)
        return [*grads, du]

    def volrend_bwd():
        grads, du = fvr.fused_field_volrend_bwd(leaves, u, sh, dt, tm, S, g_acc, g_w, True)
        return [*grads, du]

    def k1_bwd():
        dW, dphase, grads, du = fm.fused_spectral_field_bwd(field.W, field.phase, layers, u, g_h,
                                                            True)
        return [dW, dphase, *grads, du]

    with torch.no_grad():
        runs = {
            "fused_field_heads": lambda: [ffh.fused_field_heads(leaves, u, sh, S)],
            "fused_field_volrend": lambda: list(fvr.fused_field_volrend(leaves, u, sh, dt, tm,
                                                                        S)),
            "fused_field_volrend_lossgrad": lossgrad,
            "fused_field_heads_bwd": heads_bwd,
            "fused_field_volrend_bwd": volrend_bwd,
            "fused_spectral_field": lambda: [fm.fused_spectral_field(
                field.W, field.phase, field.mlp_base, u)],
            "fused_spectral_field_bwd": k1_bwd,
        }
        for name, run in runs.items():
            h = hashlib.sha256()
            for t in run():
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
            print(f"field kernels alone: {name} outputs sha256 {h.hexdigest()[:16]} (the "
                  f"bench's field, random biases, {R} x {S})", flush=True)


def k6_device_time(dev, calls=5, cfg=None):
    """The device time of K6's own kernels in one call of the train-step
    wrapper at the bench shape (``torch.profiler`` over ``calls`` calls),
    by kernel, the bench configuration's field or ``cfg``'s → ms: the
    wrapper's ``kernel_ms`` is a host time (PERF.md)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 6)
    cfg = cfg or bench.bench_config()
    s_cfg = make_spectral_config(cfg)
    field = spectral.init_spectral(s_cfg, gen, dev)
    inputs = _k6_inputs(gen, dev, cfg.num_rays, cfg.max_samples_train, cfg.num_semantic_classes,
                        cfg.aabb)
    for _ in range(3):
        spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        name = e.name.split("::")[-1].split("<")[0].split("(")[0]
        if e.device_type == DeviceType.CUDA and name.startswith(("fvr_", "dw_", "col_sums")):
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    print(f"field kernels alone: fused_field_volrend_lossgrad's kernels: "
          f"{sum(by_kernel.values()):.4f} ms of device time a call ("
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_kernel.items())) + ") at "
          f"{cfg.num_semantic_classes} classes, geo {cfg.geo_feat_dim}", flush=True)
    return sum(by_kernel.values())


def k4_launch_ms(dev, cfg=None):
    """The packed field kernel's launch alone (its weights repacked once)
    at the candidate render's shape, 4096 x 256, ``PipelineConfig()``'s
    field or ``cfg``'s → ms of its CUDA-event window."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import build, fused_field_heads as ffh
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 8)
    cfg = cfg or PipelineConfig()
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

        ms = cuda_ms(launch)
    print(f"field kernels alone: fused_field_heads without the wrapper (weights repacked "
          f"once) N={R * S} at {cfg.num_semantic_classes} classes, geo {cfg.geo_feat_dim}: "
          f"{ms:.4f} ms", flush=True)
    return ms


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
    from apnerf_tpu_torch.models import propnet, spectral
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import fused_field_heads_plain
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import fused_field_volrend_plain
    from apnerf_tpu_torch.ops.cuda.fused_mlp import (
        fused_mlp_apply_plain,
        fused_spectral_field_plain,
    )
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain
    from apnerf_tpu_torch.render import prop_renderer, renderer
    from apnerf_tpu_torch.train import examples, flagship

    swaps = [(spectral, "fused_spectral_field", fused_spectral_field_plain),
             (spectral, "fused_mlp_apply", fused_mlp_apply_plain),
             (spectral, "fused_field_heads", fused_field_heads_plain),
             (spectral, "fused_field_volrend", fused_field_volrend_plain)]
    swaps += [(m, "fused_render_weights", fused_render_weights_plain)
              for m in (propnet, prop_renderer, renderer, flagship, examples)]
    saved = [getattr(m, name) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, saved):
            setattr(m, name, fn)


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


def _k2_intervals(gen, dev, R, S):
    """Sorted interval edges over [0.1, 20.1] and sigma uniform in [0, 2)."""
    edges = torch.sort(torch.rand((R, S + 1), generator=gen, device=dev) * 20.0 + 0.1,
                       dim=-1).values
    sig = torch.rand((R, S), generator=gen, device=dev) * 2.0
    return edges[:, :-1].contiguous(), edges[:, 1:].contiguous(), sig


def _misaligned(x):
    """A contiguous copy of ``x`` that starts one float past a 16-byte
    boundary, so the kernels must take their scalar accesses."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _f64(*xs):
    return [x.double() for x in xs]


def k2_fwd_case(dev, label, t0_, t1_, sig, timed=True):
    """The weights kernel against its plain version on these inputs,
    computed in float64 (the witness: both f32 sides round a ray's prefix
    sum, the plain one as cumsum - x); the limit shown to catch a zeroed
    and a negated output; with ``timed`` its event window, device time,
    L2-cold device time, launch floor (each None where the profiler
    dropped it, as in ``kernel_device_ms``) and both bounds → (max-abs
    error, ms, plain ms, bound, {device ms, cold device ms, floor device
    ms})."""
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_plain,
        lane_span,
    )

    R, S = sig.shape
    tol = K2_TOL
    got = fused_render_weights(t0_, t1_, sig)
    torch.cuda.synchronize()
    ref = fused_render_weights_plain(*_f64(t0_, t1_, sig)).float()
    if not (got.shape == ref.shape and torch.isfinite(got).all()):
        fail(f"weights kernel {label}: non-finite or misshapen output")
    err = float((got - ref).abs().max())
    zeroed, negated = float(ref.abs().max()), float((got + ref).abs().max())
    line = (f"weights kernel {label} [{R}, {S}] (lane span {lane_span(S)}): max_abs {err:.3e} "
            f"(tol {tol}; zeroed reads {zeroed:.3e}, negated {negated:.3e})")
    if not (zeroed > tol and negated > tol):
        fail(f"the limit on the weights kernel {label} would pass a zeroed or negated output")
    if not err <= tol:
        fail(f"weights kernel {label} [{R}, {S}] disagrees with its plain version: {err}")
    if not timed:
        print(line, flush=True)
        return None
    ms = cuda_ms(lambda: fused_render_weights(t0_, t1_, sig))
    pms = cuda_ms(lambda: fused_render_weights_plain(t0_, t1_, sig))
    bnd, old = k2_fwd_bound(R, S), k2_fwd_bound(R, S, outputs=3)
    print(f"{line} | kernel {ms:.4f} ms (event window) | plain {pms:.4f} ms | bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}, 16 B a sample; 24 B: {old[0]:.4f})", flush=True)
    dms, cold, floor = k2_times(dev, R, lambda: fused_render_weights(t0_, t1_, sig),
                                "render_weights_fwd_kernel", f"weights kernel [{R}, {S}]")
    return err, ms, pms, bnd, dict(device_ms=dms, cold_device_ms=cold, floor_device_ms=floor)


def k2_bwd_case(dev, label, t0_, t1_, sig, g, with_dt, timed=True):
    """The weights kernel's backward against autograd through its plain
    version in float64, dsigma alone or with dt0 and dt1; the limit shown
    to catch a zeroed and a negated dsigma; with ``timed`` the times and
    bounds as in ``k2_fwd_case`` → the same record."""
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights_bwd,
        fused_render_weights_plain,
    )

    R, S = sig.shape
    tol = K2_BWD_TOL
    run = lambda: fused_render_weights_bwd(t0_, t1_, sig, g, with_dt=with_dt)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    if (got[1] is None) == with_dt or (got[2] is None) == with_dt:
        fail(f"weights backward {label}: dt0/dt1 returned {'without' if with_dt else 'with'} "
             "being asked for")
    leaves = [x.double().requires_grad_(True) for x in (sig, t0_, t1_)][:3 if with_dt else 1]
    w = fused_render_weights_plain(*(leaves[1:] if with_dt else _f64(t0_, t1_)), leaves[0])
    ref = [r.float() for r in torch.autograd.grad(w, leaves, g.double())]
    errs = [_errs(a, b) for a, b in zip(got, ref)]
    zeroed, negated = _errs(torch.zeros_like(ref[0]), ref[0])[1], _errs(-got[0], ref[0])[1]
    names = ("dsigma", "dt0", "dt1")[:len(errs)]
    line = (f"weights backward {label} [{R}, {S}] {'with' if with_dt else 'without'} dt: "
            f"max_abs " + " ".join(f"{n} {e[0]:.3e}" for n, e in zip(names, errs))
            + " | err/scale " + " ".join(f"{e[1]:.3e}" for e in errs)
            + f" (tol {tol}; zeroed dsigma reads {zeroed:.3e}, negated {negated:.3e})")
    if not all(np.isfinite(e[0]) for e in errs):
        fail(f"weights backward {label} [{R}, {S}]: non-finite output")
    if not (zeroed > tol and negated > tol):
        fail(f"the limit on the weights backward {label} would pass a zeroed or negated output")
    if not max(e[1] for e in errs) <= tol:
        fail(f"weights backward {label} [{R}, {S}] disagrees with autograd")
    if not timed:
        print(line, flush=True)
        return None
    ms = cuda_ms(run)
    leaves = [x.clone().requires_grad_(True) for x in (sig, t0_, t1_)][:3 if with_dt else 1]
    w = fused_render_weights_plain(*(leaves[1:] if with_dt else (t0_, t1_)), leaves[0])
    pms = cuda_ms(lambda: torch.autograd.grad(w, leaves, g, retain_graph=True))
    bnd, old = k2_bwd_bound(R, S, with_dt), k2_bwd_bound(R, S, True)
    print(f"{line} | kernel {ms:.4f} ms (event window) | plain (autograd backward) {pms:.4f} "
          f"ms | bound {bnd[0]:.4f} ms ({bnd[1]}, {20 + 8 * with_dt} B a sample; 28 B: "
          f"{old[0]:.4f})", flush=True)
    dms, cold, floor = k2_times(dev, R, run, "render_weights_bwd_kernel",
                                f"weights backward [{R}, {S}]")
    return (max(e[0] for e in errs), ms, pms, bnd,
            dict(device_ms=dms, cold_device_ms=cold, floor_device_ms=floor))


# widths off the paths' shapes: S = 1, the scalar accesses (S not a
# multiple of 4) and the widest lane-span instance
K2_EXTRA_SAMPLES = (1, 33, 130, 1024)


def phase_k2_fwd(dev, R, S, Sp):
    """Phase 3: the weights kernel at the candidate render's two shapes
    ([R, S] main, [R, Sp] proposal), timed, then at every S of
    ``K2_EXTRA_SAMPLES`` and from storage off the 16-byte boundary →
    the record at [R, S]."""
    gen = _generator(dev, 3)
    record = k2_fwd_case(dev, "candidate render, main", *_k2_intervals(gen, dev, R, S))
    k2_fwd_case(dev, "candidate render, proposal", *_k2_intervals(gen, dev, R, Sp))
    for n_s in K2_EXTRA_SAMPLES:
        k2_fwd_case(dev, "other width", *_k2_intervals(gen, dev, 2048, n_s), timed=False)
    k2_fwd_case(dev, "misaligned rows", *map(_misaligned, _k2_intervals(gen, dev, 2048, 128)),
                timed=False)
    return record


def phase_k2_bwd(dev):
    """Phase 5: the weights kernel's backward against autograd through its
    plain version: at the flagship's proposal loss ([2048, 64], no dt, the
    record) and at [4096, 256] with and without dt, timed, then at every S
    of ``K2_EXTRA_SAMPLES`` and from misaligned storage, with and without
    dt → the record."""
    gen = _generator(dev, 5)

    def inputs(R, n_s):
        t0_, t1_, sig = _k2_intervals(gen, dev, R, n_s)
        return t0_, t1_, sig, torch.randn((R, n_s), generator=gen, device=dev)

    record = k2_bwd_case(dev, "proposal loss", *inputs(2048, 64), with_dt=False)
    args = inputs(4096, 256)
    for with_dt in (False, True):
        k2_bwd_case(dev, "candidate shape", *args, with_dt=with_dt)
    for n_s in K2_EXTRA_SAMPLES:
        args = inputs(2048, n_s)
        for with_dt in (False, True):
            k2_bwd_case(dev, "other width", *args, with_dt=with_dt, timed=False)
    args = tuple(map(_misaligned, inputs(2048, 128)))
    for with_dt in (False, True):
        k2_bwd_case(dev, "misaligned rows", *args, with_dt=with_dt, timed=False)
    return record


def k2_fwd_bound(R, S, outputs=1):
    """The weights kernel's bound at [R, S]: 3 f32 inputs read and
    ``outputs`` f32 outputs written a sample: 1, the weights (16 B: what
    the function returns and the kernel writes), or 3 (24 B: the count of
    the kernel before this design, which also wrote T and alpha); ~12 f32
    operations a sample (two exp, the scan)."""
    return bound(12 * R * S, (12 + 4 * outputs) * R * S, PEAK_F32_FLOPS)


def k2_bwd_bound(R, S, with_dt):
    """The weights backward's bound at [R, S]: 4 f32 inputs read and
    dsigma written (20 B a sample), and dt0, dt1 ``with_dt`` (28 B); ~30
    f32 operations a sample."""
    return bound(30 * R * S, (20 + 8 * with_dt) * R * S, PEAK_F32_FLOPS)


L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB of L2


def kernel_device_ms(fn, kernel, calls=20, before=None, tries=3):
    """The device time (ms) of one launch of the kernel named ``kernel``
    in ``fn``: the mean over the launches ``torch.profiler`` records in a
    window of ``calls`` calls (``before()`` ahead of each, untimed). The
    profiler drops some launches from a window (one of 20 in most, all of
    them in a few, on an H100 with torch 2.11, and then often in several
    windows in a row, early or late in a run), so the mean is taken over
    those it recorded; a window that holds fewer than half is measured
    again, up to ``tries`` times, and then None is returned: the reading
    is "not measured". The kernel's event window, plain time and bound do
    not depend on the profiler, so no check waits on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and kernel in e.name]
        if 2 * len(got) >= calls:
            return sum(got) / len(got) / 1e3
    print(f"  the profiler recorded {len(got)} of {calls} launches of {kernel} in {tries} "
          "windows: its device time is not measured", flush=True)
    return None


def k2_times(dev, R, fn, kernel, label, calls=20):
    """Prints and returns the device time of ``fn``'s kernel (named
    ``kernel``) warm and with its inputs out of L2 (64 MB written between
    launches), and the device time and event window of an empty kernel
    launched as the weights kernels are (its grid for R rays): the launch
    floor → (warm ms, cold ms, floor ms), each None where the profiler
    dropped it (``kernel_device_ms``)."""
    from apnerf_tpu_torch.ops.cuda import build

    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty():
        if lib.apnerf_empty_launch(R, stream) != 0:
            fail("the empty kernel did not launch")

    floor = kernel_device_ms(empty, "empty_kernel", calls)
    floor_window = cuda_ms(empty)
    warm = kernel_device_ms(fn, kernel, calls)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cold = kernel_device_ms(fn, kernel, calls, before=lambda: flush.fill_(1.0))
    ms = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    print(f"  {label}: device time {ms(warm)}, with its inputs out of L2 (64 MB written "
          f"between launches) {ms(cold)} | an empty kernel launched the same way: "
          f"{ms(floor)} device time, {floor_window:.4f} ms event window", flush=True)
    return warm, cold, floor


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


def phase_k6(dev, cfg=None, limits=None):
    """The train-step kernel against its plain version at the train shape
    → (max-abs error of the weights, kernel ms, plain ms, bound), zero
    biases; the bench configuration's field at ``K6_TOL``, or ``cfg``'s at
    ``limits``."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 6)
    cfg = cfg or bench.bench_config()
    s_cfg = make_spectral_config(cfg)
    R, S = cfg.num_rays, cfg.max_samples_train
    field = spectral.init_spectral(s_cfg, gen, dev)
    inputs = _k6_inputs(gen, dev, R, S, cfg.num_semantic_classes, cfg.aabb)
    record = None
    for case, (w_tol, l_tol, g_tol, leaf_tol) in (limits or K6_TOL).items():
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


@contextlib.contextmanager
def plain_trunk_backward():
    """The field kernel keeps its forward and takes its plain backward on
    the same cotangents, where its ``autograd.Function`` looks it up."""
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm

    saved = fm.fused_spectral_field_bwd
    fm.fused_spectral_field_bwd = fm.fused_spectral_field_bwd_plain
    try:
        yield
    finally:
        fm.fused_spectral_field_bwd = saved


def compare_member_step(dev, state, ds, seed, route="lossgrad", fused_prop=False,
                        tols=(STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_GRAD_TOL), prop_tols=None,
                        cfg=None):
    """One member step of member 0 from ``state`` on a batch drawn with
    ``seed``: ``route`` on the kernels against the same route with the
    plain versions in place of the kernels (for the combined-kernel branch,
    whose plain version returns gradients too, against the autograd branch
    ``field`` on the plain versions). Holds the loss (relative) to
    ``tols[0]`` and every tensor's update and gradient (err / max-abs) to
    ``tols[1:]``; ``prop_tols``, where given, are the (update, gradient)
    limits of the proposal field's tensors. With ``fused_prop`` the
    proposal field's update is held on the field kernel's backward alone:
    against the same step with that backward's plain version on the same
    cotangents (``ROUTE_STEP_TOL``); its gradient on both comparisons. →
    (loss relative error, worst update and worst gradient over the main
    field's tensors, the same over the proposal field's). The gradient is
    recovered from Adam's first moment, g = (mu' - b1 mu) / (1 - b1).
    ``cfg`` replaces the bench configuration (the members' widths)."""
    import copy

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    cfg = cfg or bench.bench_config()
    batch, noise = _step_inputs(dev, ds, seed)
    old = state.members[0]
    opt0 = state.opt[0]
    b1 = 0.9
    sizes = [p.numel() for p in old.parameters()]

    def one_step(core):
        member = copy.deepcopy(old)
        out = core(member, AdamState(*(t.clone() for t in opt0)), batch, state.step,
                   noise=noise)
        if bool(out.skipped):
            fail("the member step met a non-finite gradient")
        return member, out

    def rows(got, ref):
        """(name, update err / scale, gradient err / scale) of every tensor."""
        (mk, ok), (mp, op_) = got, ref
        gk = torch.split((ok.opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
        gp = torch.split((op_.opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
        out = []
        for i, ((name, p0), a, b) in enumerate(zip(old.named_parameters(), mk.parameters(),
                                                   mp.parameters())):
            _, ru = _errs(a.detach() - p0.detach(), b.detach() - p0.detach())
            eg, rg = _errs(gk[i], gp[i])
            if gp[i].numel() == 1:
                # a one-element leaf (the proposal field's output bias) has no
                # scale of its own: its gradient is one sum over every sample,
                # and near a sign change the ratio to itself reads anything
                # (6.5e-4, 2.7e-3 and 3.6e-1 in three runs on an H100). Held at
                # its layer's scale, the larger max-abs of its weight's
                # gradient and its own.
                rg = eg / max(float(gp[i].abs().max()), float(gp[i - 1].abs().max()), 1e-30)
            out.append((name, ru, rg))
        return out

    def worst(rs, part):
        return (max(r[1] for r in rs if r[0].startswith(part)),
                max(r[2] for r in rs if r[0].startswith(part)))

    kernels = one_step(make_flagship_member_core(cfg, route, fused_prop=fused_prop))
    with plain_routes():
        plain = one_step(make_flagship_member_core(
            cfg, "field" if route == "lossgrad" else route, fused_prop=fused_prop))
    loss_rel = abs(float(kernels[1].loss) - float(plain[1].loss)) / abs(float(plain[1].loss))
    rs = rows(kernels, plain)
    limits = {"main": tuple(tols[1:]), "prop": tuple(prop_tols or tols[1:])}
    worsts = {part: worst(rs, part) for part in limits}
    print(f"  member step on route {route}{' with fused_prop' if fused_prop else ''} (batch seed "
          f"{seed}), kernels vs plain versions: loss {float(kernels[1].loss):.6f} vs "
          f"{float(plain[1].loss):.6f} (rel {loss_rel:.3e}, tol {tols[0]}); "
          + "; ".join(
              f"{part} field: update worst err/scale {worsts[part][0]:.3e} (tol "
              f"{'see below' if part == 'prop' and fused_prop else limits[part][0]}), gradient "
              f"{worsts[part][1]:.3e} (tol {limits[part][1]})"
              for part in limits), flush=True)
    for name, ru, rg in rs:
        print(f"    {name:24s} update {ru:.3e} gradient {rg:.3e}")
    held = {"main": worsts["main"], "prop": worsts["prop"]}
    if fused_prop:
        # the proposal field's update against the same step with the field
        # kernel's plain backward (B): the two sides sample alike, so what
        # is left is the backward kernel's own
        with plain_trunk_backward():
            share = rows(kernels, one_step(make_flagship_member_core(cfg, route,
                                                                     fused_prop=True)))
        w_share = worst(share, "prop")
        print(f"  the same step against the field kernel's plain backward on the same "
              f"cotangents: prop field update worst err/scale {w_share[0]:.3e} (tol "
              f"{limits['prop'][0]}), gradient {w_share[1]:.3e} (tol {limits['prop'][1]})",
              flush=True)
        for name, ru, rg in share:
            if name.startswith("prop"):
                print(f"    {name:24s} update {ru:.3e} gradient {rg:.3e}")
        held["prop"] = (w_share[0], max(worsts["prop"][1], w_share[1]))
    over = [part for part in limits
            if not (held[part][0] <= limits[part][0] and held[part][1] <= limits[part][1])]
    if not loss_rel <= tols[0] or over:
        fail(f"the member step on route {route} with the kernels disagrees with the plain "
             f"versions (loss {loss_rel:.3e}, tensors of {over or 'no'} field over their limits)")
    return loss_rel, worsts["main"], held["prop"]


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


def profile_member_step(dev, state, ds, route, fused_prop=False, rows=20, cfg=None):
    """One member step of ``route`` from ``state`` traced with
    ``torch.profiler``: device time by kernel and the device's idle share;
    the bench configuration's field, or ``cfg``'s."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.train.flagship import make_flagship_member_core
    from apnerf_tpu_torch.train.step import AdamState

    batch, noise = _step_inputs(dev, ds, 123)
    core = make_flagship_member_core(cfg or bench.bench_config(), route, fused_prop=fused_prop)
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
# samples, and the proposal field, whose gradients come through the
# proposal loss alone, takes Adam's update from a state whose conditioning
# the route's training decides: its update against the plain versions read
# 1.9e-2 to 1.8e-1 over five trained states on an H100, most of it the
# forwards' (PERF.md). So its update is held on the backward kernel's own
# share, against the same step with the kernel's plain backward on the
# same cotangents (read 1.9e-2 to 3.8e-2), and its gradient on both
# comparisons.
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


def phase_k4(dev, cfg=None, limits=None):
    """The packed field kernel against its plain version at the candidate
    render's shape → (max-abs error of rgb with zero biases, kernel ms,
    plain ms, bound); ``PipelineConfig()``'s field at ``K4_TOL``, or
    ``cfg``'s at ``limits``."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
        fused_field_heads,
        fused_field_heads_plain,
    )
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 8)
    cfg = cfg or PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    R, S, C = 4096, 256, cfg.num_semantic_classes
    field = spectral.init_spectral(s_cfg, gen, dev)
    pos, dirs, _, _, _ = _render_inputs(gen, dev, R, S, cfg.aabb)
    groups = {"rgb": slice(0, 3), "sigma": slice(3, 4), "sem": slice(4, 4 + C)}
    record = None
    with torch.inference_mode():
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        for case, tols in (limits or K4_TOL).items():
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


def phase_k5(dev, cfg=None, limits=None, shapes=((25600, 256), (4096, 512))):
    """The fused field-and-render kernel against its plain version at the
    evaluation's shape and at S = 512 → (max-abs error of the weights with
    zero biases at the evaluation's shape, kernel ms, plain ms, bound);
    ``PipelineConfig()``'s field at ``K5_TOL``, or ``cfg``'s at
    ``limits``."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda.fused_field_volrend import (
        FWD_CHUNK_ROWS,
        fused_field_volrend,
        fused_field_volrend_plain,
    )
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 9)
    cfg = cfg or PipelineConfig()
    s_cfg = make_spectral_config(cfg)
    C = cfg.num_semantic_classes
    groups = {"rgb": slice(0, 3), "opacity": slice(3, 4), "depth": slice(4, 5),
              "sem": slice(5, 5 + C)}
    record = None
    for R, S in shapes:
        field = spectral.init_spectral(s_cfg, gen, dev)
        pos, dirs, t0_, t1_, miss = _render_inputs(gen, dev, R, S, cfg.aabb)
        with torch.inference_mode():
            u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
            dt = ((t1_ - t0_) * (~miss)[:, None]).reshape(-1).contiguous()
            tm = (0.5 * (t0_ + t1_)).reshape(-1).contiguous()
            del pos
            for case, tols in (limits or K5_TOL).items():
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
                macs = field_macs(s_cfg.n_freqs, s_cfg.neurons, s_cfg.layers,
                                  s_cfg.geo_feat_dim, s_cfg.neurons // 4, C)
                # u, dt, t_mid read and the weights written per sample; SH
                # read and the sums written per ray; the parameters read
                n_bytes = (R * S * (12 + 8 + 4) + R * (64 + 4 * (5 + C))
                           + field_weight_bytes(field))
                bnd = bound(2 * macs * R * S, n_bytes)
                print(f"fused field-and-render kernel [{case}] R={R} S={S} C={C} "
                      f"({chunks} ray chunks per call): kernel {ms:.3f} ms, plain "
                      f"{pms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
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
                    record = (_errs(w_k, w_p)[0], ms, pms, bnd)
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
        ).reshape(N)
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
        w = fused_render_weights_plain(
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
            # dW's partials are added in a fixed order: a second run gives the same bits
            again = flatten(fm.fused_spectral_field_bwd(W, phase, layers, u_, g, True))
            same = all(torch.equal(a, b) for a, b in zip(gk, again))
            print(f"fused_spectral_field_bwd [{label}, {case}]: two runs bit-identical: {same}",
                  flush=True)
            if not same:
                fail(f"fused_spectral_field_bwd ({label}, {case}): two runs differ")
            del again
            gp = flatten(fm.fused_spectral_field_bwd_plain(W, phase, layers, u_, g, True))
            ms = cuda_ms(lambda: fm.fused_spectral_field_bwd(W, phase, layers, u_, g, True),
                         reps=5, inner=3)
            pms = cuda_ms(lambda: fm.fused_spectral_field_bwd_plain(W, phase, layers, u_, g, True),
                          reps=3, inner=2)
            macs = 3 * W.shape[1] + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
            w_bytes = 4 * sum(p.numel() for p in mlp.parameters()) + 16 * W.shape[1]
            # u and g read, du written per row; parameters read, gradients written
            bnd = bound(6 * macs * N, N * (12 + 4 * widths[-1] + 12) + 2 * w_bytes)
            print(f"fused_spectral_field_bwd [{label}, {case}] N={N} widths {widths}: kernel "
                  f"{ms:.3f} ms, plain (forward and backward under autograd) {pms:.3f} ms, "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
            if case == "zero biases":
                with torch.no_grad():
                    f_ms = cuda_ms(lambda: fm.fused_spectral_field(W, phase, mlp, u_), reps=5,
                                   inner=3)
                f_bnd = k1_fwd_bound(W.shape[1], mlp, N)
                print(f"fused_spectral_field [{label}] N={N}: kernel {f_ms:.3f} ms, bound "
                      f"{f_bnd[0]:.4f} ms ({f_bnd[1]})", flush=True)
            names = ["W", "phase"] + [n for n, _ in mlp.named_parameters()] + ["du"]
            worst, rel = _check_grads(f"fused_spectral_field_bwd [{label}, {case}]", names, gk,
                                      gp, tol, leaf_tol)
            if main and case == "zero biases":
                record = (worst, ms, pms, bnd, rel)
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
            gk2, dxk2 = fm.fused_mlp_apply_bwd(layers, x, g, True)
            same = torch.equal(dxk, dxk2) and all(torch.equal(a, b) for a, b in zip(gk, gk2))
            print(f"fused_mlp_apply_bwd [{kind} x, {case}]: two runs bit-identical: {same}",
                  flush=True)
            if not same:
                fail(f"fused_mlp_apply_bwd ({kind} x, {case}): two runs differ")
            del gk2, dxk2
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


# Fields on each of the tile's four instances H in 64, 128, 256, 512 and
# between two of them, each against the plain versions at 512 rays x 128
# samples (65,536 rows: several passes per block) and again at 375 x 64
# (24,000 rows: a last pass only partly filled), 29 classes, 15 geometry
# features, 3 hidden layers (2 at H = 128), with zero biases and then random
# ones: K4 fwd, K5 fwd, K6 (weights max-abs, loss terms relative, gradient
# leaves err / leaf scale) and the backwards of K4, K5 and K1 (every leaf
# and du). (M, H) = (256, 512) is the 512 instance with 256 frequencies (8
# k-blocks of the encoding), (48, 96) a field between two instances, zero-
# padded to H = 128 (heads 24 to 32) with 48 frequencies (a k-block half
# padded). With zero biases K4 and K5 fwd are held to their limits above;
# every other limit is about 2x the largest reading over the nine instances
# of the tile before it took these widths, on an H100 (PERF.md; with zero
# biases the loss terms read up to 9.7e-5, K6's phase gradient 1.05e-2 at
# (32, 64), the backwards' leaves up to 8.3e-3; with random biases, where
# the two bias conventions meet, the readings at 65,536 rows run up to 2x
# those of the shipping shapes above). Each limit is shown at run time to
# catch a zeroed and a negated output or gradient; two runs of K6 at
# (64, 128) agree to the last bit. The shipping instance (128, 256) runs
# here too, at this shape. Then the trunk kernels, forward and backward,
# at trunks of the widths the tile takes beyond the main field's, which
# run zero-padded to their instance, at the same limits as K1's.
WIDTH_FIELDS = ((32, 64), (64, 128), (128, 256), (256, 512), (48, 96))
WIDTH_SHAPES = ((512, 128), (375, 64))
WIDTH_K6_TOL = (6e-7, 2e-4, 2e-2)
WIDTH_BWD_TOL = 1.6e-2
_WIDTH_RENDER_BWD_RANDOM = (4.2e-2, {"W": 2.3e-1, "phase": 2.8e-1, "mlp_base.w0": 1.3e-1,
                                     "mlp_base.w1": 8e-2, "du": 4.4e-1})
WIDTH_RANDOM_TOL = {
    "fused_field_heads": {"rgb": 2.2e-2, "sigma": 3.3e-2, "sem": 3.1e-2},
    "fused_field_volrend": {"weights": 4.3e-3, "rgb": 1.2e-2, "opacity": 7.8e-3,
                            "depth": 7.1e-3, "sem": 2.2e-2},
    "fused_field_volrend_lossgrad": (6e-3, 3e-4, 7e-2, {"W": 3e-1, "phase": 3.2e-1,
                                                         "mlp_base.w0": 1.5e-1}),
    "fused_field_heads_bwd": _WIDTH_RENDER_BWD_RANDOM,
    "fused_field_volrend_bwd": _WIDTH_RENDER_BWD_RANDOM,
    "fused_spectral_field_bwd": (2e-2, {"W": 2e-1, "phase": 1.7e-1, "w0": 1.1e-1, "w1": 7.2e-2,
                                        "du": 4.4e-1}),
}
WIDTH_BWDS = ("fused_field_heads_bwd", "fused_field_volrend_bwd", "fused_spectral_field_bwd")
# The fields at (48, 96) and (256, 512) hold every limit above but four,
# which have their own, about 2x their readings on an H100 (PERF.md): at
# (48, 96) with random biases K5's weights
# (6.0e-3 absolute) and K6's loss terms (7.3e-4), where the plain version
# given the kernels' bias convention reads 3.8e-5 for the same loss terms:
# the difference is the convention's (the plain chain adds hidden biases in
# bf16 after rounding), which this field's dense rays amplify; at (256, 512)
# with zero biases K4's sigma (1.01e-6 of scale) and K5's semantic sums
# (1.58e-3), where no bias is added: the f32 sums of the plain chain's GEMMs
# at these shapes (K = 512, the heads 128 wide) come in another order than
# the tile's, and a few bf16 roundings flip.
WIDTH_OWN_TOL = {
    ((48, 96), "random biases"): {"fused_field_volrend": {"weights": 1.2e-2},
                                  "fused_field_volrend_lossgrad": {"loss": 1.5e-3}},
    ((256, 512), "zero biases"): {"fused_field_heads": {"sigma": 2e-6},
                                  "fused_field_volrend": {"sem": 3.2e-3}},
}
# (the encode's frequencies or 0 for an input x, its width, H, hidden
# layers, output): K1 on the 128 instance (M = 48; M = 24 with out 17) and
# on the 512 one (M = 256, out 32); K3 on the 128 instance (out 1, out 64),
# on the 512 one (din 512, out 17) and at din 1472
PADDED_TRUNKS = ((48, 96, 96, 3, 16), (256, 512, 512, 3, 32), (24, 48, 112, 2, 17),
                 (0, 48, 112, 2, 1), (0, 48, 96, 2, 64), (0, 512, 512, 3, 17),
                 (0, 1472, 256, 3, 16))


def _width_tols(case, width=None):
    """(K4's, K5's, K6's (weights, loss, gradient, leaf limits), each
    backward's (limit, leaf limits)) for a bias case of the widths phase,
    at the field ``width`` = (M, H) where it has limits of its own."""
    if case == "zero biases":
        k4, k5, k6 = K4_TOL[case], K5_TOL[case], WIDTH_K6_TOL + ({},)
        bwds = dict.fromkeys(WIDTH_BWDS, (WIDTH_BWD_TOL, {}))
    else:
        t = WIDTH_RANDOM_TOL
        k4, k5, k6 = (t["fused_field_heads"], t["fused_field_volrend"],
                      t["fused_field_volrend_lossgrad"])
        bwds = {k: t[k] for k in WIDTH_BWDS}
    own = WIDTH_OWN_TOL.get((width, case), {})
    k4 = dict(k4, **own.get("fused_field_heads", {}))
    k5 = dict(k5, **own.get("fused_field_volrend", {}))
    if "loss" in own.get("fused_field_volrend_lossgrad", {}):
        k6 = (k6[0], own["fused_field_volrend_lossgrad"]["loss"]) + tuple(k6[2:])
    return k4, k5, k6, bwds


@contextlib.contextmanager
def plain_variant(variant):
    """The plain field chain (``fused_field_heads.field_plain``'s layers)
    with the kernels' bias convention ("kernel_bias": f32 sums of the bf16
    operands, the f32 bias, one rounding) or with exact sums ("exact": the
    bf16 operands' products summed in float64, then the plain chain's own
    roundings and bf16 bias)."""
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh

    bf16 = torch.bfloat16

    def layers(pairs, x, compute_dtype=None):
        x = x.to(bf16)
        for i, (w, b) in enumerate(pairs):
            last = i == len(pairs) - 1
            if variant == "kernel_bias":
                y = x.float() @ w.to(bf16).float() + b
                x = y if last else torch.relu(y).to(bf16)
            else:
                y = x.double() @ w.to(bf16).double()
                x = (y.float() + b) if last else torch.relu(y.to(bf16) + b.to(bf16))
        return x

    saved = ffh.apply_layers
    ffh.apply_layers = layers
    try:
        yield
    finally:
        ffh.apply_layers = saved


def diagnose_width(label, field, s_cfg, inputs, render, k6):
    """What a field's limits of its own stand for (``WIDTH_OWN_TOL``): K4, K5
    and K6 against the plain versions with the kernels' bias convention, and
    the plain versions as they run against exact sums beside the kernels
    (readings only, no limit)."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr

    u, sh, dt, tm, S = render
    leaves = list(field.parameters())
    C = s_cfg.num_semantic_classes
    groups = {"rgb": slice(0, 3), "sigma": slice(3, 4), "sem": slice(4, 4 + C)}
    with torch.inference_mode():
        yk = ffh.fused_field_heads(leaves, u, sh, S)
        yp = ffh.fused_field_heads_plain(leaves, u, sh, S)
        sk = fvr.fused_field_volrend(leaves, u, sh, dt, tm, S)[0][:, 5:]
        sp = fvr.fused_field_volrend_plain(leaves, u, sh, dt, tm, S)[0][:, 5:]
    for name, variant in (("the kernels' bias convention", "kernel_bias"),
                          ("exact sums", "exact")):
        with plain_variant(variant):
            with torch.inference_mode():
                yv = ffh.fused_field_heads_plain(leaves, u, sh, S)
                sv = fvr.fused_field_volrend_plain(leaves, u, sh, dt, tm, S)[0][:, 5:]
            spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad_plain
            try:
                lv, wv, _ = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
            finally:
                spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad
        rel = [abs(float(k6[0][i].sum()) - float(lv[i].sum())) / abs(float(lv[i].sum()))
               for i in range(3)]
        print(f"{label} diagnosis against the plain versions with {name}: kernels: K4 "
              + " ".join(f"{g} {_errs(yk[:, s], yv[:, s])[1]:.3e}" for g, s in groups.items())
              + f", K5 sem {_errs(sk, sv)[1]:.3e}, K6 loss terms "
              + " ".join(f"{x:.3e}" for x in rel) + f", K6 weights {_errs(k6[1], wv)[0]:.3e}"
              + "; the plain versions as they run: K4 "
              + " ".join(f"{g} {_errs(yp[:, s], yv[:, s])[1]:.3e}" for g, s in groups.items())
              + f", K5 sem {_errs(sp, sv)[1]:.3e}", flush=True)


# (field, bias case) of the widths phases whose K6 gradients are also read
# against the plain chain with the kernels' bias convention (diagnose_grads)
GRAD_DIAGNOSIS = {((128, 1024, 15, 29), "random biases"), ((128, 256, 63, 847), "random biases")}


def diagnose_grads(label, field, s_cfg, inputs, fk):
    """K6's gradients ``fk`` (by leaf) against autograd through the plain
    field chain with the kernels' bias convention (``plain_variant
    ("kernel_bias")``): what of the random-bias readings the two bias
    conventions account for (readings only, no limit)."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr

    with plain_variant("kernel_bias"):
        spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad_plain
        try:
            _, _, gv = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
        finally:
            spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad
    worst = sorted(((_errs(fk[k], v)[1], k) for k, v in _flat(gv).items()), reverse=True)
    print(f"{label} K6 gradients against the plain chain with the kernels' bias convention: "
          + ", ".join(f"{k} {e:.3e}" for e, k in worst[:8]), flush=True)


def _width_config(M, H, geo=None, classes=None):
    """``PipelineConfig()`` at M frequencies and an H-wide trunk (and, where
    given, ``geo`` geometry features and ``classes`` semantic classes)."""
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    cfg = dataclasses.replace(PipelineConfig(), n_levels=M // 8, spectral_neurons=H,
                              spectral_layers=2 if H == 128 else 3)
    if geo is not None:
        cfg = dataclasses.replace(cfg, geo_feat_dim=geo, num_semantic_classes=classes)
    s_cfg = make_spectral_config(cfg)
    if (s_cfg.n_freqs, s_cfg.neurons) != (M, H):
        fail(f"the width configuration gives M={s_cfg.n_freqs} H={s_cfg.neurons}, not {M}, {H}")
    return cfg, s_cfg


def phase_widths(dev, pairs=None, shapes=WIDTH_SHAPES, tols=None):
    """Every instance of the tile, and the padded trunks, against the plain
    versions (above) → {(M, H): {kernel: ms}}, zero biases. ``pairs``: (M,
    H) or (M, H, geo, classes) of the fields to run instead; ``tols(case,
    field)`` their limits (``_width_tols``'s form)."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import field_images
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm

    times = {}
    tols = tols or _width_tols
    for width, (R, S) in ((w, s) for w in pairs or WIDTH_FIELDS for s in shapes):
        M, H = width[:2]
        gen = _generator(dev, 17)
        cfg, s_cfg = _width_config(*width)
        C = cfg.num_semantic_classes
        field = spectral.init_spectral(s_cfg, gen, dev)
        names = [n for n, _ in field.named_parameters()]
        pos, dirs, t0_, t1_, miss = _render_inputs(gen, dev, R, S, cfg.aabb)
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        dt = ((t1_ - t0_) * (~miss)[:, None]).reshape(-1).contiguous()
        tm = (0.5 * (t0_ + t1_)).reshape(-1).contiguous()
        inputs = _k6_inputs(gen, dev, R, S, C, cfg.aabb)
        ms = {}
        for case in ("zero biases", "random biases"):
            if case == "random biases":
                _set_random_biases(field, gen, dev)
            timed = case == "zero biases" and (R, S) == shapes[0]
            k4_tol, k5_tol, (w_tol, l_tol, g_tol, g_leaf), bwd_tols = tols(case, width)
            leaves = list(field.parameters())
            label = (f"widths M={M} H={H} layers={s_cfg.layers} geo={s_cfg.geo_feat_dim} "
                     f"C={C} rows {R}x{S}={R * S} [{case}]")
            with torch.inference_mode():
                yk = ffh.fused_field_heads(leaves, u, sh, S)
                torch.cuda.synchronize()
                yp = ffh.fused_field_heads_plain(leaves, u, sh, S)
                _check_groups(f"{label} K4", yk, yp, {
                    "rgb": slice(0, 3), "sigma": slice(3, 4), "sem": slice(4, 4 + C)}, k4_tol)
                if timed:
                    ms["fused_field_heads"] = cuda_ms(
                        lambda: ffh.fused_field_heads(leaves, u, sh, S), reps=3, inner=3)
                acc_k, w_k = fvr.fused_field_volrend(leaves, u, sh, dt, tm, S)
                torch.cuda.synchronize()
                acc_p, w_p = fvr.fused_field_volrend_plain(leaves, u, sh, dt, tm, S)
                _check_groups(f"{label} K5", acc_k, acc_p, {
                    "rgb": slice(0, 3), "opacity": slice(3, 4), "depth": slice(4, 5),
                    "sem": slice(5, 5 + C)}, k5_tol)
                _check_groups(f"{label} K5", w_k[:, None], w_p[:, None],
                              {"weights": slice(0, 1)}, k5_tol, absolute=("weights",))
                del yk, yp, acc_k, w_k, acc_p, w_p

            lk, wk, gk = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
            torch.cuda.synchronize()
            if (M, H) == (64, 128) and timed:
                lk2, wk2, gk2 = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
                again = _flat(gk2)
                same = (torch.equal(lk, lk2) and torch.equal(wk, wk2)
                        and all(torch.equal(v, again[k]) for k, v in _flat(gk).items()))
                print(f"{label} K6: two runs bit-identical: {same}", flush=True)
                if not same:
                    fail(f"{label}: two runs of the train-step kernel differ")
            spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad_plain
            try:
                lp, wp, gp = spectral.forward_packed_lossgrad(field, s_cfg, *inputs)
            finally:
                spectral.fused_field_volrend_lossgrad = fvr.fused_field_volrend_lossgrad
            w_err = _errs(wk, wp)[0]
            l_err = max(abs(float(lk[i].sum()) - float(lp[i].sum())) / abs(float(lp[i].sum()))
                        for i in range(3))
            print(f"{label} K6: weights max_abs {w_err:.3e} (tol {w_tol}), loss terms rel "
                  f"{l_err:.3e} (tol {l_tol})", flush=True)
            if (width, case) in WIDTH_OWN_TOL and (R, S) == shapes[0]:
                diagnose_width(label, field, s_cfg, inputs, (u, sh, dt, tm, S), (lk, wk))
            if not (w_err <= w_tol and l_err <= l_tol):
                fail(f"{label}: the train-step kernel disagrees with its plain version")
            fk, fp = _flat(gk), _flat(gp)
            _check_grads(f"{label} K6", list(fp), [fk[k] for k in fp], list(fp.values()), g_tol,
                         g_leaf)
            if (width, case) in GRAD_DIAGNOSIS:
                diagnose_grads(label, field, s_cfg, inputs, fk)
            if timed:
                ms["fused_field_volrend_lossgrad"] = cuda_ms(
                    lambda: spectral.forward_packed_lossgrad(field, s_cfg, *inputs), reps=3,
                    inner=3)
            del lk, wk, gk, lp, wp, gp, fk, fp

            g_acc, g_w, g_y, g_h = _loss_cotangents(leaves, u, sh, dt, tm, S, C, 17)
            mlp = field.mlp_base
            layers = mlp.layers()

            def k1(fn):
                dW, dphase, grads, du = fn(field.W, field.phase, layers, u, g_h, True)
                return [dW, dphase, *grads], du

            for name, kernel, plain, leaf_names in (
                ("fused_field_heads_bwd",
                 lambda: ffh.fused_field_heads_bwd(leaves, u, sh, S, g_y, True),
                 lambda: ffh.fused_field_heads_bwd_plain(leaves, u, sh, S, g_y, True), names),
                ("fused_field_volrend_bwd",
                 lambda: fvr.fused_field_volrend_bwd(leaves, u, sh, dt, tm, S, g_acc, g_w, True),
                 lambda: fvr.fused_field_volrend_bwd_plain(leaves, u, sh, dt, tm, S, g_acc, g_w,
                                                           True), names),
                ("fused_spectral_field_bwd", lambda: k1(fm.fused_spectral_field_bwd),
                 lambda: k1(fm.fused_spectral_field_bwd_plain),
                 ["W", "phase"] + [n for n, _ in mlp.named_parameters()]),
            ):
                gk, duk = kernel()
                torch.cuda.synchronize()
                gp, dup = plain()
                _check_grads(f"{label} {name}", leaf_names + ["du"], [*gk, duk], [*gp, dup],
                             *bwd_tols[name])
                if timed:
                    ms[name] = cuda_ms(kernel, reps=3, inner=3)
                del gk, duk, gp, dup
            del g_acc, g_w, g_y, g_h
        if ms:
            print(f"widths {width}: kernel ms at {R} x {S} "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
            times[width] = ms
        del field, leaves, inputs, u, sh, dt, tm, pos
        torch.cuda.empty_cache()
    if pairs is None:
        phase_padded_trunks(dev)
    return times


def _padded_trunk_tols(case, trunk=None):
    """(the forward's limit, the backward's (limit, leaf limits)) of
    ``phase_padded_trunks`` for a bias case: K1's, and K1 bwd's in the widths
    phase."""
    return ((K1_TOL_ZERO_BIAS if case == "zero biases" else K1_TOL_RANDOM_BIAS),
            _width_tols(case)[3]["fused_spectral_field_bwd"])


def phase_padded_trunks(dev, trunks=PADDED_TRUNKS, tols=_padded_trunk_tols):
    """The trunk kernels at the widths of ``trunks`` (``PADDED_TRUNKS``'s
    form), which run zero-padded to their instance, at 65,536 rows and at
    24,000: the forward against its plain version, each limit shown to
    catch a zeroed and a negated output, and the backward against autograd
    through the plain version (bf16 x for K3, from the cotangent of half the
    mean squared output; dx at du's limit); ``tols(case, trunk)``: the limits
    (K1's, and K1 bwd's in the widths phase, by default); zero and then
    random biases; two runs of the backward agree to the last bit."""
    from apnerf_tpu_torch.models.nn import init_mlp
    from apnerf_tpu_torch.ops.cuda import field_images
    from apnerf_tpu_torch.ops.cuda import fused_mlp as fm

    for (m, din, h, n_hidden, out), N in ((t, n) for t in trunks
                                          for n in (WIDTH_SHAPES[0][0] * WIDTH_SHAPES[0][1],
                                                    LOOP_GRID_CELLS)):
        gen = _generator(dev, 19)
        mlp = init_mlp([din] + [h] * n_hidden + [out], gen, dev)
        layers = mlp.layers()
        field_images.check_trunk("chip_smoke", [tuple(t.shape) for pair in layers for t in pair],
                                 m)
        H = field_images.instance(h)
        W = torch.randn((3, m), generator=gen, device=dev) * 8.0 if m else None
        phase = torch.rand((m,), generator=gen, device=dev) if m else None
        u = torch.rand((N, 3), generator=gen, device=dev)
        x = torch.randn((N, din), generator=gen, device=dev).to(torch.bfloat16)
        names = [n for n, _ in mlp.named_parameters()]
        if m:
            names = ["W", "phase"] + names + ["du"]

            def kernel(fn=fm.fused_spectral_field_bwd):
                dW, dphase, grads, du = fn(W, phase, layers, u, g, True)
                return [dW, dphase, *grads, du]

            def plain():
                return kernel(fm.fused_spectral_field_bwd_plain)

            def output(fn=fm.fused_spectral_field_plain):
                return fn(W, phase, mlp, u)

            forward = fm.fused_spectral_field
        else:
            names = names + ["dx"]

            def kernel(fn=fm.fused_mlp_apply_bwd):
                grads, dx = fn(layers, x, g, True)
                return [*grads, dx]

            def plain():
                return kernel(fm.fused_mlp_apply_bwd_plain)

            def output(fn=fm.fused_mlp_apply_plain):
                return fn(mlp, x)

            forward = fm.fused_mlp_apply
        who = "fused_spectral_field" if m else "fused_mlp_apply"
        for case in ("zero biases", "random biases"):
            if case == "random biases":
                _set_random_biases(mlp, gen, dev)
            label = (f"padded trunk {'M=' + str(m) if m else 'din=' + str(din)} H={h} "
                     f"layers={n_hidden} out={out} on the H={H} instance, {N} rows: {who} "
                     f"[{case}]")
            with torch.no_grad():
                yk = output(forward)
                torch.cuda.synchronize()
                yp = output()
                g = (yp / N).contiguous()
            f_err, f_rel = _errs(yk, yp)
            f_tol, (tol, leaf_tol) = tols(case, (m, din, h, n_hidden, out))
            zeroed, negated = _errs(torch.zeros_like(yk), yp)[1], _errs(-yk, yp)[1]
            print(f"{label} forward: err/scale {f_rel:.3e} (tol {f_tol}) max_abs {f_err:.3e}; "
                  f"zeroed reads {zeroed:.3e}, negated {negated:.3e}", flush=True)
            if not (torch.isfinite(yk).all() and yk.shape == yp.shape and f_rel <= f_tol):
                fail(f"{label}: the forward disagrees with its plain version")
            if not (zeroed > f_tol and negated > f_tol):
                fail(f"{label}: the limit would pass a zeroed or negated output")
            del yk, yp
            gk = kernel()
            torch.cuda.synchronize()
            again = kernel()
            same = all(torch.equal(a, b) for a, b in zip(gk, again))
            print(f"{label} backward: two runs bit-identical: {same}", flush=True)
            if not same:
                fail(f"{label}: two runs differ")
            del again
            gp = plain()
            _check_grads(f"{label} backward", names, gk, gp, tol,
                         dict(leaf_tol, dx=leaf_tol.get("du", tol)))
            del gk, gp, g
        torch.cuda.empty_cache()


# one member step at spectral_neurons=128 against the plain versions: (loss
# relative, update and gradient err / max-abs), about 2x one reading on an
# H100 (PERF.md; the member step's readings repeat run to run). Its biases
# are trained, so the two bias conventions meet as in phase 14's routes.
WIDTH_STEP_TOL = (7e-4, 4e-1, 4e-2)


def phase_member_widths(dev, bench_run):
    """One member step of the default route at ``spectral_neurons=128``
    (the (128, 128) instance: K6 on the kernels against the autograd branch
    on the plain versions) at ``WIDTH_STEP_TOL``, from members trained
    one chunk of 100 steps on the kernels on the bench's scan (as phase 14's
    routes are: from a fresh state Adam's first update is -lr sign(g), whose
    sign flips wherever a gradient element is near zero)."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.train.flagship import (
        default_route,
        init_flagship_ensemble,
        make_flagship_train_phase,
        make_spectral_config,
    )
    from apnerf_tpu_torch.train.phase import pools_from_dataset

    cfg = dataclasses.replace(bench.bench_config(), spectral_neurons=128)
    s_cfg = make_spectral_config(cfg)
    if (s_cfg.n_freqs, s_cfg.neurons, default_route(s_cfg)) != (128, 128, "lossgrad"):
        fail(f"the member step runs M={s_cfg.n_freqs} H={s_cfg.neurons} on "
             f"{default_route(s_cfg)}")
    gen = _generator(dev, 18)
    ds = bench_run[1].dataset
    state = init_flagship_ensemble(cfg, gen, dev)._replace(step=1000)
    pools, counts = pools_from_dataset(ds)
    state, losses = make_flagship_train_phase(cfg)(
        state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K, pools, counts, ds.size,
        bench.STEPS_PER_CALL, False, gen)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"member step at spectral_neurons=128 (M={s_cfg.n_freqs}, H={s_cfg.neurons}, heads "
          f"{s_cfg.neurons // 4}), after {bench.STEPS_PER_CALL} steps on the kernels (loss "
          f"{first:.6f} over the first 10, {last:.6f} over the last 10):", flush=True)
    if not (np.isfinite(last) and last < first):
        fail(f"training at spectral_neurons=128 did not lower the loss ({first} -> {last})")
    compare_member_step(dev, state, ds, seed=123, cfg=cfg, tols=WIDTH_STEP_TOL)


# ---- 26. the field tile past 64 classes and 15 geometry features
#
# (M, H, geo, classes) of the fields held to their plain versions, each on
# its tier (T_out, C_pad): (32, 128), (48, 256), (32, 256), (16, 128)
WIDE_FIELDS = ((128, 256, 31, 101), (128, 256, 47, 256), (256, 512, 31, 150), (32, 64, 15, 65))
WIDE_GEO, WIDE_CLASSES = 31, 101  # the main path's field: fakeprod's widths, --sem-num 101
WIDE_LOOP_TRAJ, WIDE_LOOP_STEPS = 4, 20  # the loop's depth: candidates, train steps a phase
WIDE_KERNELS = ("fused_field_heads", "fused_field_heads_bwd", "fused_field_volrend",
                "fused_field_volrend_bwd", "fused_field_volrend_lossgrad")
# Limits of phase 26, about 2x the largest reading on an H100 (PERF.md; the
# kernels and the plain versions are deterministic, seeded inputs), each
# checked at run time to lie under a zeroed and a negated output's reading.
# K4, K5 and K6 at the main paths' shapes with the 101-class, geo-31 field
# (phases 8, 9 and 6's forms): sigma with zero biases reads 1.3e-6 of its
# scale at 1,048,576 rows (the shipping field 3.0e-7): the trunk output's
# f32 sums over 32 columns come in another order than the plain chain's.
WIDE_K4_TOL = {
    "zero biases": {"rgb": 8e-3, "sigma": 2.6e-6, "sem": 7e-3},
    "random biases": {"rgb": 1.8e-2, "sigma": 1.7e-2, "sem": 2e-2},
}
WIDE_K5_TOL = {
    "zero biases": {"weights": 2.5e-7, "rgb": 7e-4, "opacity": 2.7e-4, "depth": 3.5e-4,
                    "sem": 6e-4},
    "random biases": {"weights": 2.8e-3, "rgb": 9e-3, "opacity": 5.5e-3, "depth": 5e-3,
                      "sem": 8e-3},
}
WIDE_K6_TOL = {
    "zero biases": (5.5e-7, 2e-5, 1.2e-2, {}),
    "random biases": (1e-2, 4e-4, 1.8e-2, {"W": 1.9e-1, "phase": 2.2e-1, "mlp_base.w0": 3e-2}),
}
# the fields of WIDE_FIELDS at 512 x 128 (``_width_tols``'s form): (K4's, K5's,
# K6's (weights, loss, gradient, leaf limits), each backward's (limit, leaf
# limits)), over the largest reading of the four fields
_WIDE_RENDER_BWD = {
    "zero biases": (9e-3, {"W": 2.6e-2, "phase": 2.7e-2, "du": 1.6e-2}),
    "random biases": (2.8e-2, {"W": 2.3e-1, "phase": 2.1e-1, "mlp_base.w0": 9.5e-2, "du": 3.5e-1}),
}
WIDE_WIDTH_TOL = {
    "zero biases": (
        {"rgb": 6e-3, "sigma": 2.5e-6, "sem": 7e-3},
        {"weights": 5e-7, "rgb": 6e-4, "opacity": 1.2e-5, "depth": 5e-4, "sem": 9e-4},
        (3e-7, 1.5e-4, 1.1e-2, {"W": 1.6e-2, "phase": 1.7e-2}),
        {"fused_field_heads_bwd": _WIDE_RENDER_BWD["zero biases"],
         "fused_field_volrend_bwd": _WIDE_RENDER_BWD["zero biases"],
         "fused_spectral_field_bwd": (9e-3, {"W": 1.6e-2, "phase": 1.9e-2, "du": 1.2e-2})}),
    "random biases": (
        {"rgb": 2.8e-2, "sigma": 2.6e-2, "sem": 2.2e-2},
        {"weights": 5e-3, "rgb": 9e-3, "opacity": 8e-3, "depth": 8e-3, "sem": 1.3e-2},
        (6e-3, 4.5e-4, 4e-2, {"W": 2.3e-1, "phase": 2.6e-1, "mlp_base.w0": 9e-2}),
        {"fused_field_heads_bwd": _WIDE_RENDER_BWD["random biases"],
         "fused_field_volrend_bwd": _WIDE_RENDER_BWD["random biases"],
         "fused_spectral_field_bwd": (2.8e-2, {"W": 1.6e-1, "phase": 1.7e-1, "w0": 8e-2,
                                               "du": 3.5e-1})}),
}


def _wide_tols(case, width):
    """The limits of the fields of ``WIDE_FIELDS`` (``_width_tols``'s form)."""
    return WIDE_WIDTH_TOL[case]


def _wide_config(cfg):
    """``cfg`` with the main path's wide field: ``WIDE_GEO`` geometry
    features and ``WIDE_CLASSES`` classes."""
    return dataclasses.replace(cfg, geo_feat_dim=WIDE_GEO, num_semantic_classes=WIDE_CLASSES)


def phase_wide(dev, bench_run):
    """K4 fwd/bwd, K5 fwd/bwd and K6 on the tile's wider tiers against their
    plain versions (``WIDE_FIELDS`` at 512 x 128, zero and random biases);
    K4 fwd, K5 fwd and K6 at the main paths' shapes with the 101-class,
    geo-31 field; the bench protocol at that field's full width (a warm-up
    and a timed chunk of 100 steps on the bench's scan, exact launches),
    one member step against the plain versions and one traced → ({kernel:
    record at the wide field}, {kernel: ms at 512 x 128 by field}, the
    bench's result, the timed chunk's launches)."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.config import PipelineConfig

    t_phase = time.perf_counter()
    times = phase_widths(dev, WIDE_FIELDS, shapes=WIDTH_SHAPES[:1], tols=_wide_tols)
    records = {
        "fused_field_heads": phase_k4(dev, _wide_config(PipelineConfig()), WIDE_K4_TOL),
        "fused_field_volrend": phase_k5(dev, _wide_config(PipelineConfig()), WIDE_K5_TOL,
                                        shapes=((25600, 256),)),
        "fused_field_volrend_lossgrad": phase_k6(dev, _wide_config(bench.bench_config()),
                                                 WIDE_K6_TOL),
    }
    # device times beside the shipping field's, in turns: K6's kernels, K4's launch alone
    device = {"fused_field_volrend_lossgrad": [], "fused_field_heads": []}
    for wide in (False, True, True, False):
        device["fused_field_volrend_lossgrad"].append(k6_device_time(
            dev, cfg=_wide_config(bench.bench_config()) if wide else None))
        device["fused_field_heads"].append(k4_launch_ms(
            dev, _wide_config(PipelineConfig()) if wide else None))
    for name, (s1, w1, w2, s2) in device.items():
        records[name] += ({"device_ms": (w1 + w2) / 2, "shipping_device_ms": (s1 + s2) / 2},)
    t_kernels = time.perf_counter() - t_phase
    res, counts = wide_member_step(dev, bench_run, _wide_config(bench.bench_config()), "wide")
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s (kernels {t_kernels:.1f} s, the "
          f"member steps the rest)", flush=True)
    return records, times, res, counts


def wide_member_step(dev, bench_run, cfg, label, compare=True):
    """The bench protocol at ``cfg``'s field (a warm-up and a timed chunk
    of 100 steps on phase 7's scan; exact launches over the timed chunk, a
    finite falling loss) and, with ``compare``, one member step against
    the plain versions and one traced → (the bench's result, the timed
    chunk's launches)."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.ops.cuda.fused_mlp import fused_spectral_field
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_bwd,
    )
    from apnerf_tpu_torch.train.flagship import default_route, make_spectral_config

    s_cfg = make_spectral_config(cfg)
    geo, classes = s_cfg.geo_feat_dim, s_cfg.num_semantic_classes
    if (geo, classes, default_route(s_cfg)) != (cfg.geo_feat_dim, cfg.num_semantic_classes,
                                                "lossgrad"):
        fail(f"the {label} member step runs geo {geo} classes {classes} on "
             f"{default_route(s_cfg)}")
    counters = (fused_spectral_field, fused_render_weights, fused_render_weights_bwd,
                fvr.fused_field_volrend_lossgrad)
    counts = {}

    @contextlib.contextmanager
    def timed():
        for c in counters:
            c.launches = 0
        yield
        counts.update({c.__name__: c.launches for c in counters})

    run = bench.run(dev, timed=timed, n_calls=1, data=bench_run[0], cfg=cfg)
    res = run.result
    E, n = cfg.n_ensembles, res["timed_steps"]
    print(f"{label} member step (geo {geo}, {classes} classes, {s_cfg.layers}x{s_cfg.neurons} "
          f"on {s_cfg.n_freqs} frequencies, route lossgrad): {res['ms_per_step']:.3f} ms per "
          f"step over {n} timed steps (phase {res['phase_ms_per_step']:.3f}), "
          f"{res['value']:.6e} samples/s; the 29-class field's "
          f"{bench_run[1].result['ms_per_step']:.3f} ms (phase 7); final loss "
          f"{res['final_loss']:.6f}, canary {res['psnr_100steps']:.3f} dB after 200 steps; "
          f"launches {counts}", flush=True)
    expected = {"fused_field_volrend_lossgrad": E * n, "fused_render_weights_bwd": E * n,
                "fused_render_weights": 2 * E * n, "fused_spectral_field": E}
    if counts != expected:
        fail(f"{label} member step launch counts {counts}, expected {expected}")
    if not (np.isfinite(res["final_loss"]) and res["final_loss"] < float(run.losses[:10].mean())):
        fail(f"the {label} member steps' loss is not finite or did not fall: {res['final_loss']}")
    if compare:
        compare_member_step(dev, run.state, run.dataset, seed=123, cfg=cfg)
        profile_member_step(dev, run.state, run.dataset, "lossgrad", cfg=cfg)
    return res, counts


def wide_refusals(dev):
    """Fields past the set (1025 classes, 64 geometry features, a 2048-wide
    trunk, 512 frequencies on a 1024-wide one) on the card: every
    main-field kernel's wrapper raises before any launch, naming the set,
    and no counter moves."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.ops.cuda import fused_field_heads as ffh
    from apnerf_tpu_torch.ops.cuda import fused_field_volrend as fvr
    from apnerf_tpu_torch.train.flagship import make_spectral_config

    gen = _generator(dev, 26)
    R, S = 64, 8
    counters = all_counters()
    reset_counts(counters)
    for M, H, geo, classes in ((128, 256, 15, 1025), (128, 256, 64, 29), (128, 2048, 15, 29),
                               (512, 1024, 15, 29)):
        cfg = dataclasses.replace(_width_config(128, 256)[0], spectral_neurons=H,
                                  n_levels=M // 8, geo_feat_dim=geo,
                                  num_semantic_classes=classes)
        s_cfg = make_spectral_config(cfg)
        leaves = list(spectral.init_spectral(s_cfg, gen, dev).parameters())
        pos, dirs, t0_, t1_, miss = _render_inputs(gen, dev, R, S, cfg.aabb)
        u, sh = spectral._packed_inputs(s_cfg, pos, dirs)
        dt = ((t1_ - t0_) * (~miss)[:, None]).reshape(-1).contiguous()
        tm = (0.5 * (t0_ + t1_)).reshape(-1).contiguous()
        inputs = _k6_inputs(gen, dev, R, S, classes, cfg.aabb)[5:]
        for name, call in (
            ("fused_field_heads", lambda: ffh.fused_field_heads(leaves, u, sh, S)),
            ("fused_field_volrend", lambda: fvr.fused_field_volrend(leaves, u, sh, dt, tm, S)),
            ("fused_field_volrend_lossgrad", lambda: fvr.fused_field_volrend_lossgrad(
                leaves, u, sh, dt, tm, *inputs, S)),
        ):
            try:
                with torch.no_grad():
                    call()
            except ValueError as e:
                if "geo 1..63, classes 1..1024" not in str(e):
                    fail(f"{name} refused H={H} geo {geo} classes {classes} without naming the "
                         f"set: {e}")
            else:
                fail(f"{name} took H={H} geo {geo} classes {classes} on the card")
        print(f"wide refusals: M={M} H={H} geo {geo} classes {classes}: K4, K5 and K6 raise "
              f"before any launch", flush=True)
    if any(read_counts(counters).values()):
        fail(f"a refused field launched a kernel: {read_counts(counters)}")


def phase_wide_loop(dev, geo, classes, neurons=None):
    """One planning step of the loop through its CLI entry at
    ``config_fakeprod.yaml``'s width with ``geo_feat_dim: geo``,
    ``--sem-num classes`` and, where given, ``spectral_neurons: neurons``,
    its depth cut to ``WIDE_LOOP_TRAJ`` candidates,
    train phases of ``WIDE_LOOP_STEPS`` steps and one test location: finite
    losses, finite evaluation rows, exact launches → the loop's launches."""
    import yaml

    from apnerf_tpu_torch.active import pipeline
    from apnerf_tpu_torch.ops.cuda import build

    with open(build.REPO_ROOT / "configs" / "config_fakeprod.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(planning_step=1, training_steps=WIDE_LOOP_STEPS, num_traj=WIDE_LOOP_TRAJ,
               geo_feat_dim=geo, test_loc=LOOP_TEST_LOC[:1],
               save_path=str(build.BUILD_DIR / f"chip_smoke_loop_{classes}"))
    if neurons is not None:
        raw.update(spectral_neurons=neurons)
    cfg_path = build.BUILD_DIR / f"chip_smoke_loop_{classes}.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper

    counters = all_counters()
    walls = {}
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed_methods(ActiveNeRFMapper, LOOP_TIMED, walls):
        mapper = pipeline.main(["--sim", "fake", "--sem-num", str(classes), "--device",
                                str(dev), "--config", str(cfg_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    cfg = mapper.cfg
    rows = np.asarray(mapper.errors_hist)
    print(f"wide loop: {cfg_path.name} = config_fakeprod.yaml with geo_feat_dim {geo}, "
          f"--sem-num {classes}, spectral_neurons {cfg.spectral_neurons}, planning_step 1, "
          f"num_traj {WIDE_LOOP_TRAJ}, training_steps {WIDE_LOOP_STEPS}, 1 test location: "
          f"{wall:.1f} s of wall; host wall "
          f"by method (calls, seconds): "
          + ", ".join(f"{k} ({c}, {t:.2f})" for k, (c, t) in walls.items())
          + f"; evaluation rows {rows.tolist()}; launches {counts}", flush=True)
    if (cfg.num_semantic_classes, cfg.geo_feat_dim, cfg.img_w, cfg.num_rays) != (
            classes, geo, 640, 2048) or (neurons or cfg.spectral_neurons) != cfg.spectral_neurons:
        fail("the wide loop did not run at its widths")
    losses = [float(l) for phase in mapper.loss_hist for l in phase]
    if not np.isfinite(losses).all() or rows.shape != (3, 4) or not np.isfinite(rows).all():
        fail(f"the wide loop's losses or evaluation rows are not finite: {rows}")
    E = cfg.n_ensembles
    ran = len(losses) + mapper.refit_discarded_steps
    chunks = sum(-(-len(phase) // mapper.steps_per_call) for phase in mapper.loss_hist)
    renders = cfg.planning_step * cfg.num_traj * N_VIEWS * E
    eval_renders = 3 * len(mapper._test_poses) * E
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "fused_field_volrend_lossgrad": E * ran, "fused_render_weights_bwd": E * ran,
        "fused_spectral_field": E * chunks, "fused_field_heads": renders,
        "fused_field_volrend": eval_renders,
        "fused_render_weights": 2 * E * ran + 2 * renders + eval_renders,
    })
    if counts != expected:
        fail(f"wide loop launch counts {counts}, expected {expected}")
    return counts


# ---- 27. the field tile's last tier: past 47 geometry features and 256 classes
#
# (M, H, geo, classes) of the fields held to their plain versions on the tier
# (T_out, C_pad) = (64, 1024), one at each instance of the tile
WIDEST_FIELDS = ((128, 256, 63, 847), (32, 64, 48, 257), (64, 128, 63, 1024),
                 (256, 512, 63, 1000), (128, 1024, 15, 29), (128, 1024, 63, 1024),
                 (64, 300, 15, 29))
# (the encode's frequencies or 0 for an input x, its width, H, hidden layers,
# output) of the trunk kernels on the 1024 instance (K1 at the 1024-wide field's
# trunk; K3 with two output blocks of g and more); K1 at H = 300 on the 512 instance
WIDEST_TRUNKS = ((128, 256, 1024, 3, 64), (0, 256, 1024, 2, 17), (0, 512, 700, 3, 130),
                 (48, 96, 300, 3, 16))
# the member step's and the loop's field: fakeprod's widths, 63 geometry features and
# --sem-num 847 (the label set of ADE20K-Full, A-847)
WIDEST_GEO, WIDEST_CLASSES, WIDEST_NEURONS = 63, 847, 1024
# Limits of phase 27, about 2x the largest reading over its fields on an H100
# (PERF.md; deterministic kernels and plain versions on seeded inputs), each checked at
# run time to lie under a zeroed and a negated output's reading. With zero biases K5's
# opacity and semantic sums read up to 2.0e-4 and 1.1e-3 of their scale (phase 26's
# fields 0.6e-5 and 4e-4): a sum of bf16(w x) takes a rounding flip where the weights
# differ by 2-4e-7, the trunk output's f32 sums over 64 columns (and a 1024-wide
# trunk's over 1024) coming in another order than the plain chain's.
WIDEST_WIDTH_TOL = {
    "zero biases": (
        {"rgb": 6.5e-3, "sigma": 4e-6, "sem": 6.5e-3},
        {"weights": 8.5e-7, "rgb": 7e-4, "opacity": 4.5e-4, "depth": 6e-4, "sem": 2.3e-3},
        (5.5e-7, 1.6e-4, 1.1e-2, {"W": 1.5e-2, "phase": 1.5e-2}),
        {"fused_field_heads_bwd": (9e-3, {"W": 1.5e-2, "phase": 1.7e-2, "du": 1.6e-2}),
         "fused_field_volrend_bwd": (8.5e-3, {"W": 2e-2, "phase": 1.9e-2, "du": 2.2e-2}),
         "fused_spectral_field_bwd": (7.5e-3, {"W": 1.4e-2, "phase": 1.5e-2, "du": 1.5e-2})}),
    "random biases": (
        {"rgb": 2.7e-2, "sigma": 2.8e-2, "sem": 2.8e-2},
        {"weights": 9e-3, "rgb": 1.1e-2, "opacity": 7e-3, "depth": 7e-3, "sem": 2.2e-2},
        (1e-2, 1.1e-3, 2.6e-2, {"W": 2.1e-1, "phase": 1.9e-1, "mlp_base.w0": 9.2e-2}),
        {"fused_field_heads_bwd": (3.8e-2, {"W": 2.3e-1, "phase": 2.2e-1, "mlp_base.w0": 8.3e-2,
                                            "du": 3.6e-1}),
         "fused_field_volrend_bwd": (3.9e-2, {"W": 2.3e-1, "phase": 2.1e-1,
                                              "mlp_base.w0": 8.4e-2, "du": 3.7e-1}),
         "fused_spectral_field_bwd": (4.1e-2, {"W": 1.6e-1, "phase": 1.5e-1, "w0": 6.3e-2,
                                               "du": 3.6e-1})}),
}
# The 300-wide field runs on the 512 instance, its trunk zero-padded: with zero biases
# K4's sigma reads 2.2e-4 of its scale and K5's weights 5.2e-5 (the 512-wide field 1.4e-6
# and 4.2e-7). The plain chain's GEMMs at K = 300 sum in another order than at a
# multiple of 64 (the padded trunks' K1 forward at H = 300 reads 9.7e-4 where H = 96 or
# 512 read under 1e-5), and a few bf16 roundings of the hidden layers flip; the
# gradients, where the padding matters (every matrix's items read back), are within the
# other fields' ranges.
WIDEST_300_TOL = {
    "zero biases": (
        {"rgb": 6.5e-3, "sigma": 4.4e-4, "sem": 7e-3},
        {"weights": 1.1e-4, "rgb": 7e-4, "opacity": 2e-3, "depth": 6e-4, "sem": 2e-3},
        (4.4e-5, 1.6e-4, 9e-3, {"W": 1e-2, "phase": 1.3e-2}),
        {"fused_field_heads_bwd": (1.1e-2, {"W": 1e-2, "phase": 1.1e-2, "du": 3e-2}),
         "fused_field_volrend_bwd": (9e-3, {"W": 1.1e-2, "phase": 1e-2, "du": 2.1e-2}),
         "fused_spectral_field_bwd": (8.5e-3, {"W": 1.1e-2, "phase": 9e-3, "du": 2.1e-2})}),
    "random biases": (
        WIDEST_WIDTH_TOL["random biases"][0], WIDEST_WIDTH_TOL["random biases"][1],
        (1e-2, 1.1e-3, 4e-2, {"W": 1.5e-1, "phase": 1.4e-1, "mlp_base.w0": 1.1e-1}),
        {"fused_field_heads_bwd": (3.8e-2, {"W": 1.4e-1, "phase": 1.5e-1, "mlp_base.w0": 1.2e-1,
                                            "du": 2.2e-1}),
         "fused_field_volrend_bwd": (3.9e-2, {"W": 1.5e-1, "phase": 1.5e-1,
                                              "mlp_base.w0": 1.2e-1, "du": 2.3e-1}),
         "fused_spectral_field_bwd": (3e-2, {"W": 8e-2, "phase": 8.5e-2, "w0": 7e-2,
                                             "du": 1.2e-1})}),
}


def _widest_tols(case, width):
    """The limits of the fields of ``WIDEST_FIELDS`` (``_width_tols``'s form)."""
    return (WIDEST_300_TOL if width[1] == 300 else WIDEST_WIDTH_TOL)[case]


def _widest_config(cfg):
    """``cfg`` with ``WIDEST_GEO`` geometry features and ``WIDEST_CLASSES`` classes."""
    return dataclasses.replace(cfg, geo_feat_dim=WIDEST_GEO, num_semantic_classes=WIDEST_CLASSES)


def _widest_trunk_tols(case, trunk):
    """The limits of ``WIDEST_TRUNKS`` (``_padded_trunk_tols``'s form): K1's
    and K1 bwd's, but for a width that is no multiple of 64 with zero biases
    (the plain chain's GEMMs at K = 300 or 700 sum in another order than the
    tile's: the forward reads 9.7e-4 and 1.3e-3 of its scale, dx 2.4e-2),
    limits at about 2x those readings."""
    f_tol, (tol, leaf) = _padded_trunk_tols(case)
    if trunk[2] % 64 and case == "zero biases":
        return 2.6e-3, (tol, dict(leaf, du=5e-2))
    return f_tol, (tol, leaf)


def phase_widest(dev, bench_run):
    """Fields past the set refused on the card (``wide_refusals``); K4
    fwd/bwd, K5 fwd/bwd, K6 and K1 bwd on the last tier (64, 1024) at every
    instance and on the 1024 instance against their plain versions
    (``WIDEST_FIELDS`` at 512 x 128, zero and random biases); K1 and K3
    forward and backward on the 1024 instance (``WIDEST_TRUNKS``); K6's
    kernels' device time at the bench shape with the 847-class, geo-63
    field; the bench protocol (a warm-up and a timed chunk of 100 steps,
    exact launches, a finite falling loss) at that field and at the
    bench's field with a 1024-wide trunk; then ``active.pipeline --sem-num
    847`` at ``config_fakeprod.yaml``'s width with ``geo_feat_dim: 63`` and
    ``spectral_neurons: 1024``, its depth as phase 26's was → ({kernel: ms
    at 512 x 128 by field}, the two benches' results, the loop's launches,
    K6's device ms)."""
    from apnerf_tpu_torch import bench

    t_phase = time.perf_counter()
    wide_refusals(dev)
    times = phase_widths(dev, WIDEST_FIELDS, shapes=WIDTH_SHAPES[:1], tols=_widest_tols)
    phase_padded_trunks(dev, WIDEST_TRUNKS, _widest_trunk_tols)
    cfg = _widest_config(bench.bench_config())
    k6_ms = k6_device_time(dev, cfg=cfg)
    t_kernels = time.perf_counter() - t_phase
    res, _ = wide_member_step(dev, bench_run, cfg, "widest", compare=False)
    res_1024, _ = wide_member_step(
        dev, bench_run, dataclasses.replace(bench.bench_config(), spectral_neurons=1024),
        "1024-wide", compare=False)
    t_steps = time.perf_counter() - t_phase - t_kernels
    loop_counts = phase_wide_loop(dev, WIDEST_GEO, WIDEST_CLASSES, WIDEST_NEURONS)
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s (kernels {t_kernels:.1f} s, member "
          f"steps {t_steps:.1f} s, the loop the rest)", flush=True)
    return times, (res, res_1024), loop_counts, k6_ms


LOOP_ARTIFACTS = (
    "train/data0.npz", "test/data0.npz", "uncertainty.npy", "errors.npy", "metrics_ext.npy",
    "throughput.json", "checkpoints/model_0.npz", "checkpoints/model_1.npz",
)
LOOP_TEST_LOC = [[-3.7, 1.5, -4.4], [-4.5, 1.5, -3.8]]
LOOP_PLANNING_STEPS = 1  # phase 10's depth
NGP_LOOP_TRAJ = 10  # phase 20's candidates
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
    raw.update(planning_step=LOOP_PLANNING_STEPS, training_steps=100, test_loc=LOOP_TEST_LOC,
               save_path=str(build.BUILD_DIR / "chip_smoke_loop"))
    cfg_path = build.BUILD_DIR / "chip_smoke_loop.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    try:
        import imageio  # noqa: F401
        has_imageio = True
    except ImportError:
        has_imageio = False
    print(f"loop: {cfg_path.name} = config_fakeprod.yaml with planning_step "
          f"{LOOP_PLANNING_STEPS}, training_steps "
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
    n_chunks = 6 + LOOP_PLANNING_STEPS  # 100 + planning steps x 100 + 500 train steps
    if not np.isfinite(chunk_means).all() or len(chunk_means) != n_chunks:
        fail(f"the loop's losses are not finite, or not {n_chunks} chunks: {chunk_means}")
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
    if len(mapper.train_dataset) != 39 + LOOP_PLANNING_STEPS * N_VIEWS:
        fail(f"the train dataset holds {len(mapper.train_dataset)} images")

    # launches: 100 + LOOP_PLANNING_STEPS x 100 + 500 train steps in chunks of 100,
    # LOOP_PLANNING_STEPS planning steps of 20 candidates x 40 views x E members, 3
    # evaluations of 8 views x E members
    # (one wrapper call per view; each call runs its rays in chunks). A chunk
    # that the refit's divergence guard threw away ran its train steps and no
    # occupancy update; the mapper counts those steps.
    steps = sum(len(phase) for phase in mapper.loss_hist)
    chunks = len(chunk_means)
    ran = steps + mapper.refit_discarded_steps
    if steps != n_chunks * T or mapper.refit_discarded_steps != mapper.refit_rollbacks * 100:
        fail(f"the loop kept {steps} train steps and discarded "
             f"{mapper.refit_discarded_steps} in {mapper.refit_rollbacks} rollbacks")
    renders = LOOP_PLANNING_STEPS * cfg.num_traj * N_VIEWS * E
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


def phase_faketiny(dev):
    """The whole loop through the CLI at ``configs/config_faketiny.yaml``
    on the card: M = 32 frequencies and a 256-wide trunk, the tile's
    (32, 256) instance in every render and train step (the proposal
    field's trunk forward on the wmma tile), depth as the file sets it.
    Finite falling losses, finite evaluation rows, and launch counts
    exact against what the run did (its kept and discarded train steps,
    the candidates it scored, its evaluations) → the mapper."""
    import yaml

    from apnerf_tpu_torch.active import pipeline
    from apnerf_tpu_torch.ops.cuda import build

    with open(build.REPO_ROOT / "configs" / "config_faketiny.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(save_path=str(build.BUILD_DIR / "chip_smoke_faketiny"))
    cfg_path = build.BUILD_DIR / "chip_smoke_faketiny.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    prof_dir = build.BUILD_DIR / "chip_smoke_profile"
    counters = all_counters()
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper = pipeline.main(["--sim", "fake", "--device", str(dev), "--config", str(cfg_path),
                            "--profile", str(prof_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    check_trace(prof_dir / "trace.json", PROFILE_KERNELS)
    shutil.rmtree(prof_dir)
    cfg, s_cfg = mapper.cfg, mapper.spectral_cfg
    print(f"faketiny loop: {wall:.1f} s of wall; M={s_cfg.n_freqs} H={s_cfg.neurons} "
          f"layers={s_cfg.layers} classes={s_cfg.num_semantic_classes}; launches: {counts}",
          flush=True)
    for row, ext in zip(mapper.errors_hist, mapper.metrics_ext_hist):
        print(f"  evaluation at planning step {row[0]:.0f}: PSNR {row[1]:.4f} dB, depth MSE "
              f"{row[2]:.6f}, semantic CE {row[3]:.6f}, mIoU {ext[2]:.6f}")
    per = mapper.steps_per_call
    chunk_means = [float(np.mean(phase[i:i + per])) for phase in mapper.loss_hist
                   for i in range(0, len(phase), per)]
    print(f"  chunk-mean losses: {' '.join(f'{m:.4f}' for m in chunk_means)}; refit "
          f"rollbacks {mapper.refit_rollbacks}", flush=True)
    if (s_cfg.n_freqs, s_cfg.neurons) != (32, 256):
        fail(f"faketiny runs M={s_cfg.n_freqs} H={s_cfg.neurons}, not the (32, 256) instance")
    if not np.isfinite(chunk_means).all() or not chunk_means[-1] < chunk_means[0]:
        fail(f"the faketiny loop's losses are not finite or did not fall: {chunk_means}")
    rows = np.asarray(mapper.errors_hist)
    if rows.ndim != 2 or len(rows) < 2 or not np.isfinite(rows).all():
        fail(f"expected finite evaluation rows, got {rows}")
    E = cfg.n_ensembles
    steps = sum(len(phase) for phase in mapper.loss_hist)
    ran = steps + mapper.refit_discarded_steps
    scored = sum(len(c) for c in mapper.trajector_uncertainty_list)
    renders = scored * N_VIEWS * E
    eval_renders = len(mapper.errors_hist) * len(mapper._test_poses) * E
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "fused_field_volrend_lossgrad": E * ran,
        "fused_render_weights_bwd": E * ran,
        "fused_spectral_field": E * len(chunk_means),  # the occupancy update
        "fused_field_heads": renders,
        "fused_field_volrend": eval_renders,
        "fused_render_weights": 2 * E * ran + 2 * renders + eval_renders,
    })
    if scored == 0 or counts != expected:
        fail(f"faketiny loop launch counts {counts}, expected {expected} ({scored} candidates "
             f"scored)")
    return mapper


# kernels a profiled loop's trace must name: K6's per-ray loss kernel (only
# the train-step kernel runs it with the loss on), the field backward (on the
# default route only K6 runs one), and K5 forward's per-ray render kernel
PROFILE_KERNELS = {
    "fused_field_volrend_lossgrad": ("fvr_ray_kernel", "fvr_field_bwd_kernel"),
    "fused_field_volrend": ("fvr_fwd_ray_kernel",),
}


def check_trace(path, kernels):
    """The Chrome trace that ``--profile`` wrote names each kernel of
    ``kernels`` ({wrapper: device kernel names}) among its device kernels.
    The file is scanned for the kernel events' names, not parsed: a
    profiled loop's trace holds a CPU event per op (about 500 MiB)."""
    import mmap

    event = re.compile(rb'"cat":\s*"kernel",\s*"name":\s*"((?:[^"\\]|\\.)*)"')
    t0 = time.perf_counter()
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
        found_names = [m.group(1).decode() for m in event.finditer(buf)]
    names = set(found_names)
    found = {w: {k: sum(k + "<" in n or k + "(" in n for n in names) for k in ks}
             for w, ks in kernels.items()}
    print(f"  profile: {path.name} {os.path.getsize(path) / 2**20:.1f} MiB, {len(found_names)} "
          f"kernel events, {len(names)} distinct device kernels, scanned in "
          f"{time.perf_counter() - t0:.1f} s; kernels named: {found}", flush=True)
    missing = [(w, k) for w, ks in found.items() for k, n in ks.items() if not n]
    if missing:
        fail(f"the profiled loop's trace names none of {missing}")


# The replay loop (phase 22): a ring of inward-facing views at
# config_fakeprod.yaml's width around the room's centre, every 8th held out.
REPLAY_FRAMES = 48
REPLAY_RADIUS = 2.5
REPLAY_STEPS = 100
REPLAY_HOLDOUT = 8


def record_ring(out_dir, n=REPLAY_FRAMES, radius=REPLAY_RADIUS):
    """A FakeSim tour of ``n`` views on a ring of ``radius`` m at 1.5 m,
    each facing the ring's centre, at ``config_fakeprod.yaml``'s aabb and
    width, written by ``RayDataset.save`` into ``out_dir`` → (the npz's
    path, the [n, 7] poses, the aabb)."""
    from apnerf_tpu_torch.config import load_scene_config
    from apnerf_tpu_torch.data.dataset import RayDataset
    from apnerf_tpu_torch.ops.cuda import build
    from apnerf_tpu_torch.ops.rays import pose_matrix_from_quat
    from apnerf_tpu_torch.sim.fake import FakeSim

    cfg = load_scene_config(str(build.REPO_ROOT / "configs" / "config_fakeprod.yaml"))
    aabb = np.asarray(cfg.aabb, dtype=np.float64)
    center = 0.5 * (aabb[:3] + aabb[3:])
    poses = []
    for a in np.linspace(0.0, 2 * np.pi, n, endpoint=False):
        pos = center + radius * np.array([np.cos(a), 0.0, np.sin(a)])
        pos[1] = 1.5
        yaw = 0.5 * np.pi - a  # the camera's -z towards the centre
        poses.append(np.concatenate([pos, [0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)]]))
    sim = FakeSim(aabb=tuple(cfg.aabb), img_w=cfg.img_w, img_h=cfg.img_h, hfov=cfg.hfov)
    imgs, deps, sems = sim.sample_images_from_poses(poses)
    mats = np.array([pose_matrix_from_quat(p[:3], p[3:]) for p in poses])
    ds = RayDataset(training=True, save_fp=str(out_dir), width=cfg.img_w, height=cfg.img_h,
                    hfov=cfg.hfov, max_images=n, device="cpu")
    ds.update_data(imgs[..., :3], deps, sems, mats)
    return ds.save(), np.array(poses), tuple(float(v) for v in aabb)


def replay_argv(npz, aabb, out, steps, planning_steps=1, device="cuda"):
    """``replay_eval``'s flags at the flagship's full width."""
    return ["--npz", str(npz), "--steps", str(steps), "--planning-steps", str(planning_steps),
            "--holdout", str(REPLAY_HOLDOUT), "--num-rays", "2048", "--samples", "128",
            "--out", str(out), "--aabb", *map(str, aabb), "--device", str(device)]


def phase_replay(dev):
    """The replay loop through ``replay_eval`` at the flagship's full width
    and cut depth → its mapper."""
    from apnerf_tpu_torch import replay_eval
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.ops.cuda import build
    from apnerf_tpu_torch.ops.rays import pose_matrix_from_quat

    t0 = time.perf_counter()
    npz, poses, aabb = record_ring(build.BUILD_DIR / "chip_smoke_replay_rec")
    t_rec = time.perf_counter() - t0
    print(f"replay: recorded {len(poses)} views at 640^2 on a ring of {REPLAY_RADIUS} m in "
          f"{t_rec:.1f} s -> {os.path.relpath(npz, build.REPO_ROOT)}", flush=True)
    counters = all_counters()
    walls = {}
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed_methods(ActiveNeRFMapper, LOOP_TIMED, walls):
        rows, mapper = replay_eval.run(replay_eval.parse_args(replay_argv(
            npz, aabb, build.BUILD_DIR / "chip_smoke_replay", REPLAY_STEPS, device=dev)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    cfg, s_cfg = mapper.cfg, mapper.spectral_cfg
    print(f"replay loop: {wall:.1f} s of wall; host wall by method (calls, seconds): "
          + ", ".join(f"{k} ({c}, {s:.2f})" for k, (c, s) in walls.items()), flush=True)
    print(f"  M={s_cfg.n_freqs} H={s_cfg.neurons} layers={s_cfg.layers} classes="
          f"{cfg.num_semantic_classes} rays={cfg.num_rays} samples={cfg.max_samples_train}; "
          f"launches: {counts}")
    for r in rows:
        print(f"  evaluation at planning step {r['planning_step']:.0f}: PSNR {r['psnr']:.4f} dB, "
              f"depth MSE {r['depth_mse']:.6f}, semantic CE {r['sem_ce']:.6f}", flush=True)
    if ((cfg.img_w, cfg.num_rays, cfg.max_samples_train, cfg.n_ensembles, s_cfg.neurons,
         s_cfg.layers) != (640, 2048, 128, 2, 256, 3)
            or cfg.num_semantic_classes != mapper.sim.num_semantic_classes):
        fail("the replay loop did not run at the flagship's full width")
    # evaluations after the initial training, before and inside planning, and at the end
    if len(rows) != 4 or not np.isfinite([[r[k] for k in ("psnr", "depth_mse", "sem_ce")]
                                          for r in rows]).all():
        fail(f"expected 4 finite error rows, got {rows}")
    rec = np.array([pose_matrix_from_quat(p[:3], p[3:]) for p in poses])
    got = mapper.train_dataset.camtoworlds[: len(mapper.train_dataset)].double().cpu().numpy()
    worst = max(float(np.abs(rec - c).max(axis=(1, 2)).min()) for c in got)
    n_test = len(mapper._test_poses)
    print(f"  {len(got)} supervised cameras, the farthest {worst:.3e} from a recorded one; "
          f"{n_test} held-out views", flush=True)
    if not worst < 1e-5 or len(got) <= 12:
        fail(f"a supervised camera is {worst} from every recorded one ({len(got)} cameras)")
    E = cfg.n_ensembles
    per = mapper.steps_per_call
    chunks = sum(-(-len(phase) // per) for phase in mapper.loss_hist)
    steps = sum(len(phase) for phase in mapper.loss_hist)
    ran = steps + mapper.refit_discarded_steps
    scored = sum(len(c) for c in mapper.trajector_uncertainty_list)
    renders = scored * N_VIEWS * E
    eval_renders = len(rows) * n_test * E
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "fused_field_volrend_lossgrad": E * ran,
        "fused_render_weights_bwd": E * ran,
        "fused_spectral_field": E * chunks,  # the occupancy update
        "fused_field_heads": renders,
        "fused_field_volrend": eval_renders,
        "fused_render_weights": 2 * E * ran + 2 * renders + eval_renders,
    })
    if ran != 2 * REPLAY_STEPS or scored == 0 or counts != expected:
        fail(f"replay loop launch counts {counts}, expected {expected} ({ran} steps, "
             f"{scored} candidates scored)")
    return mapper


# phase 23's renders on the replay loop's trained mapper, kernel route
# against plain route, per output as err / scale of the plain output: (99.9th
# percentile over rays, mean over rays). On an H100 (PERF.md) the percentile
# read 8.6e-4 rgb, 7.0e-4 opacity, 8.9e-4 depth, 2.5e-3 logits and the mean
# 1.8e-4, 1.4e-4, 1.5e-4, 1.4e-4; the limits are about 3x. The single worst
# ray is heavy-tailed on a trained field, as in phase 11 (3.2e-3 to 5.0e-3
# here, the same in two runs: the replay loop's seeded training repeats to
# the last digit) and is printed, not held. Each limit is shown at run time
# to catch a zeroed and a negated output (they read 0.1 to 2).
VIZ_RENDER_TOL = {"rgb": (2.5e-3, 5e-4), "opacity": (2e-3, 4e-4), "depth": (2.5e-3, 4.5e-4),
                  "sem": (7.5e-3, 4e-4)}


def phase_viz(mapper):
    """``render_comparison``, ``walkthrough`` and the scripted viewer on the
    replay loop's mapper: launches, panels, and the renders on the plain route."""
    from apnerf_tpu_torch.viz import render_views as rv
    from apnerf_tpu_torch.viz.interactive import InteractiveViewer

    poses = mapper._test_poses[:2]
    scale, n_walk = 0.25, 4
    counters = all_counters()
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = rv.render_comparison(mapper, poses, scale=scale)
    walk = rv.walkthrough(mapper, poses[0], n_frames=n_walk, scale=scale)
    viewer = InteractiveViewer(mapper, scale=scale)
    viewer._emit = lambda frame: None  # no display, and the host has no imageio to write
    shown = viewer.run_scripted("wasd")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    E = mapper.cfg.n_ensembles
    views = len(poses) + n_walk + len(shown)
    print(f"viz: {len(frames)} comparisons, {len(walk)} walkthrough frames, {len(shown)} viewer "
          f"frames of {frames[0].shape}, {walk[0].shape}, {shown[0].shape} in {wall:.2f} s; "
          f"launches: {counts}", flush=True)
    expected = dict.fromkeys(counts, 0)
    expected.update(fused_field_volrend=E * views, fused_render_weights=E * views)
    if (len(frames), len(walk), len(shown)) != (2, n_walk, 4) or counts != expected:
        fail(f"viz launch counts {counts}, expected {expected}")

    # each NeRF panel from _render_eval on the same rays, and that render on
    # the plain route within the fused field-and-render kernel's limits
    cfg = mapper.cfg
    oh, ow = int(cfg.img_h * scale), int(cfg.img_w * scale)
    st, white = mapper.state, torch.ones(3, device=mapper.device)
    rays = mapper._pose7_to_rays(poses, scale)
    out_k = mapper._render_eval(st.members, st.occ, rays.origins, rays.viewdirs, white)
    with plain_routes():
        out_p = mapper._render_eval(st.members, st.occ, rays.origins, rays.viewdirs, white)
    # panels gt | nerf per rgb, depth, semantics, 2 px apart; the simulator's
    # at full resolution, the NeRF's at the render's
    C, W = cfg.num_semantic_classes, cfg.img_w
    starts = np.cumsum([0] + [w + 2 for w in (W, ow, W, ow, W)])
    for i, f in enumerate(frames):
        rgb = out_k["rgb"][0][i].float().cpu().numpy().reshape(oh, ow, 3)
        dep = out_k["depth"][0][i].float().cpu().numpy().reshape(oh, ow)
        sem = np.argmax(out_k["sem"][0][i].float().cpu().numpy(), -1).reshape(oh, ow)
        panels = {1: (rgb * 255).astype(np.uint8), 3: rv.colorize_depth(dep),
                  5: rv.colorize_semantics(sem, C)}
        same = all(np.array_equal(f[:oh, starts[k]:starts[k] + ow], p) for k, p in panels.items())
        if f.shape != (cfg.img_h, starts[5] + ow, 3) or not same:
            fail(f"comparison {i}: a NeRF panel is not _render_eval's render of its rays")
    # the kernel route against the plain route, per output as err / scale of
    # the plain output (phase 9's measure), on VIZ_RENDER_TOL; the worst ray
    # is printed, not held
    for name, (tol_q, tol_mean) in VIZ_RENDER_TOL.items():
        got, ref = out_k[name][0].float(), out_p[name][0].float()
        ref_scale = max(float(ref.abs().max()), 1e-30)

        def reading(x):
            diff = ((x - ref).abs() / ref_scale).reshape(-1)
            return float(torch.quantile(diff, 0.999)), float(diff.mean()), float(diff.max())

        q, mean, worst = reading(got)
        corrupt = {"zeroed": reading(torch.zeros_like(got)), "negated": reading(-got)}
        print(f"  viz render [{len(poses)} x {ow * oh} rays] {name:8s} p99.9 {q:.3e} (tol "
              f"{tol_q}), mean {mean:.3e} (tol {tol_mean}), worst ray {worst:.3e}; "
              + ", ".join(f"{k} reads p99.9 {v[0]:.3e} mean {v[1]:.3e}"
                          for k, v in corrupt.items()), flush=True)
        if not (torch.isfinite(got).all() and q <= tol_q and mean <= tol_mean):
            fail(f"the viz render's {name} with kernels disagrees with the plain route")
        if not all(v[0] > tol_q and v[1] > tol_mean for v in corrupt.values()):
            fail(f"the limits on the viz render's {name} would pass a zeroed or negated output")


# The ngp+occ member step on the card against the same step with the weights
# kernel's plain version in place (forward and backward): the loss (relative),
# each tensor's update and gradient (err / max-abs; the gradient recovered
# from Adam's first moment), and the occupancy grid, whose update comes
# before the render and runs no kernel, exactly. The hash table's gradient
# is an index_add_ with float atomics, so two runs of the same step differ
# already, and the state the step starts from was trained through the same
# atomics. Four readings on an H100 (PERF.md): loss 8.9e-8, 0, 8.9e-8, 0
# (one f32 ulp near 1.3 is 9e-8 relative), update 1.4e-5-4.1e-5 (the
# largest in mlp_sem.w0, where an element with a small second moment
# magnifies a small change of its gradient), gradient 4.6e-6-1.3e-5 (the
# table's); the limits are 5.6x the largest loss reading (room for a few
# ulp), 3.7x the largest update's and 3.8x the largest gradient's. Zeroed
# or negated weights move all three by orders of magnitude more.
NGP_STEP_TOL = (5e-7, 1.5e-4, 5e-5)
NGP_SHAPES = ((2048, 128, True), (4096, 256, False), (2048, 512, False))


def _ngp_config():
    """``PipelineConfig()``'s ngp+occ field at the bench's scene and batch:
    a 16-level hash grid of 2^19 x 4 features, a 2 x 128 base MLP, 29
    classes, 2 members x 2048 rays x 128 samples, 2048 candidates."""
    from apnerf_tpu_torch import bench

    return dataclasses.replace(bench.bench_config(), field_type="ngp", sampler_type="occ")


def _march_inputs(dev, gen, R, S, cfg, batch):
    """Intervals of a real occupancy march at [R, S] (rays of a train
    batch, a grid 40 % occupied) and σ uniform in [0, 2) on valid samples,
    0 on padded ones."""
    from apnerf_tpu_torch.ops.grid_march import march_rays
    from apnerf_tpu_torch.train.step import make_lattice

    lattice = make_lattice(cfg, dev)
    binaries = torch.rand(cfg.main_grid_resolution, generator=gen, device=dev) < 0.4
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=dev)
    reps = -(-R // batch.origins.shape[0])
    o = batch.origins.repeat(reps, 1)[:R]
    d = batch.viewdirs.repeat(reps, 1)[:R]
    segs = march_rays(o, d, binaries, aabb, lattice, S)
    sig = torch.rand((R, S), generator=gen, device=dev) * 2.0 * segs.valid
    return segs.t_starts, segs.t_ends, sig, segs.valid


def phase_ngp_step(dev, bench_run):
    """Phase 19: the weights kernel at the ngp+occ path's shapes, then the
    ngp+occ member step at full width on the bench's scan: two chunks of
    100 steps (the second timed, its launches exact), one member step on
    the kernels against one on the plain versions, one traced."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apnerf_tpu_torch.ops.occupancy import _draw
    from apnerf_tpu_torch.train.phase import make_ngp_train_phase, pools_from_dataset
    from apnerf_tpu_torch.train.step import (
        AdamState,
        init_ensemble,
        make_lattice,
        make_member_core,
    )

    cfg = _ngp_config()
    ds = bench_run[1].dataset
    gen = _generator(dev, 19)
    batch, _ = _step_inputs(dev, ds, 119)
    for R, S, with_bwd in NGP_SHAPES:
        t0_, t1_, sig, valid = _march_inputs(dev, gen, R, S, cfg, batch)
        label = f"ngp path ({float(valid.float().mean()):.3f} of samples valid, sigma 0 on the rest)"
        k2_fwd_case(dev, label, t0_, t1_, sig)
        if with_bwd:
            # the march's intervals carry no gradient: dsigma alone
            g = torch.randn((R, S), generator=gen, device=dev) * valid
            k2_bwd_case(dev, label, t0_, t1_, sig, g, with_dt=False)

    # two chunks of 100 steps of the ensemble on the bench's scan
    state = init_ensemble(cfg, _generator(dev, 20), dev)
    lattice = make_lattice(cfg, dev)
    phase_fn = make_ngp_train_phase(cfg, lattice)
    pools, counts = pools_from_dataset(ds)
    counters = all_counters()
    losses = []
    for timed in (False, True):
        reset_counts(counters)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        state, chunk = phase_fn(state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K,
                                pools, counts, ds.size, 100, False, gen,
                                occ_thre=cfg.occ_thre_for_phase(-1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_c
        losses.append(chunk)
    launches = read_counts(counters)
    E = cfg.n_ensembles
    loss = torch.cat(losses).mean(dim=1).cpu().numpy()
    print(f"ngp path: member steps on the bench's scan: {wall / 100 * 1e3:.3f} ms per ensemble "
          f"step ({wall / 100 / E * 1e3:.3f} ms per member step) over the timed chunk of 100; "
          f"chunk-mean losses {loss[:100].mean():.4f}, {loss[100:].mean():.4f}; occupancy "
          f"{[round(float(o.binaries.float().mean()), 4) for o in state.occ]}; launches "
          f"{launches}", flush=True)
    if not np.isfinite(loss).all():
        fail("the ngp+occ member steps gave a non-finite loss")
    expected = dict.fromkeys(launches, 0)
    expected.update(fused_render_weights=E * 100, fused_render_weights_bwd=E * 100)
    if launches != expected:
        fail(f"ngp+occ train launch counts {launches}, expected {expected}")

    # one member step on the kernels against the same step on the plain versions
    step = -(-state.step // cfg.occ_every_n) * cfg.occ_every_n  # a step that updates the grid
    core = make_member_core(cfg, lattice)
    old, opt0, occ0 = state.members[0], state.opt[0], state.occ[0]
    n_cells = occ0.occs.numel()
    draws = _draw(n_cells, n_cells if step < cfg.occ_warmup_steps else 2 * (n_cells // 4),
                  _generator(dev, 21), dev)
    b1 = 0.9
    sizes = [p.numel() for p in old.parameters()]

    def one_step():
        member = copy.deepcopy(old)
        out = core(member, AdamState(*(t.clone() for t in opt0)), batch, step, occ=occ0,
                   occ_thre=cfg.occ_thre_for_phase(-1), occ_draws=draws)
        if bool(out.skipped):
            fail("the ngp+occ member step met a non-finite gradient")
        return member, out

    reset_counts(counters)
    kern = one_step()
    torch.cuda.synchronize()
    step_launches = read_counts(counters)
    with plain_routes():
        plain = one_step()
    loss_rel = abs(float(kern[1].loss) - float(plain[1].loss)) / abs(float(plain[1].loss))
    gk = torch.split((kern[1].opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
    gp = torch.split((plain[1].opt.mu - b1 * opt0.mu) / (1 - b1), sizes)
    rows = []
    for i, ((name, p0), a, b) in enumerate(zip(old.named_parameters(), kern[0].parameters(),
                                               plain[0].parameters())):
        rows.append((name, _errs(a.detach() - p0.detach(), b.detach() - p0.detach())[1],
                     _errs(gk[i], gp[i])[1]))
    occ_err = float((kern[1].occ.occs - plain[1].occ.occs).abs().max())
    occ_same = torch.equal(kern[1].occ.binaries, plain[1].occ.binaries)
    worst_u, worst_g = max(r[1] for r in rows), max(r[2] for r in rows)
    print(f"ngp path: member step at step {step} (the grid updated), kernels vs plain versions: "
          f"loss {float(kern[1].loss):.6f} vs {float(plain[1].loss):.6f} (rel {loss_rel:.3e}, tol "
          f"{NGP_STEP_TOL[0]}); update worst err/scale {worst_u:.3e} (tol {NGP_STEP_TOL[1]}), "
          f"gradient {worst_g:.3e} (tol {NGP_STEP_TOL[2]}); occupancy EMA max-abs {occ_err:.3e}, "
          f"binaries equal {occ_same}; samples {int(kern[1].n_samples)}; launches {step_launches}",
          flush=True)
    for name, ru, rg in rows:
        print(f"    {name:16s} update {ru:.3e} gradient {rg:.3e}")
    expected = dict.fromkeys(step_launches, 0)
    expected.update(fused_render_weights=1, fused_render_weights_bwd=1)
    if step_launches != expected:
        fail(f"an ngp+occ member step launched {step_launches}, expected {expected}")
    if not (loss_rel <= NGP_STEP_TOL[0] and worst_u <= NGP_STEP_TOL[1]
            and worst_g <= NGP_STEP_TOL[2] and occ_err == 0.0 and occ_same):
        fail("the ngp+occ member step with the kernels disagrees with the plain versions")

    # one member step traced
    member = copy.deepcopy(old)
    opt = AdamState(*(t.clone() for t in opt0))
    core(member, opt, batch, state.step, occ=occ0, occ_thre=1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        float(core(member, opt, batch, state.step, occ=occ0, occ_thre=1e-3).loss)
        t_p = time.perf_counter() - t_p
    busy = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    ) / 1e6
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    print(f"profiled ngp+occ member step (no grid update): wall {t_p * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / t_p:.1%}", flush=True)
    return state


def _render_calls(rays: int, samples: int) -> int:
    """Render calls (and weights-kernel launches) of one ngp view render."""
    from apnerf_tpu_torch.active.mapper import RENDER_ROWS

    return -(-rays // max(RENDER_ROWS // samples, 1))


def phase_ngp_loop(dev):
    """Phase 20: the ngp+occ loop through its CLI at
    ``config_fakeprod.yaml``'s width with the pair set, one planning step
    → the launches of the weights kernel over it."""
    import yaml

    from apnerf_tpu_torch.active import pipeline
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.ops.cuda import build

    with open(build.REPO_ROOT / "configs" / "config_fakeprod.yaml") as f:
        raw = yaml.safe_load(f)
    # one planning step, where phase 10 runs two: the whole smoke stays inside
    # half its time limit (PERF.md)
    raw.update(field_type="ngp", sampler_type="occ", planning_step=1, training_steps=100,
               num_traj=NGP_LOOP_TRAJ, test_loc=LOOP_TEST_LOC,
               save_path=str(build.BUILD_DIR / "chip_smoke_ngp_loop"))
    cfg_path = build.BUILD_DIR / "chip_smoke_ngp_loop.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
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
    print(f"ngp loop: {cfg_path.name} = config_fakeprod.yaml with field_type ngp, sampler_type "
          f"occ, planning_step 1 of {NGP_LOOP_TRAJ} candidates, training_steps 100 and 2 test "
          f"locations; {wall:.1f} s of wall; "
          f"host wall by method (calls, seconds): "
          + ", ".join(f"{k} ({c}, {s:.2f})" for k, (c, s) in walls.items()), flush=True)
    print(f"  throughput log: {json.dumps(mapper.throughput_log)}")
    print(f"  launches: {counts}")
    for row, ext in zip(mapper.errors_hist, mapper.metrics_ext_hist):
        print(f"  evaluation at planning step {row[0]:.0f}: PSNR {row[1]:.4f} dB, depth MSE "
              f"{row[2]:.6f}, semantic CE {row[3]:.6f}, mIoU {ext[2]:.6f}")
    chunk_means = [float(np.mean(phase[i:i + 100])) for phase in mapper.loss_hist
                   for i in range(0, len(phase), 100)]
    print(f"  chunk-mean losses: {' '.join(f'{m:.4f}' for m in chunk_means)}; refit "
          f"rollbacks {mapper.refit_rollbacks}; occupancy "
          f"{[round(float(o.binaries.float().mean()), 4) for o in mapper.occ]}", flush=True)
    n = mapper.ngp_cfg
    if (cfg.num_semantic_classes, cfg.num_traj, cfg.img_w, cfg.num_rays, n.neurons,
            n.log2_hashmap_size, n.n_levels) != (29, NGP_LOOP_TRAJ, 640, 2048, 128, 19, 16):
        fail("the ngp loop did not run at the full width")
    if not np.isfinite(chunk_means).all() or not chunk_means[-1] < chunk_means[0]:
        fail(f"the ngp loop's losses are not finite or did not fall: {chunk_means}")
    rows = np.asarray(mapper.errors_hist)
    if rows.shape != (3, 4) or not np.isfinite(rows).all():
        fail(f"expected 3 finite evaluation rows from the ngp loop, got {rows}")
    E = cfg.n_ensembles
    steps = sum(len(phase) for phase in mapper.loss_hist)
    ran = steps + mapper.refit_discarded_steps
    scored = sum(len(c) for c in mapper.trajector_uncertainty_list)
    unc_rays = int(cfg.img_h * mapper.unc_scale) * int(cfg.img_w * mapper.unc_scale)
    oh, ow = mapper._eval_size(mapper.eval_scale)
    renders = scored * N_VIEWS * E * _render_calls(unc_rays, mapper.max_samples_unc)
    eval_renders = (len(mapper.errors_hist) * len(mapper._test_poses) * E
                    * _render_calls(oh * ow, cfg.max_samples_test))
    expected = dict.fromkeys(counts, 0)
    expected.update(fused_render_weights=E * ran + renders + eval_renders,
                    fused_render_weights_bwd=E * ran)
    if scored == 0 or counts != expected:
        fail(f"ngp loop launch counts {counts}, expected {expected} ({scored} candidates scored)")
    return counts


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


# ---- 21. the example trainers ------------------------------------------------------------

# held-out PSNR of the NGP + occupancy trainer over the background alone, at least (dB;
# written into PERF.md before the first reading and not tuned after it)
TRAINER_PSNR_MARGIN = 5.0
# a trainer step on the kernels against the same step with K2's plain version, per trainer:
# (loss relative, worst update err / scale, worst gradient err / scale, the gradient read from
# Adam's first moment); the occupancy grid must match exactly. Each limit is shown to be passed
# by neither a zeroed nor a negated K2 (they read 0.39-656 on the loss, 0.80-340 on the update,
# 1-400 on the gradient on an H100, PERF.md). The NGP fields' tables take their gradient by float
# atomics, so two steps differ by their order as well as by K2's rounding: ngp+occ keeps phase
# 19's limits (`NGP_STEP_TOL`; read 0-1.8e-7 / 9.5e-6-5.0e-5 / 5.9e-7-8.2e-7 over four calls).
# The proposal trainer is compared at its final samples only (its level keeps the kernel on both
# sides: a last-digit difference in the level's weights moves a sample across an inverse-CDF bin
# edge, which read up to 1.6e-2 on a table's gradient); there it read 0-2.0e-7 / 3.3e-5-2.4e-4 /
# 1.5e-6-8.5e-6 over ten steps of two calls, limits 3x. The MLP fields take no atomics: about
# 2-3x their readings (MLP 0 / 3.2e-5-4.4e-5 / 3.2e-7-1.3e-6, T-NeRF 0 / 4.0e-5 / 1.2e-6).
TRAINER_STEP_TOL = {
    "ngp+occ": NGP_STEP_TOL,
    "ngp+prop": (6e-7, 7.5e-4, 2.5e-5),
    "mlp": (1e-6, 1.5e-4, 5e-6),
    "tnerf": (1e-6, 1.5e-4, 5e-6),
}
NGP_OCC_STEPS = 1100  # a warm-up chunk and 1000 steps, the last 100 timed
TRAINER_CHUNKS = (50, 50)  # the other three trainers: a warm-up and a timed chunk
# T-NeRF's relu density dies in some runs (JAX's trainer the same on the same weights and draws,
# tests/test_torch_examples.py): counted over these init / draw seeds, each this many steps
TNERF_DEATH_SEEDS, TNERF_DEATH_STEPS = range(16), 48
YARDSTICK_SAMPLES_PER_S = 1.95e7  # nerfacc's Instant-NGP example on a TITAN RTX (BASELINE.md)
SYNTH_SIZE, SYNTH_ANGLE_X, SYNTH_RADIUS = 400, 0.6911, 4.0
SYNTH_AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
# the analytic scene: (centre, radius, rgb) spheres and (low corner, high corner, rgb) boxes
SYNTH_SPHERES = (((0.5, 0.3, 0.0), 0.5, (0.9, 0.2, 0.15)),
                 ((-0.6, -0.2, 0.4), 0.45, (0.2, 0.8, 0.25)),
                 ((-0.2, 0.8, -0.6), 0.3, (0.85, 0.3, 0.85)))
SYNTH_BOXES = (((-0.4, -1.0, -0.9), (0.4, -0.3, -0.1), (0.2, 0.35, 0.9)),
               ((0.3, -1.0, 0.4), (1.0, -0.5, 1.1), (0.95, 0.85, 0.2)))


def _look_at(pos):
    """OpenGL camera-to-world [4, 4] at ``pos`` looking at the origin."""
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0]) if abs(fwd[1]) < 0.99 else np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def _sphere_cameras(n, offset):
    """n camera-to-world poses on the sphere of radius ``SYNTH_RADIUS``
    (a Fibonacci lattice turned by ``offset``) looking at the origin."""
    i = np.arange(n) + 0.5
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(1.0 - y * y)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i + offset
    pos = SYNTH_RADIUS * np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    return np.stack([_look_at(p) for p in pos]).astype(np.float32)


def _render_analytic(c2w, focal, size):
    """One RGBA view [size, size, 4] uint8 of the analytic scene: the
    nearest hit of the spheres and boxes, Lambert-shaded, alpha 0 where the
    ray hits nothing (NeRF-Synthetic's transparent background)."""
    y, x = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64),
                       indexing="ij")
    d_cam = np.stack([(x - size / 2 + 0.5) / focal, -(y - size / 2 + 0.5) / focal,
                      -np.ones_like(x)], axis=-1).reshape(-1, 3)
    d = d_cam @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    best = np.full(d.shape[0], np.inf)
    normal, color = np.zeros_like(d), np.zeros_like(d)
    for c, rad, rgb in SYNTH_SPHERES:
        oc = o - np.asarray(c)
        b = np.sum(d * oc, axis=-1)
        disc = b * b - (np.sum(oc * oc, axis=-1) - rad * rad)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 0) & (t < best)
        best = np.where(hit, t, best)
        p = o + t[:, None] * d
        normal[hit] = (p[hit] - np.asarray(c)) / rad
        color[hit] = rgb
    for lo, hi, rgb in SYNTH_BOXES:
        lo, hi = np.asarray(lo), np.asarray(hi)
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (lo - o) / d, (hi - o) / d
        t_near = np.minimum(t0, t1).max(axis=-1)
        t_far = np.maximum(t0, t1).min(axis=-1)
        hit = (t_far > np.maximum(t_near, 0.0)) & (t_near > 0) & (t_near < best)
        best = np.where(hit, t_near, best)
        p = o + t_near[:, None] * d
        q = (p - (lo + hi) / 2) / ((hi - lo) / 2)
        axis = np.abs(q).argmax(axis=-1)
        n = np.zeros_like(q)
        n[np.arange(len(q)), axis] = np.sign(q[np.arange(len(q)), axis])
        normal[hit] = n[hit]
        color[hit] = rgb
    light = np.array([0.4, 0.8, 0.45]) / np.linalg.norm([0.4, 0.8, 0.45])
    shade = 0.35 + 0.65 * np.clip(normal @ light, 0.0, 1.0)
    hit = np.isfinite(best)
    rgba = np.zeros((d.shape[0], 4))
    rgba[hit, :3] = color[hit] * shade[hit, None]
    rgba[hit, 3] = 1.0
    return (rgba.reshape(size, size, 4) * 255 + 0.5).astype(np.uint8)


def synthetic_subject(n_views, offset):
    """``SubjectData`` of the analytic scene at NeRF-Synthetic's field of view."""
    from apnerf_tpu_torch.data.nerf_synthetic import SubjectData

    focal = 0.5 * SYNTH_SIZE / np.tan(0.5 * SYNTH_ANGLE_X)
    c2ws = _sphere_cameras(n_views, offset)
    images = np.stack([_render_analytic(c, focal, SYNTH_SIZE) for c in c2ws])
    return SubjectData(images=images, camtoworlds=c2ws, focal=focal, width=SYNTH_SIZE,
                       height=SYNTH_SIZE)


K2_SITES = ("train.examples", "render.renderer", "models.propnet")


@contextlib.contextmanager
def k2_sites_replaced(fn, sites=K2_SITES):
    """K2's wrapper replaced by ``fn`` where the trainers look it up (the
    modules ``sites``)."""
    import importlib

    mods = [importlib.import_module(f"apnerf_tpu_torch.{m}") for m in sites]
    saved = [m.fused_render_weights for m in mods]
    for m in mods:
        m.fused_render_weights = fn
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.fused_render_weights = f


def _trainer_batch(gen, views, R):
    """(origins, viewdirs, pixels, bkgd, view indices) from ``views``
    (images, c2ws, K on the device)."""
    from apnerf_tpu_torch.train_ngp_occ import sample_batch

    return sample_batch(gen, *views, R)


def _views(data, dev):
    from apnerf_tpu_torch.data.nerf_synthetic import intrinsics

    return (torch.as_tensor(data.images, device=dev),
            torch.as_tensor(data.camtoworlds, dtype=torch.float32, device=dev),
            torch.as_tensor(intrinsics(data), device=dev))


def _run_chunks(name, step, state, chunks, counters, probe):
    """``chunks`` chunks of steps (``step(state, i) -> (state, loss,
    n_samples)``); the launches are read over the last. The loss must be
    finite and ``probe(state)``, the loss of one fixed batch, lower after
    the steps than before them (a training batch's loss swings with its
    random background) → (state, losses [steps], samples [steps], seconds
    of the last chunk, its launches, the probe before and after)."""
    losses, samples = [], []
    before = probe(state)
    i = 0
    for n in chunks:
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss, ns = step(state, i)
            losses.append(loss)
            samples.append(ns)
            i += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    losses = torch.stack(losses).cpu().numpy()
    samples = torch.stack(samples).cpu().numpy()
    after = probe(state)
    if not np.isfinite(losses).all():
        fail(f"the {name} trainer's loss is not finite")
    if not after < before:
        fail(f"the {name} trainer's loss on a fixed batch did not fall: {before} -> {after}")
    return state, losses, samples, wall, launches, (before, after)


def _fixed_probe(dev, step_fn, args):
    """The loss of ``step_fn`` on the fixed batch ``args`` at a state's
    parameters (one step on a copy, with draws of its own)."""
    def probe(state):
        return float(step_fn(_copy_state(state), *args, generator=_generator(dev, 2199))[1])
    return probe


def _occ_step_draws(state, gen, dev):
    """The occupancy update's draws at ``state.step``: every cell in the
    warm-up (256 steps), half of them after."""
    from apnerf_tpu_torch.ops.occupancy import _draw

    n = state.occ.occs.numel()
    return _draw(n, n if state.step < 256 else 2 * (n // 4), gen, dev)


def _copy_state(state):
    import copy

    from apnerf_tpu_torch.train.step import AdamState

    return state._replace(params=copy.deepcopy(state.params),
                          opt=AdamState(*(t.clone() for t in state.opt)))


@contextlib.contextmanager
def prop_loss_weights(w):
    """``train.examples.prop_loss`` reading the final weights ``w`` in place
    of those its caller gives (``None``: as it is)."""
    from apnerf_tpu_torch.train import examples

    saved = examples.prop_loss
    if w is not None:
        examples.prop_loss = lambda levels, t0, t1, _w: saved(levels, t0, t1, w)
    try:
        yield
    finally:
        examples.prop_loss = saved


def _k2_witness(t0, t1, sig):
    """K2's plain version in float64, cast back to f32 (autograd flows
    through the casts): the f32 plain version's exclusive sum, cumsum - x,
    loses about ulp(cumsum) at large optical depth, and its backward with it."""
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

    return fused_render_weights_plain(t0.double(), t1.double(), sig.double()).float()


class _K2Float64Backward(torch.autograd.Function):
    """K2's plain version in f32 forward, its backward autograd through the
    plain version in float64: the forward the f32 plain step has, the
    gradients K2's float64 witness gives (``_check_k2_at`` holds K2's
    backward to it)."""

    @staticmethod
    def forward(ctx, t0, t1, sig):
        from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

        ctx.save_for_backward(t0, t1, sig)
        return fused_render_weights_plain(t0, t1, sig)

    @staticmethod
    def backward(ctx, g):
        from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

        xs = [t.detach().double().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            w = fused_render_weights_plain(*xs)
            grads = torch.autograd.grad(w, xs, g.double())
        return tuple(gr.float() if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))


def _k2_f64_backward(t0, t1, sig):
    return _K2Float64Backward.apply(t0, t1, sig)


# the plain steps the trainer step is read against: K2's plain version in f32
# (with its prop_loss on the kernel step's final weights: "shared"), in float64,
# or in f32 with its backward in float64
K2_REFERENCES = ("f32", "shared", "float64", "f64 backward")


def _trainer_step_readings(name, step_fn, state, args, kwargs, counters, sites=K2_SITES,
                           reference="f32", plain_f32=False, spread=False):
    """One step from ``state`` on the kernels against the same step with
    K2's plain version at the call sites ``sites`` (``reference``, one of
    ``K2_REFERENCES``: in f32; in f32 with its ``prop_loss`` reading the
    final weights the kernel step formed; in float64, ``_k2_witness``; in
    f32 with its backward in float64), and with K2 zeroed and negated there
    → {"kernel", "zeroed", "negated" and, with ``plain_f32``, the f32 plain
    step's: (loss rel, worst update err / scale, worst gradient err / scale,
    occupancy equal, update's leaf, gradient's leaf, [(gradient err / scale,
    leaf) of every leaf]), "launches", "seen": the inputs K2 was given in
    the kernel step, "outs": its outputs} and, with ``spread``, "spread":
    {leaf: the plain step's own gradient err / scale against the same step
    with K2's float64 witness (``_k2_witness``)}."""
    from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
        fused_render_weights,
        fused_render_weights_plain,
    )

    b1 = 0.9
    sizes = [p.numel() for p in state.params.parameters()]
    seen, outs = [], []

    def recording(t0, t1, sig):
        seen.append((t0.detach().clone(), t1.detach().clone(), sig.detach().clone(),
                     t0.requires_grad))
        w = fused_render_weights(t0, t1, sig)
        outs.append(w.detach().clone())
        return w

    def one(fn, at=sites, final_w=None):
        with k2_sites_replaced(fn, at), prop_loss_weights(final_w):
            return step_fn(_copy_state(state), *args, **kwargs)[:2]

    reset_counts(counters)
    kern = one(recording, K2_SITES)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    final_w = next(w for w, s in zip(outs, seen) if s[3]) if reference == "shared" else None
    plain = one({"float64": _k2_witness, "f64 backward": _k2_f64_backward}.get(
        reference, fused_render_weights_plain), final_w=final_w)

    def readings(other):
        (sa, la), (sb, lb) = other, plain
        loss_rel = abs(float(la) - float(lb)) / abs(float(lb))
        ga = torch.split((sa.opt.mu - b1 * state.opt.mu) / (1 - b1), sizes)
        gb = torch.split((sb.opt.mu - b1 * state.opt.mu) / (1 - b1), sizes)
        upd, grd = [], []
        for i, ((pname, p0), pa, pb) in enumerate(zip(
                state.params.named_parameters(), sa.params.parameters(),
                sb.params.parameters())):
            upd.append((_errs(pa.detach() - p0.detach(), pb.detach() - p0.detach())[1], pname))
            grd.append((_errs(ga[i], gb[i])[1], pname))
        occ_same = sa.occ is None or (torch.equal(sa.occ.occs, sb.occ.occs)
                                      and torch.equal(sa.occ.binaries, sb.occ.binaries))
        return loss_rel, max(upd)[0], max(grd)[0], occ_same, max(upd)[1], max(grd)[1], grd

    res = {"kernel": readings(kern),
           "zeroed": readings(one(lambda a, b, s: fused_render_weights_plain(a, b, s) * 0.0)),
           "negated": readings(one(lambda a, b, s: -fused_render_weights(a, b, s))),
           "launches": launches, "seen": seen, "outs": outs}
    if plain_f32:
        res["plain_f32"] = readings(one(fused_render_weights_plain))
    if spread:
        res["spread"] = {n: e for e, n in readings(one(_k2_witness))[6]}
    return res


def _step_passes(name, x, spread=None):
    """Whether readings ``x`` pass ``TRAINER_STEP_TOL[name]``; with
    ``spread`` ({leaf: the plain step's own gradient err / scale against its
    float64 witness}), each leaf's gradient limit is the limit plus that
    leaf's spread: the reference is no closer than that to exact K2."""
    tol = TRAINER_STEP_TOL[name]
    grad_ok = (x[2] <= tol[2] if spread is None
               else all(e <= tol[2] + spread[n] for e, n in x[6]))
    return x[0] <= tol[0] and x[1] <= tol[1] and grad_ok and x[3]


def _compare_trainer_step(name, step_fn, state, args, kwargs, counters, fwd, bwd,
                          sites=K2_SITES, spread=False):
    """``_trainer_step_readings`` at ``TRAINER_STEP_TOL[name]``: the kernel
    step must pass, K2 zeroed and negated must not, and the kernel step
    must launch K2 ``fwd`` and ``bwd`` times → the inputs K2 was given in
    the kernel step."""
    res = _trainer_step_readings(name, step_fn, state, args, kwargs, counters, sites,
                                 spread=spread)
    r, zeroed, negated, launches = res["kernel"], res["zeroed"], res["negated"], res["launches"]
    tol = TRAINER_STEP_TOL[name]
    sp = res.get("spread")
    ref = (f" (gradient limit plus the plain step's own spread against K2's float64 witness, "
           f"at most {max(sp.values()):.3e})" if sp else "")
    print(f"  {name}: one step at step {state.step}, kernels vs K2's plain version{ref}: "
          f"loss rel {r[0]:.3e} (tol {tol[0]}), update worst err/scale {r[1]:.3e} ({r[4]}; tol "
          f"{tol[1]}), gradient {r[2]:.3e} ({r[5]}; tol {tol[2]}), occupancy grid equal "
          f"{r[3]}; K2 zeroed reads "
          f"{zeroed[0]:.3e} / {zeroed[1]:.3e} / {zeroed[2]:.3e}, negated {negated[0]:.3e} / "
          f"{negated[1]:.3e} / {negated[2]:.3e}; launches {launches}", flush=True)
    expected = dict.fromkeys(launches, 0)
    expected.update(fused_render_weights=fwd, fused_render_weights_bwd=bwd)
    if launches != expected:
        fail(f"a {name} trainer step launched {launches}, expected {expected}")
    if _step_passes(name, zeroed, sp) or _step_passes(name, negated, sp):
        fail(f"the {name} step limits would pass a zeroed or negated K2")
    if not _step_passes(name, r, sp):
        fail(f"the {name} trainer step with the kernels disagrees with K2's plain version")
    return res["seen"]


PROP_TRAINER_RAYS = 4096


def _prop_trainer(dev, views):
    """Phase 21's ngp+prop trainer at its sizes → (state, step_fn, one step
    on a fresh batch ``prop_step(state, i)``, its generator, R)."""
    from apnerf_tpu_torch.train import examples

    R = PROP_TRAINER_RAYS
    gen = _generator(dev, 2101)  # each trainer its own draws
    state, step_fn = examples.make_ngp_prop_trainer(SYNTH_AABB, ngp_kwargs=dict(unbounded=True),
                                                    device=dev)

    def prop_step(s, i):
        o, d, px, bk, _ = _trainer_batch(gen, views, R)
        return step_fn(s, o, d, px, bk, generator=gen)

    return state, step_fn, prop_step, gen, R


PROBE_PROP_STATES, PROBE_PROP_STRIDE = 80, 3


def probe_prop_states(dev, n_states=PROBE_PROP_STATES, stride=PROBE_PROP_STRIDE):
    """The ngp+prop check of phase 21 over many trained states
    (``--prop-states N``): the trainer trained as there (``TRAINER_CHUNKS``),
    then its one-step comparison at ``n_states`` states ``stride`` steps
    apart, the kernel step read against each plain step of
    ``K2_REFERENCES`` (K2's plain version in f32; the same with its
    ``prop_loss`` on the kernel step's final weights; in float64; in f32
    with its backward in float64) at the fixed limits, and against the f32
    one with each gradient limit plus that leaf's spread, the f32 plain
    step against the float64 witness step (phase 21's check). Where the f32
    reading is over the limit, its leaves over it, their readings the other
    ways and their spread, and the final weights under 1e-7 (where
    ``prop_loss`` weighs by 1 / (w + 1e-7)). Fails if phase 21's check fails
    in any state or passes a zeroed or negated K2 → 0."""
    t0_ = time.perf_counter()
    counters = all_counters()
    views = _views(synthetic_subject(100, 0.0), dev)
    state, step_fn, prop_step, gen, R = _prop_trainer(dev, views)
    for i in range(sum(TRAINER_CHUNKS)):
        state = prop_step(state, i)[0]
    tol = TRAINER_STEP_TOL["ngp+prop"]
    fails = dict.fromkeys(K2_REFERENCES + ("f32 + spread",), 0)
    worst = dict.fromkeys(K2_REFERENCES + ("spread",), 0.0)
    for k in range(n_states):
        o, d, px, bk, _ = _trainer_batch(gen, views, R)
        noise = torch.rand((R, 49), generator=gen, device=dev)
        args, kwargs = (o, d, px, bk), dict(noises=[noise])
        runs = {way: _trainer_step_readings("ngp+prop", step_fn, state, args, kwargs, counters,
                                            ("train.examples",), way, spread=way == "f32")
                for way in K2_REFERENCES}
        sp = runs["f32"]["spread"]
        line = []
        for way, res in runs.items():
            r = res["kernel"]
            bad = not _step_passes("ngp+prop", r)
            fails[way] += bad
            worst[way] = max(worst[way], r[2])
            line.append(f"{way}: gradient {r[2]:.3e} ({r[5]}){' FAILS' if bad else ''}")
        f32 = runs["f32"]
        bad = not _step_passes("ngp+prop", f32["kernel"], sp)
        fails["f32 + spread"] += bad
        worst["spread"] = max(worst["spread"], max(sp.values()))
        top = max((e, n) for n, e in sp.items())
        print(f"prop state {k} (step {state.step}): kernel step against the plain step with K2 "
              + "; ".join(line) + f"; the f32 plain step's spread against its float64 witness "
              f"at most {top[0]:.3e} ({top[1]}), the check with it"
              f"{' FAILS' if bad else ' passes'}; K2 zeroed {f32['zeroed'][2]:.3e}, negated "
              f"{f32['negated'][2]:.3e}", flush=True)
        if _step_passes("ngp+prop", f32["zeroed"], sp) or \
                _step_passes("ngp+prop", f32["negated"], sp):
            fail("the ngp+prop step limits would pass a zeroed or negated K2")
        if not _step_passes("ngp+prop", f32["kernel"]):
            by_leaf = {way: dict((n, e) for e, n in runs[way]["kernel"][6]) for way in runs}
            over = sorted(((e, n) for e, n in f32["kernel"][6] if e > tol[2]), reverse=True)
            t0, t1, sig, _ = next(x for x in f32["seen"] if x[3])
            wk = next(w for w, x in zip(f32["outs"], f32["seen"]) if x[3])
            from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights_plain

            wp = fused_render_weights_plain(t0, t1, sig)
            tiny = wk < 1e-7
            depth = float((sig * (t1 - t0)).sum(dim=1).max())
            print(f"  over the limit {tol[2]}: "
                  + "; ".join(f"{n} " + ", ".join(f"{way} {by_leaf[way][n]:.3e}"
                                                  for way in by_leaf)
                              + f", spread {sp[n]:.3e}" for _, n in over)
                  + f"; final samples with w < 1e-7: {float(tiny.float().mean()):.4f}, "
                  f"|w_kernel - w_plain| there max {float((wk - wp).abs()[tiny].max()):.3e} "
                  f"(everywhere {float((wk - wp).abs().max()):.3e}); largest optical depth "
                  f"{depth:.4g}", flush=True)
        for i in range(stride):
            state = prop_step(state, i)[0]
    print(f"prop states: {n_states} states {stride} steps apart from step "
          f"{sum(TRAINER_CHUNKS)}: over the limits "
          + ", ".join(f"{way} {n}" for way, n in fails.items()) + "; worst gradient readings "
          + ", ".join(f"{way} {v:.3e}" for way, v in worst.items())
          + f"; {time.perf_counter() - t0_:.1f} s", flush=True)
    if fails["f32 + spread"]:
        fail(f"the ngp+prop check failed in {fails['f32 + spread']} of {n_states} states")
    return 0


def _check_k2_at(dev, label, inputs, gen, timed):
    """K2 forward and backward on inputs a trainer gave it, against the
    float64 witness at ``K2_TOL`` and ``K2_BWD_TOL`` → the timed records
    (forward, backward) or None. The largest optical depth tau = sum(sigma
    dt) of a ray is printed: the proposal trainer's final samples
    (unbounded, 'lindisp' from 0.2 to 1e3) reach tau ~370-680, the march
    34-60. Device times are "not measured" where the profiler drops most
    launches of a window (``kernel_device_ms``)."""
    t0, t1, sig, with_dt = inputs
    depth = float((sig * (t1 - t0)).sum(dim=1).max())
    print(f"  K2 inputs of the {label}: {tuple(sig.shape)}, intervals [{float(t0.min()):.3g}, "
          f"{float(t1.max()):.3g}], largest optical depth {depth:.4g}", flush=True)
    fwd = k2_fwd_case(dev, label, t0, t1, sig, timed=timed)
    g = torch.randn(sig.shape, generator=gen, device=dev) * (sig > 0)
    bwd = k2_bwd_case(dev, label, t0, t1, sig, g, with_dt=with_dt, timed=timed)
    return fwd, bwd


def _tnerf_dead(params, res, dev):
    """Whether a T-NeRF's density is 0 at every centre of a ``res``^3 grid
    over the aabb at t = 0, 0.5 and 1: its relu density then takes no
    gradient from any sample again."""
    from apnerf_tpu_torch.models import mlp as mlpmod

    lo, hi = SYNTH_AABB[0], SYNTH_AABB[3]
    g = (torch.arange(res, device=dev) + 0.5) * ((hi - lo) / res) + lo
    cells = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    with torch.no_grad():
        return all(not bool((mlpmod.tnerf_query_density(
            params, cells, torch.full((len(cells), 1), t, device=dev)) > 0).any())
            for t in (0.0, 0.5, 1.0))


def _count_tnerf_deaths(dev, views, times, R=1024):
    """T-NeRF trained ``TNERF_DEATH_STEPS`` steps at each seed of
    ``TNERF_DEATH_SEEDS`` (the field's init and the draws' generator):
    prints how many died (a measurement, not a check)."""
    from apnerf_tpu_torch.train import examples

    t0 = time.perf_counter()
    dead = []
    for seed in TNERF_DEATH_SEEDS:
        state, step_fn = examples.make_tnerf_occ_trainer(SYNTH_AABB, seed=seed, device=dev)
        gen = _generator(dev, 3000 + seed)
        for _ in range(TNERF_DEATH_STEPS):
            o, d, px, bk, ids = _trainer_batch(gen, views, R)
            state = step_fn(state, o, d, px, times[ids], bk, generator=gen)[0]
        if _tnerf_dead(state.params, state.occ.binaries.shape[0], dev):
            dead.append(seed)
    print(f"  T-NeRF deaths: {len(dead)} of {len(TNERF_DEATH_SEEDS)} init / draw seeds died within "
          f"{TNERF_DEATH_STEPS} steps (density 0 at every grid centre at t = 0, 0.5, 1): seeds "
          f"{dead}; {time.perf_counter() - t0:.1f} s", flush=True)


def _shape_record(rec, R, S, with_dt=None):
    err, ms, pms, (bnd, by), times = rec
    out = dict(shape=[R, S], max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by,
               **times)
    if with_dt is not None:
        out["with_dt"] = with_dt
    return out


def phase_trainers(dev):
    """Phase 21: the four example trainers on the analytic scene → (K2
    launches over their timed chunks, K2's records at their shapes)."""
    from apnerf_tpu_torch import train_ngp_occ
    from apnerf_tpu_torch.models import mlp as mlpmod
    from apnerf_tpu_torch.train import examples
    from apnerf_tpu_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    counters = all_counters()
    train_data = synthetic_subject(100, 0.0)
    test_data = synthetic_subject(8, 1.234)
    bg_psnr = float(np.mean([psnr(np.ones((SYNTH_SIZE, SYNTH_SIZE, 3), np.float32),
                                  train_ngp_occ.composite(im, (1.0, 1.0, 1.0)))
                             for im in test_data.images]))
    cover = float((train_data.images[..., 3] > 0).mean())
    print(f"trainers: analytic scene, {len(train_data.images)} train / {len(test_data.images)} "
          f"test views of {SYNTH_SIZE}^2 at camera_angle_x {SYNTH_ANGLE_X}, {cover:.3f} of "
          f"pixels covered; built in {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches_total = {"fused_render_weights": 0, "fused_render_weights_bwd": 0}
    records = {}
    gen_k2 = _generator(dev, 2121)

    # -- NGP + occupancy at the yardstick's sizes, through train_ngp_occ.train ----------------
    steps, R, S = NGP_OCC_STEPS, 4096, train_ngp_occ.TRAINER_KWARGS["max_samples"]
    chunk = train_ngp_occ.CHUNK
    timed = {}

    def on_chunk(done, seconds):
        if done == steps - chunk:
            reset_counts(counters)
        if done == steps:
            timed.update(read_counts(counters), seconds=seconds)

    out = train_ngp_occ.train(train_data, test_data, steps=steps, num_rays=R, aabb=SYNTH_AABB,
                              eval_every=steps, device=dev, on_chunk=on_chunk)
    losses = out["losses"].cpu().numpy()
    visible = out["n_samples"][-chunk:].sum().item()
    sec = timed.pop("seconds")
    ms = sec / chunk * 1e3
    vis_rate = visible / sec
    held = out["evals"][-1][1]
    print(f"  ngp+occ (16 x 2^19 x 4 table, 2 x 128 MLP, 128^3 grid, {R} rays x {S} samples): "
          f"{ms:.3f} ms per step over the timed chunk of {chunk} (the last); chunks (ms per "
          f"step) {' '.join(f'{c / chunk * 1e3:.2f}' for c in out['chunk_seconds'])}; "
          f"{R * chunk / sec:.4e} rays/s, {R * S * chunk / sec:.4e} ray-samples/s, "
          f"{vis_rate:.4e} visible samples/s ({visible / chunk / R:.2f} a ray) = "
          f"{vis_rate / YARDSTICK_SAMPLES_PER_S:.4f} x the TITAN RTX yardstick's 1.95e7 (a "
          f"synthetic scene, not NeRF-Synthetic); loss {losses[:chunk].mean():.5f} -> "
          f"{losses[-chunk:].mean():.5f}; held-out PSNR {held:.3f} dB "
          f"(views {' '.join(f'{p:.2f}' for p in out['evals'][-1][2])}) against "
          f"{bg_psnr:.3f} dB for the background alone (margin {TRAINER_PSNR_MARGIN} dB); "
          f"occupancy {float(out['state'].occ.binaries.float().mean()):.4f}; launches over the "
          f"timed chunk {timed}", flush=True)
    if not np.isfinite(losses).all() or not losses[-chunk:].mean() < losses[:chunk].mean():
        fail("the ngp+occ trainer's loss is not finite or did not fall")
    if not held > bg_psnr + TRAINER_PSNR_MARGIN:
        fail(f"the ngp+occ trainer's held-out PSNR {held} is not {TRAINER_PSNR_MARGIN} dB over "
             f"the background's {bg_psnr}")
    expected = dict.fromkeys(timed, 0)
    expected.update(fused_render_weights=chunk, fused_render_weights_bwd=chunk)
    if timed != expected:
        fail(f"ngp+occ trainer launch counts {timed}, expected {expected}")
    for k in launches_total:
        launches_total[k] += timed[k]

    views = _views(train_data, dev)
    gen = _generator(dev, 2100)
    state, step_fn = out["state"], out["step_fn"]
    o, d, px, bk, _ = _trainer_batch(gen, views, R)
    state = state._replace(step=-(-state.step // 16) * 16)  # a step that updates the grid
    draws = _occ_step_draws(state, gen, dev)
    seen = _compare_trainer_step("ngp+occ", step_fn, state, (o, d, px, bk),
                                 dict(occ_draws=draws), counters, 1, 1)
    f, b = _check_k2_at(dev, "ngp+occ trainer", seen[0], gen_k2, True)
    records["ngp+occ"] = (_shape_record(f, R, S), _shape_record(b, R, S, False))
    del out, state

    # -- NGP + proposal net, unbounded, 'lindisp' ----------------------------------------------
    state, step_fn, prop_step, gen, R = _prop_trainer(dev, views)
    probe = _fixed_probe(dev, step_fn, _trainer_batch(_generator(dev, 2198), views, R)[:4])
    state, losses, _, sec, timed, probed = _run_chunks("ngp+prop", prop_step, state,
                                                       TRAINER_CHUNKS, counters, probe)
    print(f"  ngp+prop (unbounded 16 x 2^19 x 4 field, 5-level 2^17 proposal field, {R} rays, "
          f"64 proposal + 48 samples, near 0.2, far 1e3, lindisp): "
          f"{sec / TRAINER_CHUNKS[-1] * 1e3:.3f} ms per step over the timed chunk of "
          f"{TRAINER_CHUNKS[-1]}; loss (first / last fifth) {losses[:20].mean():.5f} -> "
          f"{losses[-20:].mean():.5f}, on a fixed batch {probed[0]:.5f} -> {probed[1]:.5f}; "
          f"launches {timed}", flush=True)
    expected = dict.fromkeys(timed, 0)
    expected.update(fused_render_weights=2 * TRAINER_CHUNKS[-1],
                    fused_render_weights_bwd=2 * TRAINER_CHUNKS[-1])
    if timed != expected:
        fail(f"ngp+prop trainer launch counts {timed}, expected {expected}")
    for k in launches_total:
        launches_total[k] += timed[k]
    o, d, px, bk, _ = _trainer_batch(gen, views, R)
    noise = torch.rand((R, 49), generator=gen, device=dev)
    # the proposal level's weights feed the inverse CDF's bin search, so a last-digit
    # difference there moves a final sample across a bin edge at random: the level
    # keeps K2 on both sides (it is held alone below) and the final samples' K2 is compared
    seen = _compare_trainer_step("ngp+prop", step_fn, state, (o, d, px, bk),
                                 dict(noises=[noise]), counters, 2, 2, ("train.examples",),
                                 spread=True)
    level, final = seen
    if level[3] or not final[3]:
        fail("the proposal level's intervals carry a gradient or the final ones do not")
    f, b = _check_k2_at(dev, "ngp+prop trainer, proposal level", level, gen_k2, True)
    records["ngp+prop level"] = (_shape_record(f, R, 64), _shape_record(b, R, 64, False))
    f, b = _check_k2_at(dev, "ngp+prop trainer, final samples (lindisp)", final, gen_k2, True)
    records["ngp+prop final"] = (_shape_record(f, R, 48), _shape_record(b, R, 48, True))
    del state

    # -- MLP NeRF and T-NeRF ---------------------------------------------------------------------
    R, S = 1024, 128
    times = torch.as_tensor(np.linspace(0, 1, len(train_data.images), dtype=np.float32),
                            device=dev)
    for i_trainer, name in enumerate(("mlp", "tnerf")):
        # T-NeRF's draws are ones under which its density lives: it dies under some draws, as
        # JAX's trainer does on the same weights and draws; ``_count_tnerf_deaths`` counts how often
        gen = _generator(dev, 2102 + i_trainer)
        if name == "mlp":
            state, step_fn = examples.make_mlp_occ_trainer(SYNTH_AABB, device=dev)

            def step(s, i, fn=step_fn):
                o, d, px, bk, _ = _trainer_batch(gen, views, R)
                return fn(s, o, d, px, bk, generator=gen)
        else:
            state, step_fn = examples.make_tnerf_occ_trainer(SYNTH_AABB, device=dev)

            def step(s, i, fn=step_fn):
                o, d, px, bk, ids = _trainer_batch(gen, views, R)
                return fn(s, o, d, px, times[ids], bk, generator=gen)

        o, d, px, bk, ids = _trainer_batch(_generator(dev, 2198), views, R)
        probe = _fixed_probe(dev, step_fn, (o, d, px, bk) if name == "mlp"
                             else (o, d, px, times[ids], bk))
        state, losses, samples, sec, timed, probed = _run_chunks(name, step, state,
                                                                 TRAINER_CHUNKS, counters, probe)
        print(f"  {name} ({'8 x 256, skip 4' if name == 'mlp' else 'T-NeRF, 4 x 64 warp'}, 64^3 "
              f"grid, {R} rays x {S} samples): {sec / TRAINER_CHUNKS[-1] * 1e3:.3f} ms per step "
              f"over the timed chunk of {TRAINER_CHUNKS[-1]}; "
              f"{samples[-TRAINER_CHUNKS[-1]:].mean():.0f} visible samples a step; loss "
              f"(first / last fifth) {losses[:20].mean():.5f} -> {losses[-20:].mean():.5f}, on a "
              f"fixed batch {probed[0]:.5f} -> {probed[1]:.5f}; launches {timed}",
              flush=True)
        expected = dict.fromkeys(timed, 0)
        expected.update(fused_render_weights=TRAINER_CHUNKS[-1],
                        fused_render_weights_bwd=TRAINER_CHUNKS[-1])
        if timed != expected:
            fail(f"{name} trainer launch counts {timed}, expected {expected}")
        for k in launches_total:
            launches_total[k] += timed[k]
        o, d, px, bk, ids = _trainer_batch(gen, views, R)
        state = state._replace(step=-(-state.step // 16) * 16)
        draws = _occ_step_draws(state, gen, dev)
        args = (o, d, px, bk) if name == "mlp" else (o, d, px, times[ids], bk)
        kw = dict(occ_draws=draws)
        if name == "tnerf":
            kw["occ_times"] = torch.rand((draws["jitter"].shape[0], 1), generator=gen,
                                         device=dev)
        seen = _compare_trainer_step(name, step_fn, state, args, kw, counters, 1, 1)
        f, b = _check_k2_at(dev, f"{name} trainer", seen[0], gen_k2, name == "mlp")
        if name == "mlp":
            records["mlp"] = (_shape_record(f, R, S), _shape_record(b, R, S, False))
        del state

    _count_tnerf_deaths(dev, views, times)

    # -- NDR-TNeRF forward and backward ----------------------------------------------------------
    cfg = mlpmod.NDRTNeRFConfig()
    field = mlpmod.init_ndr_tnerf(cfg, _generator(dev, 2122), dev)
    N = 1 << 17
    x = (torch.rand((N, 3), generator=gen, device=dev) * 3.0 - 1.5).requires_grad_(True)
    t = torch.rand((N, 1), generator=gen, device=dev)
    dirs = torch.nn.functional.normalize(torch.randn((N, 3), generator=gen, device=dev), dim=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, sigma = mlpmod.ndr_tnerf_forward(field, x, t, dirs, cfg)
    loss = rgb.sum() + sigma.sum()
    grads = torch.autograd.grad(loss, list(field.parameters()) + [x])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"  NDR-TNeRF at NDRTNeRFConfig() on {N} points: rgb {tuple(rgb.shape)}, sigma "
          f"{tuple(sigma.shape)}, forward + backward {wall * 1e3:.1f} ms (first call), "
          f"{len(grads) - 1} parameter gradients and the positions' finite: {finite}", flush=True)
    if (tuple(rgb.shape), tuple(sigma.shape)) != ((N, 3), (N, 1)) or not finite or not (
            torch.isfinite(rgb).all() and torch.isfinite(sigma).all()):
        fail("NDR-TNeRF's forward or backward is misshapen or not finite")
    print(f"trainers: phase 21 took {time.perf_counter() - t_phase:.1f} s; K2 launches over the "
          f"timed chunks {launches_total}", flush=True)
    return launches_total, records


# phase 24: the sharded train phases and render at full width, on ranks that
# share the card, each against the unsharded phase on the same draws.
# Flagship (2, 1): every loss and the 20 steps' update (final - initial
# parameters, err / max-abs of each tensor) at one member step's limits
# kernels against plain versions (compare_member_step's): each rank does
# its member's unsharded arithmetic, and only the proposal loss's float
# atomics move it. Flagship (1, 2): JAX's own bounds for its shard_map
# phase against its unsharded phase (tests/test_sharding.py:270-287), on
# JAX's protocol of 3 steps: their losses within rtol 1e-2 / atol 1e-3, and
# the drift of the trunk's first layer after them, mean under 0.3 and
# median under 2 learning rates. Two halves' gradients averaged round
# otherwise, and Adam turns the rounding of a near-zero gradient into a
# step of up to one learning rate either way, so the runs part with the
# steps: after 20, on an H100 (PERF.md), the losses read up to 3.0e-2 apart
# and the drift 0.30-0.60 lr, from the bench's trained state. Both are
# printed. ngp+occ, both meshes:
# NGP_STEP_TOL, which holds one member step, on the first step's update
# and gradient (from Adam's first moment) and on every loss; the 10 steps'
# update and moment are printed beside two unsharded runs' spread (the
# table's index_add_ atomics are not bit-repeatable).
MESH_STEPS = 20
MESH_NGP_STEPS = 10
MESH_SHAPES = ((2, 1), (1, 2))
MESH_CANDIDATES = 4
MESH_LOSS_TOL = (1e-2, 1e-3)
MESH_DRIFT_TOL = (0.3, 2.0)
MESH_DRIFT_STEPS = 3


def _counted_jobs(mesh, todo, t_launch=None, refs=None):
    """A rank's run of ``parallel/runs.py`` jobs, each with the kernels'
    launches it made on that rank and its wall seconds; the first job's
    also with the seconds since ``t_launch`` (the rank's start-up). With
    ``refs`` (per job None, or the unsharded run's arrays on the card and
    its initial state), rank 0 holds a train job's result to
    them here (``_train_summary``) and every rank sends back digests of
    its arrays: the ngp+occ tables need not travel back."""
    from apnerf_tpu_torch.parallel.runs import _sync, output_digest

    counters = all_counters()
    out = []
    for i, (job, kw) in enumerate(todo):
        t0 = time.time()
        reset_counts(counters)
        res = job(mesh, **kw)
        _sync(mesh.device)
        ref = refs[i] if refs is not None else None
        if ref is not None:
            arrays, state = ref
            if mesh.rank == 0:
                host = {k: v.cpu().numpy() for k, v in arrays.items() if k != "at"}
                host["at"] = {n: {k: v.cpu().numpy() for k, v in a.items()}
                              for n, a in arrays["at"].items()}
                res["summary"] = _train_summary(res, host, state)
            digest = lambda v: output_digest(v) if isinstance(v, np.ndarray) else v  # noqa: E731
            res = {k: digest(v) for k, v in res.items()}
            res["at"] = {n: {k: digest(v) for k, v in a.items()} for n, a in res["at"].items()}
        res["job_s"] = time.time() - t0
        if t_launch is not None and not out:
            res["startup_s"] = t0 - t_launch
        out.append((res, read_counts(counters)))
    return out


def _train_summary(got, ref, state):
    """What phase 24 holds of a train run against the unsharded one on the
    same draws (both as ``runs.train_job`` returns them, with arrays):
    losses, the whole run's update (final - initial, worst err / max-abs
    of a tensor) and Adam first moment, the trunk's first layer's drift,
    grids; after ``MESH_DRIFT_STEPS`` or 1 step where snapshotted, the
    drift or the first step's update and gradient."""
    out = {
        "loss_rel": float(np.max(np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"]))),
        "losses_close": bool(np.allclose(got["losses"][:MESH_DRIFT_STEPS],
                                         ref["losses"][:MESH_DRIFT_STEPS], rtol=MESH_LOSS_TOL[0],
                                         atol=MESH_LOSS_TOL[1])),
        "bits": all(np.array_equal(got[k], ref[k]) for k in ("losses", "params")),
        "occ_err": float(np.abs(got["occs"] - ref["occs"]).max()),
        "binaries_equal": bool(np.array_equal(got["binaries"], ref["binaries"])),
    }
    out["update"], out["drift"] = _drift(got["params"], ref["params"], state)
    cut = np.cumsum([p.numel() for p in state.members[0].parameters()])[:-1]
    out["mu"] = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for m in range(len(state.members))
                    for a, b in zip(np.split(got["mu"][m], cut), np.split(ref["mu"][m], cut)))
    if MESH_DRIFT_STEPS in got["at"]:
        out["drift_at"] = _drift(got["at"][MESH_DRIFT_STEPS]["params"],
                                 ref["at"][MESH_DRIFT_STEPS]["params"], state)[1]
    if 1 in got["at"]:
        out["update_1"], out["grad_1"] = _ngp_first_step(got["at"][1], ref["at"][1], state)
    return out


def _on_card(res, dev):
    """A train job's arrays as tensors on the card (for the ranks, through
    CUDA IPC)."""
    keys = ("losses", "params", "mu", "occs", "binaries")
    out = {k: torch.as_tensor(res[k], device=dev) for k in keys}
    out["at"] = {n: {k: torch.as_tensor(v, device=dev) for k, v in a.items()}
                 for n, a in res["at"].items()}
    return out


def _mesh_inputs(cfg, state, ds, dev, seed, n_steps, updates_occ):
    """The store and every step's draws for ``state`` (made here from one
    seeded generator; each rank keeps its share), on the card like the
    state: the ranks, on the same card, open them through CUDA IPC, and
    each job copies the members it trains."""
    from apnerf_tpu_torch.train.phase import draw_step, pools_from_dataset

    gen = _generator(dev, seed)
    E, n = cfg.n_ensembles, ds.size
    draws = [draw_step(cfg, E, state.step + i, (cfg.img_h, cfg.img_w), dev, gen, updates_occ,
                       state.occ[0].occs.numel()) for i in range(n_steps)]
    pools, counts = pools_from_dataset(ds)
    store = (ds.images[:n], ds.depths[:n], ds.semantics[:n], ds.camtoworlds[:n], ds.K, pools,
             counts, n)
    return store, draws


def _candidate_rays(cfg, center, k):
    """Candidate ``k``'s 40 views at the planner's 0.1 scale (4096 rays a
    view, the reference's flat-index subsampling): a flight across the
    room that turns as it goes."""
    from apnerf_tpu_torch.ops.rays import make_intrinsics, pose_matrix_from_quat, rays_from_pixels

    rng = np.random.default_rng(240 + k)
    pos = np.asarray(center) + np.linspace(rng.uniform(-1, 1, 3) * [1, 0.2, 1],
                                           rng.uniform(-1, 1, 3) * [1, 0.2, 1], N_VIEWS)
    yaw = np.linspace(0, 2 * np.pi, N_VIEWS) + rng.uniform(0, np.pi)
    c2w = np.stack([pose_matrix_from_quat(p, np.array([0, np.sin(a / 2), 0, np.cos(a / 2)]))
                    for p, a in zip(pos, yaw)]).astype(np.float32)
    H, W = cfg.img_h, cfg.img_w
    idx = np.round(np.linspace(0, H * W - 1, int(H * 0.1) * int(W * 0.1))).astype(np.int64)
    K = torch.as_tensor(make_intrinsics(W, H, cfg.hfov))
    rays = rays_from_pixels(torch.as_tensor(idx % W, dtype=torch.float32)[None],
                            torch.as_tensor(idx // W, dtype=torch.float32)[None],
                            torch.as_tensor(c2w)[:, None], K)
    return rays.origins, rays.viewdirs


def _drift(got, ref, state):
    """Per tensor of member 0..E-1, the update's err / max-abs of (final -
    initial) against the reference, and the absolute drift of the main
    trunk's first layer (mean, median over its elements)."""
    names = [n for n, _ in state.members[0].named_parameters()]
    sizes = [p.numel() for p in state.members[0].parameters()]
    p0 = np.stack([torch.cat([p.detach().reshape(-1) for p in m.parameters()]).cpu().numpy()
                   for m in state.members])
    cut = np.cumsum(sizes)[:-1]
    worst, w0 = 0.0, None
    for m in range(len(state.members)):
        for name, a, b, s0 in zip(names, np.split(got[m], cut), np.split(ref[m], cut),
                                  np.split(p0[m], cut)):
            ua, ub = a - s0, b - s0
            worst = max(worst, float(np.abs(ua - ub).max() / max(np.abs(ub).max(), 1e-30)))
            if name == "main.mlp_base.w0":
                d = np.abs(a - b) if w0 is None else np.concatenate([w0, np.abs(a - b)])
                w0 = d
    return worst, (float(w0.mean()), float(np.median(w0))) if w0 is not None else (0.0, 0.0)


def _ngp_first_step(got, ref, state, b1=0.9):
    """(update, gradient) worst err / max-abs over the tensors after one
    step; the gradient recovered from Adam's first moment as in
    ``compare_member_step``."""
    upd, _ = _drift(got["params"], ref["params"], state)
    cut = np.cumsum([p.numel() for p in state.members[0].parameters()])[:-1]
    worst = 0.0
    for m, opt in enumerate(state.opt):
        mu0 = opt.mu.cpu().numpy()
        for a, b, z in zip(np.split(got["mu"][m], cut), np.split(ref["mu"][m], cut),
                           np.split(mu0, cut)):
            ga, gb = (a - b1 * z) / (1 - b1), (b - b1 * z) / (1 - b1)
            worst = max(worst, float(np.abs(ga - gb).max() / max(np.abs(gb).max(), 1e-30)))
    return upd, worst


def phase_mesh(dev, bench_run, ngp_state):
    """Phase 24: the sharded flagship and ngp+occ phases and the sharded
    candidate render at full width on (2, 1) and (1, 2) meshes whose two
    ranks share the card, each against the unsharded run in this process
    on the same draws and weights, with exact launches per rank → each
    rank's launches over the (2, 1) flagship phase."""
    from apnerf_tpu_torch import bench
    from apnerf_tpu_torch.parallel import runs
    from apnerf_tpu_torch.parallel.launch import launch
    from apnerf_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    data, run = bench_run
    cfg, ngp_cfg = bench.bench_config(), _ngp_config()
    E = cfg.n_ensembles
    fl_state = run.state
    store, fl_draws = _mesh_inputs(cfg, fl_state, run.dataset, dev, 24, MESH_STEPS, False)
    _, ng_draws = _mesh_inputs(ngp_cfg, ngp_state, run.dataset, dev, 25, MESH_NGP_STEPS, True)
    todo = [
        (runs.train_job, dict(cfg=cfg, kind="flagship", state=fl_state, store=store,
                              n_steps=MESH_STEPS, draws=fl_draws, one_step_calls=True,
                              occ_update=True, occ_thre=bench.OCC_THRE,
                              snapshots=(MESH_DRIFT_STEPS,))),
        (runs.train_job, dict(cfg=ngp_cfg, kind="ngp", state=ngp_state, store=store,
                              n_steps=MESH_NGP_STEPS, draws=ng_draws, one_step_calls=True,
                              occ_thre=ngp_cfg.occ_thre_for_phase(-1), snapshots=(1,))),
    ]
    for k in range(MESH_CANDIDATES):
        o, d = _candidate_rays(cfg, data.center, k)
        todo.append((runs.render_job, dict(cfg=cfg, state=fl_state, origins=o, viewdirs=d,
                                           bkgd=torch.zeros(3), max_samples=256,
                                           with_variance=True, digest=True)))
    single = _counted_jobs(Mesh.single(dev), todo)
    # the unsharded ngp+occ phase again: two runs differ by the table's atomics alone
    spread = _train_summary(runs.train_job(Mesh.single(dev), **todo[1][1]), single[1][0],
                            ngp_state)
    refs = [(_on_card(single[0][0], dev), fl_state),
            (_on_card(single[1][0], dev), ngp_state)] + [None] * MESH_CANDIDATES
    results = {}
    for shape in MESH_SHAPES:
        t0 = time.perf_counter()
        results[shape] = launch(_counted_jobs, *shape, todo, time.time(), refs, device=dev)
        r0 = [res for res, _ in results[shape][0]]
        print(f"  mesh {shape}: launch and run {time.perf_counter() - t0:.1f} s; rank 0 reached "
              f"its first job after {r0[0]['startup_s']:.1f} s, its jobs took "
              + ", ".join(f"{r['job_s']:.1f}" for r in r0) + " s", flush=True)
    lr = cfg.spectral_lr
    ms = lambda r: 1e3 * float(np.median(r["seconds"][5:]))  # noqa: E731
    dev_ms = lambda r: float(np.median(r["device_ms"][5:]))  # noqa: E731
    print(f"mesh: flagship phase of {MESH_STEPS} steps, 2 members x {cfg.num_rays} rays x "
          f"{cfg.max_samples_train} samples, from the bench's trained state: unsharded "
          f"{ms(single[0][0]):.3f} ms per ensemble step (device events {dev_ms(single[0][0]):.3f})"
          + "".join(f"; {shape} {ms(results[shape][0][0][0]):.3f} ms (rank 0's events "
                    f"{dev_ms(results[shape][0][0][0]):.3f})" for shape in MESH_SHAPES),
          flush=True)
    print(f"mesh: ngp+occ phase of {MESH_NGP_STEPS} steps: unsharded {ms(single[1][0]):.3f} ms "
          f"per ensemble step" + "".join(f"; {shape} {ms(results[shape][0][1][0]):.3f} ms"
                                        for shape in MESH_SHAPES), flush=True)
    render_s = lambda rs: sum(r[0]["seconds"] for r in rs[2:])  # noqa: E731
    print(f"mesh: {MESH_CANDIDATES} candidates x {N_VIEWS} views x 4096 rays x 256 samples, "
          f"render wall: unsharded {render_s(single):.3f} s"
          + "".join(f"; {shape} {render_s(results[shape][0]):.3f} s (rank 0)"
                    for shape in MESH_SHAPES), flush=True)
    print(f"  two unsharded ngp+occ runs: losses max rel {spread['loss_rel']:.3e}, update worst "
          f"err/scale {spread['update']:.3e}, Adam's first moment {spread['mu']:.3e}", flush=True)
    bad = []
    for shape in MESH_SHAPES:
        ranks = results[shape]
        n_ens, n_data = shape
        E_l = E // n_ens
        for rank, rr in enumerate(ranks):
            (fl, fl_n), (ng, ng_n) = rr[0], rr[1]
            # launches, exact per rank
            want = dict.fromkeys(fl_n, 0)
            want.update(fused_field_volrend_lossgrad=MESH_STEPS * E_l,
                        fused_render_weights_bwd=MESH_STEPS * E_l,
                        fused_render_weights=2 * MESH_STEPS * E_l,
                        fused_spectral_field=E_l)  # the chunk's occupancy update
            if fl_n != want:
                bad.append(f"{shape} rank {rank} flagship launches {fl_n}, expected {want}")
            want = dict.fromkeys(ng_n, 0)
            want.update(fused_render_weights=MESH_NGP_STEPS * E_l,
                        fused_render_weights_bwd=MESH_NGP_STEPS * E_l)
            if ng_n != want:
                bad.append(f"{shape} rank {rank} ngp launches {ng_n}, expected {want}")
            renders = sum(n["fused_field_heads"] for _, n in rr[2:])
            if renders != MESH_CANDIDATES * N_VIEWS * E // (n_ens * n_data):
                bad.append(f"{shape} rank {rank} rendered {renders} member views")
            # every rank holds the same gathered results (their digests)
            for a, b in zip(rr[:2], ranks[0][:2]):
                for k in ("losses", "params", "occs"):
                    if a[0][k] != b[0][k]:
                        bad.append(f"{shape} rank {rank} {k} differ from rank 0's")
        fl, ng = ranks[0][0][0]["summary"], ranks[0][1][0]["summary"]
        (mean_w0, med_w0), (mean_3, med_3) = fl["drift"], fl["drift_at"]
        print(f"  {shape} flagship vs unsharded: losses max rel {fl['loss_rel']:.3e} (within rtol "
              f"{MESH_LOSS_TOL[0]}, atol {MESH_LOSS_TOL[1]} over the first {MESH_DRIFT_STEPS}: "
              f"{fl['losses_close']}), update worst "
              f"err/scale {fl['update']:.3e}, trunk w0 drift after {MESH_DRIFT_STEPS} steps mean "
              f"{mean_3:.3e} median {med_3:.3e}, after {MESH_STEPS} mean {mean_w0:.3e} median "
              f"{med_w0:.3e} (lr {lr}); grids max-abs {fl['occ_err']:.3e}, binaries equal "
              f"{fl['binaries_equal']}; bit for bit {fl['bits']}", flush=True)
        if n_data == 1:
            if not (fl["loss_rel"] <= STEP_LOSS_RTOL and fl["update"] <= STEP_UPDATE_TOL):
                bad.append(f"{shape} flagship off the unsharded phase (loss {fl['loss_rel']:.3e}, "
                           f"update {fl['update']:.3e})")
        elif not (fl["losses_close"] and mean_3 < MESH_DRIFT_TOL[0] * lr
                  and med_3 < MESH_DRIFT_TOL[1] * lr):
            bad.append(f"{shape} flagship off the unsharded phase over {MESH_DRIFT_STEPS} steps "
                       f"(losses within bounds: {fl['losses_close']}, w0 drift {mean_3:.3e}, "
                       f"{med_3:.3e})")
        print(f"  {shape} ngp+occ vs unsharded: losses max rel {ng['loss_rel']:.3e} (tol "
              f"{NGP_STEP_TOL[0]}); the first step's update worst err/scale {ng['update_1']:.3e} "
              f"(tol {NGP_STEP_TOL[1]}), gradient {ng['grad_1']:.3e} (tol {NGP_STEP_TOL[2]}); "
              f"after {MESH_NGP_STEPS} steps update {ng['update']:.3e}, Adam's first moment "
              f"{ng['mu']:.3e}; grids max-abs {ng['occ_err']:.3e}", flush=True)
        if not (ng["loss_rel"] <= NGP_STEP_TOL[0] and ng["update_1"] <= NGP_STEP_TOL[1]
                and ng["grad_1"] <= NGP_STEP_TOL[2]):
            bad.append(f"{shape} ngp+occ off the unsharded phase")
        for k, ((got, _), (want, _)) in enumerate(zip(ranks[0][2:], single[2:])):
            off = [name for name in want
                   if name not in ("seconds", "job_s", "startup_s") and got[name][0] != want[name][0]]
            if off:
                bad.append(f"{shape} candidate {k}: {off} not bit for bit (sums "
                           + ", ".join(f"{n} {got[n][2]!r} vs {want[n][2]!r}" for n in off) + ")")
        nonzero = lambda n: {k: v for k, v in n.items() if v}  # noqa: E731
        print(f"  {shape} launches of rank 0: flagship {nonzero(ranks[0][0][1])}; ngp "
              f"{nonzero(ranks[0][1][1])}; render {nonzero(ranks[0][2][1])} a candidate",
              flush=True)
    print(f"mesh: phase 24 wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        fail("phase 24: " + "; ".join(bad))
    return results[(2, 1)][0][0][1]


def _replay_rank(mesh, argv):
    """A rank of phase 25: the replay loop on the mesh → its rows, the
    cameras it supervised, its launches and every member's final state."""
    from apnerf_tpu_torch import replay_eval
    from apnerf_tpu_torch.parallel.mesh import gather_ensemble_state
    from apnerf_tpu_torch.parallel.runs import state_arrays

    counters = all_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    rows, m = replay_eval.run(replay_eval.parse_args(argv), mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = m.train_dataset
    return {"rows": rows, "wall": wall, "launches": read_counts(counters),
            "camtoworlds": ds.camtoworlds[:ds.size].cpu().numpy(),
            "uncertainty": m.trajector_uncertainty_list, "loss_hist": m.loss_hist,
            "chunks": sum(-(-len(p) // m.steps_per_call) for p in m.loss_hist),
            "n_test": len(m._test_poses),
            **state_arrays(gather_ensemble_state(m.state, mesh))}


def phase_mesh_loop(dev, replay_mapper):
    """Phase 25: ``--mesh 2,1`` at ``config_faketiny.yaml`` and ``python -m
    apnerf_tpu_torch.dryrun 4`` as subprocesses, started first and run
    alongside the mesh-mode replay loop on phase 22's recording at its
    settings on (2, 1), which is held to phase 22's mapper."""
    import yaml

    from apnerf_tpu_torch.ops.cuda import build

    t_phase = time.perf_counter()
    with open(os.path.join(build.REPO_ROOT, "configs", "config_faketiny.yaml")) as f:
        doc = yaml.safe_load(f)
    runs_dir = build.BUILD_DIR / "chip_smoke_mesh_cli"
    shutil.rmtree(runs_dir, ignore_errors=True)
    doc["save_path"] = str(runs_dir)
    cli_cfg = build.BUILD_DIR / "chip_smoke_mesh_faketiny.yaml"
    cli_cfg.write_text(yaml.safe_dump(doc))
    procs = {label: subprocess.Popen(cmd, cwd=build.REPO_ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
             for label, cmd in (
                 ("--mesh 2,1", [sys.executable, "-m", "apnerf_tpu_torch.active.pipeline", "--sim",
                                 "fake", "--config", str(cli_cfg), "--mesh", "2,1"]),
                 ("dryrun 4", [sys.executable, "-m", "apnerf_tpu_torch.dryrun", "4"]))}
    bad = []
    try:
        _mesh_replay(dev, replay_mapper, bad)
        for label, proc in procs.items():
            out_, err_ = proc.communicate(timeout=600)
            lines = [ln for ln in out_.splitlines() if ln.startswith(("mesh", "done", "dryrun",
                                                                      "throughput", "entry"))]
            print(f"  {label}: exit {proc.returncode}, {time.perf_counter() - t_phase:.1f} s "
                  "after the phase started: " + " | ".join(lines), flush=True)
            if proc.returncode != 0:
                print(out_[-3000:], err_[-3000:])
                bad.append(f"{label} exited {proc.returncode}")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    (run_dir,) = os.listdir(runs_dir) or [None]
    errors = np.load(runs_dir / run_dir / "errors.npy") if run_dir else np.zeros((0, 4))
    print(f"  --mesh 2,1 evaluation rows {errors.tolist()}", flush=True)
    if len(errors) < 3 or not np.isfinite(errors).all():
        bad.append(f"--mesh 2,1 wrote {errors.tolist()}")
    print(f"mesh: phase 25 wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        fail("phase 25: " + "; ".join(bad))


def _mesh_replay(dev, replay_mapper, bad):
    """The replay loop of phase 22 on a (2, 1) mesh against phase 22's
    mapper: the same trajectory, its rows (reported), every camera a
    recorded one, exact launches per rank, and rank 0's checkpoints
    reloaded into an unsharded mapper bit for bit. Failures go to ``bad``."""
    from apnerf_tpu_torch import replay_eval
    from apnerf_tpu_torch.ops.cuda import build
    from apnerf_tpu_torch.parallel.launch import launch
    from apnerf_tpu_torch.parallel.runs import state_arrays

    npz = build.BUILD_DIR / "chip_smoke_replay_rec" / "data0.npz"
    out = build.BUILD_DIR / "chip_smoke_replay_mesh"
    shutil.rmtree(out, ignore_errors=True)
    cfg = replay_mapper.cfg
    ranks = launch(_replay_rank, 2, 1, replay_argv(npz, cfg.aabb, out, REPLAY_STEPS,
                                                   device="cuda"), device=dev)
    r = ranks[0]
    ref_rows = np.asarray(replay_mapper.errors_hist, dtype=float)
    rows = np.asarray([[x["planning_step"], x["psnr"], x["depth_mse"], x["sem_ce"]]
                       for x in r["rows"]])
    ds = replay_mapper.train_dataset
    ref_cams = ds.camtoworlds[:ds.size].cpu().numpy()
    same_traj = r["camtoworlds"].shape == ref_cams.shape and np.array_equal(r["camtoworlds"],
                                                                            ref_cams)
    diff = (np.abs(rows - ref_rows).max(axis=0).tolist() if rows.shape == ref_rows.shape
            else "n/a")
    print(f"mesh replay loop (2, 1), beside the two subprocesses: {r['wall']:.1f} s of wall in "
          f"rank 0; rows (planning step, PSNR, depth MSE, CE) {rows.tolist()}; phase 22's "
          f"{ref_rows.tolist()}; max abs difference by column {diff}", flush=True)
    print(f"  the supervised cameras equal phase 22's (the chosen trajectory): {same_traj}; "
          f"losses equal phase 22's: {r['loss_hist'] == replay_mapper.loss_hist}; launches of "
          f"rank 0 {r['launches']}", flush=True)
    if not same_traj:
        bad.append("the mesh-mode replay loop flew another trajectory than phase 22")
    if rows.shape != ref_rows.shape or not np.isfinite(rows).all():
        bad.append(f"expected {len(ref_rows)} finite error rows, got {rows.tolist()}")
    elif not np.array_equal(rows, ref_rows):
        # phase 22's seeded run repeats to the last digit between calls, so
        # its run-to-run spread is zero: any difference is reported here
        print("  the held-out rows are not phase 22's to the last digit (reported, not held)",
              flush=True)
    poses = np.load(npz)["camtoworlds"]
    worst = max(float(np.abs(poses - c).max(axis=(1, 2)).min()) for c in r["camtoworlds"])
    if not worst < 1e-5:
        bad.append(f"a supervised camera is {worst} from every recorded one")
    for rank, x in enumerate(ranks):
        if not (np.array_equal(x["params"], r["params"]) and x["rows"] == r["rows"]):
            bad.append(f"rank {rank} disagrees with rank 0")
    E_l, n_test = cfg.n_ensembles // 2, r["n_test"]
    ran = sum(len(p) for p in r["loss_hist"])
    scored = sum(len(c) for c in r["uncertainty"])
    renders = scored * N_VIEWS * E_l
    eval_renders = len(rows) * n_test * E_l
    want = dict.fromkeys(r["launches"], 0)
    want.update(fused_field_volrend_lossgrad=E_l * ran, fused_render_weights_bwd=E_l * ran,
                fused_spectral_field=E_l * r["chunks"], fused_field_heads=renders,
                fused_field_volrend=eval_renders,
                fused_render_weights=2 * E_l * ran + 2 * renders + eval_renders)
    for rank, x in enumerate(ranks):
        if x["launches"] != want:
            bad.append(f"rank {rank} launches {x['launches']}, expected {want}")
    m, _, _ = replay_eval.build_mapper(replay_eval.parse_args(
        replay_argv(npz, cfg.aabb, build.BUILD_DIR / "chip_smoke_replay_reload", REPLAY_STEPS,
                    device=dev)))
    m.load_checkpoints(str(out / "checkpoints"))
    got = state_arrays(m.state)
    reload_ok = all(np.array_equal(got[k], r[k]) for k in ("params", "mu", "count", "occs",
                                                            "binaries", "step"))
    print(f"  rank 0's checkpoints reload into an unsharded mapper bit for bit: {reload_ok}",
          flush=True)
    if not reload_ok:
        bad.append("rank 0's checkpoints do not reload bit for bit")

if __name__ == "__main__":
    sys.exit(main())
