"""Drive the PyTorch port's planning step and train step on one NVIDIA GPU.

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
     device time by kernel and the device's idle share;
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
     with ``torch.profiler``.

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

    # ---- 5-7. the train step's kernels and the train path ------------------------
    records["fused_render_weights_bwd"] = phase_k2_bwd(dev)
    records["fused_field_volrend_lossgrad"] = phase_k6(dev)
    train_launches = phase_train(dev)
    launches.update(
        fused_render_weights_bwd=train_launches["fused_render_weights_bwd"],
        fused_field_volrend_lossgrad=train_launches["fused_field_volrend_lossgrad"],
    )

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
    version → (max-abs error at the proposal shape, kernel ms, plain ms)."""
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
            record = (max(e[0] for e in errs), ms, pms)
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
    → (max-abs error of the weights, kernel ms, plain ms), zero biases."""
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
            record = (w_err, ms, pms)
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
        _, rg = _errs(gk[i], gp[i])
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
    import contextlib
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


if __name__ == "__main__":
    sys.exit(main())
