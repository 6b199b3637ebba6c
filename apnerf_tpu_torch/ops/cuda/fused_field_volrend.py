"""The main field fused with volume rendering, in CUDA kernels
(``csrc/fused_field_volrend.cu``): the forward-only render of evaluation
and visualisation, and the train step's render, loss and backward.

``fused_field_volrend`` is the port of ``apnerf_tpu/ops/pallas/
fused_field_volrend.py::fused_field_volrend``, forward and backward: the field, the
weights w = T·α from σ·dt and the per-ray sums Σw·rgb, Σw, Σw·t_mid and
Σw·sem, with misses folded into dt = 0. It runs the packed field kernel
(``csrc/fused_field_heads.cu``) and a per-ray kernel over chunks of rays,
so the per-sample field values of a chunk live in one scratch buffer
that the next chunk reuses. The output is row-major ``acc [R, 5 + C]``
(0:3 rgb, 3 opacity, 4 depth numerator, 5: semantics) and ``w [N]``;
``fused_field_volrend_plain`` is its plain PyTorch version, with the
kernel's bf16 rounding of the per-sample products. A call that asks for
gradients goes through a ``torch.autograd.Function`` whose backward,
``fused_field_volrend_bwd``, recomputes the field with its activations
saved (as the TPU kernel recomputes), turns the cotangents of ``acc`` and
``w`` into per-sample cotangents in a warp-per-ray kernel (the train-step
kernel's, started from the given cotangents instead of the loss) and runs
the field backward: gradients of every leaf and of ``u``; ``sh``, ``dt``
and ``tm`` get none, as in the JAX VJP. The plain backward is autograd
through the plain version with the per-ray cotangents rounded to bf16
first, as both kernels round them.

``fused_field_volrend_lossgrad`` is the port of ``apnerf_tpu/ops/pallas/fused_field_volrend.py::
fused_field_volrend_lossgrad``: the main field, volume rendering, the
3-term loss (huber rgb after background compositing, huber depth,
softmax CE) and the closed-form backward to every main-field parameter,
in one call. ``fused_field_volrend_lossgrad`` launches the kernels for
CUDA tensors and takes ``fused_field_volrend_lossgrad_plain`` only for
CPU tensors. The plain version is the math of the JAX package's autograd
branch (``train/flagship.py:243-311`` without ``prop_loss``) on one
member, with its gradients from ``torch.autograd.grad``. Both take the
field's parameters as one flat list and return the gradients in its
order; ``models/spectral.py`` maps them to the parameter tree.

The kernel rounds three things to bf16 that autograd does not: the
per-sample products before the per-ray sums, the per-ray cotangents,
and the head inputs (as the Pallas kernel does), so the two agree on
the scale of bf16 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build
from .field_train import FieldTrainCall
from .fused_field_heads import field_plain, launch_field_rows, prepare_field
from .launch import check_tensor, needs_grad
from .volrend_cuda import fused_render_weights_plain

# the train loss's weights of its rgb, depth and semantic terms
# (``apnerf_tpu/train/flagship.py:298-308``)
LOSS_WEIGHTS = (10.0, 1.0 / 5.0, 1.0 / 2.0)
MAX_SAMPLES = 1024
# rows of per-sample field values the forward-only render keeps in device
# memory at a time: 2^21 rows of 4 + C f32 are 277 MB at 29 classes
FWD_CHUNK_ROWS = 1 << 21
# rows a differentiable call may have: its backward keeps every row's bf16
# activations and cotangents at once (~5 KB a row at the shipping widths,
# 1.3 GB at a train step's 262,144 rows), unchunked
BWD_MAX_ROWS = FWD_CHUNK_ROWS
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _term_sizes(R: int) -> Tuple[float, float, float]:
    """Elements each loss term averages over: rgb channels, depths, labels."""
    return 3.0 * R, float(R), float(R)


def loss_terms(lossrows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray sums [3, R] → the mean rgb, depth and semantic terms that
    ``LOSS_WEIGHTS`` weigh."""
    sizes = _term_sizes(lossrows.shape[1])
    return tuple(lossrows[i].sum() / sizes[i] for i in range(3))


def fused_field_volrend_lossgrad_plain(
    leaves, u, sh, dt, tm, pix, dgt, lab, bk, S: int, compute_dtype=torch.bfloat16,
):
    """The same outputs as ``fused_field_volrend_lossgrad`` from plain
    PyTorch ops and autograd; ``compute_dtype`` is the field's matmul
    dtype (the kernel's is bf16)."""
    N = u.shape[0]
    R = N // S
    with torch.enable_grad():
        rgb, sigma, sem = field_plain(leaves, u, sh, S, compute_dtype)
        # render_weight_from_density with the miss mask folded into dt
        w = fused_render_weights_plain(
            torch.zeros_like(dt).reshape(R, S), dt.reshape(R, S), sigma.reshape(R, S)
        )
        # render_outputs, with t_mid given
        rgb_acc = torch.einsum("rs,rsc->rc", w, rgb.reshape(R, S, 3))
        op = w.sum(dim=-1, keepdim=True)
        depth = (w * tm.reshape(R, S)).sum(dim=-1, keepdim=True) / op.clamp(min=_F32_EPS)
        sem_acc = torch.einsum("rs,rsc->rc", w, sem.reshape(R, S, -1))
        rgb_full = rgb_acc + bk * (1.0 - op)
        lossrows = torch.stack([
            F.huber_loss(rgb_full, pix, reduction="none", delta=1.0).sum(dim=-1),
            F.huber_loss(depth[:, 0], dgt, reduction="none", delta=1.0),
            F.cross_entropy(sem_acc, lab.long(), reduction="none"),
        ])
        loss = sum(c * t for c, t in zip(LOSS_WEIGHTS, loss_terms(lossrows)))
        grads = torch.autograd.grad(loss, list(leaves))
    return lossrows.detach(), w.detach().reshape(-1), list(grads)


@torch.no_grad()
def fused_field_volrend_lossgrad(
    leaves: Sequence[torch.Tensor],  # W [3, M], phase [M], then the (w, b) pairs of
    # the trunk's, the rgb head's and the semantic head's layers, in order; f32
    u: torch.Tensor,  # [N, 3] f32 unit-cube coordinates, N = R * S
    sh: torch.Tensor,  # [R, 16] f32 SH of the ray directions
    dt: torch.Tensor,  # [N] f32 t1 - t0, zero on rays that miss the box
    tm: torch.Tensor,  # [N] f32 interval midpoints
    pix: torch.Tensor,  # [R, 3] f32 rgb targets
    dgt: torch.Tensor,  # [R] f32 depth targets
    lab: torch.Tensor,  # [R] int32 semantic labels
    bk: torch.Tensor,  # [3] f32 background color
    S: int,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """→ (lossrows [3, R] per-ray sums: huber rgb over channels, huber
    depth, CE; weights [N] (no gradient: the proposal loss reads them
    detached); the gradients of Σ_k LOSS_WEIGHTS[k]·loss_terms[k], one per
    leaf, in ``leaves``' order). Not differentiable itself. A CUDA tensor
    launches the kernels or raises."""
    if u.device.type == "cpu":
        return fused_field_volrend_lossgrad_plain(
            leaves, u, sh, dt, tm, pix, dgt, lab, bk, S, compute_dtype
        )
    if u.device.type != "cuda":
        raise ValueError(f"fused_field_volrend_lossgrad: unsupported device {u.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("fused_field_volrend_lossgrad: the CUDA kernel computes in bf16")
    who = "fused_field_volrend_lossgrad"
    N = u.shape[0]
    if not 0 < S <= MAX_SAMPLES:
        raise ValueError(f"{who}: S={S} must be in 1..{MAX_SAMPLES}")
    call = FieldTrainCall(who, leaves, u, sh, S)
    dev, R = call.dev, call.R
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("dt", dt, f32, (N,)), ("tm", tm, f32, (N,)), ("pix", pix, f32, (R, 3)),
        ("dgt", dgt, f32, (R,)), ("lab", lab, torch.int32, (R,)), ("bk", bk, f32, (3,)),
    ):
        check_tensor(who, t, name, dtype, shape, dev)
    w_out = call.buf((N,), f32)
    lossrows = call.buf((3, R), f32)
    call.set_inputs(dt=dt, tm=tm, pix=pix, dgt=dgt, lab=lab, bk=bk, w=w_out, lossrows=lossrows)
    a = call.a
    a.c_rgb, a.c_dep, a.c_sem = (c / n for c, n in zip(LOSS_WEIGHTS, _term_sizes(R)))
    call.field_forward()
    call.run(call.lib.apnerf_fvr_rays, call.ref, 1)
    grads, _ = call.field_backward()
    fused_field_volrend_lossgrad.launches += 1
    return lossrows, w_out, grads


# wrapper calls that launched the kernels since the counter was last reset
# (chip_smoke.py reads it)
fused_field_volrend_lossgrad.launches = 0


def fused_field_volrend_plain(leaves, u, sh, dt, tm, S: int, compute_dtype=torch.bfloat16):
    """The same outputs as ``fused_field_volrend`` from plain PyTorch ops.
    In bf16 the per-sample products round to bf16 before the f32 per-ray
    sums, as the kernel's do."""
    N = u.shape[0]
    R = N // S
    rgb, sigma, sem = field_plain(leaves, u, sh, S, compute_dtype)
    w = fused_render_weights_plain(
        torch.zeros_like(dt).reshape(R, S), dt.reshape(R, S), sigma.reshape(R, S)
    )
    w = w.reshape(N)
    per_sample = torch.cat([rgb * w[:, None], w[:, None], (w * tm)[:, None], sem * w[:, None]],
                           dim=-1)
    if compute_dtype != torch.float32:
        per_sample = per_sample.to(compute_dtype).float()
    return per_sample.reshape(R, S, -1).sum(dim=1), w


def _check_backward_rows(who, N):
    if N > BWD_MAX_ROWS:
        raise ValueError(
            f"{who}: a backward keeps every row's activations at once: N={N} exceeds "
            f"{BWD_MAX_ROWS} rows"
        )


def _check_render_inputs(who, u, sh, dt, tm, S):
    dev, N = u.device, u.shape[0]
    if not 0 < S <= MAX_SAMPLES or N == 0 or N % S:
        raise ValueError(f"{who}: N={N} must be a positive multiple of S={S} <= {MAX_SAMPLES}")
    for name, t, shape in (("u", u, (N, 3)), ("sh", sh, (N // S, 16)), ("dt", dt, (N,)),
                           ("tm", tm, (N,))):
        check_tensor(who, t, name, torch.float32, shape, dev)


def _launch_forward(leaves, u, sh, dt, tm, S):
    """The forward kernels over chunks of rays → (acc, w)."""
    who = "fused_field_volrend"
    dev, N = u.device, u.shape[0]
    R = N // S
    f32 = torch.float32
    fld = prepare_field(who, leaves, dev)
    lib = build.library()
    C = fld.C
    rays_per_chunk = max(FWD_CHUNK_ROWS // S, 1)
    y = torch.empty((min(R, rays_per_chunk) * S, 4 + C), dtype=f32, device=dev)
    acc = torch.empty((R, 5 + C), dtype=f32, device=dev)
    w = torch.empty((N,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for r0 in range(0, R, rays_per_chunk):
        n_rays = min(rays_per_chunk, R - r0)
        row0 = r0 * S
        err = launch_field_rows(
            lib, fld, u.data_ptr() + row0 * 12, sh.data_ptr() + r0 * 64, y.data_ptr(),
            n_rays * S, S, stream,
        )
        if err == 0:
            err = lib.apnerf_fvr_fwd_rays(
                y.data_ptr(), dt.data_ptr() + row0 * 4, tm.data_ptr() + row0 * 4,
                acc.data_ptr() + r0 * (5 + C) * 4, w.data_ptr() + row0 * 4, n_rays, S, C,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"{who}: CUDA launch failed, error {err}")
    fused_field_volrend.launches += 1
    return acc, w


def fused_field_volrend_bwd_plain(leaves, u, sh, dt, tm, S: int, g_acc, g_w=None,
                                  need_du: bool = False, compute_dtype=torch.bfloat16):
    """The same outputs as ``fused_field_volrend_bwd`` by autograd through
    the plain forward; in bf16 the per-ray cotangents round to bf16 first."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    u = u.detach().requires_grad_(need_du)
    if compute_dtype != torch.float32:
        g_acc = g_acc.to(compute_dtype).float()
    with torch.enable_grad():
        acc, w = fused_field_volrend_plain(leaves, u, sh, dt, tm, S, compute_dtype)
        outs, gs = [acc], [g_acc]
        if g_w is not None:
            outs, gs = outs + [w], gs + [g_w]
        grads = torch.autograd.grad(outs, leaves + ([u] if need_du else []), gs)
    return list(grads[: len(leaves)]), (grads[-1] if need_du else None)


@torch.no_grad()
def fused_field_volrend_bwd(
    leaves: Sequence[torch.Tensor],
    u: torch.Tensor,  # [N, 3]
    sh: torch.Tensor,  # [R, 16]
    dt: torch.Tensor,  # [N]
    tm: torch.Tensor,  # [N]
    S: int,
    g_acc: torch.Tensor,  # [R, 5 + C] f32 cotangent of the per-ray sums
    g_w: Optional[torch.Tensor] = None,  # [N] f32 cotangent of the weights, or None
    need_du: bool = False,
    compute_dtype=torch.bfloat16,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of ``fused_field_volrend`` → (one gradient per leaf, in
    ``leaves``' order; du [N, 3] or None). A CUDA tensor launches the
    kernels or raises."""
    who = "fused_field_volrend_bwd"
    if u.device.type == "cpu":
        return fused_field_volrend_bwd_plain(
            leaves, u, sh, dt, tm, S, g_acc, g_w, need_du, compute_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{who}: the CUDA kernels compute in bf16")
    _check_render_inputs(who, u, sh, dt, tm, S)
    N = u.shape[0]
    _check_backward_rows(who, N)
    call = FieldTrainCall(who, leaves, u, sh, S, need_du)
    check_tensor(who, g_acc, "g_acc", torch.float32, (call.R, 5 + call.fld.C), call.dev)
    if g_w is not None:
        check_tensor(who, g_w, "g_w", torch.float32, (N,), call.dev)
    call.set_inputs(dt=dt, tm=tm, g_acc=g_acc, g_w=g_w)
    call.field_forward()
    call.run(call.lib.apnerf_fvr_rays, call.ref, 0)
    out = call.field_backward()
    fused_field_volrend_bwd.launches += 1
    return out


class _FieldVolrend(torch.autograd.Function):
    """acc, w = f(u, sh, dt, tm, *leaves); the forward keeps its inputs only."""

    @staticmethod
    def forward(ctx, S, u, sh, dt, tm, *leaves):
        ctx.S = S
        ctx.save_for_backward(u, sh, dt, tm, *leaves)
        ctx.set_materialize_grads(False)
        return _launch_forward(leaves, u, sh, dt, tm, S)

    @staticmethod
    def backward(ctx, g_acc, g_w):
        u, sh, dt, tm, *leaves = ctx.saved_tensors
        if g_acc is None:
            g_acc = torch.zeros((u.shape[0] // ctx.S, leaves[-1].shape[0] + 5),
                                dtype=torch.float32, device=u.device)
        grads, du = fused_field_volrend_bwd(
            leaves, u, sh, dt, tm, ctx.S, g_acc.float().contiguous(),
            None if g_w is None else g_w.float().contiguous(), ctx.needs_input_grad[1],
        )
        # sh, dt and t_mid come from the sampler, which runs without gradients
        return (None, du, None, None, None, *grads)


def fused_field_volrend(
    leaves: Sequence[torch.Tensor],  # as ``fused_field_volrend_lossgrad`` takes them
    u: torch.Tensor,  # [N, 3] f32 unit-cube coordinates, N = R * S
    sh: torch.Tensor,  # [R, 16] f32 SH of the ray directions
    dt: torch.Tensor,  # [N] f32 t1 - t0, zero on rays that miss the box
    tm: torch.Tensor,  # [N] f32 interval midpoints
    S: int,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (acc [R, 5 + C] f32 per-ray sums: rgb, opacity, depth numerator,
    semantic logits; weights [N] f32). Any R, any S up to ``MAX_SAMPLES``.
    A CUDA tensor launches the kernels or raises. Differentiable in the
    leaves and ``u`` (``sh``, ``dt`` and ``tm`` get no gradient), up to
    ``BWD_MAX_ROWS`` rows: a larger differentiable call raises; without
    gradients any size goes, in chunks of ``FWD_CHUNK_ROWS`` rows."""
    who = "fused_field_volrend"
    if u.device.type == "cpu":
        return fused_field_volrend_plain(leaves, u, sh, dt, tm, S, compute_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{who}: the CUDA kernels compute in bf16")
    _check_render_inputs(who, u, sh, dt, tm, S)
    if needs_grad(*leaves, u):
        _check_backward_rows(who, u.shape[0])  # now, not when the backward runs
        return _FieldVolrend.apply(S, u, sh, dt, tm, *leaves)
    return _launch_forward(leaves, u, sh, dt, tm, S)


# wrapper calls that launched the kernels since the counters were last reset
fused_field_volrend.launches = 0
fused_field_volrend_bwd.launches = 0
