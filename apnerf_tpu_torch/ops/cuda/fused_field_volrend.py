"""The train step's render, loss and backward in CUDA kernels
(``csrc/fused_field_volrend.cu``).

Port of ``apnerf_tpu/ops/pallas/fused_field_volrend.py::
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

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...models.ngp import trunc_exp
from ...models.nn import apply_layers
from . import build
from .fused_mlp import encode_plain
from .volrend_cuda import fused_render_weights_plain

# the train loss's weights of its rgb, depth and semantic terms
# (``apnerf_tpu/train/flagship.py:298-308``)
LOSS_WEIGHTS = (10.0, 1.0 / 5.0, 1.0 / 2.0)
MAX_SAMPLES = 1024
MAX_CLASSES = 64
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_N_CHUNKS = 64  # row chunks of the weight-gradient reduction
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _term_sizes(R: int) -> Tuple[float, float, float]:
    """Elements each loss term averages over: rgb channels, depths, labels."""
    return 3.0 * R, float(R), float(R)


def loss_terms(lossrows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray sums [3, R] → the mean rgb, depth and semantic terms that
    ``LOSS_WEIGHTS`` weigh."""
    sizes = _term_sizes(lossrows.shape[1])
    return tuple(lossrows[i].sum() / sizes[i] for i in range(3))


def _split(leaves: Sequence[torch.Tensor]):
    """``leaves`` → (W, phase, trunk, rgb head, semantic head), each MLP a
    list of its ``(w, b)`` pairs; each head has three layers."""
    W, phase, *rest = leaves
    pairs = list(zip(rest[0::2], rest[1::2]))
    return W, phase, pairs[:-6], pairs[-6:-3], pairs[-3:]


def fused_field_volrend_lossgrad_plain(
    leaves, u, sh, dt, tm, pix, dgt, lab, bk, S: int, compute_dtype=torch.bfloat16,
):
    """The same outputs as ``fused_field_volrend_lossgrad`` from plain
    PyTorch ops and autograd; ``compute_dtype`` is the field's matmul
    dtype (the kernel's is bf16)."""
    W, phase, trunk, head, semh = _split(leaves)
    N = u.shape[0]
    R = N // S
    with torch.enable_grad():
        h = apply_layers(trunk, encode_plain(W, phase, u, compute_dtype), compute_dtype)
        raw, geo = h[:, 0], h[:, 1:]
        sel = ((u > 0.0) & (u < 1.0)).all(dim=-1)
        sigma = trunc_exp(raw - 1.0) * sel
        x = torch.cat([sh.repeat_interleave(S, dim=0), geo], dim=-1)
        rgb = torch.sigmoid(apply_layers(head, x, compute_dtype))
        sem = apply_layers(semh, geo, compute_dtype)
        # render_weight_from_density with the miss mask folded into dt
        w, _, _ = fused_render_weights_plain(
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


_p = ctypes.c_void_p


class _FvrArgs(ctypes.Structure):
    """Every pointer and size of one call; mirrors ``FvrArgs`` in
    ``csrc/fused_field_volrend.cu`` field by field."""

    _fields_ = (
        [(n, _p) for n in ("u", "sh", "dt", "tm", "pix", "dgt", "lab", "bk", "W", "phase")]
        + [("tw", _p * 4), ("tb", _p * 4), ("rw", _p * 3), ("rb", _p * 3),
           ("sw", _p * 3), ("sb", _p * 3)]
        + [("enc", _p), ("h", _p * 3)]
        + [(n, _p) for n in (
            "xr", "hr1", "hr2", "hs1", "hs2", "sigma", "dsd", "rgb", "sem", "graw",
            "gout_rgb", "gout_sem", "ray_part", "gtrb")]
        + [("gh", _p * 3)]
        + [(n, _p) for n in ("gr1", "gr2", "gs1", "gs2", "tile_part", "w", "lossrows")]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "n_rows_pad", "n_rays", "n_samples", "m", "hidden", "n_layers",
            "trunk_out_pad", "geo", "head_hidden", "n_classes", "c_pad")]
        + [(n, ctypes.c_float) for n in ("c_rgb", "c_dep", "c_sem")]
    )


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.bfloat16, device=w.device)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _padded_bias(b: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.float32, device=b.device)
    out[: b.shape[0]] = b
    return out


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_field_volrend_lossgrad: {name} must be {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_field_volrend_lossgrad: {name} must be contiguous")


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
    dev = u.device
    N = u.shape[0]
    if not 0 < S <= MAX_SAMPLES or N == 0 or N % S:
        raise ValueError(
            f"fused_field_volrend_lossgrad: N={N} must be a positive multiple of "
            f"S={S} <= {MAX_SAMPLES}"
        )
    R = N // S
    if len(leaves) % 2:
        raise ValueError("fused_field_volrend_lossgrad: W, phase, then (w, b) pairs")
    W, phase, trunk, head, semh = _split(leaves)
    if len(trunk) not in (3, 4):
        raise ValueError(
            "fused_field_volrend_lossgrad: the trunk needs 2 or 3 hidden layers and "
            "each head 2"
        )
    M, H = W.shape[1], trunk[0][0].shape[1]
    out_t = trunk[-1][0].shape[1]
    G = out_t - 1
    hh = head[0][0].shape[1]
    C = semh[-1][0].shape[1]
    if M % 16 or H % 16 or hh % 16 or G > 16 or C > MAX_CLASSES:
        raise ValueError(
            f"fused_field_volrend_lossgrad: unsupported widths M={M} H={H} head={hh} "
            f"geo={G} classes={C} (M, H and the head multiples of 16, geo <= 16, "
            f"classes <= {MAX_CLASSES})"
        )
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("u", u, f32, (N, 3)), ("sh", sh, f32, (R, 16)), ("dt", dt, f32, (N,)),
        ("tm", tm, f32, (N,)), ("pix", pix, f32, (R, 3)), ("dgt", dgt, f32, (R,)),
        ("lab", lab, torch.int32, (R,)), ("bk", bk, f32, (3,)),
        ("W", W, f32, (3, M)), ("phase", phase, f32, (M,)),
    ):
        _check(t, name, dtype, shape, dev)
    widths = [(2 * M, H)] + [(H, H)] * (len(trunk) - 2) + [(H, out_t)]
    for i, ((w, b), s) in enumerate(zip(trunk, widths)):
        _check(w, f"mlp_base.w{i}", f32, s, dev)
        _check(b, f"mlp_base.b{i}", f32, (s[1],), dev)
    for mlp_name, layers, shapes in (
        ("mlp_head", head, [(16 + G, hh), (hh, hh), (hh, 3)]),
        ("mlp_sem", semh, [(G, hh), (hh, hh), (hh, C)]),
    ):
        for i, ((w, b), s) in enumerate(zip(layers, shapes)):
            _check(w, f"{mlp_name}.w{i}", f32, s, dev)
            _check(b, f"{mlp_name}.b{i}", f32, (s[1],), dev)
    lib = build.library()
    nh = len(trunk) - 1
    Np = -(-N // 64) * 64
    tpad, cpad = _ceil16(out_t), _ceil16(C)
    bf16 = torch.bfloat16

    # bf16 weights, zero-padded to the kernels' widths; f32 biases
    tws = [w.to(bf16).contiguous() for w, _ in trunk[:-1]] + [_padded(trunk[-1][0], H, tpad)]
    tbs = [b for _, b in trunk[:-1]] + [_padded_bias(trunk[-1][1], tpad)]
    rws = [_padded(head[0][0], 32, hh), head[1][0].to(bf16).contiguous(),
           _padded(head[2][0], hh, 16)]
    rbs = [head[0][1], head[1][1], _padded_bias(head[2][1], 16)]
    sws = [_padded(semh[0][0], 16, hh), semh[1][0].to(bf16).contiguous(),
           _padded(semh[2][0], hh, cpad)]
    sbs = [semh[0][1], semh[1][1], _padded_bias(semh[2][1], cpad)]

    def buf(shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device=dev)

    s = {
        "enc": buf((Np, 2 * M)), "h": [buf((Np, H)) for _ in range(nh)],
        "xr": buf((Np, 32)), "hr1": buf((Np, hh)), "hr2": buf((Np, hh)),
        "hs1": buf((Np, hh)), "hs2": buf((Np, hh)),
        "sigma": buf((N,), f32), "dsd": buf((N,), f32), "rgb": buf((N, 3), f32),
        "sem": buf((N, C), f32), "graw": buf((N,), f32),
        "gout_rgb": buf((Np, 16)), "gout_sem": buf((Np, cpad)),
        "ray_part": buf((R, 16 + cpad), f32), "gtrb": buf((Np, tpad)),
        "gh": [buf((Np, H)) for _ in range(nh)],
        "gr1": buf((Np, hh)), "gr2": buf((Np, hh)), "gs1": buf((Np, hh)),
        "gs2": buf((Np, hh)),
    }
    w_out = buf((N,), f32)
    lossrows = buf((3, R), f32)
    a = _FvrArgs()
    for name, t in (("u", u), ("sh", sh), ("dt", dt), ("tm", tm), ("pix", pix),
                    ("dgt", dgt), ("lab", lab), ("bk", bk)):
        setattr(a, name, t.data_ptr())
    a.W, a.phase = W.data_ptr(), phase.data_ptr()
    for dst, ts in ((a.tw, tws), (a.tb, tbs), (a.rw, rws), (a.rb, rbs), (a.sw, sws),
                    (a.sb, sbs), (a.h, s["h"]), (a.gh, s["gh"])):
        for i, t in enumerate(ts):
            dst[i] = t.data_ptr()
    for name, t in s.items():
        if torch.is_tensor(t):
            setattr(a, name, t.data_ptr())
    a.w, a.lossrows = w_out.data_ptr(), lossrows.data_ptr()
    a.n_rows, a.n_rows_pad, a.n_rays, a.n_samples = N, Np, R, S
    a.m, a.hidden, a.n_layers, a.trunk_out_pad, a.geo = M, H, len(trunk), tpad, G
    a.head_hidden, a.n_classes, a.c_pad = hh, C, cpad
    a.c_rgb, a.c_dep, a.c_sem = (c / n for c, n in zip(LOSS_WEIGHTS, _term_sizes(R)))
    ref = ctypes.addressof(a)
    for which in (0, 1):
        if lib.apnerf_fvr_smem(ref, which) > _MAX_SMEM:
            raise ValueError("fused_field_volrend_lossgrad: widths too large for shared memory")
    n_bias = lib.apnerf_fvr_n_bias(ref)
    tile_part = buf((Np // 64, n_bias), f32)
    a.tile_part = tile_part.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, *args):
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"fused_field_volrend_lossgrad: CUDA launch failed, error {err}")

    run(lib.apnerf_fvr_field_fwd, ref)
    run(lib.apnerf_fvr_rays, ref)
    run(lib.apnerf_fvr_field_bwd, ref)

    # weight gradients X^T dY, in the leaves' order: (X, ld X, readable X
    # columns, rows of dW, dY, ld dY, columns of dW)
    xr_geo = s["xr"].data_ptr() + 16 * 2  # the sem head's input: xr[:, 16:]
    jobs = [(s["enc"].data_ptr(), 2 * M, 2 * M, 2 * M, s["gh"][0].data_ptr(), H, H)]
    for l in range(1, nh):
        jobs.append((s["h"][l - 1].data_ptr(), H, H, H, s["gh"][l].data_ptr(), H, H))
    jobs += [
        (s["h"][nh - 1].data_ptr(), H, H, H, s["gtrb"].data_ptr(), tpad, out_t),
        (s["xr"].data_ptr(), 32, 32, 16 + G, s["gr1"].data_ptr(), hh, hh),
        (s["hr1"].data_ptr(), hh, hh, hh, s["gr2"].data_ptr(), hh, hh),
        (s["hr2"].data_ptr(), hh, hh, hh, s["gout_rgb"].data_ptr(), 16, 3),
        (xr_geo, 32, 16, G, s["gs1"].data_ptr(), hh, hh),
        (s["hs1"].data_ptr(), hh, hh, hh, s["gs2"].data_ptr(), hh, hh),
        (s["hs2"].data_ptr(), hh, hh, hh, s["gout_sem"].data_ptr(), cpad, C),
    ]
    offs, total = [], 0
    for job in jobs:
        offs.append(total)
        total += job[3] * job[6]
    rows_per_chunk = 64 * -(-(Np // 64) // _N_CHUNKS)
    n_chunks = -(-Np // rows_per_chunk)
    P = buf((n_chunks, total), f32)
    for job, off in zip(jobs, offs):
        X, ldx, xc, din, Y, ldy, dout = job
        run(lib.apnerf_xt_dy, X, ldx, xc, din, Y, ldy, dout, Np, rows_per_chunk, n_chunks,
            P.data_ptr(), total, off)
    gw, gb, gr = buf((total,), f32), buf((n_bias,), f32), buf((16 + cpad,), f32)
    run(lib.apnerf_sum_rows, P.data_ptr(), n_chunks, total, total, gw.data_ptr())
    run(lib.apnerf_sum_rows, tile_part.data_ptr(), Np // 64, n_bias, n_bias, gb.data_ptr())
    run(lib.apnerf_sum_rows, s["ray_part"].data_ptr(), R, 16 + cpad, 16 + cpad,
        gr.data_ptr())
    fused_field_volrend_lossgrad.launches += 1

    dws = [gw[off: off + job[3] * job[6]].view(job[3], job[6]) for job, off in zip(jobs, offs)]
    off_gtr = nh * H
    off_r1 = off_gtr + tpad
    off_s1 = off_r1 + 2 * hh
    off_dph = off_s1 + 2 * hh
    dbs = [gb[l * H: (l + 1) * H] for l in range(nh)] + [
        gb[off_gtr: off_gtr + out_t],
        gb[off_r1: off_r1 + hh], gb[off_r1 + hh: off_r1 + 2 * hh], gr[:3],
        gb[off_s1: off_s1 + hh], gb[off_s1 + hh: off_s1 + 2 * hh], gr[16: 16 + C],
    ]
    grads = [gb[off_dph + M: off_dph + 4 * M].view(3, M), gb[off_dph: off_dph + M]]
    for dw, db in zip(dws, dbs):
        grads += [dw, db]
    return lossrows, w_out, grads


# wrapper calls that launched the kernels since the counter was last reset
# (chip_smoke.py reads it)
fused_field_volrend_lossgrad.launches = 0
