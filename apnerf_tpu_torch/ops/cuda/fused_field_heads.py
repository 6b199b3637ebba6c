"""The whole main field per sample in one CUDA kernel
(``csrc/fused_field_heads.cu``).

Port of ``apnerf_tpu/ops/pallas/fused_field_heads.py::fused_field_heads``,
forward and backward: spectral encode, trunk, density (``trunc_exp(raw - 1)`` times
the in-cube selector), the rgb head on SH(direction) ⊕ geometry features
(sigmoid applied) and the semantic head, packed per sample.
``fused_field_heads`` launches the kernel for CUDA tensors and takes
``fused_field_heads_plain`` only for CPU tensors. Both take the field's
parameters as one flat list (``list(field.parameters())``). A call that
asks for gradients goes through a ``torch.autograd.Function`` whose
backward, ``fused_field_heads_bwd``, recomputes the field with its
activations saved (as the TPU kernel recomputes), turns the packed
cotangent into per-sample cotangents (the sigmoid's and ``trunc_exp``'s
derivatives) and runs the field backward (``field_train.py``): gradients
of every leaf and of ``u``; ``sh`` gets none, as in the JAX VJP.

Layout (the port's, not the TPU's ``[channels, N]``): the output is
row-major ``[N, 4 + C]`` f32, columns 0:3 rgb, 3 sigma, 4: the C logits;
the SH features come per ray ``[R, 16]`` and sample ``n`` belongs to ray
``n // S``.

The module also holds what every kernel of the main field shares on the
Python side: the flat-list split, the plain field and the padded bf16
weights the kernels read (``prepare_field``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ...models.ngp import trunc_exp
from ...models.nn import apply_layers
from . import build
from .fused_mlp import encode_plain
from .launch import MAX_SMEM, check_tensor, needs_grad

MAX_CLASSES = 64

_p = ctypes.c_void_p


def split_leaves(leaves: Sequence[torch.Tensor]):
    """``leaves`` → (W, phase, trunk, rgb head, semantic head), each MLP a
    list of its ``(w, b)`` pairs; each head has three layers."""
    W, phase, *rest = leaves
    pairs = list(zip(rest[0::2], rest[1::2]))
    return W, phase, pairs[:-6], pairs[-6:-3], pairs[-3:]


def field_plain(leaves, u, sh, S: int, compute_dtype=torch.bfloat16):
    """The main field as plain PyTorch ops → (rgb [N, 3], sigma [N],
    sem [N, C]); hidden biases are added in ``compute_dtype`` after
    rounding, as ``apply_mlp`` does."""
    W, phase, trunk, head, semh = split_leaves(leaves)
    h = apply_layers(trunk, encode_plain(W, phase, u, compute_dtype), compute_dtype)
    raw, geo = h[:, 0], h[:, 1:]
    sel = ((u > 0.0) & (u < 1.0)).all(dim=-1)
    sigma = trunc_exp(raw - 1.0) * sel
    x = torch.cat([sh.repeat_interleave(S, dim=0), geo], dim=-1)
    rgb = torch.sigmoid(apply_layers(head, x, compute_dtype))
    sem = apply_layers(semh, geo, compute_dtype)
    return rgb, sigma, sem


def fused_field_heads_plain(leaves, u, sh, S: int, compute_dtype=torch.bfloat16):
    """The same output as ``fused_field_heads`` from plain PyTorch ops."""
    rgb, sigma, sem = field_plain(leaves, u, sh, S, compute_dtype)
    return torch.cat([rgb, sigma[:, None], sem], dim=-1)


class FieldParamsStruct(ctypes.Structure):
    """Mirrors ``FieldParams`` in ``csrc/field_heads_tile.cuh`` field by field."""

    _fields_ = (
        [("W", _p), ("phase", _p), ("tw", _p * 4), ("tb", _p * 4), ("rw", _p * 3),
         ("rb", _p * 3), ("sw", _p * 3), ("sb", _p * 3)]
        + [(n, ctypes.c_int) for n in (
            "m", "hidden", "n_layers", "trunk_out_pad", "geo", "head_hidden", "n_classes",
            "c_pad")]
    )


class _FfhArgs(ctypes.Structure):
    """Mirrors ``FfhArgs`` in ``csrc/fused_field_heads.cu`` field by field."""

    _fields_ = [("u", _p), ("sh", _p), ("y", _p), ("p", FieldParamsStruct),
                ("n_rows", ctypes.c_int), ("n_rows_pad", ctypes.c_int),
                ("n_samples", ctypes.c_int)]


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


class PreparedField(NamedTuple):
    """A main field as the kernels read it. The tensor lists keep the
    padded copies alive for as long as ``params`` points at them."""

    params: FieldParamsStruct
    M: int
    H: int
    out_t: int  # trunk output width, 1 + G
    G: int
    hh: int  # head width
    C: int
    tpad: int
    cpad: int
    n_trunk: int  # trunk weight matrices, 3 or 4
    tws: List[torch.Tensor]
    tbs: List[torch.Tensor]
    rws: List[torch.Tensor]
    rbs: List[torch.Tensor]
    sws: List[torch.Tensor]
    sbs: List[torch.Tensor]


def prepare_field(who: str, leaves: Sequence[torch.Tensor], dev) -> PreparedField:
    """Check the field's leaves (f32, contiguous, on ``dev``, widths the
    kernels take) and make the bf16 weights, zero-padded to the kernels'
    widths, and the f32 biases."""
    if len(leaves) % 2:
        raise ValueError(f"{who}: W, phase, then (w, b) pairs")
    W, phase, trunk, head, semh = split_leaves(leaves)
    if len(trunk) not in (3, 4):
        raise ValueError(f"{who}: the trunk needs 2 or 3 hidden layers and each head 2")
    M, H = W.shape[1], trunk[0][0].shape[1]
    out_t = trunk[-1][0].shape[1]
    G = out_t - 1
    hh = head[0][0].shape[1]
    C = semh[-1][0].shape[1]
    if M % 16 or H % 16 or hh % 16 or G > 16 or C > MAX_CLASSES:
        raise ValueError(
            f"{who}: unsupported widths M={M} H={H} head={hh} geo={G} classes={C} "
            f"(M, H and the head multiples of 16, geo <= 16, classes <= {MAX_CLASSES})"
        )
    f32, bf16 = torch.float32, torch.bfloat16
    check_tensor(who, W, "W", f32, (3, M), dev)
    check_tensor(who, phase, "phase", f32, (M,), dev)
    widths = [(2 * M, H)] + [(H, H)] * (len(trunk) - 2) + [(H, out_t)]
    for mlp_name, layers, shapes in (
        ("mlp_base", trunk, widths),
        ("mlp_head", head, [(16 + G, hh), (hh, hh), (hh, 3)]),
        ("mlp_sem", semh, [(G, hh), (hh, hh), (hh, C)]),
    ):
        for i, ((w, b), s) in enumerate(zip(layers, shapes)):
            check_tensor(who, w, f"{mlp_name}.w{i}", f32, s, dev)
            check_tensor(who, b, f"{mlp_name}.b{i}", f32, (s[1],), dev)
    tpad, cpad = _ceil16(out_t), _ceil16(C)
    tws = [w.to(bf16).contiguous() for w, _ in trunk[:-1]] + [_padded(trunk[-1][0], H, tpad)]
    tbs = [b for _, b in trunk[:-1]] + [_padded_bias(trunk[-1][1], tpad)]
    rws = [_padded(head[0][0], 32, hh), head[1][0].to(bf16).contiguous(),
           _padded(head[2][0], hh, 16)]
    rbs = [head[0][1], head[1][1], _padded_bias(head[2][1], 16)]
    sws = [_padded(semh[0][0], 16, hh), semh[1][0].to(bf16).contiguous(),
           _padded(semh[2][0], hh, cpad)]
    sbs = [semh[0][1], semh[1][1], _padded_bias(semh[2][1], cpad)]
    p = FieldParamsStruct()
    p.W, p.phase = W.data_ptr(), phase.data_ptr()
    for dst, ts in ((p.tw, tws), (p.tb, tbs), (p.rw, rws), (p.rb, rbs), (p.sw, sws),
                    (p.sb, sbs)):
        for i, t in enumerate(ts):
            dst[i] = t.data_ptr()
    p.m, p.hidden, p.n_layers, p.trunk_out_pad, p.geo = M, H, len(trunk), tpad, G
    p.head_hidden, p.n_classes, p.c_pad = hh, C, cpad
    return PreparedField(p, M, H, out_t, G, hh, C, tpad, cpad, len(trunk),
                         tws, tbs, rws, rbs, sws, sbs)


def launch_field_rows(lib, fld: PreparedField, u_ptr: int, sh_ptr: int, y_ptr: int,
                      n_rows: int, S: int, stream: int) -> int:
    """Launch the packed field kernel on ``n_rows`` rows starting at the
    given addresses → the CUDA error code."""
    a = _FfhArgs()
    a.u, a.sh, a.y, a.p = u_ptr, sh_ptr, y_ptr, fld.params
    a.n_rows, a.n_rows_pad, a.n_samples = n_rows, -(-n_rows // 64) * 64, S
    return lib.apnerf_ffh_fwd(ctypes.addressof(a), stream)


def check_field_smem(who: str, lib, fld: PreparedField):
    a = _FfhArgs()
    a.p = fld.params
    if lib.apnerf_ffh_smem(ctypes.addressof(a)) > MAX_SMEM:
        raise ValueError(f"{who}: widths too large for shared memory")


def _launch_forward(leaves, u, sh, S):
    who = "fused_field_heads"
    dev, N = u.device, u.shape[0]
    fld = prepare_field(who, leaves, dev)
    lib = build.library()
    check_field_smem(who, lib, fld)
    y = torch.empty((N, 4 + fld.C), dtype=torch.float32, device=dev)
    err = launch_field_rows(lib, fld, u.data_ptr(), sh.data_ptr(), y.data_ptr(), N, S,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: CUDA launch failed, error {err}")
    fused_field_heads.launches += 1
    return y


def fused_field_heads_bwd_plain(leaves, u, sh, S: int, g, need_du: bool = False,
                                compute_dtype=torch.bfloat16):
    """The same outputs as ``fused_field_heads_bwd`` by autograd through the
    plain forward."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    u = u.detach().requires_grad_(need_du)
    with torch.enable_grad():
        y = fused_field_heads_plain(leaves, u, sh, S, compute_dtype)
        grads = torch.autograd.grad(y, leaves + ([u] if need_du else []), g)
    return list(grads[: len(leaves)]), (grads[-1] if need_du else None)


@torch.no_grad()
def fused_field_heads_bwd(
    leaves: Sequence[torch.Tensor],
    u: torch.Tensor,  # [N, 3]
    sh: torch.Tensor,  # [R, 16]
    S: int,
    g: torch.Tensor,  # [N, 4 + C] f32 cotangent of the packed output
    need_du: bool = False,
    compute_dtype=torch.bfloat16,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of ``fused_field_heads`` → (one gradient per leaf, in
    ``leaves``' order; du [N, 3] or None). A CUDA tensor launches the
    kernels or raises."""
    who = "fused_field_heads_bwd"
    if u.device.type == "cpu":
        return fused_field_heads_bwd_plain(leaves, u, sh, S, g, need_du, compute_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{who}: the CUDA kernel computes in bf16")
    from .field_train import FieldTrainCall  # field_train imports this module

    call = FieldTrainCall(who, leaves, u, sh, S, need_du)
    check_tensor(who, g, "g", torch.float32, (call.N, 4 + call.fld.C), call.dev)
    call.set_inputs(g_packed=g)
    call.field_forward()
    call.run(call.lib.apnerf_ffh_bwd_pack, call.ref)
    out = call.field_backward()
    fused_field_heads_bwd.launches += 1
    return out


class _FieldHeads(torch.autograd.Function):
    """y = f(u, sh, *leaves); the forward keeps its inputs only."""

    @staticmethod
    def forward(ctx, S, u, sh, *leaves):
        ctx.S = S
        ctx.save_for_backward(u, sh, *leaves)
        return _launch_forward(leaves, u, sh, S)

    @staticmethod
    def backward(ctx, g):
        u, sh, *leaves = ctx.saved_tensors
        grads, du = fused_field_heads_bwd(
            leaves, u, sh, ctx.S, g.float().contiguous(), ctx.needs_input_grad[1])
        # the SH features are a fixed function of the ray directions
        return (None, du, None, *grads)


def fused_field_heads(
    leaves: Sequence[torch.Tensor],  # W [3, M], phase [M], then the (w, b) pairs of
    # the trunk's, the rgb head's and the semantic head's layers, in order; f32
    u: torch.Tensor,  # [N, 3] f32 unit-cube coordinates, N = R * S
    sh: torch.Tensor,  # [R, 16] f32 SH of the ray directions
    S: int,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """→ packed [N, 4 + C] f32: rgb, sigma, semantic logits. A CUDA tensor
    launches the kernel or raises. Differentiable in the leaves and ``u``
    (``sh`` gets no gradient); the backward keeps every row's activations
    at once."""
    who = "fused_field_heads"
    if u.device.type == "cpu":
        return fused_field_heads_plain(leaves, u, sh, S, compute_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{who}: the CUDA kernel computes in bf16")
    dev = u.device
    N = u.shape[0]
    if S <= 0 or N == 0 or N % S:
        raise ValueError(f"{who}: N={N} must be a positive multiple of S={S}")
    check_tensor(who, u, "u", torch.float32, (N, 3), dev)
    check_tensor(who, sh, "sh", torch.float32, (N // S, 16), dev)
    if needs_grad(*leaves, u):
        return _FieldHeads.apply(S, u, sh, *leaves)
    return _launch_forward(leaves, u, sh, S)


# wrapper calls that launched the kernels since the counters were last reset
# (chip_smoke.py reads them)
fused_field_heads.launches = 0
fused_field_heads_bwd.launches = 0
