"""Spectral encode + trunk in one CUDA kernel, and the ReLU MLP alone in
one CUDA kernel (``csrc/fused_mlp.cu``), each with its backward.

Port of ``apnerf_tpu/ops/pallas/fused_mlp.py::fused_spectral_field`` and
``::fused_mlp_apply``. ``fused_spectral_field`` and ``fused_mlp_apply``
launch the kernels for CUDA tensors and take the plain PyTorch versions,
``fused_spectral_field_plain`` and ``fused_mlp_apply_plain``, only for CPU
tensors. The plain versions are the chains the JAX package runs off the
TPU (``spectral._encode_math``, then ``apply_mlp`` in bf16), which add
each hidden bias in bf16 after rounding; the kernels, like the Pallas
kernels, add it in f32 before rounding. The two agree to bf16 precision.

A call that asks for gradients goes through a ``torch.autograd.Function``
that keeps its inputs only. The backwards (``fused_spectral_field_bwd``,
``fused_mlp_apply_bwd``) recompute the forward with the bf16 activations
saved, go back through the trunk on 64-row tiles and reduce the weight
gradients in a fixed order (``launch.weight_grads``): every layer's
dW and db, then dW_spec, dphase and du, or dx in x's dtype. The plain
backwards are autograd through the plain forwards.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.nn import MLP, apply_layers, apply_mlp
from . import build
from .launch import MAX_SMEM, check_tensor, launcher, needs_grad, weight_grads


def encode_plain(W, phase, u, dtype):
    """[cos, sin](2π·u·W + φ) in ``dtype``, with u and W rounded to
    ``dtype`` and the K=3 product taken in f32 (``spectral.py:124-135``:
    a bf16 matmul output would round the phase with an ulp of 256 rad)."""
    proj = (u.to(dtype).float() @ W.to(dtype).float()) * (2 * np.pi) + phase
    return torch.cat([torch.cos(proj).to(dtype), torch.sin(proj).to(dtype)], -1)


def fused_spectral_field_plain(W, phase, params: MLP, u):
    """y = MLP(cos/sin(2π·u·W + φ)) as plain PyTorch ops, bf16 compute."""
    enc = encode_plain(W, phase, u, torch.bfloat16)
    return apply_mlp(params, enc, compute_dtype=torch.bfloat16)


def fused_mlp_apply_plain(params: MLP, x):
    """y = MLP(x) as plain PyTorch ops, bf16 compute, f32 out."""
    return apply_mlp(params, x, compute_dtype=torch.bfloat16)


_p = ctypes.c_void_p


class _MlpArgs(ctypes.Structure):
    """Mirrors ``MlpArgs`` in ``csrc/fused_mlp.cu`` field by field."""

    _fields_ = (
        [(n, _p) for n in ("u", "W", "phase", "x")]
        + [("w", _p * 4), ("b", _p * 4), ("g", _p), ("xs", _p), ("h", _p * 3), ("gout", _p),
           ("gh", _p * 3)]
        + [(n, _p) for n in ("tile_part", "y", "du", "dx")]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "n_rows_pad", "m", "din", "hidden", "n_layers", "out_pad", "out",
            "x_f32")]
    )


class _Call:
    """One launch sequence over ``N`` rows of an MLP [din, H, ..., H, out]:
    the checked layers as the kernels read them (bf16 weights, the last
    zero-padded to 16 columns, f32 biases) and the argument struct."""

    def __init__(self, who: str, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 N: int, din: int, dev, m: int = 0, backward: bool = False):
        if len(layers) not in (3, 4):
            raise ValueError(f"{who}: the MLP needs 2 or 3 hidden layers")
        H, out = layers[0][0].shape[1], layers[-1][0].shape[1]
        if H % 16 or din % 16:
            raise ValueError(f"{who}: widths must be multiples of 16, got {din} and {H}")
        shapes = [(din, H)] + [(H, H)] * (len(layers) - 2) + [(H, out)]
        for i, ((w, b), s) in enumerate(zip(layers, shapes)):
            check_tensor(who, w, f"w{i}", torch.float32, s, dev)
            check_tensor(who, b, f"b{i}", torch.float32, (s[1],), dev)
        self.who, self.dev, self.N, self.din, self.H, self.out = who, dev, N, din, H, out
        self.encode, self.nh = int(m > 0), len(layers) - 1  # m: frequencies of the encode
        self.Np = -(-N // 64) * 64
        self.out_pad = out_pad = -(-out // 16) * 16
        bf16 = torch.bfloat16
        self.ws = [w.to(bf16).contiguous() for w, _ in layers[:-1]]
        w_last = torch.zeros((H, out_pad), dtype=bf16, device=dev)
        w_last[:, :out] = layers[-1][0]
        b_last = torch.zeros(out_pad, dtype=torch.float32, device=dev)
        b_last[:out] = layers[-1][1]
        self.ws.append(w_last)
        self.bs = [b for _, b in layers[:-1]] + [b_last]
        self.a = a = _MlpArgs()
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            a.w[i], a.b[i] = w.data_ptr(), b.data_ptr()
        a.n_rows, a.n_rows_pad, a.m, a.din, a.hidden = N, self.Np, m, din, H
        a.n_layers, a.out_pad, a.out = len(layers), out_pad, out
        self.ref = ctypes.addressof(a)
        self.lib = build.library()
        for which in (0, 1) if backward else (0,):
            if self.lib.apnerf_mlp_smem(self.ref, which, self.encode) > MAX_SMEM:
                raise ValueError(f"{who}: the MLP is too wide for shared memory")
        self.run = launcher(who, dev)

    def backward(self, g: torch.Tensor):
        """Recompute with saves, go back through the trunk and reduce →
        (the layers' [dw0, db0, dw1, ...], the summed tile partials past
        the biases: dphase and dW_spec with the encode)."""
        a, lib, run, dev = self.a, self.lib, self.run, self.dev
        Np, H, nh, din, out_pad = self.Np, self.H, self.nh, self.din, self.out_pad
        check_tensor(self.who, g, "g", torch.float32, (self.N, self.out), dev)

        def buf(shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device=dev)

        xs, gout = buf((Np, din)), buf((Np, out_pad))
        hs, ghs = [buf((Np, H)) for _ in range(nh)], [buf((Np, H)) for _ in range(nh)]
        n_bias = lib.apnerf_mlp_n_bias(self.ref, self.encode)
        tile_part = buf((Np // 64, n_bias), torch.float32)
        a.g, a.xs, a.gout, a.tile_part = (t.data_ptr() for t in (g, xs, gout, tile_part))
        for i in range(nh):
            a.h[i], a.gh[i] = hs[i].data_ptr(), ghs[i].data_ptr()
        a.y = None
        run(lib.apnerf_mlp_fwd, self.ref, self.encode, 1)
        run(lib.apnerf_mlp_bwd, self.ref, self.encode)
        jobs = [(xs.data_ptr(), din, din, din, ghs[0].data_ptr(), H, H)]
        for l in range(1, nh):
            jobs.append((hs[l - 1].data_ptr(), H, H, H, ghs[l].data_ptr(), H, H))
        jobs.append((hs[nh - 1].data_ptr(), H, H, H, gout.data_ptr(), out_pad, self.out))
        dws = weight_grads(lib, run, jobs, Np, dev)
        gb = buf((n_bias,), torch.float32)
        run(lib.apnerf_sum_rows, tile_part.data_ptr(), Np // 64, n_bias, n_bias, gb.data_ptr())
        grads = []
        for l, dw in enumerate(dws):
            width = H if l < nh else self.out
            grads += [dw, gb[l * H: l * H + width]]
        return grads, gb[nh * H + out_pad:]


def _spectral_call(who, W, phase, layers, u, backward=False) -> _Call:
    dev, N, M = u.device, u.shape[0], W.shape[1]
    check_tensor(who, u, "u", torch.float32, (N, 3), dev)
    check_tensor(who, W, "W", torch.float32, (3, M), dev)
    check_tensor(who, phase, "phase", torch.float32, (M,), dev)
    call = _Call(who, layers, N, 2 * M, dev, m=M, backward=backward)
    call.a.u, call.a.W, call.a.phase = u.data_ptr(), W.data_ptr(), phase.data_ptr()
    return call


def _launch_spectral_forward(W, phase, layers, u):
    call = _spectral_call("fused_spectral_field", W, phase, layers, u)
    y = torch.empty((call.N, call.out), dtype=torch.float32, device=call.dev)
    if call.N == 0:
        return y
    call.a.y = y.data_ptr()
    call.run(call.lib.apnerf_mlp_fwd, call.ref, 1, 0)
    fused_spectral_field.launches += 1
    return y


def _pairs(flat):
    return list(zip(flat[0::2], flat[1::2]))


def fused_spectral_field_bwd_plain(W, phase, layers, u, g, need_du: bool = False):
    """The same outputs as ``fused_spectral_field_bwd`` by autograd through
    the plain forward."""
    flat = [t.detach().requires_grad_(True) for pair in layers for t in pair]
    W, phase = (t.detach().requires_grad_(True) for t in (W, phase))
    u = u.detach().requires_grad_(need_du)
    with torch.enable_grad():
        enc = encode_plain(W, phase, u, torch.bfloat16)
        y = apply_layers(_pairs(flat), enc, torch.bfloat16)
        grads = torch.autograd.grad(y, [W, phase, *flat] + ([u] if need_du else []), g)
    return grads[0], grads[1], list(grads[2: 2 + len(flat)]), (grads[-1] if need_du else None)


@torch.no_grad()
def fused_spectral_field_bwd(
    W: torch.Tensor,  # [3, M]
    phase: torch.Tensor,  # [M]
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # the trunk's (w, b) pairs
    u: torch.Tensor,  # [N, 3]
    g: torch.Tensor,  # [N, Dout] f32 cotangent of y
    need_du: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of ``fused_spectral_field`` → (dW_spec [3, M], dphase
    [M], [dw0, db0, dw1, ...] of the trunk, du [N, 3] or None). A CUDA
    tensor launches the kernels or raises."""
    who = "fused_spectral_field_bwd"
    if u.device.type == "cpu":
        return fused_spectral_field_bwd_plain(W, phase, layers, u, g, need_du)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    call = _spectral_call(who, W, phase, layers, u, backward=True)
    M = W.shape[1]
    du = torch.empty((call.N, 3), dtype=torch.float32, device=call.dev) if need_du else None
    call.a.du = du.data_ptr() if need_du else None
    grads, rest = call.backward(g)
    fused_spectral_field_bwd.launches += 1
    return rest[M: 4 * M].view(3, M), rest[:M], grads, du


class _SpectralField(torch.autograd.Function):
    """y = f(W, phase, u, w0, b0, ...); the forward keeps its inputs only."""

    @staticmethod
    def forward(ctx, W, phase, u, *flat):
        ctx.save_for_backward(W, phase, u, *flat)
        return _launch_spectral_forward(W, phase, _pairs(flat), u)

    @staticmethod
    def backward(ctx, g):
        W, phase, u, *flat = ctx.saved_tensors
        dW, dphase, grads, du = fused_spectral_field_bwd(
            W, phase, _pairs(flat), u, g.float().contiguous(), ctx.needs_input_grad[2])
        return (dW, dphase, du, *grads)


def fused_spectral_field(
    W: torch.Tensor,  # [3, M] f32
    phase: torch.Tensor,  # [M] f32
    params: MLP,  # w0 [2M, H], hidden [H, H], last [H, Dout]
    u: torch.Tensor,  # [N, 3] f32 unit-cube coords
) -> torch.Tensor:
    """→ [N, Dout] f32. A CUDA tensor launches the kernel or raises.
    Differentiable in W, phase, the trunk's parameters and u."""
    if u.device.type == "cpu":
        return fused_spectral_field_plain(W, phase, params, u)
    if u.device.type != "cuda":
        raise ValueError(f"fused_spectral_field: unsupported device {u.device}")
    layers = params.layers()
    flat = [t for pair in layers for t in pair]
    if needs_grad(W, phase, u, *flat) and u.shape[0] > 0:
        return _SpectralField.apply(W, phase, u, *flat)
    return _launch_spectral_forward(W, phase, layers, u)


def _mlp_call(who, layers, x, backward=False) -> _Call:
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{who}: x must be [N, Din] bf16 or f32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    check_tensor(who, x, "x", x.dtype, x.shape, x.device)
    call = _Call(who, layers, x.shape[0], x.shape[1], x.device, backward=backward)
    call.a.x, call.a.x_f32 = x.data_ptr(), int(x.dtype == torch.float32)
    return call


def _launch_mlp_forward(layers, x):
    call = _mlp_call("fused_mlp_apply", layers, x)
    y = torch.empty((call.N, call.out), dtype=torch.float32, device=call.dev)
    if call.N == 0:
        return y
    call.a.y = y.data_ptr()
    call.run(call.lib.apnerf_mlp_fwd, call.ref, 0, 0)
    fused_mlp_apply.launches += 1
    return y


def fused_mlp_apply_bwd_plain(layers, x, g, need_dx: bool = True):
    """The same outputs as ``fused_mlp_apply_bwd`` by autograd through the
    plain forward."""
    flat = [t.detach().requires_grad_(True) for pair in layers for t in pair]
    x = x.detach().requires_grad_(need_dx)
    with torch.enable_grad():
        y = apply_layers(_pairs(flat), x, torch.bfloat16)
        grads = torch.autograd.grad(y, flat + ([x] if need_dx else []), g)
    return list(grads[: len(flat)]), (grads[-1] if need_dx else None)


@torch.no_grad()
def fused_mlp_apply_bwd(
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # the MLP's (w, b) pairs
    x: torch.Tensor,  # [N, Din] bf16 or f32
    g: torch.Tensor,  # [N, Dout] f32 cotangent of y
    need_dx: bool = True,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of ``fused_mlp_apply`` → ([dw0, db0, dw1, ...] in f32, dx
    [N, Din] in x's dtype or None). A CUDA tensor launches the kernels or
    raises."""
    who = "fused_mlp_apply_bwd"
    if x.device.type == "cpu":
        return fused_mlp_apply_bwd_plain(layers, x, g, need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    call = _mlp_call(who, layers, x, backward=True)
    dx = torch.empty_like(x) if need_dx else None
    call.a.dx = dx.data_ptr() if need_dx else None
    grads, _ = call.backward(g)
    fused_mlp_apply_bwd.launches += 1
    return grads, dx


class _MlpApply(torch.autograd.Function):
    """y = f(x, w0, b0, ...); the forward keeps its inputs only."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return _launch_mlp_forward(_pairs(flat), x)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        grads, dx = fused_mlp_apply_bwd(
            _pairs(flat), x, g.float().contiguous(), ctx.needs_input_grad[0])
        return (dx, *grads)


def fused_mlp_apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """y = MLP(x) for a ReLU MLP [Din, H, ..., H, Dout] with 2 or 3 hidden
    layers, Din and H multiples of 16; x [N, Din] in bf16 or f32 (a bf16 x
    is read as it is), y [N, Dout] f32. A CUDA tensor launches the kernel
    or raises. Differentiable in the parameters and x (dx in x's dtype)."""
    if x.device.type == "cpu":
        return fused_mlp_apply_plain(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_apply: unsupported device {x.device}")
    layers = params.layers()
    flat = [t for pair in layers for t in pair]
    if needs_grad(x, *flat) and x.shape[0] > 0:
        return _MlpApply.apply(x, *flat)
    return _launch_mlp_forward(layers, x)


# kernel launches (the backwards: wrapper calls that launched their kernels)
# since the counters were last reset (chip_smoke.py reads them)
fused_spectral_field.launches = 0
fused_spectral_field_bwd.launches = 0
fused_mlp_apply.launches = 0
fused_mlp_apply_bwd.launches = 0
