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

The forwards take any width that is a multiple of 16 (``csrc/fused_mlp.cu``,
a wmma tile). A call that asks for gradients goes through a
``torch.autograd.Function`` that keeps its inputs only. The backwards
(``fused_spectral_field_bwd``, ``fused_mlp_apply_bwd``) run on the field's
wgmma tile with the heads left out (``field_train.TrunkTrainCall``):
they recompute the encode (or read x) and the hidden layers with the bf16
activations saved, go back from the output's cotangent, rounded to bf16,
through the trunk, and reduce the weight gradients in a fixed order: every
layer's dW and db, then dW_spec, dphase and du, or dx in x's dtype. They
take the tile's widths (``field_images.check_trunk``): H a multiple of 16
up to 256, 2 or 3 hidden layers, an output of at most 16, and the encode
of a multiple of 8 up to 128 frequencies or an input x a multiple of 16
up to 256 wide, zero-padded up to the next of the tile's instances (H in
64, 128, 256; M in 32, 64, 128). A wider trunk, which the forwards take,
raises on the card. The plain backwards are autograd through the plain
forwards.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.nn import MLP, apply_layers, apply_mlp
from . import build
from .launch import MAX_SMEM, check_tensor, launcher, needs_grad


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
        + [("w", _p * 4), ("b", _p * 4), ("y", _p)]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "n_rows_pad", "m", "din", "hidden", "n_layers", "out_pad", "out",
            "x_f32")]
    )


class _Call:
    """One forward launch over ``N`` rows of an MLP [din, H, ..., H, out]:
    the checked layers as the kernel reads them (bf16 weights, the last
    zero-padded to 16 columns, f32 biases) and the argument struct."""

    def __init__(self, who: str, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 N: int, din: int, dev, m: int = 0):
        if len(layers) not in (3, 4):
            raise ValueError(f"{who}: the MLP needs 2 or 3 hidden layers")
        H, out = layers[0][0].shape[1], layers[-1][0].shape[1]
        if H % 16 or din % 16:
            raise ValueError(f"{who}: widths must be multiples of 16, got {din} and {H}")
        shapes = [(din, H)] + [(H, H)] * (len(layers) - 2) + [(H, out)]
        for i, ((w, b), s) in enumerate(zip(layers, shapes)):
            check_tensor(who, w, f"w{i}", torch.float32, s, dev)
            check_tensor(who, b, f"b{i}", torch.float32, (s[1],), dev)
        self.dev, self.N, self.out = dev, N, out
        out_pad = -(-out // 16) * 16
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
        a.n_rows, a.n_rows_pad, a.m, a.din, a.hidden = N, -(-N // 64) * 64, m, din, H
        a.n_layers, a.out_pad, a.out = len(layers), out_pad, out
        self.ref = ctypes.addressof(a)
        self.lib = build.library()
        if self.lib.apnerf_mlp_smem(self.ref) > MAX_SMEM:
            raise ValueError(f"{who}: the MLP is too wide for shared memory")
        self.run = launcher(who, dev)


def _spectral_call(who, W, phase, layers, u) -> _Call:
    dev, N, M = u.device, u.shape[0], W.shape[1]
    check_tensor(who, u, "u", torch.float32, (N, 3), dev)
    check_tensor(who, W, "W", torch.float32, (3, M), dev)
    check_tensor(who, phase, "phase", torch.float32, (M,), dev)
    call = _Call(who, layers, N, 2 * M, dev, m=M)
    call.a.u, call.a.W, call.a.phase = u.data_ptr(), W.data_ptr(), phase.data_ptr()
    return call


def _launch_spectral_forward(W, phase, layers, u):
    call = _spectral_call("fused_spectral_field", W, phase, layers, u)
    y = torch.empty((call.N, call.out), dtype=torch.float32, device=call.dev)
    if call.N == 0:
        return y
    call.a.y = y.data_ptr()
    call.run(call.lib.apnerf_mlp_fwd, call.ref, 1)
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
    tensor launches the kernels or raises: the tile takes M up to 128 and
    the trunks of ``field_images.check_trunk``."""
    who = "fused_spectral_field_bwd"
    if u.device.type == "cpu":
        return fused_spectral_field_bwd_plain(W, phase, layers, u, g, need_du)
    if u.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {u.device}")
    from .field_train import TrunkTrainCall  # field_train imports this module

    call = TrunkTrainCall(who, layers, g, W=W, phase=phase, u=u, need_du=need_du)
    grads, (dW, dphase), du, _ = call.run_all()
    fused_spectral_field_bwd.launches += 1
    return dW, dphase, grads, du


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


def _check_x(who, x):
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{who}: x must be [N, Din] bf16 or f32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    check_tensor(who, x, "x", x.dtype, x.shape, x.device)


def _mlp_call(who, layers, x) -> _Call:
    _check_x(who, x)
    call = _Call(who, layers, x.shape[0], x.shape[1], x.device)
    call.a.x, call.a.x_f32 = x.data_ptr(), int(x.dtype == torch.float32)
    return call


def _launch_mlp_forward(layers, x):
    call = _mlp_call("fused_mlp_apply", layers, x)
    y = torch.empty((call.N, call.out), dtype=torch.float32, device=call.dev)
    if call.N == 0:
        return y
    call.a.y = y.data_ptr()
    call.run(call.lib.apnerf_mlp_fwd, call.ref, 0)
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
    raises: the tile takes Din up to 256 and the trunks of
    ``field_images.check_trunk``."""
    who = "fused_mlp_apply_bwd"
    if x.device.type == "cpu":
        return fused_mlp_apply_bwd_plain(layers, x, g, need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    _check_x(who, x)
    from .field_train import TrunkTrainCall  # field_train imports this module

    call = TrunkTrainCall(who, layers, g, x=x, need_dx=need_dx)
    grads, _, _, dx = call.run_all()
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
