"""Spectral encode + trunk in one CUDA kernel, and the ReLU MLP alone in
one CUDA kernel, each with its backward: the field's wgmma tile with the
heads left out (``csrc/field_tile.cuh``; the launches are
``trunk_fwd_kernel`` of ``csrc/fused_field_heads.cu`` and the field
forward, backward and weight gradients of ``csrc/fused_field_volrend.cu``).

Port of ``apnerf_tpu/ops/pallas/fused_mlp.py::fused_spectral_field`` and
``::fused_mlp_apply``. ``fused_spectral_field`` and ``fused_mlp_apply``
launch the kernels for CUDA tensors and take the plain PyTorch versions,
``fused_spectral_field_plain`` and ``fused_mlp_apply_plain``, only for CPU
tensors. The plain versions are the chains the JAX package runs off the
TPU (``spectral._encode_math``, then ``apply_mlp`` in bf16), which add
each hidden bias in bf16 after rounding; the kernels, like the Pallas
kernels, add it in f32 before rounding. The two agree to bf16 precision.

The forwards (``field_train.TrunkForwardCall``) form the encode (or read
x, rounding an f32 x to bf16) and the trunk one layer after the other on
the tile, y = the f32 output layer, 16 of its columns at a time. A call
that asks for gradients goes through a ``torch.autograd.Function`` that
keeps its inputs only. The backwards (``fused_spectral_field_bwd``,
``fused_mlp_apply_bwd``; ``field_train.TrunkTrainCall``) recompute the
encode (or read x) and the hidden layers with the bf16 activations saved,
go back from the output's cotangent, rounded to bf16, through the trunk,
and reduce the weight gradients in a fixed order: every layer's dW and
db, then dW_spec, dphase and du, or dx in x's dtype. Both directions take
one set of widths (``field_images.check_trunk``): H from 1 to 1024 on the
instances H in 64, 128, 256, 512, 1024 (a trunk between two zero-padded up
to the next), 2 or 3 hidden layers, any output width, and the encode of
any number of frequencies or an input x of any width that is a multiple
of 16 (past H = 512: at most 256 frequencies or 512 input columns, an
output of at most 1024). A deeper trunk, or one wider than 1024, raises on
the card before any launch. The plain backwards are autograd through the
plain forwards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...models.nn import MLP, apply_layers, apply_mlp
from .launch import check_tensor, needs_grad


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


def _launch_spectral_forward(W, phase, layers, u):
    from .field_train import TrunkForwardCall  # field_train imports this module

    y = TrunkForwardCall("fused_spectral_field", layers, W=W, phase=phase, u=u).run()
    if u.shape[0]:
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
    tensor launches the kernels or raises: the tile takes the trunks of
    ``field_images.check_trunk``."""
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
    """→ [N, Dout] f32. A CUDA tensor launches the kernel or raises (the
    widths of ``field_images.check_trunk``). Differentiable in W, phase,
    the trunk's parameters and u."""
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


def _launch_mlp_forward(layers, x):
    from .field_train import TrunkForwardCall  # field_train imports this module

    who = "fused_mlp_apply"
    _check_x(who, x)
    y = TrunkForwardCall(who, layers, x=x).run()
    if x.shape[0]:
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
    raises: the tile takes the trunks of ``field_images.check_trunk``."""
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
    layers, Din a multiple of 16, H up to 1024; x [N, Din] in bf16 or f32 (a
    bf16 x is read as it is), y [N, Dout] f32. A CUDA tensor launches the
    kernel or raises. Differentiable in the parameters and x (dx in x's
    dtype)."""
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
