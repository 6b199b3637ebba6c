"""Spectral encode + trunk in one CUDA kernel (``csrc/fused_mlp.cu``).

Port of ``apnerf_tpu/ops/pallas/fused_mlp.py::fused_spectral_field``,
forward only (the train step's field gradients come from the train-step
kernel, ``fused_field_volrend.py``). ``fused_spectral_field`` launches the kernel for CUDA
tensors and takes the plain PyTorch version, ``fused_spectral_field_plain``,
only for CPU tensors. The plain version is the chain the JAX package runs
off the TPU (``spectral._encode_math`` then ``apply_mlp`` in bf16), which
adds each hidden bias in bf16 after rounding; the kernel, like the Pallas
kernel, adds it in f32 before rounding. The two agree to bf16 precision.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.nn import MLP, apply_mlp
from . import build

_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


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


def _check(t, name, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_spectral_field: {name} must be {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_spectral_field: {name} must be contiguous")


def fused_spectral_field(
    W: torch.Tensor,  # [3, M] f32
    phase: torch.Tensor,  # [M] f32
    params: MLP,  # w0 [2M, H], hidden [H, H], last [H, Dout]
    u: torch.Tensor,  # [N, 3] f32 unit-cube coords
) -> torch.Tensor:
    """→ [N, Dout] f32. A CUDA tensor launches the kernel or raises."""
    if u.device.type == "cpu":
        return fused_spectral_field_plain(W, phase, params, u)
    if u.device.type != "cuda":
        raise ValueError(f"fused_spectral_field: unsupported device {u.device}")
    layers = params.layers()
    N, M = u.shape[0], W.shape[1]
    H = layers[0][0].shape[1]
    Dout = layers[-1][0].shape[1]
    dev = u.device
    if len(layers) not in (3, 4):
        raise ValueError("fused_spectral_field: the trunk needs 2 or 3 hidden layers")
    if H % 16 or (2 * M) % 16:
        raise ValueError("fused_spectral_field: widths must be multiples of 16")
    if torch.is_grad_enabled() and any(
        p.requires_grad for p in (W, phase, u, *params.parameters())
    ):
        raise NotImplementedError(
            "fused_spectral_field: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() (its backward is queued in ROADMAP.md)"
        )
    _check(u, "u", (N, 3), torch.float32, dev)
    _check(W, "W", (3, M), torch.float32, dev)
    _check(phase, "phase", (M,), torch.float32, dev)
    shapes = [(2 * M, H)] + [(H, H)] * (len(layers) - 2) + [(H, Dout)]
    for i, ((w, b), s) in enumerate(zip(layers, shapes)):
        _check(w, f"w{i}", s, torch.float32, dev)
        _check(b, f"b{i}", (s[1],), torch.float32, dev)
    lib = build.library()
    if lib.apnerf_fused_spectral_field_smem(M, H) > _MAX_SMEM:
        raise ValueError("fused_spectral_field: trunk too wide for shared memory")
    y = torch.empty((N, Dout), dtype=torch.float32, device=dev)
    if N == 0:
        return y
    # bf16 weights; the last layer zero-padded to a multiple of 16 columns
    Dp = -(-Dout // 16) * 16
    ws = [w.to(torch.bfloat16).contiguous() for w, _ in layers[:-1]]
    w_last = torch.zeros((H, Dp), dtype=torch.bfloat16, device=dev)
    w_last[:, :Dout] = layers[-1][0]
    b_last = torch.zeros(Dp, dtype=torch.float32, device=dev)
    b_last[:Dout] = layers[-1][1]
    ws.append(w_last)
    bs = [b for _, b in layers[:-1]] + [b_last]
    ptrs = []
    for i in range(4):
        ptrs += [ws[i].data_ptr(), bs[i].data_ptr()] if i < len(ws) else [None, None]
    err = lib.apnerf_fused_spectral_field_fwd(
        u.data_ptr(), W.data_ptr(), phase.data_ptr(), N, M, *ptrs,
        len(layers), H, Dp, Dout, y.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_spectral_field: CUDA launch failed, error {err}")
    fused_spectral_field.launches += 1
    return y


# kernel launches since the counter was last reset (chip_smoke.py reads it)
fused_spectral_field.launches = 0
