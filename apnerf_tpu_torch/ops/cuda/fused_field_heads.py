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
Python side: the flat-list split, the plain field and the repacking of
the weights into the tile images the kernels read (``prepare_field``,
``field_images.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ...models.ngp import trunc_exp
from ...models.nn import apply_layers
from . import build, field_images
from .fused_mlp import encode_plain
from .launch import check_tensor, needs_grad

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


class FieldWeightsStruct(ctypes.Structure):
    """Mirrors ``FieldWeights`` in ``csrc/field_tile.cuh`` field by field."""

    _fields_ = [("W", _p), ("phase", _p), ("wfwd", _p), ("wbwd", _p), ("bias", _p),
                ("n_hidden", ctypes.c_int), ("geo", ctypes.c_int), ("n_classes", ctypes.c_int)]


class _FfhArgs(ctypes.Structure):
    """Mirrors ``FfhArgs`` in ``csrc/fused_field_heads.cu`` field by field."""

    _fields_ = [("u", _p), ("sh", _p), ("y", _p), ("p", FieldWeightsStruct),
                ("n_rows", ctypes.c_int), ("n_samples", ctypes.c_int)]


class PreparedField(NamedTuple):
    """A main field as the kernels read it. ``images`` keeps the repacked
    buffers alive for as long as ``weights`` points at them."""

    weights: FieldWeightsStruct
    images: Tuple[torch.Tensor, ...]  # forward slabs, backward slabs, biases
    M: int
    H: int
    out_t: int  # trunk output width, 1 + G
    G: int
    hh: int  # head width
    C: int
    n_hidden: int  # trunk hidden layers, 2 or 3


def prepare_field(who: str, leaves: Sequence[torch.Tensor], dev) -> PreparedField:
    """Check the field's leaves (f32, contiguous, on ``dev``, the widths the
    kernels take) and repack them for the kernels (``field_weights``)."""
    n_hidden, G, C = field_images.check_widths(who, [tuple(t.shape) for t in leaves])
    lay = field_images.leaf_layout(n_hidden, G, C)
    for i, (t, shape) in enumerate(zip(leaves, lay.shapes)):
        check_tensor(who, t, f"leaf {i}", torch.float32, shape, dev)
    weights, images = field_weights(leaves, dev, n_hidden, G, C)
    return PreparedField(weights, images, field_images.M, field_images.H, 1 + G, G,
                         field_images.HH, C, n_hidden)


@functools.lru_cache(maxsize=None)
def _index_tables(dev: torch.device, n_hidden: int, G: int, C: int):
    """``field_images.index_tables`` as tensors on ``dev``, made once."""
    return tuple(torch.from_numpy(t).to(dev) for t in field_images.index_tables(n_hidden, G, C))


@torch.no_grad()
def field_weights(leaves, dev, n_hidden: int, G: int, C: int):
    """The leaves as the Hopper tile reads them: every weight repacked into
    bf16 tile images in the order the kernels consume them (one gather each
    for the forward and the backward slabs) and the padded f32 biases →
    (the kernels' struct, the tensors it points at)."""
    fwd, bwd, bias = _index_tables(dev, n_hidden, G, C)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves] + [leaves[0].new_zeros(1)])
    flat16 = flat.to(torch.bfloat16)
    images = (flat16[fwd], flat16[bwd], flat[bias])
    w = FieldWeightsStruct()
    w.W, w.phase = leaves[0].data_ptr(), leaves[1].data_ptr()
    w.wfwd, w.wbwd, w.bias = (t.data_ptr() for t in images)
    w.n_hidden, w.geo, w.n_classes = n_hidden, G, C
    return w, images


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_field_rows(lib, fld: PreparedField, u_ptr: int, sh_ptr: int, y_ptr: int,
                      n_rows: int, S: int, stream: int) -> int:
    """Launch the packed field kernel on ``n_rows`` rows starting at the
    given addresses → the CUDA error code."""
    a = _FfhArgs()
    a.u, a.sh, a.y, a.p = u_ptr, sh_ptr, y_ptr, fld.weights
    a.n_rows, a.n_samples = n_rows, S
    grid = field_images.field_grid(n_rows, sm_count(fld.images[0].device))
    return lib.apnerf_ffh_fwd(ctypes.addressof(a), grid, stream)


def _launch_forward(leaves, u, sh, S):
    who = "fused_field_heads"
    dev, N = u.device, u.shape[0]
    fld = prepare_field(who, leaves, dev)
    lib = build.library()
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
