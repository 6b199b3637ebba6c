"""What the kernel wrappers share around a launch: the check of a tensor a
kernel reads through a raw pointer, the error-checked call of a library
entry on the current stream, and the weight-gradient pass dW = Xᵀ·dY of
the trunk kernels' backwards (``csrc/fused_mlp.cu``: ``xt_dy_kernel``,
``sum_rows_kernel``; the main field's kernels have their own, in
``field_train.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_N_CHUNKS = 64  # row chunks of the weight-gradient reduction


def check_tensor(who: str, t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel reads through a raw pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{who}: {name} must be {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def needs_grad(*tensors) -> bool:
    """Whether autograd will ask for a gradient of any of these."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def launcher(who: str, dev):
    """→ ``run(fn, *args)``: call a library entry on the current stream of
    ``dev`` and raise on a CUDA error."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, *args):
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{who}: CUDA launch failed, error {err}")

    return run


def weight_grads(lib, run, jobs: Sequence[tuple], Np: int, dev) -> List[torch.Tensor]:
    """dW = Xᵀ·dY for each job ``(X ptr, ld X, readable X columns, rows of
    dW, dY ptr, ld dY, columns of dW)`` over ``Np`` rows of bf16 operands →
    the f32 gradients, one [rows, columns] tensor per job. Per-chunk
    partials, then one pass that adds them in a fixed order."""
    offs, total = [], 0
    for job in jobs:
        offs.append(total)
        total += job[3] * job[6]
    rows_per_chunk = 64 * -(-(Np // 64) // _N_CHUNKS)
    n_chunks = -(-Np // rows_per_chunk)
    P = torch.empty((n_chunks, total), dtype=torch.float32, device=dev)
    for (X, ldx, xc, din, Y, ldy, dout), off in zip(jobs, offs):
        run(lib.apnerf_xt_dy, X, ldx, xc, din, Y, ldy, dout, Np, rows_per_chunk, n_chunks,
            P.data_ptr(), total, off)
    gw = torch.empty((total,), dtype=torch.float32, device=dev)
    run(lib.apnerf_sum_rows, P.data_ptr(), n_chunks, total, total, gw.data_ptr())
    return [gw[off: off + job[3] * job[6]].view(job[3], job[6]) for job, off in zip(jobs, offs)]
