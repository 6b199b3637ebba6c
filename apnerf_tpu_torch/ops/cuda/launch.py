"""What the kernel wrappers share around a launch: the check of a tensor a
kernel reads through a raw pointer and the error-checked call of a library
entry on the current stream.
"""

from __future__ import annotations

import torch

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


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

