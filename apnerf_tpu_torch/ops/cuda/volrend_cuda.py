"""Volume-rendering weights in CUDA kernels (``csrc/volrend.cu``).

Port of ``apnerf_tpu/ops/pallas/volrend_pallas.py::fused_render_weights``,
forward and backward: (t0, t1, σ) → the weights [R, S], as the JAX
function returns them. ``fused_render_weights`` launches the kernels for
CUDA tensors and takes ``fused_render_weights_plain`` only for CPU
tensors. The kernels give each lane of a warp a span of ``lane_span(S)``
consecutive samples of one ray; the wrapper picks that instance and
whether the rows take 16-byte vector accesses (``vector_access``). A row
past ``SPAN_SAMPLES`` samples takes the widest instance in ``span_count(S)``
passes of one warp, so any S ≥ 1 goes.
"""

from __future__ import annotations

import torch

from ..volrend import render_transmittance_from_density
from . import build

LANE_SPANS = (1, 2, 4, 8, 16, 32)  # the kernels' compile-time instances
SPAN_SAMPLES = 32 * LANE_SPANS[-1]  # samples one warp takes in one pass


def lane_span(n_samples: int) -> int:
    """The kernels' samples per lane for rows of ``n_samples``: the
    smallest instance V with 32 V ≥ S (one warp a ray), and the widest
    past ``SPAN_SAMPLES``."""
    if n_samples < 1:
        raise ValueError(f"fused_render_weights: S={n_samples} must be at least 1")
    return next((v for v in LANE_SPANS if 32 * v >= n_samples), LANE_SPANS[-1])


def span_count(n_samples: int) -> int:
    """Passes of ``SPAN_SAMPLES`` samples the kernels' warp makes over a row
    of ``n_samples``: 1 up to ``SPAN_SAMPLES`` (the one-pass kernels),
    more past it (the ``_spans`` kernels, which carry the optical depth
    and the backward's suffix sum from pass to pass)."""
    lane_span(n_samples)
    return -(-n_samples // SPAN_SAMPLES)


def vector_access(n_samples: int, span: int, ptrs) -> bool:
    """Whether the kernels may move each lane's span as vectors of
    min(V, 4) floats: every row and every pointer aligned to one."""
    width = min(span, 4)
    return n_samples % width == 0 and all(p % (4 * width) == 0 for p in ptrs)


def fused_render_weights_plain(t0, t1, sigmas):
    """The weights of ``render_weight_from_density`` as plain PyTorch ops
    (``apnerf_tpu/ops/volrend.py:55-83``); autograd gives its backward."""
    trans, alphas = render_transmittance_from_density(t0, t1, sigmas)
    return trans * alphas


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t, name, sigmas):
    R, S = sigmas.shape
    if t.device != sigmas.device or t.dtype != torch.float32 or t.shape != (R, S):
        raise ValueError(
            f"fused_render_weights: {name} must be float32 {(R, S)} on "
            f"{sigmas.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_render_weights: {name} must be contiguous")


def _launch_terms(tensors, outs):
    """(span, vec) of a launch on rows of the tensors' width."""
    S = tensors[0].shape[1]
    span = lane_span(S)
    return span, int(vector_access(S, span, [t.data_ptr() for t in (*tensors, *outs)]))


def _fwd_launch(t0, t1, sigmas):
    R, S = sigmas.shape
    w = torch.empty((R, S), dtype=torch.float32, device=sigmas.device)
    if R == 0 or S == 0:
        return w
    span, vec = _launch_terms((t0, t1, sigmas), (w,))
    err = build.library().apnerf_fused_render_weights_fwd(
        t0.data_ptr(), t1.data_ptr(), sigmas.data_ptr(), R, S, span, vec, w.data_ptr(),
        _stream(sigmas),
    )
    if err != 0:
        raise RuntimeError(f"fused_render_weights: CUDA launch failed, error {err}")
    fused_render_weights.launches += 1
    return w


def fused_render_weights_bwd(t0, t1, sigmas, g, with_dt: bool = True):
    """(t0, t1, σ, dL/dw) → (dσ, dt0, dt1), each [R, S] f32, by the
    backward kernel; dt0 and dt1 are None unless ``with_dt``. CUDA tensors
    only."""
    if sigmas.device.type != "cuda":
        raise ValueError(f"fused_render_weights_bwd: unsupported device {sigmas.device}")
    if sigmas.dim() != 2:
        raise ValueError("fused_render_weights_bwd: inputs must be [R, S]")
    for name, t in (("t0", t0), ("t1", t1), ("sigmas", sigmas), ("g", g)):
        _check(t, name, sigmas)
    R, S = sigmas.shape
    outs = [torch.empty((R, S), dtype=torch.float32, device=sigmas.device)
            for _ in range(3 if with_dt else 1)]
    dsig, dt0, dt1 = (outs + [None, None])[:3]
    if R == 0 or S == 0:
        return dsig, dt0, dt1
    span, vec = _launch_terms((t0, t1, sigmas, g), outs)
    err = build.library().apnerf_fused_render_weights_bwd(
        t0.data_ptr(), t1.data_ptr(), sigmas.data_ptr(), g.data_ptr(), R, S, span, vec,
        dsig.data_ptr(), *((dt0.data_ptr(), dt1.data_ptr()) if with_dt else (None, None)),
        _stream(sigmas),
    )
    if err != 0:
        raise RuntimeError(f"fused_render_weights_bwd: CUDA launch failed, error {err}")
    fused_render_weights_bwd.launches += 1
    return dsig, dt0, dt1


class _RenderWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t0, t1, sigmas):
        ctx.save_for_backward(t0, t1, sigmas)
        return _fwd_launch(t0, t1, sigmas)

    @staticmethod
    def backward(ctx, g):
        t0, t1, sigmas = ctx.saved_tensors
        dsig, dt0, dt1 = fused_render_weights_bwd(
            t0, t1, sigmas, g.float().contiguous(),
            with_dt=ctx.needs_input_grad[0] or ctx.needs_input_grad[1],
        )
        return dt0, dt1, dsig


def fused_render_weights(
    t0: torch.Tensor,  # [R, S] f32
    t1: torch.Tensor,  # [R, S] f32
    sigmas: torch.Tensor,  # [R, S] f32
) -> torch.Tensor:
    """→ weights [R, S] f32. A CUDA tensor launches the forward kernel,
    and the backward kernel when a gradient flows through the weights
    (dt0, dt1 only where t0 or t1 needs one), or raises."""
    if sigmas.device.type == "cpu":
        return fused_render_weights_plain(t0, t1, sigmas)
    if sigmas.device.type != "cuda":
        raise ValueError(f"fused_render_weights: unsupported device {sigmas.device}")
    if sigmas.dim() != 2:
        raise ValueError("fused_render_weights: inputs must be [R, S]")
    for name, t in (("t0", t0), ("t1", t1), ("sigmas", sigmas)):
        _check(t, name, sigmas)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (t0, t1, sigmas)):
        return _RenderWeights.apply(t0, t1, sigmas)
    return _fwd_launch(t0, t1, sigmas)


# kernel launches since the counters were last reset (chip_smoke.py reads them)
fused_render_weights.launches = 0
fused_render_weights_bwd.launches = 0
