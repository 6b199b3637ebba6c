"""Proposal-network sampling and the PDF-matching loss.

Port of ``apnerf_tpu/models/propnet.py``: ``transform_stot`` (the
'uniform' and 'lindisp' warps), ``propnet_sampling``, ``_outer`` and
``prop_loss``, on the searchsorted inverse CDF (``ops/pdf.py``). The
flagship's proposal renderer samples 'uniform'; the NGP + proposal
example trainer samples 'lindisp'. The proposal weights go through
``fused_render_weights``, the CUDA weights kernel on the card. Nothing
here detaches: as in JAX, the resampled edges carry the gradient of the
proposal weights they were drawn from (``prop_loss`` alone stops it on
the final weights and edges). ``_outer``'s two gathers go through
``gather_rows_pair``, whose backward on the card is a CUDA kernel that
sums without atomics, so the proposal gradient repeats bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops.pdf import importance_sampling, searchsorted
from ..ops.cuda.gather_rows import gather_rows_pair
from ..ops.cuda.volrend_cuda import fused_render_weights


def transform_stot(s_vals: torch.Tensor, t_min, t_max,
                   transform_type: str = "uniform") -> torch.Tensor:
    """s in [0,1] → t: 'uniform' is linear in t, 'lindisp' linear in 1/t
    (``propnet.py:36-49``)."""
    t_min = torch.as_tensor(t_min, device=s_vals.device)[..., None]
    t_max = torch.as_tensor(t_max, device=s_vals.device)[..., None]
    if transform_type == "uniform":
        return s_vals * (t_max - t_min) + t_min
    if transform_type == "lindisp":
        inv = s_vals / t_max.clamp(min=1e-10) + (1 - s_vals) / t_min.clamp(min=1e-10)
        return 1.0 / inv.clamp(min=1e-10)
    raise ValueError(f"transform_stot: unknown warp {transform_type!r}")


def propnet_sampling(
    prop_sigma_fns: Sequence[Callable],  # each (t0 [R,S], t1 [R,S]) -> sigmas [R,S]
    prop_samples: Sequence[int],
    num_samples: int,
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3]
    near_plane,
    far_plane,
    stratified: bool = False,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    sampling_type: str = "lindisp",
):
    """Hierarchical proposal sampling → (t_starts, t_ends [R, num_samples],
    per-level (edges, weights) for the loss). ``near_plane``/``far_plane``
    are scalars or per-ray [R] tensors. ``noises``: one stratified jitter
    tensor per level, in place of drawing from ``generator``.
    ``sampling_type``: the s → t warp of ``transform_stot``."""
    R = rays_o.shape[0]
    dev = rays_o.device
    t_min = torch.broadcast_to(torch.as_tensor(near_plane, dtype=torch.float32, device=dev), (R,))
    t_max = torch.broadcast_to(torch.as_tensor(far_plane, dtype=torch.float32, device=dev), (R,))
    n0 = prop_samples[0] if prop_sigma_fns else num_samples
    s_edges = torch.linspace(0.0, 1.0, n0 + 1, device=dev).expand(R, n0 + 1)
    level_outputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i, (fn, n_next) in enumerate(zip(prop_sigma_fns, list(prop_samples[1:]) + [num_samples])):
        t_edges = transform_stot(s_edges, t_min, t_max, sampling_type)
        t0, t1 = t_edges[..., :-1], t_edges[..., 1:]
        weights = fused_render_weights(t0.contiguous(), t1.contiguous(),
                                       fn(t0, t1).float().contiguous())
        level_outputs.append((t_edges, weights))
        s_edges, _ = importance_sampling(
            s_edges, weights, n_next, stratified=stratified, generator=generator,
            noise=noises[i] if noises is not None else None,
        )
    t_edges = transform_stot(s_edges, t_min, t_max, sampling_type)
    return t_edges[..., :-1], t_edges[..., 1:], level_outputs


def _outer(t0, t1, y, t0_env, t1_env, y_env) -> torch.Tensor:
    """Mass of y inside each envelope bin (mipnerf360 ``lossfun_outer``)."""
    cy = torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(y, dim=-1)], dim=-1)
    idx_lo_l, _ = searchsorted(t1, t0_env)
    _, idx_hi_r = searchsorted(t0, t1_env)
    # one backward for both gathers, summed in a fixed order on the card
    cy_lo, cy_hi = gather_rows_pair(cy, idx_lo_l, idx_hi_r.clamp(0, y.shape[-1]))
    return (cy_hi - cy_lo).clamp(min=0.0)


def prop_loss(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    final_edges_t0: torch.Tensor,  # [R, S]
    final_edges_t1: torch.Tensor,
    final_weights: torch.Tensor,  # [R, S]
) -> torch.Tensor:
    """PDF matching loss: each proposal's envelope must upper-bound the
    final weights (which, like the final edges, carry no gradient)."""
    w = final_weights.detach()
    t0, t1 = final_edges_t0.detach(), final_edges_t1.detach()
    loss = torch.zeros((), device=w.device)
    for t_edges, w_prop in level_outputs:
        w_outer = _outer(t_edges[..., :-1], t_edges[..., 1:], w_prop, t0, t1, w)
        loss = loss + ((w - w_outer).clamp(min=0.0) ** 2 / (w + 1e-7)).mean()
    return loss
