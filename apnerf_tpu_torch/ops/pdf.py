"""Inverse-CDF importance sampling over ray intervals.

Port of ``apnerf_tpu/ops/pdf.py`` on ``torch.searchsorted(right=True)``.
The JAX package's gather-free ``*_onehot`` helpers (``pdf.py:85-195``)
pick the same bins: bin b is chosen iff cdf[b] <= u < cdf[b+1], with the
last bin closed, which is exactly ``searchsorted(side="right") - 1``
clamped to the row. They were a TPU workaround and are not ported.

Stratified draws come from a ``torch.Generator``, or are passed in as
``noise`` (uniform [0, 1) of shape [R, n_samples]) so a test can feed the
JAX draws to both implementations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def searchsorted(
    sorted_keys: torch.Tensor,  # [R, K]
    queries: torch.Tensor,  # [R, Q]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (ids_left, ids_right), each [R, Q], with
    keys[left] <= q < keys[right], clamped to the row."""
    K = sorted_keys.shape[-1]
    right = torch.searchsorted(sorted_keys.contiguous(), queries.contiguous(), right=True)
    right = right.clamp(0, K - 1)
    left = (right - 1).clamp(0, K - 1)
    return left, right


def sample_from_weighted(
    bins: torch.Tensor,  # [R, B+1] interval edges
    weights: torch.Tensor,  # [R, B]
    n_samples: int,
    stratified: bool = False,
    vmin=-float("inf"),  # float or 0-dim tensor
    vmax=float("inf"),
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF draw of sorted sample positions per ray → (samples
    [R, n_samples], cdf [R, B+1])."""
    R = weights.shape[0]
    dev = weights.device
    pdf = weights / weights.sum(dim=-1, keepdim=True).clamp(min=eps)
    cdf = torch.cat([torch.zeros((R, 1), device=dev), torch.cumsum(pdf, dim=-1)], dim=-1)
    pad = 1.0 / (2 * n_samples)
    u = torch.linspace(pad, 1.0 - pad, n_samples, device=dev).expand(R, n_samples)
    if stratified:
        if noise is None:
            noise = torch.rand((R, n_samples), generator=generator, device=dev)
        u = u + (noise - 0.5) / n_samples
    u = u * cdf[:, -1:]  # clamp to the available mass
    left, right = searchsorted(cdf, u)
    cdf_l, cdf_r = cdf.gather(-1, left), cdf.gather(-1, right)
    bin_l, bin_r = bins.gather(-1, left), bins.gather(-1, right)
    span = cdf_r - cdf_l
    frac = ((u - cdf_l) / torch.where(span > eps, span, torch.ones_like(span))).clamp(0.0, 1.0)
    samples = bin_l + frac * (bin_r - bin_l)
    return samples.clamp(vmin, vmax), cdf


def importance_sampling(
    t_edges: torch.Tensor,  # [R, B+1]
    weights: torch.Tensor,  # [R, B]
    n_intervals: int,
    stratified: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample n_intervals per ray → (edges [R, n_intervals+1], midpoints
    [R, n_intervals])."""
    edges, _ = sample_from_weighted(
        t_edges, weights, n_intervals + 1, stratified=stratified,
        vmin=t_edges[..., :1].min(), vmax=t_edges[..., -1:].max(),
        generator=generator, noise=noise,
    )
    edges = torch.sort(edges, dim=-1).values
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    return edges, mids
