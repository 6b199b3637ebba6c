"""Unbounded-scene contraction (mip-NeRF 360 style).

Port of ``apnerf_tpu/ops/contraction.py``: positions are normalised into
the aabb as [-1, 1], magnitudes over 1 are contracted to
(2 - 1/|x|) · x/|x|, and the result is remapped to [0, 1].
"""

from __future__ import annotations

import torch


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """World positions [..., 3] → contracted unit-cube coordinates [..., 3]."""
    aabb_min, aabb_max = aabb[:3], aabb[3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2.0 - 1.0
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    safe_mag = mag.clamp(min=eps)
    contracted = (2.0 - 1.0 / safe_mag) * (x / safe_mag)
    x = torch.where(mag > 1.0, contracted, x)
    return x / 4.0 + 0.5
