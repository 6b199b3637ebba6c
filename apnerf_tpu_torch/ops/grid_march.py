"""Ray/AABB slab intersection.

Port of ``apnerf_tpu/ops/grid_march.py::ray_aabb_intersect`` only; the
occupancy-lattice march belongs to the ngp+occ path, a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ray_aabb_intersect(
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3]
    aabb: torch.Tensor,  # [6]
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    miss_value: float = 1e10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (t_min, t_max), each [R], clamped to [near, far]; misses get
    ``miss_value``."""
    safe_d = torch.where(rays_d.abs() > 1e-10, rays_d, torch.full_like(rays_d, 1e-10))
    inv_d = 1.0 / safe_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    t_min = torch.minimum(t0, t1).amax(dim=-1).clamp(near_plane, far_plane)
    t_max = torch.maximum(t0, t1).amin(dim=-1).clamp(near_plane, far_plane)
    hit = t_min < t_max
    miss = torch.full_like(t_min, miss_value)
    return torch.where(hit, t_min, miss), torch.where(hit, t_max, miss)
