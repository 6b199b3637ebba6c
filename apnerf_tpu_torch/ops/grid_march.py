"""Ray/AABB intersection and occupancy-grid ray marching with static
shapes.

Port of ``apnerf_tpu/ops/grid_march.py``: ``RaySegments``,
``ray_aabb_intersect``, ``candidate_lattice``, ``compact_mask``,
``occupancy_lookup`` and ``march_rays``. A lattice of K candidate
intervals, shared by every ray, follows the reference's cone-angle step
rule in closed form; each candidate's midpoint is looked up in the binary
occupancy grid, and the first ``max_samples`` occupied candidates of each
ray are compacted into padded ``[R, S]`` buffers with a validity mask.
The compaction and the lookups give the JAX functions' indices and masks
exactly; the binary search JAX unrolls is one ``torch.searchsorted``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class RaySegments(NamedTuple):
    """Padded per-ray sample intervals."""

    t_starts: torch.Tensor  # [R, S]
    t_ends: torch.Tensor  # [R, S]
    valid: torch.Tensor  # [R, S] bool


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


def candidate_lattice(
    n_candidates: int, near: float, dt_min: float, cone_angle: float = 0.0
) -> np.ndarray:
    """The shared marching lattice t_0..t_K, [K+1] float32 (host side):
    steps of ``dt_min`` while t < dt_min / cone, geometric growth by
    (1 + cone) after (``grid_march.py:71-95``)."""
    k = np.arange(n_candidates + 1, dtype=np.float64)
    if cone_angle <= 0.0:
        t = near + k * dt_min
    else:
        c = dt_min / cone_angle
        k0 = max(0.0, np.ceil((c - near) / dt_min))
        t_lin = near + k * dt_min
        t_k0 = near + k0 * dt_min
        t_geo = t_k0 * (1.0 + cone_angle) ** (k - k0)
        t = np.where(k < k0, t_lin, t_geo)
    return t.astype(np.float32)


def compact_mask(mask: torch.Tensor, max_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions of the first ``max_samples`` True entries of each row of
    ``mask`` [R, K] → (idx [R, S] int64, valid [R, S] bool); idx is 0
    where not valid. The (s+1)-th True entry is the first position whose
    running count reaches s+1."""
    R = mask.shape[0]
    csum = torch.cumsum(mask, dim=1, dtype=torch.int32)  # [R, K]
    targets = torch.arange(1, max_samples + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(csum, targets.expand(R, max_samples).contiguous())
    valid = targets[None, :] <= csum[:, -1:]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def _cell_index(binaries: torch.Tensor, u: torch.Tensor, d: int) -> torch.Tensor:
    """Grid index along axis d of unit-cube coordinate u (int32, clipped)."""
    n = binaries.shape[d]
    return (u * n).to(torch.int32).clamp(0, n - 1)


def occupancy_lookup(
    binaries: torch.Tensor,  # [Gx, Gy, Gz] bool
    aabb: torch.Tensor,  # [6]
    positions: torch.Tensor,  # [..., 3]
) -> torch.Tensor:
    """The binary occupancy at world positions → [...] bool; points
    outside the aabb read as unoccupied."""
    u = (positions - aabb[:3]) / (aabb[3:] - aabb[:3])
    inside = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    _, gy, gz = binaries.shape
    flat = (
        _cell_index(binaries, u[..., 0], 0) * (gy * gz)
        + _cell_index(binaries, u[..., 1], 1) * gz
        + _cell_index(binaries, u[..., 2], 2)
    )
    return binaries.reshape(-1)[flat.long()] & inside


def march_rays(
    rays_o: torch.Tensor,  # [R, 3]
    rays_d: torch.Tensor,  # [R, 3]
    binaries: torch.Tensor,  # [Gx, Gy, Gz] bool
    aabb: torch.Tensor,  # [6]
    lattice: torch.Tensor,  # [K+1] from candidate_lattice
    max_samples: int,
    near_planes: Optional[torch.Tensor] = None,  # [R]
    far_plane: float = 1e10,
) -> RaySegments:
    """Occupancy-grid marching → padded, contiguous (t_starts, t_ends,
    valid) [R, S]: candidates whose midpoint lies outside [t_aabb_min,
    min(t_aabb_max, far)] or in an empty cell are dropped, the survivors
    compacted in order (``grid_march.py:169-225``)."""
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb, far_plane=far_plane)
    t0 = lattice[:-1][None, :]  # [1, K]
    t1 = lattice[1:][None, :]
    t_mid = 0.5 * (t0 + t1)
    lo = t_min if near_planes is None else torch.maximum(t_min, near_planes)
    mask = (t_mid >= lo[:, None]) & (t_mid <= t_max[:, None])  # [R, K]
    _, gy, gz = binaries.shape
    strides = (gy * gz, gz, 1)
    flat = None
    for d in range(3):
        u_d = (rays_o[:, d : d + 1] + t_mid * rays_d[:, d : d + 1] - aabb[d]) / (
            aabb[d + 3] - aabb[d]
        )
        mask &= (u_d >= 0.0) & (u_d < 1.0)
        i_d = _cell_index(binaries, u_d, d) * strides[d]
        flat = i_d if flat is None else flat + i_d
    mask &= binaries.reshape(-1)[flat.long()]
    idx, valid = compact_mask(mask, max_samples)
    zero = torch.zeros((), dtype=lattice.dtype, device=lattice.device)
    return RaySegments(
        t_starts=torch.where(valid, lattice[:-1][idx], zero),
        t_ends=torch.where(valid, lattice[1:][idx], zero),
        valid=valid,
    )
