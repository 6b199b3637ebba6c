"""Binary occupancy grid: EMA occupancy plus its binarization.

Port of ``apnerf_tpu/ops/occupancy.py``: the state, ``update_occ_grid``,
its cadence ``maybe_update_occ_grid`` and ``mark_invisible_cells``. The
JAX package threads an immutable state through jitted updates; here
``update_occ_grid`` returns a new :class:`OccGridState` as well, so
callers keep the old one until they choose to drop it.

The draws (the in-cell jitter, and after warm-up the uniform and the
occupied cell indices) come from a ``torch.Generator``, or are passed in
through ``draws`` so a test can feed both implementations the same
numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class OccGridState(NamedTuple):
    occs: torch.Tensor  # [Gx*Gy*Gz] float32 EMA occupancy (-1 = invisible)
    binaries: torch.Tensor  # [Gx, Gy, Gz] bool
    aabb: torch.Tensor  # [6] float32

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.binaries.shape)


def init_occ_grid(aabb, resolution, device=None) -> OccGridState:
    """A fresh, all-empty grid."""
    resolution = tuple(int(r) for r in resolution)
    n = int(np.prod(resolution))
    return OccGridState(
        occs=torch.zeros(n, dtype=torch.float32, device=device),
        binaries=torch.zeros(resolution, dtype=torch.bool, device=device),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=device),
    )


def cell_centers_world(
    state: OccGridState, indices: torch.Tensor, jitter: torch.Tensor
) -> torch.Tensor:
    """World positions of cells ``indices`` with in-cell jitter in [0,1)³."""
    r0, r1, r2 = state.resolution
    gx = indices // (r1 * r2)
    gy = (indices // r2) % r1
    gz = indices % r2
    coords = torch.stack([gx, gy, gz], dim=-1).float()
    res = torch.tensor([r0, r1, r2], dtype=torch.float32, device=indices.device)
    u = (coords + jitter) / res
    return state.aabb[:3] + u * (state.aabb[3:] - state.aabb[:3])


def _draw(n_cells: int, n_idx: int, generator, device) -> Dict[str, torch.Tensor]:
    n_sub = n_cells // 4
    return {
        "jitter": torch.rand((n_idx, 3), generator=generator, device=device),
        "uniform_idx": torch.randint(
            0, n_cells, (n_sub,), generator=generator, device=device
        ),
        "occ_u": torch.rand((n_sub,), generator=generator, device=device),
    }


def update_occ_grid(
    state: OccGridState,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    step: int,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    warmup_steps: int = 256,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> OccGridState:
    """One EMA update and re-binarization (``occupancy.py:68-133``).

    During warm-up every cell is updated; after it, n/4 uniform cells and
    n/4 cells drawn from the occupied ones (duplicates are harmless under
    the max-EMA scatter). Invisible cells (occ < 0) never update and never
    count toward the threshold mean. ``draws`` holds ``jitter`` [n_idx, 3],
    ``uniform_idx`` [n/4] and ``occ_u`` [n/4], with n_idx = n during
    warm-up and n/2 after."""
    n_cells = state.occs.shape[0]
    dev = state.occs.device
    warm = step < warmup_steps
    if draws is None:
        n_idx = n_cells if warm else 2 * (n_cells // 4)
        draws = _draw(n_cells, n_idx, generator, dev)
    if warm:
        indices = torch.arange(n_cells, device=dev)
    else:
        uniform_idx = draws["uniform_idx"].to(dev)
        occ_mask = state.binaries.reshape(-1).float()
        cdf = torch.cumsum(occ_mask, dim=0)
        total = cdf[-1]
        occupied_idx = torch.searchsorted(
            cdf, draws["occ_u"].to(dev) * total, right=True
        ).clamp(0, n_cells - 1)
        occupied_idx = torch.where(total > 0, occupied_idx, uniform_idx)
        indices = torch.cat([uniform_idx, occupied_idx])

    occs = state.occs
    x = cell_centers_world(state, indices, draws["jitter"].to(dev))
    occ = occ_eval_fn(x).reshape(-1).float()
    occ = torch.nan_to_num(occ, nan=0.0, posinf=torch.finfo(torch.float32).max)
    old = occs[indices]
    visible = old >= 0.0
    decayed = torch.where(visible, old * ema_decay, old)
    new_vals = torch.where(visible, torch.maximum(decayed, occ), old)
    # scatter-decay then scatter-max handles duplicate indices exactly
    occs = occs.index_put((indices,), decayed)
    occs = occs.scatter_reduce(0, indices, new_vals, reduce="amax", include_self=True)

    visible = occs >= 0.0
    mean = torch.where(visible, occs, torch.zeros_like(occs)).sum() / visible.float().sum().clamp(min=1.0)
    thre = torch.clamp(mean, max=occ_thre)
    binaries = (occs > thre).reshape(state.resolution)
    return OccGridState(occs=occs, binaries=binaries, aabb=state.aabb)


def maybe_update_occ_grid(
    state: OccGridState,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    step: int,
    occ_thre: float,
    every_n: int = 16,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    **kw,
) -> OccGridState:
    """``update_occ_grid`` on steps that are multiples of ``every_n``, the
    state itself on the others (``occupancy.py:136-152``); a step that
    does not update draws nothing. ``kw``: ``ema_decay``,
    ``warmup_steps``."""
    if step % every_n != 0:
        return state
    return update_occ_grid(state, occ_eval_fn, step, occ_thre, generator=generator,
                           draws=draws, **kw)


def mark_invisible_cells(
    state: OccGridState,
    K: torch.Tensor,  # [3, 3]
    c2w: torch.Tensor,  # [N, 4, 4] or [N, 3, 4]
    width: int,
    height: int,
    near_plane: float = 0.0,
) -> OccGridState:
    """occ = -1 for the cells no camera covers and for those some camera
    sees nearer than ``near_plane``, 0 for the rest (``occupancy.py:155-190``):
    each cell's centre is projected into every camera (OpenGL, looking
    down -z) at once."""
    n_cells = state.occs.shape[0]
    dev = state.occs.device
    idx = torch.arange(n_cells, device=dev)
    centers = cell_centers_world(state, idx, torch.full((n_cells, 3), 0.5, device=dev))
    c2w = c2w.to(dev, torch.float32)
    K = K.to(dev, torch.float32)
    R_w2c = c2w[:, :3, :3].transpose(1, 2)  # [N, 3, 3]
    t_w2c = -torch.einsum("nij,nj->ni", R_w2c, c2w[:, :3, 3])
    xyz_c = torch.einsum("nij,cj->nci", R_w2c, centers) + t_w2c[:, None, :]
    uvd = torch.einsum("ij,ncj->nci", K, xyz_c)
    d = -xyz_c[..., 2]
    z = uvd[..., 2:]
    uv = uvd[..., :2] / torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    in_image = (
        (d >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < height)
    )
    covered = (d >= near_plane) & in_image  # [N, C]
    too_near = (d < near_plane) & in_image
    valid = covered.any(dim=0) & ~too_near.any(dim=0)
    occs = torch.where(valid, torch.zeros_like(state.occs), torch.full_like(state.occs, -1.0))
    return state._replace(occs=occs)
