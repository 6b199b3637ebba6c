"""Multi-step training phases: a chunk of ensemble steps.

Port of ``apnerf_tpu/train/phase.py``: ``pools_from_dataset``,
``_sample_pool_index`` (``:32-73``) and ``make_train_phase``
(``:76-140``). ``lax.scan`` becomes a Python loop over the chunk's steps
and ``vmap`` a loop over the E members. Each step draws on the device:
  * member 0 draws uniformly from all ``size`` images; member m>0 from
    its padded bootstrap pool (inverse CDF over the valid prefix);
  * with ``recent_bias``, a coin per member picks the recent images
    half of the time;
then fetches each member's rays and runs the member core: the flagship
core (``train/flagship.py``), or the (ngp, occ) core
(``train/step.py::make_member_core``, ``make_ngp_train_phase``), which
updates its member's occupancy grid inside the step with draws of its
own (JAX splits one ``k_occ`` per member, ``phase.py:104-126``). Nothing inside
a chunk reads a value back to the host, so the loop only queues work;
capturing a chunk in a CUDA graph is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.dataset import RayDataset, fetch_rays
from ..ops.occupancy import _draw
from .step import EnsembleState, make_member_core


def pools_from_dataset(ds: RayDataset) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded bootstrap pools [E, P_CAP] and counts [E] on the dataset's
    device. Member 0's pool is every image."""
    cap = max(ds.max_images, int(ds.max_images * ds.boot_scale) + 1)
    pools = np.zeros((ds.num_models, cap), dtype=np.int32)
    counts = np.zeros((ds.num_models,), dtype=np.int32)
    pools[0, : ds.size] = np.arange(ds.size)
    counts[0] = ds.size
    for m in range(1, ds.num_models):
        p = ds.bootstrap(m)
        n = min(len(p), cap)
        pools[m, :n] = p[:n]
        counts[m] = n
    return torch.as_tensor(pools, device=ds.device), torch.as_tensor(counts, device=ds.device)


def _sample_pool_index(
    pools: torch.Tensor,  # [E, P]
    counts: torch.Tensor,  # [E]
    recent_bias: bool,
    size: int,
    sample_disc: int,
    coin: torch.Tensor,  # [E] uniform [0, 1)
    pick: torch.Tensor,  # [E] uniform [0, 1)
) -> torch.Tensor:
    """One training-image index per member [E], from its pool: the
    device-side equivalent of ``RayDataset.sample_image_indices``."""
    P = pools.shape[1]
    valid = torch.arange(P, device=pools.device)[None, :] < counts[:, None]
    recent = valid & (pools >= size - sample_disc)
    use_recent = (coin < 0.5) & recent.any(dim=1) & bool(recent_bias)
    mask = torch.where(use_recent[:, None], recent, valid).float()
    cdf = torch.cumsum(mask, dim=1)
    u = (pick * cdf[:, -1])[:, None]
    pos = torch.searchsorted(cdf, u, right=True).clamp(0, P - 1)
    return pools.gather(1, pos)[:, 0]


def draw_step(
    cfg: PipelineConfig, n_members: int, step: int, size_hw: Tuple[int, int], device,
    generator: Optional[torch.Generator], updates_occ: bool, n_cells: int = 0,
) -> dict:
    """One step's draws for ``n_members`` members, from ``generator`` in
    the order the step's work would draw them: ``coin`` and ``pick`` [E];
    then per member its pixels ``x``, ``y`` [R] and background ``bkgd``
    [3] (``fetch_rays``'s), and the member core's own: the stratified
    ``noise`` [R, S+1] of proposal sampling, or on the (ngp, occ) path the
    occupancy update's draws ``occ`` on the steps of its cadence (None on
    the others; ``ops/occupancy.maybe_update_occ_grid``). Every rank of a
    mesh makes all of them and keeps its members' and its rays'."""
    H, W = size_hw
    R, dev, g = cfg.num_rays, device, generator
    d = {"coin": torch.rand((n_members,), generator=g, device=dev),
         "pick": torch.rand((n_members,), generator=g, device=dev)}
    xs, ys, bkgds, own = [], [], [], []
    for _ in range(n_members):
        xs.append(torch.randint(0, W, (R,), generator=g, device=dev))
        ys.append(torch.randint(0, H, (R,), generator=g, device=dev))
        bkgds.append(torch.rand((3,), generator=g, device=dev))
        if not updates_occ:
            own.append(torch.rand((R, cfg.max_samples_train + 1), generator=g, device=dev))
        elif step % cfg.occ_every_n == 0:
            warm = step < cfg.occ_warmup_steps
            own.append(_draw(n_cells, n_cells if warm else 2 * (n_cells // 4), g, dev))
        else:
            own.append(None)
    d.update(x=torch.stack(xs), y=torch.stack(ys), bkgd=torch.stack(bkgds))
    if updates_occ:
        d["occ"] = own
    else:
        d["noise"] = torch.stack(own)
    return d


def make_train_phase(cfg: PipelineConfig, member_core: Callable, mesh=None):
    """→ ``phase_fn(state, images, depths, semantics, camtoworlds, K, pools,
    counts, size, n_steps, recent_bias, generator=None, draws=None,
    occ_thre=1e-2) -> (state, losses [n_steps, E])``.

    ``member_core`` is the flagship core (``train/flagship.py``) or the
    (ngp, occ) core (``step.make_member_core``). Parameters and optimizer
    state update in place, and the returned state carries ``step +
    n_steps``. A core with ``updates_occ`` gets its member's grid and
    ``occ_thre``, the occupancy threshold of the phase
    (``cfg.occ_thre_for_phase``), and the grid it returns replaces the
    member's entry of ``state.occ``. ``draws``, when given, holds one dict
    per step with the draws that ``generator`` would make (``draw_step``).

    ``mesh`` (``parallel/mesh.Mesh``): ``state`` holds this rank's members
    of the E, and each member's step runs on this rank's slice of its rays
    (the core's ``grad_reduce`` averages the gradients over ``data``).
    Every rank makes every member's draws for all rays, so a sharded phase
    is the unsharded phase's arithmetic; the losses are averaged over
    ``data`` and gathered over ``ens``, and every rank returns all E."""
    from ..parallel.mesh import Mesh

    updates_occ = getattr(member_core, "updates_occ", False)
    mesh = mesh or Mesh.single()

    def phase_fn(
        state: EnsembleState,
        images, depths, semantics, camtoworlds, K,
        pools: torch.Tensor,  # [E, P]
        counts: torch.Tensor,  # [E]
        size: int,
        n_steps: int,
        recent_bias: bool = False,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[dict]] = None,
        occ_thre: float = 1e-2,
    ):
        E = len(state.members) * mesh.n_ens
        local = mesh.members(E)
        rays = mesh.rays(cfg.num_rays)
        shard = (mesh.data_index, mesh.n_data) if mesh.n_data > 1 else None
        dev = images.device
        n_cells = state.occ[0].occs.numel()
        opt, occ = list(state.opt), list(state.occ)
        losses = []
        for i in range(n_steps):
            if draws is not None:
                d = draws[i]
            else:
                d = draw_step(cfg, E, state.step + i, images.shape[1:3], dev, generator,
                              updates_occ, n_cells)
            image_idx = _sample_pool_index(
                pools, counts, recent_bias, size, cfg.sample_disc, d["coin"].to(dev),
                d["pick"].to(dev),
            )
            step_loss = []
            for j, m in enumerate(local):
                batch = fetch_rays(
                    images, depths, semantics, camtoworlds, K, image_idx[m],
                    cfg.num_rays, training=True, draws={k: d[k][m] for k in ("x", "y", "bkgd")},
                    shard=shard,
                )
                if updates_occ:
                    extra = dict(occ=occ[j], occ_thre=occ_thre, occ_draws=d["occ"][m])
                else:
                    extra = dict(noise=d["noise"][m][rays].to(dev))
                out = member_core(state.members[j], opt[j], batch, state.step + i,
                                  generator=generator, **extra)
                opt[j] = out.opt
                if updates_occ:
                    occ[j] = out.occ
                step_loss.append(out.loss)
            losses.append(torch.stack(step_loss))
        state = state._replace(opt=opt, occ=occ, step=state.step + n_steps)
        if not losses:
            return state, torch.zeros((0, E), device=dev)
        return state, mesh.mean_data_gather_ens(torch.stack(losses))

    return phase_fn


def make_ngp_train_phase(cfg: PipelineConfig, lattice: torch.Tensor, schedule=None,
                         mesh=None):
    """The chunk of steps over the (ngp, occ) member core on ``lattice``
    (``step.make_lattice``) under ``schedule``; on ``mesh``, sharded, the
    gradients averaged over ``data``."""
    grad_reduce = mesh.mean_data if mesh is not None and mesh.n_data > 1 else None
    return make_train_phase(cfg, make_member_core(cfg, lattice, schedule, grad_reduce), mesh)
