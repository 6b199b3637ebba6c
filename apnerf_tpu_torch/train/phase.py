"""Multi-step training phases: a chunk of ensemble steps.

Port of ``apnerf_tpu/train/phase.py``: ``pools_from_dataset``,
``_sample_pool_index`` (``:32-73``) and ``make_train_phase``
(``:76-140``). ``lax.scan`` becomes a Python loop over the chunk's steps
and ``vmap`` a loop over the E members. Each step draws on the device:
  * member 0 draws uniformly from all ``size`` images; member m>0 from
    its padded bootstrap pool (inverse CDF over the valid prefix);
  * with ``recent_bias``, a coin per member picks the recent images
    half of the time;
then fetches each member's rays and runs the member core. Nothing inside
a chunk reads a value back to the host, so the loop only queues work;
capturing a chunk in a CUDA graph is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.dataset import RayDataset, fetch_rays
from .step import EnsembleState


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


def make_train_phase(cfg: PipelineConfig, member_core: Callable):
    """→ ``phase_fn(state, images, depths, semantics, camtoworlds, K, pools,
    counts, size, n_steps, recent_bias, generator=None, draws=None) ->
    (state, losses [n_steps, E])``.

    ``member_core`` is the flagship core (``train/flagship.py``); the
    (ngp, occ) core is not ported. Parameters and optimizer state update
    in place and the returned state carries ``step + n_steps``.
    ``draws``, when given, holds one dict per step with the draws that
    ``generator`` would make: ``coin`` and ``pick`` [E], ``x`` and ``y``
    [E, R] pixels, ``bkgd`` [E, 3] and the stratified ``noise``
    [E, R, S+1] of proposal sampling."""

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
    ):
        E = len(state.members)
        dev = images.device
        opt = list(state.opt)
        losses = []
        for i in range(n_steps):
            d = draws[i] if draws is not None else None
            if d is None:
                coin = torch.rand((E,), generator=generator, device=dev)
                pick = torch.rand((E,), generator=generator, device=dev)
            else:
                coin, pick = d["coin"].to(dev), d["pick"].to(dev)
            image_idx = _sample_pool_index(
                pools, counts, recent_bias, size, cfg.sample_disc, coin, pick
            )
            step_loss = []
            for m in range(E):
                fetch_draws = None if d is None else {k: d[k][m] for k in ("x", "y", "bkgd")}
                batch = fetch_rays(
                    images, depths, semantics, camtoworlds, K, image_idx[m],
                    cfg.num_rays, training=True, generator=generator, draws=fetch_draws,
                )
                out = member_core(
                    state.members[m], opt[m], batch, state.step + i, generator=generator,
                    noise=None if d is None else d["noise"][m],
                )
                opt[m] = out.opt
                step_loss.append(out.loss)
            losses.append(torch.stack(step_loss))
        state = state._replace(opt=opt, step=state.step + n_steps)
        return state, torch.stack(losses) if losses else torch.zeros((0, E), device=dev)

    return phase_fn
