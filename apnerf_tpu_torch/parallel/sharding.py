"""The sharded train step, train phases and candidate renderer.

Port of ``apnerf_tpu/parallel/sharding.py``. Torch has no GSPMD, so each
function here is one program per rank with explicit collectives
(``parallel/mesh.py``): members over ``ens``, rays over ``data``, the
gradients averaged over ``data`` (an ``all_reduce`` in the member core's
``grad_reduce``), losses averaged over ``data`` and gathered over ``ens``.
Every rank draws what the unsharded path draws, for all members and all
rays, from a generator with the same seed, then keeps its members and its
ray slice: a sharded phase is the unsharded phase's arithmetic. That
includes the proposal sampler's stratified jitter, the global [R, S+1]
draw sliced, where JAX's shard_map phase hands every data shard of a
member the same key (``sharding.py:125-143``, ``flagship.py:205``), so
its data shards repeat one [R/n, S+1] draw (ROADMAP, faults on the
reference side).

On the card each rank runs the port's normal kernel routes on its share:
the member cores' kernels on R/n rays, and the renders' packed field
(with variance) and fused field-and-render (without), not JAX's
``cfg_gspmd`` plain chain, which worked around ``pallas_call`` under
GSPMD.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import PipelineConfig
from .mesh import Mesh, shard_ensemble_state


def _grad_reduce(mesh: Mesh):
    return mesh.mean_data if mesh.n_data > 1 else None


def make_sharded_train_step(cfg: PipelineConfig, mesh: Mesh, lattice: torch.Tensor,
                            schedule=None):
    """The (ngp, occ) ensemble step for given images (``sharding.py:43-50``,
    ``train/step.make_train_step``) on ``mesh``."""
    from ..train.step import make_train_step

    return make_train_step(cfg, lattice, schedule, mesh=mesh)


def make_sharded_occ_phase(cfg: PipelineConfig, mesh: Mesh, lattice: torch.Tensor,
                           schedule=None):
    """The (ngp, occ) chunk of steps (``sharding.py:53-64``) on ``mesh``:
    the hash table's gradient (``hash_table_bwd``) is averaged over ``data``
    with the rest, and every data rank of a member makes the same
    occupancy-update draws on the same parameters, so its grid stays the
    same on every data rank."""
    from ..train.phase import make_ngp_train_phase

    return make_ngp_train_phase(cfg, lattice, schedule, mesh=mesh)


def make_sharded_flagship_phase(cfg: PipelineConfig, mesh: Mesh, schedule=None,
                                route: Optional[str] = None):
    """The flagship chunk of steps on ``mesh``: the counterpart of both
    ``make_sharded_flagship_phase`` (``sharding.py:67``, GSPMD constraints)
    and ``make_shardmap_flagship_phase`` (``:79-176``, explicit ``pmean``),
    with ``phase.make_train_phase``'s ``phase_fn`` signature and ``draws``
    contract. Each rank runs the member core on its members and its rays;
    every rank returns the losses [n_steps, E] of every member."""
    from ..train.flagship import make_flagship_member_core
    from ..train.phase import make_train_phase

    mesh.members(cfg.n_ensembles)  # JAX's messages for a shape that does not divide
    mesh.rays(cfg.num_rays)
    core = make_flagship_member_core(cfg, route, schedule=schedule, grad_reduce=_grad_reduce(mesh))
    return make_train_phase(cfg, core, mesh)


def shard_renderer(render: Callable, mesh: Mesh) -> Callable:
    """An ensemble renderer (``render(members, occ, origins [V, P, 3],
    viewdirs, bkgd) -> {name: [E_l, V, ...]}`` of the members it is given)
    on ``mesh``: each rank renders its members on its run of views (a
    contiguous slice of the V·P rays cut at view boundaries, so every call
    a rank makes is a call of the unsharded render), and every rank gets
    every member's outputs [E, V, ...], gathered bit for bit. A ray's
    outputs depend on that ray alone, so the gathered render is the
    unsharded one."""
    if mesh.world == 1:
        return render

    def sharded(members, occ, origins, viewdirs, bkgd) -> Dict[str, torch.Tensor]:
        V = origins.shape[0]
        if V < mesh.n_data:
            raise ValueError(f"a render of {V} views on a data axis of {mesh.n_data}")
        E = len(members) * mesh.n_ens
        mine, views = mesh.members(E), mesh.views(V)
        local = render(members, occ, origins[views], viewdirs[views], bkgd)
        out = {}
        for k, v in local.items():
            buf = v.new_zeros((E, V) + tuple(v.shape[2:]))
            buf[mine.start:mine.stop, views] = v
            out[k] = mesh.sum_world_bytes(buf)
        return out

    return sharded


def make_sharded_candidate_renderer(cfg: PipelineConfig, mesh: Mesh, max_samples: int,
                                    with_variance: bool = True,
                                    lattice: Optional[torch.Tensor] = None) -> Callable:
    """The mapper's ensemble render (``sharding.py:179-249``) of
    ``max_samples`` samples a ray on ``mesh`` → ``render(members, occ,
    origins [V, P, 3], viewdirs, bkgd) -> {name: [E, V, P, ...]}``. The
    (ngp, occ) render (on ``lattice``, each member on its own grid) is
    sharded the same way: a rank holds only its own members."""
    from ..active.mapper import ensemble_renderer

    return shard_renderer(
        ensemble_renderer(cfg, max_samples, with_variance, mesh.device, lattice), mesh)


def place_training(state, dataset, mesh: Mesh):
    """The rank's members of a whole state on its device, and the
    observation store on that device: every rank holds a copy
    (``sharding.py:252-258``)."""
    state = shard_ensemble_state(state, mesh)
    for name in ("images", "depths", "semantics", "camtoworlds", "K"):
        setattr(dataset, name, getattr(dataset, name).to(mesh.device))
    dataset.device = mesh.device
    return state, dataset
