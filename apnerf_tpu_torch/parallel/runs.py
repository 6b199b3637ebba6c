"""Programs a rank runs, for ``launch``: the sharded train phases and
step and the sharded render, each on a state built whole by the caller
and handed over on the CPU, and the mesh-mode mapper's loop. They return numpy arrays, every member's, the
same on every rank, so the caller holds them to an unsharded run.

    launch(jobs, n_ens, n_data, [(train_job, {...}), (render_job, {...})])

runs several in one launch (a launch costs its processes' start).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, gather_ensemble_state, state_to


@contextlib.contextmanager
def field_dtype(dtype: Optional[str]):
    """The flagship's field configurations in ``dtype`` while the context
    lasts (``make_spectral_config``, ``make_prop_config``; the pipeline
    configuration has no such option): a float32 field takes the member
    core's plain route."""
    from ..train import flagship

    if dtype is None:
        yield
        return
    saved = flagship.make_spectral_config, flagship.make_prop_config
    flagship.make_spectral_config = lambda c: saved[0](c)._replace(compute_dtype=dtype)
    flagship.make_prop_config = lambda c: saved[1](c)._replace(compute_dtype=dtype)
    try:
        yield
    finally:
        flagship.make_spectral_config, flagship.make_prop_config = saved


def _own(state, mesh: Mesh):
    """A copy of this rank's members of the whole ``state`` on its device
    (the caller's state, shared by the ranks, stays as it was)."""
    keep = mesh.members(len(state.members))
    pick = lambda xs: [xs[i] for i in keep]  # noqa: E731
    mine = state._replace(members=pick(state.members), opt=pick(state.opt), occ=pick(state.occ))
    return state_to(copy.deepcopy(mine), mesh.device)


def _report(state, mesh: Mesh) -> dict:
    """``state_arrays`` of every member, gathered: the arrays on rank 0,
    their ``output_digest`` on the others (they hold the same bits, and a
    large table need not travel back once a rank)."""
    arrays = state_arrays(gather_ensemble_state(state, mesh))
    if mesh.rank == 0:
        return arrays
    return {k: output_digest(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}


def state_arrays(state) -> dict:
    """Every member's parameters [E, P], Adam moments and grids, as numpy."""
    flat = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts])  # noqa: E731
    return {
        "params": np.stack([flat(m.parameters()).cpu().numpy() for m in state.members]),
        "mu": np.stack([o.mu.cpu().numpy() for o in state.opt]),
        "count": np.array([int(o.count) for o in state.opt]),
        "occs": np.stack([o.occs.cpu().numpy() for o in state.occ]),
        "binaries": np.stack([o.binaries.cpu().numpy() for o in state.occ]),
        "step": state.step,
    }


def train_job(mesh: Mesh, cfg, kind: str, state, store: Sequence, n_steps: int,
              seed: Optional[int] = None, draws=None, recent_bias: bool = False,
              occ_thre: float = 1e-3, image_idx=None, dtype: Optional[str] = None,
              one_step_calls: bool = False, occ_update: bool = False,
              snapshots: Sequence[int] = ()) -> dict:
    """``n_steps`` of ``kind`` on ``mesh`` from the whole ``state``:
    ``flagship`` (``make_sharded_flagship_phase``), ``ngp``
    (``make_sharded_occ_phase``) or ``step`` (``make_sharded_train_step``
    on ``image_idx``, one step a call). ``store``: images, depths,
    semantics, camtoworlds, K, pools, counts and size. Draws come from a
    generator on the rank's device seeded ``seed`` (0 when ``draws`` are
    given), or from ``draws``. ``one_step_calls`` calls the phase once a
    step and times each call; ``occ_update`` follows the flagship's steps
    with its occupancy update (the chunk's, on the rank's members, with
    every member's draws) → the losses [n_steps, E], the wall ``seconds``
    of each call and on the card ``device_ms`` (CUDA events on the
    rank's stream), ``state_arrays`` of the final state (``_report``), and
    in ``at`` the parameters and Adam's first moment after each step of
    ``snapshots`` (with ``one_step_calls``)."""
    from ..train.step import make_lattice
    from .sharding import (
        make_sharded_flagship_phase,
        make_sharded_occ_phase,
        make_sharded_train_step,
    )

    dev = mesh.device
    images, depths, semantics, c2w, K, pools, counts, size = (
        t.to(dev) if torch.is_tensor(t) else t for t in store)
    state = _own(state, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed or 0)
    with field_dtype(dtype):
        if kind == "flagship":
            fn = make_sharded_flagship_phase(cfg, mesh)
        elif kind == "ngp":
            fn = make_sharded_occ_phase(cfg, mesh, make_lattice(cfg, dev))
        elif kind == "step":
            fn = make_sharded_train_step(cfg, mesh, make_lattice(cfg, dev))
        else:
            raise ValueError(f"unknown train job {kind!r}")
    losses, seconds, events, at = [], [], [], {}
    calls = n_steps if one_step_calls or kind == "step" else 1
    cuda = torch.device(dev).type == "cuda"
    for i in range(calls):
        k = n_steps // calls
        d = None if draws is None else draws[i * k:(i + 1) * k]
        _sync(dev)
        t0 = time.perf_counter()
        if cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        if kind == "step":
            out = fn(state, images, depths, semantics, c2w, K, torch.as_tensor(image_idx[i]),
                     occ_thre, generator=gen, draws=None if d is None else d[0])
            state, loss = out.state, out.loss[None]
        else:
            state, loss = fn(state, images, depths, semantics, c2w, K, pools, counts, size, k,
                             recent_bias, gen, draws=d, occ_thre=occ_thre)
        if cuda:
            events[-1][1].record()
        loss = loss.cpu()
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.numpy())
        if calls == n_steps and i + 1 in snapshots:
            arrays = _report(state, mesh)
            at[i + 1] = {k: arrays[k] for k in ("params", "mu")}
    if occ_update:
        from ..train.flagship import make_flagship_occ_update

        state = state._replace(occ=make_flagship_occ_update(cfg)(
            state.members, state.occ, state.step, occ_thre, generator=gen,
            local=mesh.members(cfg.n_ensembles)))
    return {"losses": np.concatenate(losses), "seconds": seconds,
            "device_ms": [a.elapsed_time(b) for a, b in events], "at": at,
            **_report(state, mesh)}


def render_job(mesh: Mesh, cfg, state, origins: torch.Tensor, viewdirs: torch.Tensor,
               bkgd: torch.Tensor, max_samples: int, with_variance: bool,
               digest: bool = False) -> dict:
    """The sharded ensemble render (``make_sharded_candidate_renderer``) of
    ``origins``/``viewdirs`` [V, P, 3] by the whole ``state``'s members →
    every member's outputs [E, V, P, ...] as numpy (with ``digest``, each
    output's ``digest`` instead), and the render's ``seconds``."""
    from ..train.step import make_lattice
    from .sharding import make_sharded_candidate_renderer

    dev = mesh.device
    state = _own(state, mesh)
    lattice = None if cfg.sampler_type == "prop" else make_lattice(cfg, dev)
    render = make_sharded_candidate_renderer(cfg, mesh, max_samples, with_variance, lattice)
    _sync(dev)
    t0 = time.perf_counter()
    out = render(state.members, state.occ, origins.to(dev), viewdirs.to(dev), bkgd.to(dev))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    _sync(dev)
    seconds = time.perf_counter() - t0
    if digest:
        out = {k: output_digest(v) for k, v in out.items()}
    return {**out, "seconds": seconds}


def same_bits(got, want: np.ndarray) -> bool:
    """Whether ``got`` (an array, or a rank's ``output_digest`` of one)
    holds the bits of ``want``."""
    if isinstance(got, tuple):
        return got == output_digest(want)
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    return got.shape == want.shape and got.dtype == want.dtype and got.tobytes() == want.tobytes()


def output_digest(a: np.ndarray) -> tuple:
    """(sha256 of the bytes, shape, float64 sum): equal digests are equal
    bits; the sums say how far two renders are apart when they are not."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes()).hexdigest(), a.shape, float(a.astype(np.float64).sum())


def loop_job(mesh: Mesh, cfg, save_path: str, sim: dict, initial_samples: int = 8,
             **mapper_kw) -> dict:
    """``pipeline()`` of a mapper on ``mesh`` (a single-rank mesh: the
    unsharded mapper) over FakeSim (``sim``: its keyword arguments), its
    scan cut to ``initial_samples`` views → its histories, the poses and
    images it supervised, and every member's final state (``_report``)."""
    from ..active.mapper import ActiveNeRFMapper
    from ..sim.fake import FakeSim

    m = ActiveNeRFMapper(cfg, FakeSim(**sim), save_path=save_path, device=mesh.device,
                         mesh=mesh if mesh.world > 1 else None, **mapper_kw)
    initialization = m.initialization
    m.initialization = lambda: initialization(initial_samples=initial_samples)
    m.pipeline()
    ds = m.train_dataset
    return {"errors_hist": np.asarray(m.errors_hist), "loss_hist": m.loss_hist,
            "uncertainty": m.trajector_uncertainty_list,
            "camtoworlds": ds.camtoworlds[:ds.size].cpu().numpy(),
            "images": ds.images[:ds.size].cpu().numpy(), **_report(m.state, mesh)}


def jobs(mesh: Mesh, todo: List[Tuple[Callable, dict]]) -> list:
    """Run each ``(job, kwargs)`` of ``todo`` in order → their results."""
    return [job(mesh, **kw) for job, kw in todo]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
