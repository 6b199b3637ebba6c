"""The (ens, data) mesh on ``torch.distributed``: one process per rank.

Port of ``apnerf_tpu/parallel/mesh.py``. The JAX package lays one program
over a device mesh; here the mesh is ``ENS × DATA`` processes that run the
same host loop (SPMD), each on one device:

  * ``ens``: ensemble members are split over it, ``E / n_ens`` a rank, the
    ranks of one ``ens`` coordinate holding the same members;
  * ``data``: each member's rays are split over it in contiguous slices,
    and the gradients are averaged over it, so every ``data`` rank of a
    member applies the same update and holds the same parameters;
  * the observation store is replicated: every rank builds its own from
    the same observations.

The process model:

  * ``parallel/launch.py`` starts the ranks with
    ``torch.multiprocessing.spawn``; each joins the group through a
    ``FileStore`` in a temporary directory (no port to clash). On the
    card the parent builds the kernel library first, so no rank compiles.
  * Backend and device: on the CPU ``gloo``, each rank on one thread. On
    the card rank r takes ``cuda:(r % device_count)``; the backend is
    ``nccl`` when every rank has a device of its own and ``gloo`` when
    ranks share one, where NCCL refuses two ranks on a device (a one-card
    host). ``gloo`` stages CUDA tensors through the host; every kernel
    still runs on the card.
  * The axes' groups come from ``init_device_mesh`` with
    ``mesh_dim_names=("ens", "data")``.
  * Every collective here is ``all_reduce`` or ``broadcast``, which both
    backends take for CUDA tensors. A gather is an ``all_reduce`` (sum) of
    a zero-filled buffer viewed as bytes, in which each rank fills its own
    block: adding zero bytes is exact, so the gathered bits are the
    owner's, NaNs and signed zeros included.
  * Every host decision is taken from values that are the same on every
    rank (gathered, reduced, or broadcast from rank 0 by ``agree``), so the
    ranks never disagree on a trajectory. A collective that fails raises,
    and a rank that dies takes the launch down.

``ensemble_sharding``, ``batch_sharding`` and ``replicated`` are
``NamedSharding`` constructors with no counterpart in a process per rank:
their role passes to ``Mesh.members`` (the rank's members), ``Mesh.rays``
(its slice of a member's rays) and the replicated store.
``shard_ensemble_state`` keeps a rank's members of a state built whole;
``gather_ensemble_state`` puts the whole state back together on every
rank. A mesh of one rank (``Mesh.single``) makes no collective at all: the
unsharded paths are its case.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("ens", "data")


def mesh_shape(world: int, n_ens: int = 2, n_data: Optional[int] = None) -> Tuple[int, int]:
    """The (ens, data) shape ``make_mesh`` gives ``world`` devices, by JAX's
    rule (``mesh.py:29-46``): an ``n_ens`` that does not divide the world
    collapses to 1, and ``n_data`` defaults to ``world // n_ens``. A shape
    larger than the world raises, as JAX's reshape does."""
    if world % n_ens != 0:
        n_ens = 1
    if n_data is None:
        n_data = world // n_ens
    if n_ens * n_data > world or n_ens * n_data < 1:
        raise ValueError(f"a ({n_ens}, {n_data}) mesh does not fit {world} devices")
    return n_ens, n_data


class Mesh:
    """This rank's place in the (ens, data) mesh, its device and the groups
    of its two axes."""

    def __init__(self, n_ens: int, n_data: int, rank: int, device, groups=None,
                 backend: Optional[str] = None):
        self.n_ens, self.n_data, self.rank = n_ens, n_data, rank
        self.device = torch.device(device)
        self.groups = groups or {}
        self.backend = backend
        self.ens_index, self.data_index = divmod(rank, n_data)

    @classmethod
    def single(cls, device="cpu") -> "Mesh":
        """The mesh of one rank: no process group, no collective."""
        return cls(1, 1, 0, device)

    @property
    def shape(self) -> dict:
        return {"ens": self.n_ens, "data": self.n_data}

    @property
    def world(self) -> int:
        return self.n_ens * self.n_data

    def __repr__(self) -> str:
        return (f"Mesh(ens={self.n_ens}, data={self.n_data}, rank={self.rank} at "
                f"({self.ens_index}, {self.data_index}), {self.device}, {self.backend})")

    # ---- this rank's share ----

    def members(self, n_members: int) -> range:
        """The indices of this rank's members among ``n_members``."""
        if n_members % self.n_ens != 0:
            raise ValueError(f"n_ensembles {n_members} % mesh ens axis {self.n_ens} != 0")
        k = n_members // self.n_ens
        return range(self.ens_index * k, (self.ens_index + 1) * k)

    def rays(self, n_rays: int) -> slice:
        """This rank's contiguous slice of a member's ``n_rays`` rays."""
        if n_rays % self.n_data != 0:
            raise ValueError(f"num_rays {n_rays} % data axis {self.n_data} != 0")
        k = n_rays // self.n_data
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def views(self, n_views: int) -> slice:
        """This rank's contiguous run of ``n_views`` views, split as evenly
        as the count allows (any count: a render's rays are sharded at view
        boundaries)."""
        edges = np.linspace(0, n_views, self.n_data + 1).round().astype(int)
        return slice(int(edges[self.data_index]), int(edges[self.data_index + 1]))

    # ---- collectives ----

    def _group(self, axis: Optional[str]):
        return None if axis is None else self.groups[axis]

    def _size(self, axis: Optional[str]) -> int:
        return {"ens": self.n_ens, "data": self.n_data, None: self.world}[axis]

    def mean_data(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over ``data`` of each tensor (one ``all_reduce`` of
        their concatenation): a member's gradients, in the member core's
        ``grad_reduce``. On one ``data`` rank the tensors themselves."""
        tensors = list(tensors)
        if self.n_data == 1:
            return tensors
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self._group("data"))
        flat = flat / self.n_data
        return [v.view_as(t).to(t.dtype)
                for v, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``data`` of ``t`` (a count over a member's rays)."""
        if self.n_data == 1:
            return t
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=self._group("data"))
        return t

    def sum_world_bytes(self, buf: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``buf`` (each zero outside its own block) summed
        over ``axis`` (or the whole mesh) byte by byte: the gather."""
        if self._size(axis) == 1:
            return buf
        import torch.distributed as dist

        raw = buf.contiguous().reshape(-1).view(torch.uint8)
        dist.all_reduce(raw, group=self._group(axis))
        return raw.view(buf.dtype).view(buf.shape)

    def gather_ens(self, local: torch.Tensor) -> torch.Tensor:
        """[E_l, ...] of this rank's members → [E, ...] of every member, the
        same bits on every rank (over the ``ens`` axis: each ``data`` rank
        of a member holds the same values)."""
        if self.n_ens == 1:
            return local
        E_l = local.shape[0]
        buf = local.new_zeros((E_l * self.n_ens,) + tuple(local.shape[1:]))
        buf[self.ens_index * E_l:(self.ens_index + 1) * E_l] = local
        return self.sum_world_bytes(buf, "ens")

    def mean_data_gather_ens(self, local: torch.Tensor) -> torch.Tensor:
        """[..., E_l] per-rank means (a member's loss over its rays) → [...,
        E]: the mean over ``data``, then every member's, on every rank."""
        if self.n_data > 1:
            (local,) = self.mean_data([local])
        return self.gather_ens(local.movedim(-1, 0)).movedim(0, -1)

    def agree(self, obj):
        """Rank 0's ``obj`` on every rank (a host decision: the chosen
        candidate, the divergence guard's reading)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self._object_device())
        return box[0]

    def _object_device(self):
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()


def make_mesh(n_ens: int = 2, n_data: Optional[int] = None, device="cuda") -> Mesh:
    """This rank's mesh over the initialized process group, with JAX's
    shape rule (``mesh_shape``). Every rank of the group has a place: a
    shape smaller than the world raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n_ens, n_data = mesh_shape(world, n_ens, n_data)
    if n_ens * n_data != world:
        raise ValueError(f"a ({n_ens}, {n_data}) mesh leaves ranks of a world of {world} "
                         "without a place")
    device = torch.device(device)
    dm = init_device_mesh(device.type, (n_ens, n_data), mesh_dim_names=AXES)
    return Mesh(n_ens, n_data, dist.get_rank(), device,
                groups={a: dm.get_group(a) for a in AXES}, backend=dist.get_backend())


# -- the ensemble state over the mesh ---------------------------------------------------------


def state_to(state, device):
    """An ``EnsembleState`` on ``device`` (members move in place)."""
    from ..ops.occupancy import OccGridState
    from ..train.step import AdamState

    device = torch.device(device)
    return state._replace(
        members=[m.to(device) for m in state.members],
        opt=[AdamState(*(t.to(device) for t in o)) for o in state.opt],
        occ=[OccGridState(*(t.to(device) for t in o)) for o in state.occ],
    )


def shard_ensemble_state(state, mesh: Mesh):
    """The rank's members of a whole ``EnsembleState`` (every rank builds
    all E from the same seeded generator, so each member's initial
    weights are the unsharded ones), on the mesh's device."""
    keep = mesh.members(len(state.members))
    pick = lambda xs: [xs[i] for i in keep]  # noqa: E731
    return state_to(state._replace(members=pick(state.members), opt=pick(state.opt),
                                   occ=pick(state.occ)), mesh.device)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def gather_ensemble_state(state, mesh: Mesh):
    """The whole ``EnsembleState`` on every rank from each rank's members:
    parameters, Adam moments and counts, and occupancy grids of every
    member, exact. Members of other ranks are copies of a local member's
    module with the owner's values."""
    from ..ops.occupancy import OccGridState
    from ..train.step import AdamState

    if mesh.n_ens == 1:
        return state
    E_l = len(state.members)

    def gathered(rows: List[torch.Tensor]) -> torch.Tensor:
        return mesh.gather_ens(torch.stack(rows))

    params = gathered([_flat(m.parameters()) for m in state.members])
    mu = gathered([o.mu for o in state.opt])
    nu = gathered([o.nu for o in state.opt])
    count = gathered([o.count for o in state.opt])
    occs = gathered([o.occs for o in state.occ])
    binaries = gathered([o.binaries for o in state.occ])
    members, opt, occ = [], [], []
    mine = mesh.members(E_l * mesh.n_ens)
    for i in range(E_l * mesh.n_ens):
        if i in mine:
            member = state.members[i - mine.start]
        else:
            member = copy.deepcopy(state.members[0])
            with torch.no_grad():
                ps = list(member.parameters())
                for p, v in zip(ps, torch.split(params[i], [p.numel() for p in ps])):
                    p.copy_(v.view_as(p))
        members.append(member)
        opt.append(AdamState(mu[i], nu[i], count[i]))
        occ.append(OccGridState(occs[i], binaries[i], state.occ[0].aabb))
    return state._replace(members=members, opt=opt, occ=occ)

