"""Start an (ens, data) mesh of ranks and run one program on each.

    results = launch(fn, n_ens, n_data, *args, device="cuda")

starts ``n_ens × n_data`` processes with ``torch.multiprocessing.spawn``.
Each joins a process group through a ``FileStore`` in a fresh temporary
directory, builds its ``Mesh`` (``parallel/mesh.py``, which sets out the
process model) and calls ``fn(mesh, *args)``; the parent returns each
rank's return value, in rank order. ``fn`` is a module-level function of
this package (or of the script that calls ``launch``), so that a rank
imports nothing else. ``args`` travel pickled, and CPU tensors in them
through shared memory: every rank sees the same storage, so a program
copies what it writes (ranks that updated one shared member in place would
each apply their update to it; ``runs.py``'s jobs copy their members).
Tensors are best on the CPU; each rank moves what it needs to its device.

On the card the parent builds the kernel library before it spawns (the
build is ``nvcc`` only and needs no CUDA context), so no rank compiles,
and rank r takes ``cuda:(r % device_count)``: ``nccl`` when every rank has
a device of its own, ``gloo`` when ranks share one. On the CPU the ranks
run ``gloo`` on one thread each. The launcher prints the backend and the
rank → device map on one line. A rank that raises or dies ends the
launch with an exception, and so does a launch that outlives its
``timeout`` (every rank is then killed, and a collective that waits longer
than it raises in its rank); nothing falls back.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, List, Tuple

import torch


def plan(world: int, device) -> Tuple[str, List[torch.device]]:
    """(backend, each rank's device) for ``world`` ranks on ``device``'s
    type, by the rule above."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", [torch.device("cpu")] * world
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on the CPU or on CUDA devices, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh was asked for CUDA devices and none is available; pass "
                           "device='cpu' to run it on the CPU")
    n_dev = torch.cuda.device_count()
    devices = [torch.device("cuda", r % n_dev) for r in range(world)]
    return ("nccl" if world <= n_dev else "gloo"), devices


def _rank_main(rank: int, world: int, n_ens: int, n_data: int, store: str, backend: str,
               devices, timeout: float, fn: Callable, args) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh

    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(n_ens, n_data, device=device)
        out = fn(mesh, *args)
        torch.save(out, f"{store}.result{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ens: int, n_data: int, *args, device="cuda", quiet: bool = False,
           timeout: float = 3600.0):
    """Run ``fn(mesh, *args)`` on every rank of an ``(n_ens, n_data)`` mesh
    → the ranks' return values."""
    import torch.multiprocessing as mp

    world = n_ens * n_data
    backend, devices = plan(world, device)
    if devices[0].type == "cuda":
        from ..ops.cuda import build

        build.build()
    if not quiet:
        print(f"mesh ({n_ens}, {n_data}): backend {backend}, ranks -> devices "
              + ", ".join(f"{r}:{d}" for r, d in enumerate(devices)), flush=True)
    with tempfile.TemporaryDirectory(prefix="apnerf_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                       args=(world, n_ens, n_data, store, backend, devices, timeout, fn, args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the mesh's ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            if devices[0].type == "cuda" and torch.cuda.is_initialized():
                torch.cuda.ipc_collect()  # frees what the ranks held of this process's memory
        return [torch.load(f"{store}.result{r}", weights_only=False) for r in range(world)]
