"""Which chunks of the hash table's backward take its claim rounds on real
training steps, and what the reduce costs without them.

Runs on one CUDA card, from the repository's root:

    python scripts/probe_hash_rounds.py [--out chiprun_out/probe_hash_rounds.json]

``csrc/hash_table_bwd.cu``'s reduce sums a chunk of 1024 terms by claim
rounds (a key's first terms chained into the slice) when the chunk holds at
least a quarter as many keys as terms, and by its block tree alone
otherwise. This script builds the port's kernels and, beside them, a
variant of that file in which every chunk goes to its tree whole. It takes
the table backward's terms of real steps: an ngp+occ member step on the
bench's scan after 100 training steps (``chip_smoke.py`` phase 19's), the
NGP + occupancy example trainer after 500 steps, and both table backwards
of an NGP + proposal trainer step after 100 steps (phase 21's trainers);
and phase 30's uniform and slab corners at 33.5M terms. For each it prints
the share of chunks, and of terms, that take the rounds, the keys a chunk,
the wrapper's window and the reduce pass's device time of both builds, and
whether their outputs are equal bit for bit. The variant is also held bit
for bit to ``hash_table_bwd_emulated`` with every chunk sent to its tree,
on phase 30's small cases.

The kernel file has since lost the rounds (the readings below chose the
tree alone), and the emulation its ``ROUNDS``: on such a file the script
stops at the switch it patches. It stays as the source of PERF.md's
readings of the rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from apnerf_tpu_torch.ops import hashgrid  # noqa: E402
from apnerf_tpu_torch.ops.cuda import build, hash_table  # noqa: E402
from apnerf_tpu_torch.ops.cuda.hash_table import CHUNK, hash_table_bwd, row_bits  # noqa: E402

ROUNDS_SWITCH = ("    atomicAdd(&n_keys, __popc(won));\n    __syncthreads();\n"
                 "    if (4 * n_keys >= n) {")
TREE_ONLY = "    __syncthreads();  // the claims are read before the tree names the keys\n    if (false) {"


def start_variant():
    """nvcc on the tree-only variant of the kernel file, started → (process, .so path)."""
    src = (build.CSRC / "hash_table_bwd.cu").read_text()
    if ROUNDS_SWITCH not in src:
        raise SystemExit("probe_hash_rounds: the reduce's switch to the rounds is not in the source")
    out = build.BUILD_DIR / "probe_hash_rounds"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "hash_table_bwd_tree.cu"
    cu.write_text(src.replace(ROUNDS_SWITCH, TREE_ONLY))
    so = out / "libhash_table_bwd_tree.so"
    proc = subprocess.Popen([build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def load_variant(so):
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apnerf_hash_table_bwd.argtypes = [p, p, p, ll, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.apnerf_hash_table_bwd.restype = i
    lib.apnerf_hash_table_bwd_slots.argtypes = [i, i, i]
    lib.apnerf_hash_table_bwd_slots.restype = i
    return lib


def chunk_stats(n_rows, idx, F):
    """The reduce's chunks of these terms → (chunks, share of chunks that take
    the rounds, share of terms in them, keys a chunk)."""
    key = idx.long()
    key = key[(key >= 0) & (key < n_rows)]
    bucket = key >> row_bits(F)
    order = torch.sort(bucket, stable=True).indices
    b, k = bucket[order], key[order]
    counts = torch.bincount(b)
    start = torch.cumsum(counts, 0) - counts
    chunk = b * (1 << 20) + (torch.arange(k.shape[0], device=k.device) - start[b]) // CHUNK
    chunks, n_terms = torch.unique(chunk, return_counts=True)
    pairs = torch.unique(chunk * (1 << 24) + k)
    _, n_keys = torch.unique(pairs >> 24, return_counts=True)
    rounds = 4 * n_keys >= n_terms
    return (int(chunks.numel()), float(rounds.float().mean()),
            float(n_terms[rounds].sum() / n_terms.sum()), float(n_keys.float().mean()))


def capture(run, last=1):
    """The table backward's calls of ``run()``: the last ``last`` of them."""
    seen = []

    def record(n_rows, idx, g, weights=None):
        seen.append((n_rows, idx, g, weights))
        del seen[:-last]
        return hash_table_bwd(n_rows, idx, g, weights)

    hashgrid.hash_table_bwd = record
    try:
        run()
    finally:
        hashgrid.hash_table_bwd = hash_table_bwd
    torch.cuda.synchronize()
    return seen


def real_terms(dev):
    """{label: (n_rows, idx, g, w)} of the real steps."""
    from apnerf_tpu_torch import bench, train_ngp_occ
    from apnerf_tpu_torch.train.phase import make_ngp_train_phase, pools_from_dataset
    from apnerf_tpu_torch.train.step import init_ensemble, make_lattice

    out = {}
    ds = bench.make_data(dev).dataset
    cfg = cs._ngp_config()
    state = init_ensemble(cfg, cs._generator(dev, 20), dev)
    phase_fn = make_ngp_train_phase(cfg, make_lattice(cfg, dev))
    pools, counts = pools_from_dataset(ds)
    gen = cs._generator(dev, 19)
    got = capture(lambda: phase_fn(state, ds.images, ds.depths, ds.semantics, ds.camtoworlds,
                                   ds.K, pools, counts, ds.size, 100, False, gen,
                                   occ_thre=cfg.occ_thre_for_phase(-1)))
    out["ngp+occ member step (bench scan, step 100)"] = got[-1]

    train_data = cs.synthetic_subject(100, 0.0)
    test_data = cs.synthetic_subject(8, 1.234)
    got = capture(lambda: train_ngp_occ.train(train_data, test_data, steps=500, num_rays=4096,
                                              aabb=cs.SYNTH_AABB, eval_every=500, device=dev))
    out["NGP + occupancy trainer (step 500)"] = got[-1]

    views = cs._views(train_data, dev)
    state, _, prop_step, _, _ = cs._prop_trainer(dev, views)
    for i in range(99):
        state = prop_step(state, i)[0]
    got = capture(lambda: prop_step(state, 99), last=2)
    for (n_rows, idx, g, w) in got:
        out[f"NGP + proposal trainer (step 100), {n_rows} rows"] = (n_rows, idx, g, w)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_hash_rounds.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_hash_rounds: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    proc, so = start_variant()
    shipping = build.library()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        print(log, file=sys.stderr)
        return 1
    variant = load_variant(so)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    def use(lib):
        build._lib = lib

    # the variant against the emulated order with every chunk sent to its tree
    gen = cs._generator(dev, 3030)
    use(variant)
    rounds = hash_table.ROUNDS
    for kind, N, F, n_rows, weighted in cs.HASH_SMALL:
        idx, g, w, n_rows = cs._hash_case(gen, dev, kind, N, F, n_rows, weighted)
        got = hash_table_bwd(n_rows, idx, g, w).cpu().numpy()
        hash_table.ROUNDS = 0
        try:
            ref = hash_table.hash_table_bwd_emulated(n_rows, idx.cpu(), g.cpu(),
                                                     None if w is None else w.cpu())
        finally:
            hash_table.ROUNDS = rounds
        print(f"tree-only variant [{kind}, small]: bit for bit against the emulated order with "
              f"every chunk sent to its tree {np.array_equal(got, ref)}", flush=True)
    use(shipping)

    cases = real_terms(dev)
    gen = cs._generator(dev, 3030)
    for kind in ("uniform", "slab"):
        idx, g, w, n_rows = cs._hash_case(gen, dev, kind, 1 << 18, 4, None, True)
        cases[f"phase 30 {kind} weighted"] = (n_rows, idx, g, w)
    rows = {}
    for label, (n_rows, idx, g, w) in cases.items():
        F = g.shape[1]
        n_chunks, share, share_terms, keys = chunk_stats(n_rows, idx, F)
        call = lambda: hash_table_bwd(n_rows, idx, g, w)  # noqa: E731
        row = dict(terms=int(idx.shape[0]), rows=n_rows, F=F, chunks=n_chunks,
                   share_chunks_rounds=share, share_terms_rounds=share_terms, keys_a_chunk=keys)
        outs = []
        for name, lib in (("rounds", shipping), ("tree", variant), ("rounds", shipping),
                          ("tree", variant)):
            use(lib)
            outs.append(call())
            ms = cs.cuda_ms(call)
            red = cs.kernel_device_ms(call, "hash_table_bwd_reduce_kernel", calls=10)
            row.setdefault(f"{name}_ms", []).append(ms)
            row.setdefault(f"{name}_reduce_ms", []).append(red)
        use(shipping)
        row["bits_equal"] = bool(torch.equal(outs[0], outs[1]))
        rows[label] = row
        fmt = lambda xs: " / ".join("not measured" if x is None else f"{x:.4f}" for x in xs)  # noqa: E731
        print(f"{label}: {row['terms']} terms into {n_rows} x {F}, {n_chunks} chunks, "
              f"{keys:.1f} keys a chunk; {share:.4f} of chunks ({share_terms:.4f} of terms) take "
              f"the rounds | wrapper with rounds {fmt(row['rounds_ms'])} ms, tree only "
              f"{fmt(row['tree_ms'])} ms; reduce with rounds {fmt(row['rounds_reduce_ms'])} ms, "
              f"tree only {fmt(row['tree_reduce_ms'])} ms; outputs bit for bit "
              f"{row['bits_equal']}", flush=True)
        del outs
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=cs.nvidia_smi(), cases=rows), indent=1))
    print(f"probe_hash_rounds: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
