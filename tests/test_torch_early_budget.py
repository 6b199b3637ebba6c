"""The early budget of the flagship (spectral + proposal) on the CPU: both
packages' quality harnesses at JAX's ``tiny`` shrink, read at 200 steps.

Protocol (ROADMAP Queue 3, F4's remainder): FakeSim's ``default_room`` at
160², the shrink of ``scripts/quality_headtohead.py::build_mapper(tiny=True)``
(256 rays × 32 samples, 64 test samples, 64-wide fields, a 2^15 hash table),
a 1000-step budget (the cyclic LR spans it), 100-step
``nerf_training(initial_train=True, evaluate=False)`` calls, and the
held-out evaluation after step 200. Each seed is one mapper seed, the same
in both packages.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_early_budget.py FIRST END [OUT]

runs seeds FIRST..END-1 through both harnesses, one JSON line per seed and
package (to OUT too when given), then each package's mean ± sd of PSNR
and Welch's t of the port against JAX. The test below holds the two
harnesses' configurations at this shrink to each other.
"""

import dataclasses
import json
import os
import sys

import numpy as np

IMG, BUDGET, READ_AT = 160, 1000, 200
SHRINK = dict(num_rays=256, max_samples_train=32, max_samples_test=64, spectral_neurons=64,
              main_neurons=64, log2_hashmap_size=15)


def _jax_mapper(seed, img=IMG):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import quality_headtohead as h2h

    return h2h.build_mapper("spectral", "prop", BUDGET, img, seed=seed, tiny=True)


def _port_mapper(seed, img=IMG):
    from apnerf_tpu_torch import quality

    return quality.build_mapper("spectral+prop", BUDGET, img, seed=seed, device="cpu",
                                overrides=SHRINK)


def run_seed(package: str, seed: int) -> dict:
    """One row: ``package`` is ``jax`` or ``port``."""
    mapper, _ = (_jax_mapper if package == "jax" else _port_mapper)(seed)
    done = 0
    while done < READ_AT:
        sl = min(100, READ_AT - done)
        mapper.nerf_training(sl, initial_train=True, evaluate=False)
        done += sl
    mapper._evaluate(-1)
    _, p, dmse, ce = mapper.errors_hist[-1]
    return dict(package=package, seed=seed, steps=READ_AT, psnr=float(p),
                depth_mse=float(dmse), sem_ce=float(ce))


def welch_t(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a.mean() - b.mean())
                 / np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)))


def test_harnesses_share_the_configuration(tmp_path):
    """Both harnesses at the shrink (at 32² to keep the scan cheap) build
    the same pipeline configuration and the same initial scan."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    mj, cj = _jax_mapper(9, img=32)
    mt, ct = _port_mapper(9, img=32)
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    shared = sorted(set(dj) & set(dt) - {"save_path"})
    assert {k: dt[k] for k in shared} == {k: dj[k] for k in shared}
    assert ct.training_steps == BUDGET and ct.num_rays == 256 and ct.img_w == 32
    np.testing.assert_array_equal(mt.train_dataset.images[: mt.train_dataset.size].numpy(),
                                  np.asarray(mj.train_dataset.images)[: mj.train_dataset.size])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "2")))
    first, end = int(sys.argv[1]), int(sys.argv[2])
    out = open(sys.argv[3], "a") if len(sys.argv) > 3 else None
    rows = []
    for seed in range(first, end):
        for package in ("jax", "port"):
            rows.append(run_seed(package, seed))
            line = json.dumps(rows[-1])
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    by = {k: [r["psnr"] for r in rows if r["package"] == k] for k in ("jax", "port")}
    for k, v in by.items():
        print(f"{k}: PSNR@{READ_AT} {np.mean(v):.3f} ± {np.std(v, ddof=1):.3f} over {len(v)} seeds")
    if len(by["jax"]) > 1:
        print(f"Welch t (port - jax): {welch_t(by['port'], by['jax']):.3f}")
