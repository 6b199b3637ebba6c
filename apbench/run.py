"""Run one cell of the benchmark once and print its result line.

    python -m apbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. Everything of
a cell is found by name: its entry in ``BENCHMARK.json``, its file under
``workloads/`` (the configuration, the traffic and the limits of
``correct``), the configuration under ``configs/``, the traffic mix under
``traffic/`` (whose ``kind`` names the driver under ``drivers/``), and one
reader a metric under ``metrics/``. Set-up runs from process start to the
first timed request; the window then makes requests until ``--seconds``
have passed and ends at a request's read-back. With ``--trace 1`` the
window runs as in any run, then a short pass of further requests runs
under ``torch.profiler`` (``trace.py``), and the line carries the cell's
per-layer metrics instead of its end-to-end ones: the device's time a
unit of work from the pass, the rate of work from the window. After the window the program's state is
freed and the comparison that decides ``correct`` runs; its numbers,
each beside its limit, close standard error and the result line. Beside
them the line's ``host`` key gives what the host did over the window
(its own CPU seconds, the machine's steal time, a fixed Python loop's
time before and after), since the cells' rates follow the host.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import generator
from .trace import REQUEST_SPAN, WINDOW_SPAN, reduce

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "apnerf_tpu")
TRACE_SECONDS = 8.0  # the traced pass after the window
PROBE_ITERS = 200_000  # the host probe: a fixed pure-Python loop


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed at one
    thread, the speed that paces a host-bound cell."""
    t = time.perf_counter()
    x = 0
    for i in range(PROBE_ITERS):
        x += i * i % 7
    return (time.perf_counter() - t) * 1e3


def _steal_ticks() -> tuple:
    """(steal, all) clock ticks of the machine's CPUs from /proc/stat, or (0, 0)."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        return ticks[7] if len(ticks) > 7 else 0, sum(ticks[:8])
    except (OSError, ValueError):
        return 0, 0


def host_sample() -> tuple:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), r.ru_utime + r.ru_stime, r.ru_nivcsw, _steal_ticks()


def host_report(a: tuple, b: tuple, probes) -> dict:
    """What the host did between two ``host_sample``s."""
    (w0, c0, n0, (s0, t0)), (w1, c1, n1, (s1, t1)) = a, b
    return {"wall_s": w1 - w0, "process_cpu_s": c1 - c0, "involuntary_switches": n1 - n0,
            "steal_pct": 100.0 * (s1 - s0) / (t1 - t0) if t1 > t0 else 0.0,
            "probe_ms": list(probes)}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def part(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return load_json(path)


def reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"apbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = HERE, overrides: Optional[dict] = None) -> dict:
    """One run of cell ``name`` → its result (the printed line's object).
    ``overrides``: ``config``, ``traffic`` and ``limits`` keys to replace, for
    small runs on the CPU."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell = cells[name]
    spec = part("workloads", name, root)
    overrides = overrides or {}
    cfg = {**part("configs", cell["config"], root), **overrides.get("config", {})}
    traffic = {**part("traffic", cell["traffic"], root), **overrides.get("traffic", {})}
    driver = importlib.import_module(f"apbench.drivers.{traffic['kind']}")
    metrics = [(m, reader(m["name"], root)) for m in cell_metrics(bench, name, trace)]
    run = SimpleNamespace(cfg=cfg, traffic=traffic, seeds=generator.sub_seeds(seed),
                          device=torch.device(device), trace_on=trace)

    driver.setup(run)
    run.setup_s = process_age_s()
    print(f"set-up {run.setup_s:.2f} s", file=sys.stderr, flush=True)
    probes = [host_probe_ms()]
    failed, ends = 0, []
    h0 = host_sample()
    t0 = h0[0]
    while not ends or ends[-1] < seconds:
        failed += bool(driver.request(run)["failed"])
        ends.append(time.perf_counter() - t0)
    h1 = host_sample()
    probes.append(host_probe_ms())
    n = len(ends)
    run.window_s = ends[-1]
    lasted = [round(1e3 * (b - a), 1) for a, b in zip([0.0] + ends[:-1], ends)]
    print(f"requests {n}, ms each: {lasted}", file=sys.stderr, flush=True)
    host = host_report(h0, h1, probes)
    print(f"host over the window: {json.dumps(host)}", file=sys.stderr, flush=True)
    run.work = driver.work(run, n)
    info = device_info(run.device)
    run.trace = traced_pass(run, driver, min(TRACE_SECONDS, seconds)) if trace else None
    if run.trace is not None:
        info.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    driver.after_window(run)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    values = {}
    for m, read in metrics:
        v = read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    readings = driver.compare(run)
    limits = {**spec["limits"], **overrides.get("limits", {})}
    compared = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": correct, "attempted": n, "failed": failed, "metrics": values,
           "device": info}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["host"] = host
    out["compared"] = compared
    return out


def traced_pass(run, driver, seconds: float) -> dict:
    """Requests for ``seconds`` (one at least) after the window, traced for
    host and device → ``trace.reduce``'s summary and the pass's ``work``."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    n = 0
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            while not n or time.perf_counter() - t0 < seconds:
                with record_function(REQUEST_SPAN):
                    driver.request(run)
                n += 1
    return {**reduce(prof), "work": driver.work(run, n)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(Path("BENCHMARK.json"))
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"BENCHMARK.json has no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print("modules of the JAX stack are loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
