"""The traced pass's reduction, from ``torch.profiler``'s events:
device busy time, kernel time by name and idle gaps by host activity.

A traced run measures its window untraced, as any run does, and then
traces a short pass of the same requests for host and device. The
profiler's hooks slow the host, even with the device alone traced (its
callback on every launch), and not the device, so the pass gives the
device's time a unit of work and the untraced window the rate of work.

The pass is the span ``apbench.window`` that the harness opens around
its requests, each in a span ``apbench.request``. Busy time is the union
of the device's intervals (kernels, copies, sets) inside it. A gap is a
stretch of the span in which no device interval runs; it is named after
the innermost host event that covers its midpoint.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "apbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
REQUEST_SPAN = SPAN_PREFIX + "request"
NAME_CHARS = 160  # a kernel's name in the breakdown, cut (template arguments run long)
TOP = 10


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _events(prof):
    """(device intervals [(start, end, name)], host events [(start, end, name)])."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            # the profiler mirrors the harness's spans onto the device's
            # timeline as annotations; they are no device work
            if not e.name().startswith(SPAN_PREFIX):
                dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    return dev, host


def _union(segs: List[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for s, t in sorted(segs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _top(d: Dict[str, float]) -> list:
    return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(prof) -> dict:
    """→ ``window_s`` (the span's length), ``busy_s``, ``kernel_s``
    ({name: seconds}), ``kernel_n`` ({name: launches}), ``device_ops`` and
    ``idle_gaps`` (the ten largest [name, seconds] of each), from a
    finished profiler that traced host and device."""
    dev, host = _events(prof)
    spans = [(s, t) for s, t, name in host if name == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = spans[0]
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    segs = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        kernel_s[name] += (t - s) * 1e-9
        kernel_n[name] += 1
        segs.append((s, t))
    merged = _union(segs)
    gaps, last = [], w0
    for s, t in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    idle = _name_gaps(gaps, [h for h in host if h[2] != WINDOW_SPAN])
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": sum(t - s for s, t in merged) * 1e-9,
            "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
            "device_ops": _top(kernel_s), "idle_gaps": _top(idle)}


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host event covering
    each gap's midpoint: a sweep over the host events in order of start
    with a stack of those still open (events nest)."""
    host = sorted(host)
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "no host event"] += (b - a) * 1e-9
    return out
