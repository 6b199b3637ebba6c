"""Per cent of the card's bfloat16 peak (989 TFLOP/s) the planning window
reaches: the candidate render's forward operations (every member, view,
ray and sample of both fields) over the window's wall time (untraced,
host clock)."""

from apbench.roofline import PEAK_BF16_FLOPS, plan_flops


def read(run):
    if run.trace is None or "candidates" not in run.work:
        return None
    flops = plan_flops(run.cfg, run.work["candidates"], run.work["views"],
                       run.work["rays_per_view"])
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
