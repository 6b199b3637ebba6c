"""Per cent of the window in which the device ran nothing, in a planning
cell: the device's busy time a candidate (the traced pass) times the
window's candidates, against the window's wall time (untraced, host
clock)."""


def read(run):
    if run.trace is None or not run.trace["work"].get("candidates") or run.trace["busy_s"] <= 0:
        return None
    busy = run.trace["busy_s"] / run.trace["work"]["candidates"] * run.work["candidates"]
    return 100.0 * (1.0 - busy / run.window_s)
