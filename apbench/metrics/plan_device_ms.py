"""Device milliseconds a candidate: the union of the device's busy
intervals in the traced pass over the pass's candidates."""


def read(run):
    if run.trace is None or not run.trace["work"].get("candidates") or run.trace["busy_s"] <= 0:
        return None
    return run.trace["busy_s"] * 1e3 / run.trace["work"]["candidates"]
