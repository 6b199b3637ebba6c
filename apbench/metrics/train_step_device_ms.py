"""Device milliseconds an ensemble step: the union of the device's busy
intervals in the traced pass over the pass's steps."""


def read(run):
    if run.trace is None or not run.trace["work"].get("steps") or run.trace["busy_s"] <= 0:
        return None
    return run.trace["busy_s"] * 1e3 / run.trace["work"]["steps"]
