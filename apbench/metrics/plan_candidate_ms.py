"""Milliseconds of window a candidate: the window's wall time (host
clock) over the candidates it scored and read back."""


def read(run):
    return run.window_s * 1e3 / run.work["candidates"] if "candidates" in run.work else None
