"""Seconds from process start to the first timed request: imports, the
kernels' build and load, weights, the scan, and the warm-up."""


def read(run):
    return run.setup_s
