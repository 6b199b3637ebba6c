"""Rays trained across all members a second: E x num_rays a step, summed
over the window's steps, over the window's wall time (host clock)."""


def read(run):
    return run.work["rays"] / run.window_s if "rays" in run.work else None
