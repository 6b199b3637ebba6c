"""Per cent of its roofline the packed field forward (K4, ``ffh_fwd_kernel``)
reaches: each launch's bound at a view's rays x samples
(``roofline.field_heads_fwd_bound``) over its device time, summed over
the launches the traced pass recorded."""

from apbench.roofline import field_heads_fwd_bound

NAME = "ffh_fwd_kernel"


def read(run):
    if run.trace is None or "rays_per_view" not in run.work:
        return None
    t = sum(v for k, v in run.trace["kernel_s"].items() if NAME in k)
    n = sum(v for k, v in run.trace["kernel_n"].items() if NAME in k)
    if t <= 0 or n == 0:
        return None
    ms, _ = field_heads_fwd_bound(run.cfg, run.work["rays_per_view"], run.cfg["max_samples_unc"])
    return 100.0 * ms * 1e-3 * n / t
