"""Per cent of its roofline the hash table's backward reaches: the bound
at the encoding's boundary for the samples the march kept (the
benchmark's own march, ``roofline.hash_table_bwd_bound``), once a member
step, over the device time of the kernel's passes in the traced pass."""

from apbench.roofline import hash_table_bwd_bound

PREFIX = "hash_table_bwd_"  # the passes: hash_table_bwd_<pass>_kernel


def read(run):
    if run.trace is None or "kept_per_member_step" not in run.work:
        return None
    t = sum(v for k, v in run.trace["kernel_s"].items() if PREFIX in k)
    if t <= 0:
        return None
    ms, _ = hash_table_bwd_bound(run.cfg, run.work["kept_per_member_step"])
    return 100.0 * ms * 1e-3 * run.trace["work"]["member_steps"] / t
