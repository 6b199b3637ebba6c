"""Per cent of the card's float32 peak (67 TFLOP/s) the train window
reaches: the NGP field's matrix-product operations, forward and backward,
on the samples the march kept, over the window's wall time (the window
runs untraced in every run; the traced pass after it only gives the
per-layer metrics their device times)."""

from apbench.roofline import PEAK_F32_FLOPS, ngp_train_flops


def read(run):
    if run.trace is None or "kept_samples" not in run.work:
        return None
    return 100.0 * ngp_train_flops(run.cfg, run.work["kept_samples"]) / (
        run.window_s * PEAK_F32_FLOPS)
