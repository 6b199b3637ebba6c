"""Quality metrics (``scripts/pipeline.py:596-613,650-656``).

PSNR = -10 log10(MSE); depth MSE; semantic cross-entropy; mIoU (added —
the reference tracks CE only). LPIPS-VGG is gated: it needs pretrained VGG
weights which a zero-egress environment can't fetch; when the ``lpips``
package (or cached weights) is absent the metric reports NaN and the
pipeline continues (the reference hard-requires the net,
``pipeline.py:200``).
"""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))
    if mse <= 0:
        return float("inf")
    return -10.0 * np.log10(mse)


def depth_mse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))


def semantic_ce(logits: np.ndarray, labels: np.ndarray) -> float:
    """Mean cross-entropy of per-pixel class logits vs integer labels."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int64)
    m = logits.max(axis=-1, keepdims=True)
    logp = logits - m - np.log(
        np.sum(np.exp(logits - m), axis=-1, keepdims=True)
    )
    flat_logp = logp.reshape(-1, logp.shape[-1])
    flat_lab = labels.reshape(-1)
    return float(-np.mean(flat_logp[np.arange(len(flat_lab)), flat_lab]))


def miou(pred_labels: np.ndarray, gt_labels: np.ndarray,
         num_classes: int) -> float:
    pred = np.asarray(pred_labels).reshape(-1)
    gt = np.asarray(gt_labels).reshape(-1)
    ious = []
    for c in range(num_classes):
        inter = np.sum((pred == c) & (gt == c))
        union = np.sum((pred == c) | (gt == c))
        if union > 0:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0


_lpips_model = None


def lpips_vgg(pred: np.ndarray, target: np.ndarray) -> float:
    """LPIPS(VGG) if available; NaN otherwise (documented gate)."""
    global _lpips_model
    try:
        if _lpips_model is None:
            import lpips  # type: ignore
            import torch  # noqa: F401

            _lpips_model = lpips.LPIPS(net="vgg")
        import torch

        def prep(x):
            t = torch.from_numpy(np.asarray(x, dtype=np.float32))
            return t.permute(2, 0, 1)[None] * 2 - 1

        with torch.no_grad():
            return float(_lpips_model(prep(pred), prep(target)).item())
    except Exception:
        return float("nan")
