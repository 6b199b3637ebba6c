"""Colour maps of the visualisation dumps.

Port of ``apnerf_tpu/viz/render_views.py``'s ``colorize_depth`` and
``colorize_semantics``, which the mapper's PNG dumps use; the comparison
renders, walkthroughs and video stitching there are not ported.
"""

from __future__ import annotations

import numpy as np


def colorize_depth(depth: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    d = np.clip(np.asarray(depth) / max_depth, 0, 1)
    # a turbo-like ramp, without matplotlib
    r = np.clip(1.5 - np.abs(2.0 * d - 1.0) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * d - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * d) * 2.0, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def colorize_semantics(sem: np.ndarray, num_classes: int) -> np.ndarray:
    """Categorical colours, class 0 black."""
    rng = np.random.RandomState(0)
    palette = (rng.rand(max(num_classes, 1), 3) * 200 + 40).astype(np.uint8)
    palette[0] = (0, 0, 0)
    return palette[np.asarray(sem) % max(num_classes, 1)]
