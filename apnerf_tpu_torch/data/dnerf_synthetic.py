"""D-NeRF synthetic (time-conditioned) dataset loader.

Port of ``apnerf_tpu/data/dnerf_synthetic.py``: NeRF-Synthetic's layout
whose frames carry a ``time`` in [0, 1] (frame i of n reads i / (n - 1)
where the field is missing), for the T-NeRF trainer.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

from .nerf_synthetic import read_png


class DNeRFData(NamedTuple):
    images: np.ndarray  # [N, H, W, 4] uint8
    camtoworlds: np.ndarray  # [N, 4, 4]
    times: np.ndarray  # [N] in [0, 1]
    focal: float
    width: int
    height: int


def load_dnerf_subject(root: str, subject: str, split: str = "train",
                       max_images: Optional[int] = None) -> DNeRFData:
    with open(os.path.join(root, subject, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"][:max_images] if max_images else meta["frames"]
    images = np.stack([read_png(os.path.join(root, subject, fr["file_path"] + ".png"))
                       for fr in frames])
    c2ws = np.stack([np.asarray(fr["transform_matrix"], dtype=np.float32) for fr in frames])
    times = [float(fr.get("time", i / max(len(frames) - 1, 1))) for i, fr in enumerate(frames)]
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return DNeRFData(images=images, camtoworlds=c2ws, times=np.asarray(times, dtype=np.float32),
                     focal=focal, width=w, height=h)
