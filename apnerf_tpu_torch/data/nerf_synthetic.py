"""NeRF-Synthetic (blender) dataset loader.

Port of ``apnerf_tpu/data/nerf_synthetic.py``: ``transforms_<split>.json``
and its PNGs → images, OpenGL camera-to-world poses and the focal length
from ``camera_angle_x``; ``rays_for_pixels`` gives the rays through pixels
of those views (``ops/rays.py::rays_from_pixels``). ``imageio`` is
imported inside the loader only, so a host without it can still train on
a ``SubjectData`` built in memory.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.rays import Rays, rays_from_pixels

SUBJECTS = [
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
]


class SubjectData(NamedTuple):
    images: np.ndarray  # [N, H, W, 4] uint8 (RGBA)
    camtoworlds: np.ndarray  # [N, 4, 4] f32
    focal: float
    width: int
    height: int


def read_png(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio
    except ImportError:  # pragma: no cover
        import imageio
    return imageio.imread(path)


def load_subject(root: str, subject: str, split: str = "train",
                 max_images: Optional[int] = None) -> SubjectData:
    with open(os.path.join(root, subject, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"][:max_images] if max_images else meta["frames"]
    images = np.stack([read_png(os.path.join(root, subject, fr["file_path"] + ".png"))
                       for fr in frames])
    c2ws = np.stack([np.asarray(fr["transform_matrix"], dtype=np.float32) for fr in frames])
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return SubjectData(images=images, camtoworlds=c2ws, focal=focal, width=w, height=h)


def intrinsics(data) -> np.ndarray:
    """The pinhole K [3, 3] of a subject's views."""
    return np.array([[data.focal, 0, data.width / 2], [0, data.focal, data.height / 2],
                     [0, 0, 1]], dtype=np.float32)


def rays_for_pixels(data, image_id, x, y, device=None) -> Rays:
    """OpenGL rays through pixels (x, y) of views ``image_id`` (arrays or
    tensors of one shape)."""
    K = torch.as_tensor(intrinsics(data), device=device)
    c2w = torch.as_tensor(np.asarray(data.camtoworlds, np.float32), device=device)
    image_id = torch.as_tensor(np.asarray(image_id), device=device)
    as_f = lambda v: torch.as_tensor(np.asarray(v), device=device).float()  # noqa: E731
    return rays_from_pixels(as_f(x), as_f(y), c2w[image_id], K)
