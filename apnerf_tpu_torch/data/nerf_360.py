"""Mip-NeRF 360 (real captures, COLMAP poses) dataset loader.

Port of ``apnerf_tpu/data/nerf_360.py`` (numpy): the COLMAP sparse model
→ OpenGL camera-to-world poses, the downsampled images of every
``test_every``-th view (test) or the others (train), and the poses
normalised so every camera sits in the unit ball (the unbounded fields'
contraction reads them there).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from .colmap import load_colmap_poses
from .nerf_synthetic import read_png


class SceneData(NamedTuple):
    images: np.ndarray  # [N, H, W, 3] uint8
    camtoworlds: np.ndarray  # [N, 4, 4]
    K: np.ndarray  # [3, 3]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    @property
    def height(self) -> int:
        return self.images.shape[1]


def normalize_poses(c2ws: np.ndarray) -> np.ndarray:
    """Centre on the mean camera position and scale so every camera lies
    in the unit ball."""
    c2ws = c2ws.copy()
    c2ws[:, :3, 3] -= c2ws[:, :3, 3].mean(axis=0)
    scale = np.max(np.linalg.norm(c2ws[:, :3, 3], axis=1))
    if scale > 0:
        c2ws[:, :3, 3] /= scale
    return c2ws


def load_360_scene(root: str, factor: int = 4, split: str = "train", test_every: int = 8,
                   max_images: Optional[int] = None) -> SceneData:
    """``root`` holds ``sparse/0/{cameras,images}.bin`` and ``images[_N]/``
    (full-size ``images/`` when ``images_<factor>/`` is missing)."""
    c2ws, K, names = load_colmap_poses(os.path.join(root, "sparse", "0"))
    img_dir = os.path.join(root, f"images_{factor}" if factor > 1 else "images")
    factor_actual = factor
    if not os.path.isdir(img_dir):
        img_dir, factor_actual = os.path.join(root, "images"), 1
    idx = np.arange(len(names))
    test_mask = idx % test_every == 0
    sel = idx[~test_mask if split == "train" else test_mask]
    if max_images:
        sel = sel[:max_images]
    images = np.stack([read_png(os.path.join(img_dir, names[i]))[..., :3] for i in sel])
    K = K.copy()
    K[:2] /= factor_actual
    return SceneData(images=images.astype(np.uint8), camtoworlds=normalize_poses(c2ws[sel]),
                     K=K.astype(np.float32))
