"""The online ray dataset: a fixed-capacity observation store on the
device, bootstrap pools, and the training ray fetch.

Port of ``apnerf_tpu/data/dataset.py``: ``RayBatch``, ``fetch_rays``
(``:44-100``: one image per member, ``num_rays`` random pixels by a flat
gather, uint8/255 colors, OpenGL rays from K, a random background in
training) and the ``RayDataset`` store with ``update_data``,
``bootstrap`` and ``sample_image_indices`` (``:103-191``). The store is
preallocated at ``max_images`` so appends are slice writes. The bootstrap
pools and the host-side image choice use the same numpy generator as the
JAX package, so a seed gives the same pools in both. ``resample_data``,
``save`` and ``load`` come with the mapper loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.rays import make_intrinsics, rays_from_pixels


class RayBatch(NamedTuple):
    """One member's training batch (device tensors)."""

    origins: torch.Tensor  # [R, 3]
    viewdirs: torch.Tensor  # [R, 3]
    pixels: torch.Tensor  # [R, 3] in [0, 1]
    depth: torch.Tensor  # [R]
    sem: torch.Tensor  # [R] int32
    color_bkgd: torch.Tensor  # [3]


def fetch_rays(
    images: torch.Tensor,  # [N, H, W, 3] uint8
    depths: torch.Tensor,  # [N, H, W] f32
    semantics: torch.Tensor,  # [N, H, W] int32
    camtoworlds: torch.Tensor,  # [N, 4, 4]
    K: torch.Tensor,  # [3, 3]
    image_idx: torch.Tensor,  # [] int (a device tensor: no host sync)
    num_rays: int,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> RayBatch:
    """``num_rays`` random pixels of one image as a ray batch. ``draws``
    (``{"x", "y", "bkgd"}``: pixel columns and rows [R] int, background
    [3] in [0, 1)) replaces the generator's draws."""
    H, W = images.shape[1], images.shape[2]
    dev = images.device
    if draws is None:
        x = torch.randint(0, W, (num_rays,), generator=generator, device=dev)
        y = torch.randint(0, H, (num_rays,), generator=generator, device=dev)
        bkgd = torch.rand((3,), generator=generator, device=dev)
    else:
        x, y, bkgd = draws["x"].to(dev).long(), draws["y"].to(dev).long(), draws["bkgd"].to(dev)
    flat = image_idx.long() * (H * W) + y * W + x
    rgb8 = images.reshape(-1, 3)[flat]
    dep = depths.reshape(-1)[flat]
    sem = semantics.reshape(-1)[flat]
    c2w = camtoworlds[image_idx.long()]
    rays = rays_from_pixels(x.float(), y.float(), c2w, K)
    return RayBatch(
        origins=rays.origins,
        viewdirs=rays.viewdirs,
        pixels=rgb8.float() / 255.0,
        depth=dep,
        sem=sem.to(torch.int32),
        color_bkgd=bkgd.float() if training else torch.ones(3, device=dev),
    )


class RayDataset:
    """Host-side manager of the fixed-capacity device observation store."""

    def __init__(
        self,
        training: bool,
        num_rays: int = 1024,
        num_models: int = 1,
        width: int = 640,
        height: int = 640,
        hfov: float = np.pi / 2,
        max_images: int = 512,
        boot_scale: float = 0.7,
        seed: int = 9,
        device="cuda",
    ):
        self.training = training
        self.num_rays = num_rays
        self.num_models = num_models
        self.boot_scale = boot_scale
        self.max_images = max_images
        self.size = 0
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.K = torch.as_tensor(make_intrinsics(width, height, hfov), device=self.device)
        self._rng = np.random.RandomState(seed)
        # bootstrap pools for members 1..num_models-1 (member 0 = all data)
        self.bootstrap_indices = [np.array([], dtype=np.int64) for _ in range(num_models - 1)]
        dev = self.device
        self.images = torch.zeros((max_images, height, width, 3), dtype=torch.uint8, device=dev)
        self.depths = torch.zeros((max_images, height, width), dtype=torch.float32, device=dev)
        self.semantics = torch.zeros((max_images, height, width), dtype=torch.int32, device=dev)
        self.camtoworlds = torch.eye(4, device=dev).repeat(max_images, 1, 1)

    def __len__(self) -> int:
        return self.size

    def update_data(self, images, depths, semantics, camtoworlds) -> None:
        """Append a batch of observations (``dataset.py:146-168``)."""
        images = np.asarray(images)[..., :3].astype(np.uint8)
        n = len(images)
        if self.size + n > self.max_images:
            raise ValueError(
                f"RayDataset capacity {self.max_images} exceeded "
                f"({self.size} + {n}); raise max_images."
            )
        for i, arr in enumerate(self.bootstrap_indices):
            ids = self._rng.choice(n, size=int(n * self.boot_scale), replace=True)
            self.bootstrap_indices[i] = np.concatenate([arr, self.size + ids])
        sl = slice(self.size, self.size + n)
        dev = self.device
        self.images[sl] = torch.as_tensor(images, device=dev)
        self.depths[sl] = torch.as_tensor(np.asarray(depths, np.float32), device=dev)
        self.semantics[sl] = torch.as_tensor(np.asarray(semantics).astype(np.int32), device=dev)
        self.camtoworlds[sl] = torch.as_tensor(np.asarray(camtoworlds, np.float32), device=dev)
        self.size += n

    def bootstrap(self, model_idx: int) -> np.ndarray:
        """Index pool visible to a member (member 0 sees every image)."""
        if model_idx == 0:
            return np.arange(self.size)
        return self.bootstrap_indices[model_idx - 1]

    def sample_image_indices(self, recent_bias: bool, sample_disc: int) -> np.ndarray:
        """One training image index per member, with the 50 % recent-data
        bias during planning (``dataset.py:176-191``)."""
        out = np.zeros((self.num_models,), dtype=np.int32)
        for m in range(self.num_models):
            pool = self.bootstrap(m)
            if recent_bias and self._rng.random_sample() < 0.5:
                recent = pool[pool >= self.size - sample_disc]
                if len(recent) > 0:
                    pool = recent
            out[m] = self._rng.choice(pool)
        return out
