"""NGP + occupancy grid trainer on NeRF-Synthetic, on the GPU.

The counterpart of ``scripts/train_ngp_occ.py``, with its flags and
defaults (4096 rays a step, the aabb ±1.5, a 128³ grid, render step 5e-3,
128 samples, 1024 lattice candidates, a random background in training and
a white one in evaluation) and ``--device`` (``cuda`` unless told
otherwise). It needs a local NeRF-Synthetic tree and ``imageio``:

    python -m apnerf_tpu_torch.train_ngp_occ --data-root /path/nerf_synthetic \\
        --scene lego --steps 20000

``main`` parses the flags and loads the subject; ``train`` takes the
views in memory (``data/nerf_synthetic.py::SubjectData``), so a caller
without the PNGs can hand it views it made. Held-out views render in
chunks of ``EVAL_CHUNK`` rays.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .data.nerf_synthetic import SubjectData, intrinsics, load_subject
from .ops.rays import image_rays, rays_from_pixels
from .train.examples import make_ngp_occ_trainer, trainer_device
from .utils.metrics import psnr

# the trainer's sizes, as the JAX script sets them
TRAINER_KWARGS = dict(grid_resolution=(128, 128, 128), render_step_size=5e-3, max_samples=128,
                      n_candidates=1024)
EVAL_CHUNK = 1 << 13  # rays of a held-out view per render call (2^20 samples at 128)
CHUNK = 100  # steps between synchronisations (and ``on_chunk`` calls)
SEED = 42  # the field's initialisation and the batches' draws, as the JAX script's
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def composite(rgba: np.ndarray, bkgd) -> np.ndarray:
    """uint8 RGBA [..., 4] → float RGB over the background ``bkgd`` [3]."""
    rgba = rgba.astype(np.float32) / 255.0
    return rgba[..., :3] * rgba[..., 3:] + np.asarray(bkgd, np.float32) * (1 - rgba[..., 3:])


def render_view(render_fn, state, data: SubjectData, i: int, bkgd: torch.Tensor) -> torch.Tensor:
    """View ``i`` of ``data`` rendered in chunks of ``EVAL_CHUNK`` rays →
    rgb [H, W, 3] on the device."""
    dev = bkgd.device
    c2w = torch.as_tensor(data.camtoworlds[i], dtype=torch.float32, device=dev)
    rays = image_rays(c2w, torch.as_tensor(intrinsics(data), device=dev), data.width, data.height)
    rgb = [render_fn(state, rays.origins[a:a + EVAL_CHUNK], rays.viewdirs[a:a + EVAL_CHUNK],
                     bkgd)["rgb"] for a in range(0, rays.origins.shape[0], EVAL_CHUNK)]
    return torch.cat(rgb).reshape(data.height, data.width, 3)


def sample_batch(gen: torch.Generator, images: torch.Tensor, c2ws: torch.Tensor, K: torch.Tensor,
                 num_rays: int):
    """A training batch: ``num_rays`` pixels drawn uniformly over the views
    ``images`` [N, H, W, 4] (uint8 RGBA on the device) and a random
    background → (origins, viewdirs, pixels over the background, bkgd,
    the views' indices)."""
    n, H, W = images.shape[:3]
    dev = images.device
    img_id = torch.randint(0, n, (num_rays,), generator=gen, device=dev)
    x = torch.randint(0, W, (num_rays,), generator=gen, device=dev)
    y = torch.randint(0, H, (num_rays,), generator=gen, device=dev)
    rays = rays_from_pixels(x.float(), y.float(), c2ws[img_id], K)
    rgba = images[img_id, y, x].float() / 255.0
    bkgd = torch.rand(3, generator=gen, device=dev)
    pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
    return rays.origins, rays.viewdirs, pixels, bkgd, img_id


def train(
    train_data: SubjectData,
    test_data: SubjectData,
    steps: int = 20000,
    num_rays: int = 4096,
    aabb: Sequence[float] = AABB,
    eval_every: int = 5000,
    device="cuda",
    on_chunk: Optional[Callable[[int, float], None]] = None,
) -> dict:
    """Train on ``train_data`` for ``steps`` steps, evaluating the PSNR of
    every view of ``test_data`` every ``eval_every`` steps and after the
    last. Every ``CHUNK`` steps the device is synchronised and
    ``on_chunk(steps done, seconds of the chunk)`` called. → dict:
    ``state``, ``step_fn``, ``render_fn``, ``losses`` and ``n_samples`` (one per step, on
    the device), ``chunk_seconds`` and ``evals`` ((step, mean PSNR, PSNR
    of each view) after each evaluation)."""
    dev = trainer_device(device)
    state, step_fn, render_fn = make_ngp_occ_trainer(aabb, seed=SEED, device=dev,
                                                     **TRAINER_KWARGS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.as_tensor(train_data.images, device=dev)
    c2ws = torch.as_tensor(train_data.camtoworlds, dtype=torch.float32, device=dev)
    K = torch.as_tensor(intrinsics(train_data), device=dev)
    white = torch.ones(3, device=dev)
    losses = torch.zeros(steps, device=dev)
    n_samples = torch.zeros(steps, dtype=torch.int64, device=dev)
    chunk_seconds, evals = [], []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t_start = t_chunk = time.perf_counter()
    for step in range(steps):
        origins, viewdirs, pixels, bkgd, _ = sample_batch(gen, images, c2ws, K, num_rays)
        state, losses[step], n_samples[step] = step_fn(state, origins, viewdirs, pixels, bkgd,
                                                       generator=gen)
        if (step + 1) % CHUNK == 0:
            sync()
            now = time.perf_counter()
            chunk_seconds.append(now - t_chunk)
            if on_chunk is not None:
                on_chunk(step + 1, now - t_chunk)
            t_chunk = time.perf_counter()
        if (step + 1) % eval_every == 0 or step + 1 == steps:
            psnrs = [
                psnr(render_view(render_fn, state, test_data, i, white).cpu().numpy(),
                     composite(test_data.images[i], (1.0, 1.0, 1.0)))
                for i in range(len(test_data.images))
            ]
            evals.append((step + 1, float(np.mean(psnrs)), psnrs))
            print(f"step {step + 1} loss {float(losses[step]):.4f} test PSNR {np.mean(psnrs):.2f} "
                f"dB elapsed {time.perf_counter() - t_start:.0f}s")
            sync()
            t_chunk = time.perf_counter()
    return dict(state=state, step_fn=step_fn, render_fn=render_fn, losses=losses, n_samples=n_samples,
                chunk_seconds=chunk_seconds, evals=evals)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True)
    p.add_argument("--scene", default="lego")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--num-rays", type=int, default=4096)
    p.add_argument("--aabb", type=float, nargs=6, default=list(AABB))
    p.add_argument("--eval-every", type=int, default=5000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    train_data = load_subject(args.data_root, args.scene, "train")
    test_data = load_subject(args.data_root, args.scene, "test", max_images=8)
    print(f"{args.scene}: {len(train_data.images)} train / {len(test_data.images)} test")
    return train(train_data, test_data, steps=args.steps, num_rays=args.num_rays,
                 aabb=args.aabb, eval_every=args.eval_every, device=args.device)


if __name__ == "__main__":
    main()
