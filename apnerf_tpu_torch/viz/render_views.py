"""Visualization: NeRF-vs-simulator comparison renders, map/trajectory
panels, video stitching.

Capability parity with the reference's ``visualization/`` scripts
(``vis_nerf_habitat.py`` side-by-side GT/NeRF rgb/depth/sem viewer,
``vis_voxel.py`` voxel view, ``make_video.py``/``make_demo.py`` frame →
video stitchers) re-organized as library functions + a small CLI:

  * ``render_comparison``: at given poses, render GT (simulator) and NeRF
    (checkpoint) rgb / depth / semantics side-by-side panels.
  * ``walkthrough``: keyboard-free version of the interactive viewer —
    renders a camera path (the curses loop of ``vis_nerf_habitat.py:76-489``
    becomes a pose trajectory; an interactive variant can feed poses in).
  * ``voxel_slices``: binary-grid slice mosaics (the open3d mesh view of
    ``vis_voxel.py`` needs open3d, absent here — documented gate; the
    slice mosaic carries the same information).
  * ``stitch_video``: frames → mp4/gif via imageio.

Port of ``apnerf_tpu/viz/render_views.py``. The host functions are the
same numpy code; ``render_comparison`` renders through the port's mapper
(``_pose7_to_rays`` and ``_render_eval`` on the members, so on the card
the evaluation renderer's kernels) and reads member 0 back to the host.
``imageio`` is imported only where frames are written.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch


def colorize_depth(depth: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    d = np.clip(np.asarray(depth) / max_depth, 0, 1)
    # a turbo-like ramp, without matplotlib
    r = np.clip(1.5 - np.abs(2.0 * d - 1.0) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * d - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * d) * 2.0, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def colorize_semantics(sem: np.ndarray, num_classes: int) -> np.ndarray:
    """tab20-style categorical colors (``pipeline.py:205-222`` uses a
    custom 30-color map)."""
    rng = np.random.RandomState(0)
    palette = (rng.rand(max(num_classes, 1), 3) * 200 + 40).astype(np.uint8)
    palette[0] = (0, 0, 0)
    return palette[np.asarray(sem) % max(num_classes, 1)]


def side_by_side(panels: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    h = max(p.shape[0] for p in panels)
    out = []
    for p in panels:
        if p.ndim == 2:
            p = np.stack([p] * 3, axis=-1)
        if p.dtype != np.uint8:
            p = (np.clip(p, 0, 1) * 255).astype(np.uint8)
        if p.shape[0] < h:
            p = np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)))
        out.append(p)
        out.append(np.zeros((h, pad, 3), dtype=np.uint8))
    return np.concatenate(out[:-1], axis=1)


def render_comparison(
    mapper,
    poses: np.ndarray,  # [N, 7]
    scale: float = 0.25,
    max_depth: float = 10.0,
) -> List[np.ndarray]:
    """GT (sim) vs NeRF (member 0) rgb|depth|sem panels per pose."""
    rgbs, depths, sems = mapper.sim.sample_images_from_poses(poses)
    rays = mapper._pose7_to_rays(np.asarray(poses), scale)
    out = mapper._render_eval(
        mapper.state.members, mapper.state.occ, rays.origins, rays.viewdirs,
        torch.ones(3, device=mapper.device),
    )
    out = {k: out[k][0].float().cpu().numpy() for k in ("rgb", "depth", "sem")}
    W, H = mapper.cfg.img_w, mapper.cfg.img_h
    oh, ow = int(H * scale), int(W * scale)
    frames = []
    C = mapper.cfg.num_semantic_classes
    for i in range(len(poses)):
        pd_rgb = out["rgb"][i].reshape(oh, ow, 3)
        pd_dep = out["depth"][i].reshape(oh, ow)
        pd_sem = np.argmax(out["sem"][i], -1).reshape(oh, ow)
        gt_rgb = rgbs[i][..., :3]
        frames.append(
            side_by_side(
                [
                    gt_rgb,
                    (pd_rgb * 255).astype(np.uint8),
                    colorize_depth(depths[i], max_depth),
                    colorize_depth(pd_dep, max_depth),
                    colorize_semantics(sems[i], C),
                    colorize_semantics(pd_sem, C),
                ]
            )
        )
    return frames


def walkthrough(mapper, start_pose: np.ndarray, n_frames: int = 36,
                scale: float = 0.25) -> List[np.ndarray]:
    """Render a 360° NeRF walkthrough from a pose (the non-interactive
    counterpart of the curses viewer)."""
    poses = []
    for ang in np.linspace(0, 360, n_frames, endpoint=False):
        a = np.deg2rad(ang) / 2
        poses.append(
            np.concatenate([start_pose[:3], [0, np.sin(a), 0, np.cos(a)]])
        )
    return render_comparison(mapper, np.asarray(poses), scale=scale)


def voxel_slices(binaries: np.ndarray, axis: int = 1,
                 max_slices: int = 16) -> np.ndarray:
    """Mosaic of binary-grid slices (``vis_voxel.py`` capability without
    open3d)."""
    binaries = np.asarray(binaries)
    n = binaries.shape[axis]
    take = np.linspace(0, n - 1, min(max_slices, n)).astype(int)
    slices = [np.take(binaries, i, axis=axis).astype(np.uint8) * 255
              for i in take]
    cols = int(np.ceil(np.sqrt(len(slices))))
    h, w = slices[0].shape
    mosaic = np.zeros((cols * h, cols * w), dtype=np.uint8)
    for i, s in enumerate(slices):
        r, c = divmod(i, cols)
        mosaic[r * h:(r + 1) * h, c * w:(c + 1) * w] = s
    return mosaic


def stitch_video(frames: Sequence[np.ndarray], path: str, fps: int = 10):
    """Frames → video/gif (``make_video.py`` capability)."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gif"):
        imageio.mimsave(path, list(frames), fps=fps)
    else:
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(f)
    return path


def save_frames(frames: Sequence[np.ndarray], out_dir: str,
                prefix: str = "frame"):
    import imageio

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        imageio.imwrite(p, f)
        paths.append(p)
    return paths
