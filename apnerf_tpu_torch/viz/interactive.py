"""Interactive GT-vs-NeRF checkpoint viewer.

Capability parity with the reference's curses viewer
(``visualization/vis_nerf_habitat.py:76-489``): load a checkpoint, fly a
camera with the keyboard, and see simulator ground truth next to the
NeRF's rgb / depth / semantics.

Differences for a headless-friendly stack:
  * rendering goes through the mapper's ensemble renderer (either
    flagship prop path or occ path — whatever the config selects; on the
    card its kernels);
  * display uses cv2.imshow when a GUI is available, else frames are
    written to ``out_dir`` (this container has no display);
  * the keyboard loop is separable: ``step(key)`` applies one command and
    returns the rendered frame, so tests and scripts can drive the viewer
    without a TTY (``run_scripted``).

Keys (reference bindings, vis_nerf_habitat.py:200-260):
  w/s forward/back   a/d strafe left/right   r/f up/down
  q/e yaw left/right  ESC or x: quit

Port of ``apnerf_tpu/viz/interactive.py``: the same poses and panels;
``cv2``, ``termios`` and ``imageio`` are imported only where used.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


class InteractiveViewer:
    MOVE = 0.25  # meters per keypress
    TURN = np.deg2rad(10.0)

    def __init__(self, mapper, out_dir: Optional[str] = None,
                 scale: float = 0.25, max_depth: float = 10.0):
        self.mapper = mapper
        self.out_dir = out_dir or os.path.join(mapper.save_path, "viewer")
        os.makedirs(self.out_dir, exist_ok=True)
        self.scale = scale
        self.max_depth = max_depth
        g = np.asarray(mapper.global_origin, dtype=np.float64)
        self.pos = g[:3].copy()
        self.yaw = 0.0
        self.frame_idx = 0

    # -- pose / motion --------------------------------------------------

    @property
    def pose7(self) -> np.ndarray:
        q = np.array([0.0, np.sin(self.yaw / 2), 0.0, np.cos(self.yaw / 2)])
        return np.concatenate([self.pos, q])

    def _apply(self, key: str) -> bool:
        """One key command; returns False on quit."""
        fwd = np.array([-np.sin(self.yaw), 0.0, -np.cos(self.yaw)])
        right = np.array([np.cos(self.yaw), 0.0, -np.sin(self.yaw)])
        if key == "w":
            self.pos += self.MOVE * fwd
        elif key == "s":
            self.pos -= self.MOVE * fwd
        elif key == "a":
            self.pos -= self.MOVE * right
        elif key == "d":
            self.pos += self.MOVE * right
        elif key == "r":
            self.pos[1] += self.MOVE
        elif key == "f":
            self.pos[1] -= self.MOVE
        elif key == "q":
            self.yaw += self.TURN
        elif key == "e":
            self.yaw -= self.TURN
        elif key in ("x", "\x1b"):
            return False
        return True

    # -- rendering ------------------------------------------------------

    def render_frame(self) -> np.ndarray:
        """GT | NeRF rgb | depth | semantics panel at the current pose."""
        from .render_views import colorize_depth, colorize_semantics, side_by_side

        m = self.mapper
        cfg = m.cfg
        oh = max(int(cfg.img_h * self.scale), 1)
        ow = max(int(cfg.img_w * self.scale), 1)
        pose = self.pose7
        rays = m._pose7_to_grid_rays(pose[None], oh, ow)
        out = m._render_eval(
            m.state.members, m.state.occ, rays.origins, rays.viewdirs,
            torch.ones(3, device=m.device),
        )
        pd_rgb = out["rgb"][0].float().cpu().numpy().reshape(oh, ow, 3)
        pd_dep = out["depth"][0].float().cpu().numpy().reshape(oh, ow)
        pd_sem = np.argmax(
            out["sem"][0].float().cpu().numpy().reshape(oh, ow, -1), axis=-1
        )
        panels = []
        if m.sim is not None:
            gt_rgb, _, _ = m.sim.sample_images_from_poses(pose[None])
            ys = (np.arange(oh) * cfg.img_h) // oh
            xs = (np.arange(ow) * cfg.img_w) // ow
            panels.append(
                np.asarray(gt_rgb[0])[..., :3][np.ix_(ys, xs)].astype(np.uint8)
            )
        panels += [
            (np.clip(pd_rgb, 0, 1) * 255).astype(np.uint8),
            colorize_depth(pd_dep, self.max_depth),
            colorize_semantics(pd_sem, cfg.num_semantic_classes),
        ]
        return side_by_side(panels)

    def _emit(self, frame: np.ndarray):
        shown = False
        if os.environ.get("DISPLAY"):
            try:
                import cv2

                cv2.imshow("apnerf viewer", frame[..., ::-1])
                cv2.waitKey(1)
                shown = True
            except Exception:
                pass
        if not shown:
            import imageio.v2 as imageio

            imageio.imwrite(
                os.path.join(self.out_dir, f"frame_{self.frame_idx:04d}.png"),
                frame,
            )
        self.frame_idx += 1

    # -- loops ------------------------------------------------------------

    def step(self, key: str) -> Optional[np.ndarray]:
        """Apply one key; render and emit. Returns the frame, or None on
        quit."""
        if not self._apply(key):
            return None
        frame = self.render_frame()
        self._emit(frame)
        return frame

    def run_scripted(self, keys: str) -> List[np.ndarray]:
        """Drive the viewer with a key string (testable, no TTY)."""
        frames = []
        for k in keys:
            f = self.step(k)
            if f is None:
                break
            frames.append(f)
        return frames

    def run(self):
        """Blocking keyboard loop (stdin cbreak mode, like the reference's
        curses thread)."""
        import sys
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        print(
            "viewer: w/s fwd/back a/d strafe r/f up/down q/e yaw, x quits; "
            f"frames -> {self.out_dir}",
            flush=True,
        )
        self._emit(self.render_frame())
        try:
            tty.setcbreak(fd)
            while True:
                key = sys.stdin.read(1)
                if self.step(key) is None:
                    break
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main(argv=None):
    """CLI: python -m apnerf_tpu_torch.viz.interactive --ckpt <dir> [--sim fake]
    [--device cpu]"""
    import argparse

    from ..active.pipeline import build_mapper, parse_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True,
                    help="checkpoints/ directory to load")
    ap.add_argument("--keys", type=str, default=None,
                    help="scripted key sequence instead of the live loop")
    ap.add_argument("--out", type=str, default=None)
    args, rest = ap.parse_known_args(argv)
    margs = parse_args(rest)
    mapper = build_mapper(margs)
    mapper.load_checkpoints(args.ckpt)
    viewer = InteractiveViewer(mapper, out_dir=args.out)
    if args.keys:
        viewer.run_scripted(args.keys)
    else:
        viewer.run()


if __name__ == "__main__":
    main()
