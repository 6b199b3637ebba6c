"""Compose per-step viz frames from a run directory into a demo video.

Working CLI equivalent of the reference's hardcoded-path stitchers
(``visualization/make_video.py`` — plain frame → video; ``make_demo.py``
— chase-cam + top-down + fpv gt/pred panel compositing): reads the layout
``mapper.render`` writes (``viz/<n>.png``, ``viz/top/<n>.png``,
``viz/fpv/{gt,pd}_{rgb,dep,sem}/<n>.png``) and writes an mp4/gif.

  python -m apnerf_tpu_torch.viz.make_video --run <save_path> [--out demo.mp4]

Port of ``apnerf_tpu/viz/make_video.py``: the same host-only numpy code.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional

import numpy as np

from .render_views import side_by_side, stitch_video


def _load(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    import imageio.v2 as imageio

    img = np.asarray(imageio.imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def compose_demo_frames(run_dir: str, stride: int = 1) -> List[np.ndarray]:
    """tpv | top | (gt rgb / pd rgb) | (gt dep / pd dep) | (gt sem / pd sem)
    panels per frame index (``make_demo.py:40-93`` layout, resolution-
    agnostic)."""
    viz = os.path.join(run_dir, "viz")
    idxs = sorted(
        int(os.path.splitext(os.path.basename(p))[0])
        for p in glob.glob(os.path.join(viz, "[0-9]*.png"))
    )
    frames = []
    for i in idxs[::stride]:
        tpv = _load(os.path.join(viz, f"{i}.png"))
        top = _load(os.path.join(viz, "top", f"{i}.png"))
        panels = [p for p in (tpv, top) if p is not None]
        for mod in ("rgb", "dep", "sem"):
            gt = _load(os.path.join(viz, "fpv", f"gt_{mod}", f"{i}.png"))
            pd = _load(os.path.join(viz, "fpv", f"pd_{mod}", f"{i}.png"))
            pair = [p for p in (gt, pd) if p is not None]
            if pair:
                # stack gt over pd like the reference's 2-row fpv column
                w = min(p.shape[1] for p in pair)
                col = np.concatenate([p[:, :w] for p in pair], axis=0)
                panels.append(col)
        if panels:
            frames.append(side_by_side(panels))
    # pad to a common size (chase/top frames can differ from fpv panels)
    if frames:
        H = max(f.shape[0] for f in frames)
        W = max(f.shape[1] for f in frames)
        frames = [
            np.pad(f, ((0, H - f.shape[0]), (0, W - f.shape[1]), (0, 0)))
            for f in frames
        ]
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="mapper save_path")
    ap.add_argument("--out", default=None, help="output video (mp4/gif)")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args(argv)
    frames = compose_demo_frames(args.run, stride=args.stride)
    if not frames:
        raise SystemExit(f"no viz frames under {args.run}/viz")
    out = args.out or os.path.join(args.run, "viz", "demo.mp4")
    stitch_video(frames, out, fps=args.fps)
    print(f"wrote {out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
