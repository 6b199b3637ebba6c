"""Minimal COLMAP binary model reader.

A copy of ``apnerf_tpu/data/colmap.py`` (numpy only): the standard COLMAP
binary format (cameras.bin / images.bin), just the pieces the 360 dataset
loader needs: intrinsics, extrinsics, image names.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np

# COLMAP camera model ids → (name, #params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
}


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    name: str
    camera_id: int
    qvec: np.ndarray  # (w, x, y, z) — COLMAP convention
    tvec: np.ndarray


def _read(fmt, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, w, h = _read("<iiQQ", f)
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{n_params}d", f))
            cams[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            img_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            cam_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read("<Q", f)
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points
            imgs[img_id] = ColmapImage(name.decode(), cam_id, qvec, tvec)
    return imgs


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def load_colmap_poses(sparse_dir: str) -> Tuple[np.ndarray, np.ndarray, list]:
    """→ (c2w [N, 4, 4] in OpenGL convention, K [3, 3], image names sorted).

    COLMAP stores w2c with +z forward (OpenCV); NeRF wants c2w with -z
    forward — flip the y/z axes (the same convention juggle the
    reference's ``datasets/nerf_360_v2.py`` performs).
    """
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    cam = cams[next(iter(cams))]
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)

    order = sorted(imgs.keys(), key=lambda i: imgs[i].name)
    c2ws, names = [], []
    flip = np.diag([1.0, -1.0, -1.0])
    for i in order:
        im = imgs[i]
        R = qvec_to_rotmat(im.qvec)
        T = np.eye(4)
        T[:3, :3] = R.T @ np.eye(3)
        T[:3, 3] = -R.T @ im.tvec
        T[:3, :3] = T[:3, :3] @ flip  # OpenCV → OpenGL camera axes
        c2ws.append(T)
        names.append(im.name)
    return np.array(c2ws, dtype=np.float32), K, names
