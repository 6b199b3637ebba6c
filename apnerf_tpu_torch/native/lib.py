"""ctypes bindings for the native planning core (``planning_core.cpp``).

Copy of ``apnerf_tpu/native/lib.py`` with one change: the library is
built with the host C++ compiler into ``build/`` at the repository root,
under a name that carries a hash of its source, and never beside the
source. A checkout therefore stays as it is whatever the files' mtimes,
and an edited source never loads a stale binary. No binary is tracked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().with_name("planning_core.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libplanning_core_{digest}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.dijkstra_plan.restype = ctypes.c_int32
    lib.dijkstra_plan.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32,
    ]
    lib.raycast_update.restype = None
    lib.raycast_update.argtypes = [
        f64p, ctypes.c_int32, ctypes.c_int32,
        f64p, f64p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.voxel_traverse.restype = ctypes.c_int32
    lib.voxel_traverse.argtypes = [
        f64p, f64p, i32p, i32p, ctypes.c_double, i32p, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def backend() -> str:
    """``"native"`` when the C++ library built and loaded, else ``"python"``."""
    return "native" if is_available() else "python"


def dijkstra_plan_native(
    obstacle: np.ndarray, sx: int, sy: int, gx: int, gy: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """→ (xs, ys) goal→start grid indices, or None (unreachable /
    native lib unavailable)."""
    lib = _load()
    if lib is None:
        return None
    obstacle = np.ascontiguousarray(obstacle != 0, dtype=np.uint8)
    X, Y = obstacle.shape
    cap = X * Y
    out_x = np.zeros(cap, dtype=np.int32)
    out_y = np.zeros(cap, dtype=np.int32)
    n = lib.dijkstra_plan(
        obstacle, X, Y, int(sx), int(sy), int(gx), int(gy), out_x, out_y, cap
    )
    if n == 0:
        return None
    return out_x[:n].copy(), out_y[:n].copy()


def raycast_update_native(
    occupancy: np.ndarray,
    ox: np.ndarray,
    oy: np.ndarray,
    loc_x: int,
    loc_y: int,
    min_x: float,
    min_y: float,
    resolution: float,
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    occupancy = np.ascontiguousarray(occupancy, dtype=np.float64)
    ox = np.ascontiguousarray(ox, dtype=np.float64)
    oy = np.ascontiguousarray(oy, dtype=np.float64)
    X, Y = occupancy.shape
    lib.raycast_update(
        occupancy, X, Y, ox, oy, len(ox), int(loc_x), int(loc_y),
        float(min_x), float(min_y), float(resolution),
    )
    return occupancy


def voxel_traverse_native(
    start_pos, end_pos, start_voxel, end_voxel, voxel_size: float,
    max_voxels: int = 65536,
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((max_voxels, 3), dtype=np.int32)
    n = lib.voxel_traverse(
        np.ascontiguousarray(start_pos, dtype=np.float64),
        np.ascontiguousarray(end_pos, dtype=np.float64),
        np.ascontiguousarray(start_voxel, dtype=np.int32),
        np.ascontiguousarray(end_voxel, dtype=np.int32),
        float(voxel_size),
        out.reshape(-1),
        max_voxels,
    )
    return out[:n].copy()
