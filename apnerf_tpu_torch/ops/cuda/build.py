"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``build/`` at the repository root; the
library's name carries a hash of the sources and flags, so an edited
kernel never loads a stale binary. Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = REPO_ROOT / "apnerf_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already built); chip_smoke.py reports it
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libapnerf_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels if their library is missing; returns its path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apnerf_fused_spectral_field_smem.argtypes = [i, i]
    lib.apnerf_fused_spectral_field_smem.restype = ctypes.c_size_t
    lib.apnerf_fused_spectral_field_fwd.argtypes = (
        [p, p, p, i, i] + [p] * 8 + [i, i, i, i, p, p]
    )
    lib.apnerf_fused_spectral_field_fwd.restype = i
    lib.apnerf_fused_render_weights_fwd.argtypes = [p, p, p, i, i, p, p, p, p]
    lib.apnerf_fused_render_weights_fwd.restype = i
    _lib = lib
    return lib
