"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into an
object, all of them at once in parallel, and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``. A source
that defines ``APNERF_PARTS`` compiles that many times, once per part
with ``-DAPNERF_PART=p``, each part a share of the field tile's kernel
instances (``csrc/field_tile.cuh``), so that they compile in parallel. The
build runs at first use, into ``build/`` at the repository root; the
library's name carries a hash of the sources, the shared headers and
the flags, so an edited kernel never loads a stale binary. Nothing here
runs at import time: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = REPO_ROOT / "apnerf_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
COMPILE_FLAGS = ARCH_FLAGS + ["-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already built); chip_smoke.py reports it
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _parts(src: Path) -> int:
    """How many times ``src`` compiles: its ``APNERF_PARTS``, or once."""
    found = re.search(r"^#define APNERF_PARTS (\d+)", src.read_text(), re.MULTILINE)
    return int(found.group(1)) if found else 1


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
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
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs, names = [], [], []
    for src in _sources():
        n_parts = _parts(src)
        for part in range(n_parts):
            obj = BUILD_DIR / f"{tag}.{src.stem}.{part}.o"
            objs.append(obj)
            names.append(src.name if n_parts == 1 else f"{src.name} part {part}")
            procs.append(subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, f"-DAPNERF_PART={part}", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [name for name, p in zip(names, procs) if p.returncode != 0]
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
        else:
            os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apnerf_fused_render_weights_fwd.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.apnerf_fused_render_weights_fwd.restype = i
    lib.apnerf_fused_render_weights_bwd.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
    lib.apnerf_fused_render_weights_bwd.restype = i
    lib.apnerf_empty_launch.argtypes = [i, p]
    lib.apnerf_empty_launch.restype = i
    lib.apnerf_field_layout.argtypes = [i, i, i, i, i, i]
    lib.apnerf_field_layout.restype = i
    for name in ("apnerf_fvr_field_fwd", "apnerf_fvr_field_bwd", "apnerf_dw", "apnerf_ffh_fwd",
                 "apnerf_trunk_fwd"):
        getattr(lib, name).argtypes = [p, i, p]
        getattr(lib, name).restype = i
    lib.apnerf_ffh_bwd_pack.argtypes = [p, p]
    lib.apnerf_ffh_bwd_pack.restype = i
    lib.apnerf_fvr_rays.argtypes = [p, i, i, p, p]
    lib.apnerf_fvr_rays.restype = i
    lib.apnerf_fvr_fwd_rays.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.apnerf_fvr_fwd_rays.restype = i
    lib.apnerf_col_sums.argtypes = [p, i, ll, i, p, p]
    lib.apnerf_col_sums.restype = i
    lib.apnerf_gather_rows_bwd.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.apnerf_gather_rows_bwd.restype = i
    lib.apnerf_hash_table_bwd.argtypes = [p, p, p, ll, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.apnerf_hash_table_bwd.restype = i
    lib.apnerf_hash_table_bwd_slots.argtypes = [i, i, i]
    lib.apnerf_hash_table_bwd_slots.restype = i
    _lib = lib
    return lib
