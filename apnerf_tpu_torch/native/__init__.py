"""Native (C++) host runtime components, loaded via ctypes.

The library builds with the host C++ compiler into ``build/`` at the
repository root at first use (``lib.py``). Every native entry point has a
pure-Python fallback with identical semantics in ``planning/``: the
native path is a performance accelerator, never a functional
requirement. ``backend()`` says which one runs.
"""

from .lib import (
    backend,
    dijkstra_plan_native,
    is_available,
    raycast_update_native,
    voxel_traverse_native,
)

__all__ = [
    "backend",
    "dijkstra_plan_native",
    "is_available",
    "raycast_update_native",
    "voxel_traverse_native",
]
