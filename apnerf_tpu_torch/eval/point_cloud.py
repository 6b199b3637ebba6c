"""Semantic point clouds from a semantic mesh (.ply).

Working equivalent of the reference's vestigial tool
(``simulator/build_point_cloud_from_mesh.py`` — broken as shipped: it
imports ``utils.habitat_utils`` which does not exist in the snapshot).
Self-contained: a minimal PLY reader/writer replaces the plyfile/open3d
dependencies (not installable here), and the per-face double sampling
loop (``build_point_cloud_from_mesh.py:63-81``) is vectorized per face.

Semantics preserved:
  * habitat→world axis remap (x, z, -y) per vertex (``:52-57``),
  * faces keep vertex corners plus a grid of surface samples at
    ``sampling_resolution`` spacing along the two edge directions,
  * colors assigned per face object id.

Port of ``apnerf_tpu/eval/point_cloud.py``: the same host-only numpy code.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Minimal PLY reader (ascii + binary_little_endian) for semantic
    meshes: returns vertices [V, 3] and, when present, faces [F, 3] with
    per-face ``object_id`` [F]."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) or list marker])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append({"name": tok[1], "count": int(tok[2]),
                             "props": []})
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1]["props"].append(
                    ("list", tok[2], tok[3], tok[4])
                )
            else:
                elements[-1]["props"].append(("scalar", tok[1], tok[2]))

    np_type = {
        "char": np.int8, "uchar": np.uint8, "int8": np.int8,
        "uint8": np.uint8, "short": np.int16, "ushort": np.uint16,
        "int16": np.int16, "uint16": np.uint16, "int": np.int32,
        "uint": np.uint32, "int32": np.int32, "uint32": np.uint32,
        "float": np.float32, "float32": np.float32,
        "double": np.float64, "float64": np.float64,
    }

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for el in elements:
            rows = []
            for _ in range(el["count"]):
                while not lines[li].strip():
                    li += 1
                rows.append(lines[li].strip().split())
                li += 1
            if el["name"] == "vertex":
                names = [p[2] for p in el["props"]]
                arr = np.array(rows, dtype=np.float64)
                xyz_idx = [names.index(c) for c in ("x", "y", "z")]
                out["vertices"] = arr[:, xyz_idx]
            elif el["name"] == "face":
                faces, oids = [], []
                for r in rows:
                    n = int(r[0])
                    faces.append([int(v) for v in r[1 : 1 + n]][:3])
                    rest = r[1 + n :]
                    oids.append(int(rest[0]) if rest else 0)
                out["faces"] = np.asarray(faces, dtype=np.int64)
                out["object_ids"] = np.asarray(oids, dtype=np.int64)
    elif fmt == "binary_little_endian":
        off = 0
        for el in elements:
            if all(p[0] == "scalar" for p in el["props"]):
                dt = np.dtype(
                    [(p[2], np_type[p[1]]) for p in el["props"]]
                )
                arr = np.frombuffer(
                    body, dtype=dt, count=el["count"], offset=off
                )
                off += dt.itemsize * el["count"]
                if el["name"] == "vertex":
                    out["vertices"] = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=-1
                    ).astype(np.float64)
            else:
                # list property (faces): parse row by row
                faces, oids = [], []
                for _ in range(el["count"]):
                    row_vals = []
                    for p in el["props"]:
                        if p[0] == "list":
                            cnt_t = np.dtype(np_type[p[1]])
                            val_t = np.dtype(np_type[p[2]])
                            n = int(
                                np.frombuffer(body, cnt_t, 1, off)[0]
                            )
                            off += cnt_t.itemsize
                            vals = np.frombuffer(body, val_t, n, off)
                            off += val_t.itemsize * n
                            row_vals.append(("list", vals))
                        else:
                            t = np.dtype(np_type[p[2]])
                            v = np.frombuffer(body, t, 1, off)[0]
                            off += t.itemsize
                            row_vals.append(("scalar", v))
                    lst = next(v for k, v in row_vals if k == "list")
                    faces.append(list(lst[:3]))
                    scalars = [v for k, v in row_vals if k == "scalar"]
                    oids.append(int(scalars[0]) if scalars else 0)
                if el["name"] == "face":
                    out["faces"] = np.asarray(faces, dtype=np.int64)
                    out["object_ids"] = np.asarray(oids, dtype=np.int64)
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")
    return out


def write_ply_points(path: str, points: np.ndarray, colors: np.ndarray):
    """ASCII PLY point-cloud writer (replaces o3d.io.write_point_cloud)."""
    points = np.asarray(points, dtype=np.float64)
    colors = np.clip(np.asarray(colors, dtype=np.float64), 0, 1)
    c8 = (colors * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(points, c8):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def _sample_face(p1, p2, p3, resolution):
    """Grid samples on a triangle, matching the reference's edge-grid scheme
    (``build_point_cloud_from_mesh.py:63-81``), vectorized."""
    n1 = p2 - p1
    d1 = float(np.linalg.norm(n1))
    n2 = p3 - p1
    d2 = float(np.linalg.norm(n2))
    if d1 < 1e-12 or d2 < 1e-12:
        return np.zeros((0, 3))
    n1, n2 = n1 / d1, n2 / d2
    i = np.arange(0, d1, resolution)
    b = (d1 - i) * d2 / d1  # shrinking second-edge extent
    j_counts = np.ceil(b / resolution).astype(int)
    if j_counts.sum() == 0:
        return np.zeros((0, 3))
    ii = np.repeat(i, j_counts)
    jj = np.concatenate(
        [np.arange(0, bi, resolution)[:c] for bi, c in zip(b, j_counts)]
    )
    return p1[None] + ii[:, None] * n1[None] + jj[:, None] * n2[None]


def build_point_cloud_from_mesh(
    ply_path: str,
    semantic_colors: Dict[int, Tuple[float, float, float]],
    out_path: Optional[str] = None,
    sampling_resolution: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Semantic mesh → colored surface point cloud.

    ``semantic_colors`` maps face object ids to RGB in [0, 1]; faces with
    unlisted ids are skipped (the reference's whitelist behavior).
    Returns (points [N, 3], colors [N, 3]); writes a PLY if out_path.
    """
    mesh = read_ply(ply_path)
    verts = mesh["vertices"]
    # habitat axis remap (x, z, -y), build_point_cloud_from_mesh.py:52-57
    world = np.stack(
        [verts[:, 0], verts[:, 2], -verts[:, 1]], axis=-1
    )
    pts, cols = [], []
    for face, oid in zip(mesh["faces"], mesh["object_ids"]):
        if oid not in semantic_colors:
            continue
        color = np.asarray(semantic_colors[oid], dtype=np.float64)
        p1, p2, p3 = world[face[0]], world[face[1]], world[face[2]]
        corner = np.stack([p1, p2, p3])
        samples = _sample_face(p1, p2, p3, sampling_resolution)
        allpts = np.concatenate([corner, samples], axis=0)
        pts.append(allpts)
        cols.append(np.tile(color, (len(allpts), 1)))
    points = (
        np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))
    )
    colors = (
        np.concatenate(cols, axis=0) if cols else np.zeros((0, 3))
    )
    if out_path:
        write_ply_points(out_path, points, colors)
    return points, colors
