"""Minimal PLY point-cloud / mesh I/O (binary little-endian + ascii; port
of ``hcmvs_tpu/io/ply.py``, a copy: the port imports nothing of the JAX
package).

Replaces the reference's vendored PLY codec (ref: frame_main/libs/IO/PLY.cpp,
2.4k LoC of C) with a numpy structured-array implementation; writes the same
element/property layout the reference emits for dense point clouds
(x y z [nx ny nz] [red green blue]) and triangle meshes so outputs open in
the same downstream tools.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     normals: Optional[np.ndarray] = None,
                     colors: Optional[np.ndarray] = None) -> None:
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        props += ["property float nx", "property float ny",
                  "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (normals[:, 0], normals[:, 1],
                                           normals[:, 2])
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (colors[:, 0], colors[:, 1],
                                                 colors[:, 2])
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props + ["end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    n, m = len(vertices), len(faces)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = (vertices[:, 0], vertices[:, 1],
                                    vertices[:, 2])
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (colors[:, 0], colors[:, 1],
                                                 colors[:, 2])
    frec = np.empty(m, dtype=[("n", "u1"), ("v", "<i4", 3)])
    frec["n"] = 3
    frec["v"] = faces
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props +
        [f"element face {m}", "property list uchar int vertex_indices",
         "end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())
        f.write(frec.tobytes())


def _read_faces(body: bytes, off: int, count: int, cnt_t: str,
                idx_t: str):
    """(count, 3) int32 faces of a binary face list at ``off`` (the first
    three indices of each polygon) and the offset after the list."""
    tri = np.dtype([("n", cnt_t), ("v", idx_t, 3)])
    if len(body) >= off + tri.itemsize * count:
        rec = np.frombuffer(body, tri, count, off)
        if (rec["n"] == 3).all():              # triangles: one read
            return (rec["v"].astype(np.int32),
                    off + tri.itemsize * count)
    faces = np.empty((count, 3), np.int32)
    cnt_size = np.dtype(cnt_t).itemsize
    idx_size = np.dtype(idx_t).itemsize
    for i in range(count):
        k = int(np.frombuffer(body, cnt_t, 1, off)[0])
        off += cnt_size
        faces[i] = np.frombuffer(body, idx_t, k, off)[:3]
        off += idx_size * k
    return faces, off


def read_ply(path: str) -> Tuple[np.ndarray, dict]:
    """Read a PLY file; returns (vertex xyz array, extras dict).

    ``extras`` may contain 'normals', 'colors', 'faces' when present.
    Handles binary_little_endian and ascii, scalar properties plus one
    face list property (binary only, as the JAX package).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file")
    header_lines = data[:end].decode(errors="replace").splitlines()
    # the body starts after end_header's line break; stripping every
    # leading \n / \r byte, as the JAX package does, eats a binary body
    # whose first byte is 0x0a or 0x0d
    body = data[data.find(b"\n", end) + 1:]
    fmt = "binary_little_endian"
    elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
    for line in header_lines:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append((t[1], t[2]))
    typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "uchar": "u1", "uint8": "u1", "char": "i1",
               "short": "<i2", "ushort": "<u2", "int": "<i4",
               "int32": "<i4", "uint": "<u4", "uint32": "<u4"}
    extras: dict = {}
    verts = None
    off = 0
    for name, count, props in elements:
        if name == "vertex":
            dt = np.dtype([(p[1] if len(p) == 2 else "list", typemap[p[0]])
                           for p in props])
            if fmt == "ascii":
                rows = body.decode().split("\n")[off:off + count]
                arr = np.array([[float(v) for v in r.split()] for r in rows])
                rec = np.rec.fromarrays(arr.T, dtype=dt)
                off += count
            else:
                rec = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
            names = rec.dtype.names
            verts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(
                np.float32)
            if "nx" in names:
                extras["normals"] = np.stack(
                    [rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
            if "red" in names:
                extras["colors"] = np.stack(
                    [rec["red"], rec["green"], rec["blue"]], -1).astype(
                        np.uint8)
        elif name == "face" and fmt != "ascii":
            extras["faces"], off = _read_faces(
                body, off, count, typemap[props[0][1]],
                typemap[props[0][2]])
    return verts, extras
