"""Wavefront OBJ mesh read/write (port of ``hcmvs_tpu/io/obj.py``, a copy:
the port imports nothing of the JAX package).

Python counterpart of the reference's OBJ codec
(ref: frame_main/libs/IO/OBJ.h and Mesh::Load/Save OBJ paths in
frame_main/libs/MVS/Mesh.cpp:1265-1525).  Supports v/vt/vn/f with
per-face-corner texcoord and normal indices, plus mtllib/usemtl
passthrough (the texturing pipeline writes its own material via
mesh/texture.py write_textured_obj).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ObjMesh(NamedTuple):
    vertices: np.ndarray              # (V, 3) float32
    faces: np.ndarray                 # (F, 3) int32 vertex indices
    texcoords: Optional[np.ndarray]   # (T, 2) float32 or None
    normals: Optional[np.ndarray]     # (N, 3) float32 or None
    face_texcoords: Optional[np.ndarray]  # (F, 3) int32 into texcoords
    face_normals: Optional[np.ndarray]    # (F, 3) int32 into normals
    material: Optional[str]           # usemtl name
    mtllib: Optional[str]             # mtllib file name


def read_obj(path: str) -> ObjMesh:
    verts, tex, nrm = [], [], []
    faces, ftex, fnrm = [], [], []
    material = mtllib = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                tex.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                nrm.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corner = [p.split("/") for p in parts[1:]]
                # triangulate fans for polygons with > 3 corners
                for k in range(1, len(corner) - 1):
                    tri = [corner[0], corner[k], corner[k + 1]]
                    faces.append([int(c[0]) - 1 for c in tri])
                    if all(len(c) > 1 and c[1] for c in tri):
                        ftex.append([int(c[1]) - 1 for c in tri])
                    if all(len(c) > 2 and c[2] for c in tri):
                        fnrm.append([int(c[2]) - 1 for c in tri])
            elif tag == "usemtl":
                material = parts[1] if len(parts) > 1 else None
            elif tag == "mtllib":
                mtllib = parts[1] if len(parts) > 1 else None
    nf = len(faces)
    return ObjMesh(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        faces=np.asarray(faces, np.int32).reshape(-1, 3),
        texcoords=(np.asarray(tex, np.float32).reshape(-1, 2)
                   if tex else None),
        normals=(np.asarray(nrm, np.float32).reshape(-1, 3)
                 if nrm else None),
        face_texcoords=(np.asarray(ftex, np.int32).reshape(-1, 3)
                        if len(ftex) == nf and nf else None),
        face_normals=(np.asarray(fnrm, np.int32).reshape(-1, 3)
                      if len(fnrm) == nf and nf else None),
        material=material, mtllib=mtllib)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              texcoords: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              face_texcoords: Optional[np.ndarray] = None,
              face_normals: Optional[np.ndarray] = None,
              material: Optional[str] = None,
              mtllib: Optional[str] = None) -> None:
    with open(path, "w") as f:
        f.write("# hcmvs_tpu OBJ\n")
        if mtllib:
            f.write(f"mtllib {mtllib}\n")
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.7g} {v[1]:.7g} {v[2]:.7g}\n")
        if texcoords is not None:
            for t in np.asarray(texcoords):
                f.write(f"vt {t[0]:.7g} {t[1]:.7g}\n")
        if normals is not None:
            for n in np.asarray(normals):
                f.write(f"vn {n[0]:.7g} {n[1]:.7g} {n[2]:.7g}\n")
        if material:
            f.write(f"usemtl {material}\n")
        faces = np.asarray(faces)
        for i, fc in enumerate(faces):
            corners = []
            for j in range(3):
                s = str(fc[j] + 1)
                has_t = face_texcoords is not None
                has_n = face_normals is not None
                if has_t or has_n:
                    s += "/" + (str(face_texcoords[i, j] + 1) if has_t
                                else "")
                    if has_n:
                        s += "/" + str(face_normals[i, j] + 1)
                corners.append(s)
            f.write("f " + " ".join(corners) + "\n")
