"""Reader/writer for the OpenMVS `.dmap` raw depth-map format (port of
``hcmvs_tpu/io/dmap.py``, a copy: the port imports nothing of the JAX
package).

Byte-compatible with the reference implementation
(ref: frame_main/libs/MVS/Interface.h:634-652 ``HeaderDepthDataRaw``,
frame_main/libs/MVS/DepthMap.cpp:2781-2929 Export/ImportDepthDataRaw), so
depth maps can be diffed against reference outputs and the hierarchical
cross-stage handoff artifacts (depthmap/depth%04u.dmap,
normalmap/normal%04u.dmap) interoperate both ways.

Layout (little-endian):
  uint16 name ("DR") | uint8 type | uint8 pad | u32 imageW,imageH,depthW,depthH
  | f32 dMin,dMax | u16 len + image file name | u32 nIDs + u32 IDs[]
  | f64 K[9], R[9], C[3] | f32 depth[H*W] | f32 normal[H*W*3]? | f32 conf[H*W]?
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Sequence

import numpy as np

HAS_DEPTH = 1 << 0
HAS_NORMAL = 1 << 1
HAS_CONF = 1 << 2

_MAGIC = struct.unpack("<H", b"DR")[0]
_HEADER = struct.Struct("<HBBIIIIff")


@dataclasses.dataclass
class DepthMapData:
    """In-memory contents of a `.dmap` file."""

    depth: np.ndarray                       # (H, W) float32
    normal: Optional[np.ndarray] = None     # (H, W, 3) float32, camera space
    conf: Optional[np.ndarray] = None       # (H, W) float32
    K: np.ndarray = None                    # (3, 3) float64
    R: np.ndarray = None                    # (3, 3) float64
    C: np.ndarray = None                    # (3,) float64
    d_min: float = 0.0
    d_max: float = 0.0
    image_size: tuple = (0, 0)              # (width, height) of source image
    image_name: str = ""
    view_ids: Sequence[int] = ()            # reference view ID + neighbors


def write_dmap(path: str, data: DepthMapData) -> None:
    h, w = data.depth.shape
    img_w, img_h = data.image_size if data.image_size != (0, 0) else (w, h)
    dtype_flags = HAS_DEPTH
    if data.normal is not None:
        dtype_flags |= HAS_NORMAL
    if data.conf is not None:
        dtype_flags |= HAS_CONF
    name = data.image_name.encode()
    ids = np.asarray(data.view_ids, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, dtype_flags, 0, img_w, img_h, w, h,
                             float(data.d_min), float(data.d_max)))
        f.write(struct.pack("<H", len(name)))
        f.write(name)
        f.write(struct.pack("<I", len(ids)))
        f.write(ids.tobytes())
        f.write(np.asarray(data.K, dtype="<f8").tobytes())
        f.write(np.asarray(data.R, dtype="<f8").tobytes())
        f.write(np.asarray(data.C, dtype="<f8").tobytes())
        f.write(np.ascontiguousarray(data.depth, dtype="<f4").tobytes())
        if data.normal is not None:
            f.write(np.ascontiguousarray(data.normal, dtype="<f4").tobytes())
        if data.conf is not None:
            f.write(np.ascontiguousarray(data.conf, dtype="<f4").tobytes())


def read_dmap(path: str) -> DepthMapData:
    with open(path, "rb") as f:
        raw = f.read()
    (magic, dtype_flags, _pad, img_w, img_h, w, h,
     d_min, d_max) = _HEADER.unpack_from(raw, 0)
    if magic != _MAGIC or not dtype_flags & HAS_DEPTH:
        raise ValueError(f"not a valid .dmap file: {path}")
    off = _HEADER.size
    (name_len,) = struct.unpack_from("<H", raw, off)
    off += 2
    image_name = raw[off:off + name_len].decode(errors="replace")
    off += name_len
    (n_ids,) = struct.unpack_from("<I", raw, off)
    off += 4
    view_ids = np.frombuffer(raw, "<u4", n_ids, off).tolist()
    off += 4 * n_ids
    K = np.frombuffer(raw, "<f8", 9, off).reshape(3, 3).copy(); off += 72
    R = np.frombuffer(raw, "<f8", 9, off).reshape(3, 3).copy(); off += 72
    C = np.frombuffer(raw, "<f8", 3, off).copy(); off += 24
    depth = np.frombuffer(raw, "<f4", h * w, off).reshape(h, w).copy()
    off += 4 * h * w
    normal = conf = None
    if dtype_flags & HAS_NORMAL:
        normal = np.frombuffer(raw, "<f4", h * w * 3, off).reshape(h, w, 3).copy()
        off += 12 * h * w
    if dtype_flags & HAS_CONF:
        conf = np.frombuffer(raw, "<f4", h * w, off).reshape(h, w).copy()
    return DepthMapData(depth=depth, normal=normal, conf=conf, K=K, R=R, C=C,
                        d_min=d_min, d_max=d_max, image_size=(img_w, img_h),
                        image_name=image_name, view_ids=view_ids)
