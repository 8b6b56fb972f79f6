"""Reader/writer for the OpenMVS `.mvs` Interface scene format (port of
``hcmvs_tpu/io/mvs.py``, a copy: the port imports nothing of the JAX
package).

Byte-compatible with the reference's versioned binary serialization
(ref: frame_main/libs/MVS/Interface.h:14-15 "MVSI" v5 header,
:363-620 Platform/Camera/Pose/Image/Vertex/Normal/Color/Line structs,
:168-360 the ARCHIVE stream codec).  The writer's bytes equal the JAX
package's for the same scene.

The vertex block (per point: ``<f4 x3, <u8 count``, then ``count`` pairs of
``<u4 id, <f4 conf``) is built with numpy in one pass instead of one
``struct.pack`` per point and view: every field is 4 bytes wide, so the
block is an array of little-endian 32-bit words where point ``p`` starts
at word ``5 p + 2 c_p`` (``c_p`` = views of the points before it) and the
pair of flat index ``j`` sits at word ``5 (p + 1) + 2 j``.  The reader
walks the counts with one integer read per point (each count gives the
next record's offset, so the walk is sequential by the format) and
gathers points, ids and confidences from the same word array.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np

MVSI_MAGIC = b"MVSI"
MVSI_VERSION = 5
NO_ID = 0xFFFFFFFF


@dataclasses.dataclass
class CameraIntrinsic:
    name: str = ""
    band_name: str = ""
    width: int = 0
    height: int = 0
    K: np.ndarray = None           # (3,3) f64; normalized if width==height==0
    R: np.ndarray = None           # (3,3) f64 camera-to-platform rotation
    C: np.ndarray = None           # (3,)  f64 camera-to-platform translation

    def full_K(self, width: int, height: int) -> np.ndarray:
        """De-normalized intrinsics for an image of the given resolution
        (ref: Interface.h:444-451 Platform::GetFullK — normalized K is
        scaled by max(width, height))."""
        if self.width > 0 and self.height > 0:
            if (self.width, self.height) == (width, height):
                return self.K.copy()
            scale = max(width, height) / max(self.width, self.height)
        else:
            scale = float(max(width, height))
        K = self.K.copy()
        K[0, :] *= scale
        K[1, 1] *= scale
        K[1, 2] *= scale
        return K


@dataclasses.dataclass
class Pose:
    R: np.ndarray                  # (3,3) f64
    C: np.ndarray                  # (3,)  f64


@dataclasses.dataclass
class Platform:
    name: str = ""
    cameras: List[CameraIntrinsic] = dataclasses.field(default_factory=list)
    poses: List[Pose] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ImageRecord:
    name: str = ""
    mask_name: str = ""
    platform_id: int = NO_ID
    camera_id: int = NO_ID
    pose_id: int = NO_ID
    id: int = NO_ID

    @property
    def is_valid(self) -> bool:
        return self.pose_id != NO_ID


@dataclasses.dataclass
class SceneMVS:
    """Host-side scene container: the `.mvs` Interface contents, point data
    in struct-of-arrays layout."""

    platforms: List[Platform] = dataclasses.field(default_factory=list)
    images: List[ImageRecord] = dataclasses.field(default_factory=list)
    points: np.ndarray = None              # (N, 3) f32
    # ragged per-point visibility as flat arrays:
    point_view_counts: np.ndarray = None   # (N,) i32
    point_view_ids: np.ndarray = None      # (sum counts,) u32
    point_view_confs: np.ndarray = None    # (sum counts,) f32
    point_normals: np.ndarray = None       # (N, 3) f32 or None
    point_colors: np.ndarray = None        # (N, 3) u8 BGR or None
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4))

    def pose_of(self, image_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Absolute (R, C) of an image (ref: Interface.h:455-463 GetPose)."""
        im = self.images[image_idx]
        plat = self.platforms[im.platform_id]
        cam = plat.cameras[im.camera_id]
        pose = plat.poses[im.pose_id]
        R = cam.R @ pose.R
        C = pose.R.T @ cam.C + pose.C
        return R, C

    def intrinsics_of(self, image_idx: int, width: int, height: int
                      ) -> np.ndarray:
        im = self.images[image_idx]
        return self.platforms[im.platform_id].cameras[im.camera_id].full_K(
            width, height)


class _Reader:
    def __init__(self, buf: bytes, version: int):
        self.buf = buf
        self.off = 0
        self.version = version

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u64()
        s = self.buf[self.off:self.off + n].decode(errors="replace")
        self.off += n
        return s

    def f64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", n, self.off).copy()
        self.off += 8 * n
        return v

    def f32s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f4", n, self.off).copy()
        self.off += 4 * n
        return v

    def bytes_(self, n: int) -> bytes:
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.parts.append(b)

    def f64s(self, a) -> None:
        self.parts.append(np.ascontiguousarray(a, dtype="<f8").tobytes())

    def f32s(self, a) -> None:
        self.parts.append(np.ascontiguousarray(a, dtype="<f4").tobytes())

    def raw(self, b: bytes):
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _read_vertices(r: _Reader):
    """The vertex block at ``r.off``: (points, counts, ids, confs)."""
    n_pts = r.u64()
    counts = np.empty(n_pts, np.int64)
    off = r.off
    unpack = struct.Struct("<Q").unpack_from
    for i in range(n_pts):            # sequential: a count gives the next
        (c,) = unpack(r.buf, off + 12)    # record's offset
        counts[i] = c
        off += 20 + 8 * c
    words = np.frombuffer(r.buf, "<u4", (off - r.off) // 4, r.off)
    r.off = off
    before = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    start = 5 * np.arange(n_pts) + 2 * before
    pts = words[start[:, None] + np.arange(3)].view("<f4").astype(np.float32)
    pt_of = np.repeat(np.arange(n_pts), counts)
    pos = 5 * (pt_of + 1) + 2 * np.arange(len(pt_of))
    return (pts, counts.astype(np.int32), words[pos].astype(np.uint32),
            words[pos + 1].view("<f4").astype(np.float32))


def read_mvs(path: str) -> SceneMVS:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != MVSI_MAGIC:
        raise ValueError(f"not an Interface .mvs file: {path}")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version > MVSI_VERSION:
        raise ValueError(f"unsupported .mvs version {version}")
    r = _Reader(buf, version)
    r.off = 12  # magic + version + reserved

    scene = SceneMVS()
    # platforms
    for _ in range(r.u64()):
        plat = Platform(name=r.string())
        for _ in range(r.u64()):   # cameras
            cam = CameraIntrinsic(name=r.string())
            if version > 3:
                cam.band_name = r.string()
            if version > 0:
                cam.width = r.u32()
                cam.height = r.u32()
            cam.K = r.f64s(9).reshape(3, 3)
            cam.R = r.f64s(9).reshape(3, 3)
            cam.C = r.f64s(3)
            plat.cameras.append(cam)
        for _ in range(r.u64()):   # poses
            R = r.f64s(9).reshape(3, 3)
            C = r.f64s(3)
            plat.poses.append(Pose(R=R, C=C))
        scene.platforms.append(plat)
    # images
    for _ in range(r.u64()):
        im = ImageRecord(name=r.string())
        if version > 4:
            im.mask_name = r.string()
        im.platform_id = r.u32()
        im.camera_id = r.u32()
        im.pose_id = r.u32()
        if version > 2:
            im.id = r.u32()
        scene.images.append(im)
    # vertices (point + view list each)
    (scene.points, scene.point_view_counts, scene.point_view_ids,
     scene.point_view_confs) = _read_vertices(r)
    # normals
    n = r.u64()
    if n:
        scene.point_normals = r.f32s(3 * n).reshape(n, 3)
    # colors
    n = r.u64()
    if n:
        scene.point_colors = np.frombuffer(
            r.bytes_(3 * n), np.uint8).reshape(n, 3).copy()
    if version > 0:
        for _ in range(r.u64()):   # lines (unused by the pipeline)
            r.f32s(6)
            for _ in range(r.u64()):
                r.u32()
                r.f32s(1)
        n = r.u64()
        if n:
            r.f32s(3 * n)          # line normals
        n = r.u64()
        if n:
            r.bytes_(3 * n)        # line colors
        if version > 1:
            scene.transform = r.f64s(16).reshape(4, 4)
    return scene


def _vertex_block(points, counts, ids, confs) -> bytes:
    """The vertex records, after their u64 count, as one byte string."""
    n = len(points)
    counts = (np.zeros(n, np.int64) if counts is None
              else np.asarray(counts, np.int64))
    total = int(counts.sum())
    words = np.zeros(5 * n + 2 * total, "<u4")
    before = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    start = 5 * np.arange(n) + 2 * before
    xyz = np.ascontiguousarray(points, "<f4").reshape(n, 3).view("<u4")
    for k in range(3):
        words[start + k] = xyz[:, k]
    words[start + 3] = (counts & 0xFFFFFFFF).astype(np.uint32)
    words[start + 4] = (counts >> 32).astype(np.uint32)
    if total:
        pt_of = np.repeat(np.arange(n), counts)
        pos = 5 * (pt_of + 1) + 2 * np.arange(total)
        words[pos] = np.asarray(ids, np.uint32)[:total]
        words[pos + 1] = np.ascontiguousarray(
            np.asarray(confs)[:total], "<f4").view("<u4")
    return words.tobytes()


def write_mvs(path: str, scene: SceneMVS) -> None:
    w = _Writer()
    w.raw(MVSI_MAGIC)
    w.u32(MVSI_VERSION)
    w.u32(0)  # reserved
    # platforms
    w.u64(len(scene.platforms))
    for plat in scene.platforms:
        w.string(plat.name)
        w.u64(len(plat.cameras))
        for cam in plat.cameras:
            w.string(cam.name)
            w.string(cam.band_name)
            w.u32(cam.width)
            w.u32(cam.height)
            w.f64s(cam.K)
            w.f64s(cam.R)
            w.f64s(cam.C)
        w.u64(len(plat.poses))
        for pose in plat.poses:
            w.f64s(pose.R)
            w.f64s(pose.C)
    # images
    w.u64(len(scene.images))
    for im in scene.images:
        w.string(im.name)
        w.string(im.mask_name)
        w.u32(im.platform_id)
        w.u32(im.camera_id)
        w.u32(im.pose_id)
        w.u32(im.id)
    # vertices
    n_pts = 0 if scene.points is None else len(scene.points)
    w.u64(n_pts)
    if n_pts:
        w.raw(_vertex_block(scene.points, scene.point_view_counts,
                            scene.point_view_ids, scene.point_view_confs))
    # normals / colors
    if scene.point_normals is not None:
        w.u64(len(scene.point_normals))
        w.f32s(scene.point_normals)
    else:
        w.u64(0)
    if scene.point_colors is not None:
        w.u64(len(scene.point_colors))
        w.raw(np.ascontiguousarray(scene.point_colors, np.uint8).tobytes())
    else:
        w.u64(0)
    # lines (none) + transform
    w.u64(0)
    w.u64(0)
    w.u64(0)
    w.f64s(scene.transform)
    with open(path, "wb") as f:
        f.write(w.getvalue())
