"""COLMAP binary model reader/writer -> SceneMVS (a numpy
copy of ``hcmvs_tpu/io/colmap.py``: the port imports nothing of the JAX
package).

The analog of the reference's InterfaceCOLMAP app
(ref: frame_main/apps/InterfaceCOLMAP/, 1.1k LoC of bidirectional
conversion): reads/writes COLMAP's sparse model format (cameras.bin,
images.bin, points3D.bin — the documented binary layout) so scenes from
COLMAP feed straight into the dense stage.

COLMAP stores world->cam quaternion qw qx qy qz and translation t
(X_cam = R X + t); SceneMVS stores (R, C) with C = -R^T t.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord, Platform, Pose,
                              SceneMVS)

# COLMAP camera model ids -> (name, n_params)
_MODELS = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
           2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
           4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
           6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
           8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
           10: ("THIN_PRISM_FISHEYE", 12)}
_MODEL_IDS = {name: (mid, n) for mid, (name, n) in _MODELS.items()}


def _qvec2rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def _rot2qvec(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([0.25 / s, (R[2, 1] - R[1, 2]) * s,
                         (R[0, 2] - R[2, 0]) * s,
                         (R[1, 0] - R[0, 1]) * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def read_colmap_model(model_dir: str) -> SceneMVS:
    """Read cameras.bin / images.bin / points3D.bin into a SceneMVS."""
    cameras = _read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
    images = _read_images_bin(os.path.join(model_dir, "images.bin"))
    points = _read_points_bin(os.path.join(model_dir, "points3D.bin"))

    plat = Platform(name="colmap")
    cam_idx: Dict[int, int] = {}
    for cid, (model, w, h, params) in sorted(cameras.items()):
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL",
                     "SIMPLE_RADIAL_FISHEYE"):
            fx = fy = params[0]
            cx, cy = params[1], params[2]
        else:
            fx, fy, cx, cy = params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        cam_idx[cid] = len(plat.cameras)
        plat.cameras.append(CameraIntrinsic(
            name=f"cam{cid}", width=int(w), height=int(h), K=K,
            R=np.eye(3), C=np.zeros(3)))

    scene = SceneMVS(platforms=[plat])
    img_idx: Dict[int, int] = {}
    for iid, (q, t, cid, name) in sorted(images.items()):
        R = _qvec2rot(q)
        C = -R.T @ t
        img_idx[iid] = len(scene.images)
        scene.images.append(ImageRecord(
            name=name, platform_id=0, camera_id=cam_idx[cid],
            pose_id=len(plat.poses), id=img_idx[iid]))
        plat.poses.append(Pose(R=R, C=C))

    pts, counts, ids, confs, cols = [], [], [], [], []
    for pid, (xyz, rgb, err, track) in sorted(points.items()):
        views = [img_idx[i] for i, _ in track if i in img_idx]
        if len(views) < 2:
            continue
        pts.append(xyz)
        counts.append(len(views))
        ids.extend(views)
        confs.extend([1.0] * len(views))
        cols.append(rgb[::-1])  # Interface colors are BGR
    scene.points = (np.stack(pts).astype(np.float32) if pts
                    else np.zeros((0, 3), np.float32))
    scene.point_view_counts = np.asarray(counts, np.int32)
    scene.point_view_ids = np.asarray(ids, np.uint32)
    scene.point_view_confs = np.asarray(confs, np.float32)
    scene.point_colors = (np.stack(cols).astype(np.uint8) if cols
                          else None)
    return scene


def write_colmap_model(model_dir: str, scene: SceneMVS) -> None:
    """Write a SceneMVS as a COLMAP binary sparse model."""
    os.makedirs(model_dir, exist_ok=True)
    plat = scene.platforms[0]
    with open(os.path.join(model_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(plat.cameras)))
        for i, cam in enumerate(plat.cameras):
            K = cam.K
            f.write(struct.pack("<iiQQ", i + 1, 1, cam.width, cam.height))
            f.write(struct.pack("<dddd", K[0, 0], K[1, 1], K[0, 2],
                                K[1, 2]))
    # build per-image observation lists from the point tracks
    obs: Dict[int, list] = {i: [] for i in range(len(scene.images))}
    off = 0
    for p in range(len(scene.points) if scene.points is not None else 0):
        cnt = int(scene.point_view_counts[p])
        for k in range(cnt):
            obs[int(scene.point_view_ids[off + k])].append(p)
        off += cnt
    with open(os.path.join(model_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(scene.images)))
        for i, im in enumerate(scene.images):
            R, C = scene.pose_of(i)
            q = _rot2qvec(R)
            t = -R @ C
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *t))
            f.write(struct.pack("<i", im.camera_id + 1))
            f.write(im.name.encode() + b"\x00")
            pts2d = obs[i]
            f.write(struct.pack("<Q", len(pts2d)))
            for p in pts2d:
                f.write(struct.pack("<ddq", 0.0, 0.0, p + 1))
    with open(os.path.join(model_dir, "points3D.bin"), "wb") as f:
        n = len(scene.points) if scene.points is not None else 0
        f.write(struct.pack("<Q", n))
        off = 0
        for p in range(n):
            xyz = scene.points[p]
            rgb = (scene.point_colors[p][::-1]
                   if scene.point_colors is not None else
                   np.array([128, 128, 128], np.uint8))
            f.write(struct.pack("<q", p + 1))
            f.write(struct.pack("<ddd", *xyz.astype(np.float64)))
            f.write(struct.pack("<BBB", *rgb))
            f.write(struct.pack("<d", 1.0))
            cnt = int(scene.point_view_counts[p])
            f.write(struct.pack("<Q", cnt))
            for k in range(cnt):
                f.write(struct.pack("<ii",
                                    int(scene.point_view_ids[off + k]) + 1,
                                    0))
            off += cnt


def _read_cameras_bin(path: str) -> Dict[int, Tuple]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id = struct.unpack("<ii", f.read(8))
            w, h = struct.unpack("<QQ", f.read(16))
            name, n_params = _MODELS[model_id]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            out[cid] = (name, w, h, np.array(params))
    return out


def _read_images_bin(path: str) -> Dict[int, Tuple]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", f.read(4))
            q = np.array(struct.unpack("<dddd", f.read(32)))
            t = np.array(struct.unpack("<ddd", f.read(24)))
            (cid,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n2d)   # xy + point3D id per observation
            out[iid] = (q, t, cid, name.decode())
    return out


def _read_points_bin(path: str) -> Dict[int, Tuple]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<q", f.read(8))
            xyz = np.array(struct.unpack("<ddd", f.read(24)))
            rgb = np.array(struct.unpack("<BBB", f.read(3)), np.uint8)
            (err,) = struct.unpack("<d", f.read(8))
            (tlen,) = struct.unpack("<Q", f.read(8))
            track = []
            for _ in range(tlen):
                iid, p2d = struct.unpack("<ii", f.read(8))
                track.append((iid, p2d))
            out[pid] = (xyz, rgb, err, track)
    return out
