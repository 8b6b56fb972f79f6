"""VisualSFM NVM scene import/export (a numpy
copy of ``hcmvs_tpu/io/nvm.py``: the port imports nothing of the JAX
package).

Python counterpart of the reference's InterfaceVisualSFM app
(ref: frame_main/apps/InterfaceVisualSFM/InterfaceVisualSFM.cpp and the
NVM_V3 grammar in frame_main/apps/InterfaceVisualSFM/Util.h:52-135):

    NVM_V3
    <ncam>
    <name> <f> <qw> <qx> <qy> <qz> <cx> <cy> <cz> <d0> <d1>   x ncam
    <npoint>
    <x> <y> <z> <r> <g> <b> <nproj> (<cam> <feat> <mx> <my>)* x npoint

Rotation is a world-to-camera quaternion (wxyz), position is the camera
center, d0 is the single radial distortion coefficient (ignored here —
images are assumed undistorted, as the reference's importer makes them).
NVM knows only a single focal length with the principal point at the image
center (the reference warns about exactly this, InterfaceVisualSFM.cpp:
316-321), so intrinsics need the image size: pass ``image_size`` or let it
default to the normalized convention with an assumed aspect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord, Platform, Pose,
                              SceneMVS)


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w, x, y, z) unit quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def read_nvm(path: str,
             image_size: Optional[Tuple[int, int]] = None) -> SceneMVS:
    """Parse an NVM_V3 model into a SceneMVS.

    Args:
      path: .nvm file.
      image_size: (width, height) of the (undistorted) images; when given,
        each camera gets a full K with the principal point at the image
        center.  When None, K keeps the raw focal with cx=cy=0 and
        width=height=0 — callers must fix intrinsics from real images.
    """
    with open(path, "r", errors="replace") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt():
        return next(it)

    header = nxt()
    if not header.startswith("NVM_V3"):
        raise ValueError(f"not an NVM_V3 file: {header!r}")
    if "R9T" in header:
        raise ValueError("NVM_V3_R9T variant not supported")
    tok = nxt()
    if tok == "FixedK":  # rare fixed-intrinsics header (Util.h:72-78)
        for _ in range(5):
            nxt()
        tok = nxt()
    ncam = int(tok)

    plat = Platform(name="nvm")
    scene = SceneMVS(platforms=[plat])
    for i in range(ncam):
        name = nxt()
        f_len = float(nxt())
        q = np.array([float(nxt()) for _ in range(4)])
        c = np.array([float(nxt()) for _ in range(3)])
        _d0, _d1 = float(nxt()), float(nxt())
        if image_size is not None:
            w, h = image_size
            K = np.array([[f_len, 0, w / 2.0], [0, f_len, h / 2.0],
                          [0, 0, 1.0]])
            cam = CameraIntrinsic(name=f"cam{i}", width=int(w), height=int(h),
                                  K=K, R=np.eye(3), C=np.zeros(3))
        else:
            K = np.array([[f_len, 0, 0], [0, f_len, 0], [0, 0, 1.0]])
            cam = CameraIntrinsic(name=f"cam{i}", K=K, R=np.eye(3),
                                  C=np.zeros(3))
        plat.cameras.append(cam)
        plat.poses.append(Pose(R=quat_to_rot(q), C=c))
        scene.images.append(ImageRecord(name=name, platform_id=0,
                                        camera_id=i, pose_id=i, id=i))

    npoint = int(nxt())
    pts, counts, ids, confs, cols = [], [], [], [], []
    for _ in range(npoint):
        xyz = [float(nxt()) for _ in range(3)]
        rgb = [int(float(nxt())) for _ in range(3)]
        nproj = int(nxt())
        views = []
        for _ in range(nproj):
            cidx = int(nxt())
            nxt()  # feature index
            nxt()  # mx
            nxt()  # my
            views.append(cidx)
        pts.append(xyz)
        counts.append(len(views))
        ids.extend(views)
        confs.extend([1.0] * len(views))
        cols.append(rgb[::-1])  # Interface colors are BGR
    scene.points = np.asarray(pts, np.float32).reshape(-1, 3)
    scene.point_view_counts = np.asarray(counts, np.int32)
    scene.point_view_ids = np.asarray(ids, np.uint32)
    scene.point_view_confs = np.asarray(confs, np.float32)
    scene.point_colors = (np.asarray(cols, np.uint8).reshape(-1, 3)
                          if cols else None)
    return scene


def write_nvm(path: str, scene: SceneMVS) -> None:
    """Export a SceneMVS as NVM_V3 (focal from K, center-principal-point
    convention; measurements written as zeros, matching the information the
    reference's exporter preserves — SaveNVM, Util.h:142-180)."""
    lines = ["NVM_V3", "", str(len(scene.images))]
    for i, im in enumerate(scene.images):
        R, C = scene.pose_of(i)
        cam = scene.platforms[im.platform_id].cameras[im.camera_id]
        f_len = float(cam.K[0, 0] + cam.K[1, 1]) * 0.5
        q = rot_to_quat(R)
        lines.append(
            f"{im.name or f'image{i}.jpg'} {f_len:.12g} "
            f"{q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g} "
            f"{C[0]:.12g} {C[1]:.12g} {C[2]:.12g} 0 0")
    n = 0 if scene.points is None else len(scene.points)
    lines += ["", str(n)]
    if n:
        offs = np.concatenate([[0], np.cumsum(scene.point_view_counts)])
        cols = (scene.point_colors if scene.point_colors is not None
                else np.full((n, 3), 128, np.uint8))
        for p in range(n):
            views = scene.point_view_ids[offs[p]:offs[p + 1]]
            xyz = scene.points[p]
            bgr = cols[p]
            parts = [f"{xyz[0]:.9g} {xyz[1]:.9g} {xyz[2]:.9g} "
                     f"{int(bgr[2])} {int(bgr[1])} {int(bgr[0])} "
                     f"{len(views)}"]
            parts += [f"{int(v)} 0 0 0" for v in views]
            lines.append(" ".join(parts))
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
