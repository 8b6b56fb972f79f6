"""OpenMVG sfm_data.json scene import/export (a numpy
copy of ``hcmvs_tpu/io/openmvg.py``: the port imports nothing of the JAX
package).

Python counterpart of the reference's InterfaceOpenMVG app
(ref: frame_main/apps/InterfaceOpenMVG/InterfaceOpenMVG.cpp:548-560 reads
openMVG::sfm::SfM_Data; the on-disk format is cereal JSON/binary — the
JSON flavor is parsed here; the binary flavor is produced by openMVG with
a cereal portable-binary archive and is out of scope).

The cereal JSON schema (openMVG v1.x):
  views[]      -> {key, value.ptr_wrapper.data.{filename,width,height,
                   id_view,id_intrinsic,id_pose}}
  intrinsics[] -> {key, value.{polymorphic_name, ptr_wrapper.data.
                   {width,height,focal_length,principal_point[2], ...}}}
  extrinsics[] -> {key, value.{rotation[3][3], center[3]}}  (world->cam R,
                   camera center)
  structure[]  -> {key, value.{X[3], observations[]{key=view_id,
                   value.{id_feat,x[2]}}}}
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord, NO_ID, Platform,
                              Pose, SceneMVS)


def read_openmvg_json(path: str) -> SceneMVS:
    with open(path) as f:
        data = json.load(f)

    intr_map: Dict[int, int] = {}
    plat = Platform(name="openmvg")
    for item in data.get("intrinsics", []):
        d = item["value"]["ptr_wrapper"]["data"]
        w, h = int(d["width"]), int(d["height"])
        f_len = float(d.get("focal_length", d.get("value0", {}).get(
            "focal_length", 0.0)) or _nested_focal(d))
        pp = d.get("principal_point") or _nested_pp(d) or [w / 2.0, h / 2.0]
        K = np.array([[f_len, 0, pp[0]], [0, f_len, pp[1]], [0, 0, 1.0]])
        intr_map[int(item["key"])] = len(plat.cameras)
        plat.cameras.append(CameraIntrinsic(
            name=f"intr{item['key']}", width=w, height=h, K=K,
            R=np.eye(3), C=np.zeros(3)))

    pose_map: Dict[int, int] = {}
    for item in data.get("extrinsics", []):
        v = item["value"]
        R = np.asarray(v["rotation"], np.float64)
        C = np.asarray(v["center"], np.float64)
        pose_map[int(item["key"])] = len(plat.poses)
        plat.poses.append(Pose(R=R, C=C))

    scene = SceneMVS(platforms=[plat])
    view_map: Dict[int, int] = {}
    root = data.get("root_path", "")
    for item in data.get("views", []):
        d = item["value"]["ptr_wrapper"]["data"]
        vid = int(d.get("id_view", item["key"]))
        iid = int(d["id_intrinsic"])
        pid = int(d["id_pose"])
        view_map[vid] = len(scene.images)
        scene.images.append(ImageRecord(
            name=os.path.join(root, d.get("local_path", ""),
                              d["filename"]).replace("//", "/"),
            platform_id=0,
            camera_id=intr_map.get(iid, NO_ID),
            pose_id=pose_map.get(pid, NO_ID),
            id=view_map[vid]))

    pts, counts, ids, confs = [], [], [], []
    for item in data.get("structure", []):
        v = item["value"]
        views = [view_map[int(ob["key"])] for ob in v.get("observations", [])
                 if int(ob["key"]) in view_map]
        pts.append(v["X"])
        counts.append(len(views))
        ids.extend(views)
        confs.extend([1.0] * len(views))
    scene.points = np.asarray(pts, np.float32).reshape(-1, 3)
    scene.point_view_counts = np.asarray(counts, np.int32)
    scene.point_view_ids = np.asarray(ids, np.uint32)
    scene.point_view_confs = np.asarray(confs, np.float32)
    return scene


def _nested_focal(d):
    # pinhole_radial_k3 etc. nest the pinhole block under "value0"
    v0 = d.get("value0", {})
    return float(v0.get("focal_length", 0.0))


def _nested_pp(d):
    v0 = d.get("value0", {})
    return v0.get("principal_point")


def write_openmvg_json(path: str, scene: SceneMVS) -> None:
    """Export a SceneMVS as openMVG cereal-JSON (pinhole intrinsics)."""
    intrinsics, views, extrinsics = [], [], []
    ptr_id = 2147483649  # cereal ptr_wrapper ids: arbitrary unique ints
    intr_key: Dict[tuple, int] = {}
    for i, im in enumerate(scene.images):
        plat = scene.platforms[im.platform_id]
        cam = plat.cameras[im.camera_id]
        key = (im.platform_id, im.camera_id)
        if key not in intr_key:
            intr_key[key] = len(intrinsics)
            intrinsics.append({
                "key": intr_key[key],
                "value": {
                    "polymorphic_id": 2147483649,
                    "polymorphic_name": "pinhole",
                    "ptr_wrapper": {
                        "id": ptr_id,
                        "data": {
                            "width": cam.width, "height": cam.height,
                            "focal_length":
                                float(cam.K[0, 0] + cam.K[1, 1]) * 0.5,
                            "principal_point": [float(cam.K[0, 2]),
                                                float(cam.K[1, 2])],
                        }}}})
            ptr_id += 1
        pose_key = None
        if im.is_valid:
            R, C = scene.pose_of(i)
            pose_key = len(extrinsics)
            extrinsics.append({"key": pose_key, "value": {
                "rotation": R.tolist(), "center": C.tolist()}})
        views.append({"key": i, "value": {
            "polymorphic_id": 1073741824,
            "ptr_wrapper": {"id": ptr_id, "data": {
                "local_path": "",
                "filename": os.path.basename(im.name) or f"image{i}.jpg",
                "width": cam.width, "height": cam.height,
                "id_view": i, "id_intrinsic": intr_key[key],
                "id_pose": pose_key if pose_key is not None else i,
            }}}})
        ptr_id += 1

    structure = []
    if scene.points is not None and len(scene.points):
        offs = np.concatenate([[0], np.cumsum(scene.point_view_counts)])
        for p in range(len(scene.points)):
            obs = [{"key": int(v), "value": {"id_feat": 0, "x": [0.0, 0.0]}}
                   for v in scene.point_view_ids[offs[p]:offs[p + 1]]]
            structure.append({"key": p, "value": {
                "X": [float(x) for x in scene.points[p]],
                "observations": obs}})

    out = {
        "sfm_data_version": "0.3",
        "root_path": "",
        "views": views,
        "intrinsics": intrinsics,
        "extrinsics": extrinsics,
        "structure": structure,
        "control_points": [],
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
