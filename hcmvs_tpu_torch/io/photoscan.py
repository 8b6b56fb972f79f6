"""Agisoft PhotoScan/Metashape camera-XML scene import/export (a numpy
copy of ``hcmvs_tpu/io/photoscan.py``: the port imports nothing of the JAX
package).

Python counterpart of the reference's InterfacePhotoScan app
(ref: frame_main/apps/InterfacePhotoScan/InterfacePhotoScan.cpp:218-380):
document > chunk > sensors > sensor{id} > calibration{resolution, f|fx/fy,
cx, cy, k1..k6, p1, p2} and document > chunk > cameras > camera{id,
sensor_id, label, enabled} > transform (16 floats, camera-to-world, row
major).  The reference converts the camera-to-world transform with
``pose.C = R*(-C); pose.R = R.t()`` (InterfacePhotoScan.cpp:370-373),
i.e. R_w2c = M[:3,:3].T and C = M[:3,3] — mirrored here.  Distortion
coefficients are parsed but not applied (images are assumed undistorted,
as the reference's UndistortBrown step makes them).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord, NO_ID, Platform,
                              Pose, SceneMVS)


def read_photoscan_xml(path: str) -> SceneMVS:
    root = ET.parse(path).getroot()
    chunk = root.find("chunk")
    if chunk is None:
        raise ValueError("no <chunk> in PhotoScan XML")

    scene = SceneMVS()
    sensor_platform: Dict[int, int] = {}
    sensors_el = chunk.find("sensors")
    for sensor in (sensors_el if sensors_el is not None else []):
        if sensor.tag != "sensor":
            continue
        sid = int(sensor.get("id"))
        calib = sensor.find("calibration")
        if calib is None:
            continue
        w = h = 0
        res = calib.find("resolution")
        if res is not None:
            w, h = int(res.get("width")), int(res.get("height"))
        vals = {el.tag: float(el.text) for el in calib
                if el.tag not in ("resolution",) and el.text}
        fx = vals.get("fx", vals.get("f", 0.0))
        fy = vals.get("fy", vals.get("f", fx))
        # Metashape >= 1.2 stores cx/cy as offsets from the image center;
        # PhotoScan < 1.2 stores absolute coords.  Heuristic: small values
        # are offsets (the reference predates the change and treats them
        # as absolute, which breaks on modern files).
        cx = vals.get("cx", 0.0)
        cy = vals.get("cy", 0.0)
        if w and abs(cx) < w / 4.0:
            cx += w / 2.0
            cy += h / 2.0
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        sensor_platform[sid] = len(scene.platforms)
        plat = Platform(name=sensor.get("label", f"sensor{sid}"))
        plat.cameras.append(CameraIntrinsic(
            name=f"sensor{sid}", width=w, height=h, K=K,
            R=np.eye(3), C=np.zeros(3)))
        scene.platforms.append(plat)

    cameras_el = chunk.find("cameras")
    for camera in (cameras_el if cameras_el is not None else []):
        if camera.tag != "camera":
            continue
        cid = int(camera.get("id"))
        sid = int(camera.get("sensor_id", -1))
        name = camera.get("label", f"camera{cid}")
        plat_id = sensor_platform.get(sid, NO_ID)
        rec = ImageRecord(name=name, platform_id=plat_id, camera_id=0,
                          pose_id=NO_ID, id=len(scene.images))
        tr = camera.find("transform")
        enabled = camera.get("enabled", "true").lower() in ("true", "1")
        if tr is not None and tr.text and plat_id != NO_ID and enabled:
            M = np.fromstring(tr.text, sep=" ").reshape(4, 4)
            R = M[:3, :3].T              # world->camera
            C = M[:3, 3].copy()          # camera center
            plat = scene.platforms[plat_id]
            rec.pose_id = len(plat.poses)
            plat.poses.append(Pose(R=R, C=C))
        scene.images.append(rec)
    return scene


def write_photoscan_xml(path: str, scene: SceneMVS) -> None:
    root = ET.Element("document", version="1.2.0")
    chunk = ET.SubElement(root, "chunk")
    sensors = ET.SubElement(chunk, "sensors")
    sensor_of: Dict[tuple, int] = {}
    for pi, plat in enumerate(scene.platforms):
        for ci, cam in enumerate(plat.cameras):
            sid = len(sensor_of)
            sensor_of[(pi, ci)] = sid
            s = ET.SubElement(sensors, "sensor", id=str(sid),
                              label=cam.name or f"sensor{sid}",
                              type="frame")
            calib = ET.SubElement(s, "calibration", type="frame",
                                  **{"class": "adjusted"})
            if cam.width and cam.height:
                ET.SubElement(calib, "resolution", width=str(cam.width),
                              height=str(cam.height))
            # Metashape document version >= 1.2 stores cx/cy as offsets
            # from the image center; emit offsets to match the declared
            # version (absolute only when the resolution is unknown).
            cx, cy = float(cam.K[0, 2]), float(cam.K[1, 2])
            if cam.width and cam.height:
                cx -= cam.width / 2.0
                cy -= cam.height / 2.0
            for tag, val in (("fx", cam.K[0, 0]), ("fy", cam.K[1, 1]),
                             ("cx", cx), ("cy", cy)):
                el = ET.SubElement(calib, tag)
                el.text = f"{float(val):.10g}"
    cams_el = ET.SubElement(chunk, "cameras")
    for i, im in enumerate(scene.images):
        attrs = {"id": str(i), "label": im.name or f"camera{i}",
                 "sensor_id": str(sensor_of.get(
                     (im.platform_id, im.camera_id), 0)),
                 "enabled": "true" if im.is_valid else "false"}
        c = ET.SubElement(cams_el, "camera", **attrs)
        if im.is_valid:
            R, C = scene.pose_of(i)
            M = np.eye(4)
            M[:3, :3] = R.T
            M[:3, 3] = C
            t = ET.SubElement(c, "transform")
            t.text = " ".join(f"{v:.12g}" for v in M.reshape(-1))
    ET.ElementTree(root).write(path, encoding="unicode",
                               xml_declaration=True)
