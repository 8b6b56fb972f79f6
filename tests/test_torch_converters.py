"""PyTorch port vs the JAX package: the scene converters (COLMAP, NVM,
OpenMVG, PhotoScan) and the offline viewer.

The port's ``io/{colmap,nvm,openmvg,photoscan,viewer}.py`` are numpy
copies that read and write through the port's own ``io/mvs.py``.  For each
converter: the port's round trip (tests/test_colmap.py and
tests/test_converters.py are the templates), each package reading the
other's file into an equal scene, and both writing byte-equal files from
the same scene.  The viewer's HTML for the same cloud and mesh is
byte-equal.  Tolerances: those of the templates for a round trip (formats
that print decimals, 1e-4 to 1e-8), exact between the packages.
"""

import numpy as np
import pytest

from hcmvs_tpu.io import colmap as jcolmap
from hcmvs_tpu.io import mvs as jmvs
from hcmvs_tpu.io import nvm as jnvm
from hcmvs_tpu.io import openmvg as jopenmvg
from hcmvs_tpu.io import photoscan as jphotoscan
from hcmvs_tpu.io import viewer as jviewer
from hcmvs_tpu_torch import io as tio
from hcmvs_tpu_torch.io import colmap as tcolmap
from hcmvs_tpu_torch.io import mvs as tmvs
from hcmvs_tpu_torch.io import nvm as tnvm
from hcmvs_tpu_torch.io import openmvg as topenmvg
from hcmvs_tpu_torch.io import photoscan as tphotoscan
from hcmvs_tpu_torch.io import viewer as tviewer


def _rand_rot(rng):
    q = rng.normal(size=4)
    return tnvm.quat_to_rot(q / np.linalg.norm(q))


def _make_scene(mod, rng, n_imgs=4, n_pts=20, center_pp=True):
    """tests/test_converters.py's scene, built with ``mod``'s (either
    package's ``io.mvs``) classes."""
    plat = mod.Platform(name="test")
    scene = mod.SceneMVS(platforms=[plat])
    w, h = 640, 480
    for i in range(n_imgs):
        f = 500.0 + 10 * i
        cx, cy = (w / 2.0, h / 2.0) if center_pp else (315.0, 245.0)
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        plat.cameras.append(mod.CameraIntrinsic(
            name=f"c{i}", width=w, height=h, K=K, R=np.eye(3),
            C=np.zeros(3)))
        plat.poses.append(mod.Pose(R=_rand_rot(rng), C=rng.normal(size=3)))
        scene.images.append(mod.ImageRecord(name=f"im{i}.jpg", platform_id=0,
                                            camera_id=i, pose_id=i, id=i))
    scene.points = rng.normal(size=(n_pts, 3)).astype(np.float32)
    counts = rng.integers(2, n_imgs + 1, n_pts).astype(np.int32)
    ids = np.concatenate([rng.choice(n_imgs, c, replace=False)
                          for c in counts]).astype(np.uint32)
    scene.point_view_counts = counts
    scene.point_view_ids = ids
    scene.point_view_confs = np.ones(len(ids), np.float32)
    scene.point_colors = rng.integers(0, 255, (n_pts, 3)).astype(np.uint8)
    return scene


def _check_poses(a, b, atol=1e-5):
    assert len(a.images) == len(b.images)
    for i in range(len(a.images)):
        Ra, Ca = a.pose_of(i)
        Rb, Cb = b.pose_of(i)
        np.testing.assert_allclose(Ra, Rb, atol=atol)
        np.testing.assert_allclose(Ca, Cb, atol=atol)


def _assert_equal_scenes(a, b):
    """Every field of two scenes (one from each package) equal."""
    assert len(a.platforms) == len(b.platforms)
    for pa, pb in zip(a.platforms, b.platforms):
        assert pa.name == pb.name
        assert len(pa.cameras) == len(pb.cameras)
        for ca, cb in zip(pa.cameras, pb.cameras):
            assert (ca.name, ca.width, ca.height) == (cb.name, cb.width,
                                                      cb.height)
            for f in ("K", "R", "C"):
                np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
        assert len(pa.poses) == len(pb.poses)
        for qa, qb in zip(pa.poses, pb.poses):
            np.testing.assert_array_equal(qa.R, qb.R)
            np.testing.assert_array_equal(qa.C, qb.C)
    assert [(i.name, i.platform_id, i.camera_id, i.pose_id, i.id)
            for i in a.images] == [(i.name, i.platform_id, i.camera_id,
                                    i.pose_id, i.id) for i in b.images]
    for f in ("points", "point_view_counts", "point_view_ids",
              "point_view_confs", "point_colors"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


def _colmap_scene(mod, rng):
    scene = _make_scene(mod, rng, n_imgs=3, n_pts=12)
    # COLMAP cameras need explicit sizes (tests/test_colmap.py)
    scene.platforms[0].cameras[0].K = np.array(
        [[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    th = 0.3
    scene.platforms[0].poses[1].R = np.array(
        [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
         [-np.sin(th), 0, np.cos(th)]])
    return scene


# (name, scene builder, write, read, file or directory, reader kwargs)
FORMATS = {
    "colmap": (_colmap_scene, "write_colmap_model", "read_colmap_model",
               "sparse", {}),
    "nvm": (lambda m, r: _make_scene(m, r), "write_nvm", "read_nvm",
            "model.nvm", {"image_size": (640, 480)}),
    "openmvg": (lambda m, r: _make_scene(m, r, center_pp=False),
                "write_openmvg_json", "read_openmvg_json", "sfm_data.json",
                {}),
    "photoscan": (lambda m, r: _make_scene(m, r, center_pp=False),
                  "write_photoscan_xml", "read_photoscan_xml",
                  "cameras.xml", {}),
}
MODULES = {"colmap": (jcolmap, tcolmap), "nvm": (jnvm, tnvm),
           "openmvg": (jopenmvg, topenmvg),
           "photoscan": (jphotoscan, tphotoscan)}


def _files(path):
    """The bytes of a written file, or of each file of a written
    directory."""
    import os
    if os.path.isdir(path):
        return {n: open(os.path.join(path, n), "rb").read()
                for n in sorted(os.listdir(path))}
    return open(path, "rb").read()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_port_round_trip(tmp_path, fmt):
    """The port writes and reads back its own files (the templates'
    checks)."""
    build, write, read, name, kw = FORMATS[fmt]
    mod = MODULES[fmt][1]
    scene = build(tmvs, np.random.default_rng(7))
    p = str(tmp_path / name)
    getattr(mod, write)(p, scene)
    back = getattr(mod, read)(p, **kw)
    _check_poses(scene, back, atol=1e-8 if fmt == "colmap" else 1e-5)
    atol = {"colmap": 1e-6, "nvm": 1e-4, "openmvg": 1e-5}
    if fmt in atol:
        np.testing.assert_allclose(back.points, scene.points,
                                   atol=atol[fmt])
        np.testing.assert_array_equal(back.point_view_counts,
                                      scene.point_view_counts)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_packages_read_and_write_each_others_files(tmp_path, fmt):
    """From the same scene both packages write byte-equal files; each
    reads the other's into an equal scene."""
    build, write, read, name, kw = FORMATS[fmt]
    jmod, tmod = MODULES[fmt]
    js = build(jmvs, np.random.default_rng(11))
    ts = build(tmvs, np.random.default_rng(11))
    _assert_equal_scenes(js, ts)
    pj, pt = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
    getattr(jmod, write)(pj, js)
    getattr(tmod, write)(pt, ts)
    assert _files(pj) == _files(pt)
    _assert_equal_scenes(getattr(jmod, read)(pt, **kw),
                         getattr(tmod, read)(pj, **kw))


def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = jnvm.quat_to_rot(q)
        np.testing.assert_array_equal(tnvm.quat_to_rot(q), R)
        np.testing.assert_array_equal(tnvm.rot_to_quat(R),
                                      jnvm.rot_to_quat(R))
        np.testing.assert_array_equal(tcolmap._qvec2rot(q),
                                      jcolmap._qvec2rot(q))
        np.testing.assert_array_equal(tcolmap._rot2qvec(R),
                                      jcolmap._rot2qvec(R))
        np.testing.assert_allclose(tnvm.quat_to_rot(tnvm.rot_to_quat(R)), R,
                                   atol=1e-12)


def test_io_exports_the_same_names():
    import hcmvs_tpu.io as jio
    names = {n for n in dir(jio) if not n.startswith("_")
             and not isinstance(getattr(jio, n), type(jio))}
    assert names <= set(dir(tio))


def test_viewer_html_matches_jax(tmp_path):
    """The HTML for the same cloud (with colours, and subsampled past
    max_points) and the same mesh; the CLI on a PLY."""
    from hcmvs_tpu_torch.io.ply import write_ply_mesh, write_ply_points
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (500, 3)).astype(np.uint8)
    faces = rng.integers(0, 500, (200, 3))
    for kw in (dict(colors=cols), dict(colors=cols / 255.0, max_points=97),
               dict(faces=faces), dict()):
        jviewer.export_viewer_html(str(tmp_path / "j.html"), pts, **kw)
        tviewer.export_viewer_html(str(tmp_path / "t.html"), pts, **kw)
        assert ((tmp_path / "j.html").read_bytes()
                == (tmp_path / "t.html").read_bytes().replace(b"t.html",
                                                              b"j.html"))
    write_ply_points(str(tmp_path / "cloud.ply"), pts)
    write_ply_mesh(str(tmp_path / "mesh.ply"), pts, faces)
    for name in ("cloud", "mesh"):
        tviewer.main([str(tmp_path / f"{name}.ply")])
        jviewer.main([str(tmp_path / f"{name}.ply"), "-o",
                      str(tmp_path / f"{name}_jax.html")])
        assert ((tmp_path / f"{name}.html").read_bytes()
                == (tmp_path / f"{name}_jax.html").read_bytes())
