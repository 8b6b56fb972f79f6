"""PyTorch port vs the JAX package: the photo-directory driver
(``pipeline/mvgmvs.py``) and its EXIF bootstrap, on the CPU.

Run as a script, ``PYTHONPATH=. python tests/test_torch_mvgmvs.py H W
[jax|port]`` runs one or both packages' ``run_pipeline_photos`` on the
chip_smoke.py phase-16 scene at H x W (8 ridge views, focal 1200 W / 1280
from EXIF, photos through k1 = -0.15, distortion estimated,
``resolution-level=0``; JAX with the table / rect backends) and prints K,
the registered views, k, the rms, the ATE and view 0's depth_acc_2pct
(an extra argument ``incremental`` or ``global``, or ``sfm`` for both,
runs SfM by that preset and the distortion refinement alone, and prints
the rms before the refinement and the sparse points)
(6 px margin), its depth scaled by the similarity (Umeyama) scale of the
camera centres to the ground truth, and by the median ratio to the
ground truth over its valid pixels (``eval/golden.py --hierarchy``'s
alignment).

The driver runs on tests/test_distortion.py's ``test_run_pipeline_photos_
exif`` scene and small DenseConfig: a folder of 4 ridge photos at 144x192,
JPEGs as that test writes them (Pillow, gray, quality 97,
FocalLengthIn35mmFilm = 33.75 in APP1), which the port decodes itself
and the JAX package through cv2.  JAX runs on the CPU with the table /
rect backends forced, as the other dense parity tests force them.  The port's SfM replays the
JAX run's draws (tests/test_torch_incremental.py); its dense stage gets
the JAX run's SfM result, so both densify the same poses.

Tolerances.  EXIF: the port's parser gives Pillow's tags and the JAX
package's focal lengths exactly, from JPEG (APP1) and PNG (``eXIf``)
files.  Driver: K equal (f = 180 from EXIF); 4 of 4 views registered; the
port's SfM ATE within 0.005 of the JAX run's; on the same poses the fused
points within 5% and the valid share within 0.02 of the JAX run's (the
random streams differ).  The SGM mode (``fusion_mode`` -1) from the same
SfM result: depth within 1% on >= 98% of pixels, points within 5%.  The
two packages load the JPEG folder to equal arrays; the default device is
cuda (raising here, where there is none).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hcmvs_tpu.core.config import DenseConfig as JaxDenseConfig
from hcmvs_tpu.eval.pose_eval import ate
from hcmvs_tpu.io import exif as jexif
from hcmvs_tpu.io.images import list_images as jax_list_images
from hcmvs_tpu.pipeline import mvgmvs as jmvg
from hcmvs_tpu.sfm import incremental as jinc
from hcmvs_tpu.utils.synth import make_ridge_scene

from hcmvs_tpu_torch.convert import sfm_result_from_numpy
from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.io import exif as texif
from hcmvs_tpu_torch.io.images import list_images, write_png
from hcmvs_tpu_torch.io.mvs import read_mvs
from hcmvs_tpu_torch.io.ply import read_ply
from hcmvs_tpu_torch.pipeline import mvgmvs as tmvg
from hcmvs_tpu_torch.sfm import incremental as tinc
from hcmvs_tpu_torch.utils.synth import write_photos

from test_torch_incremental import Replay, jax_draws

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

SMALL = dict(estimation_iters=2, estimation_iters_external=2, photo2geo=1,
             random_iters=3, use_optical_flow=0, optimize=0,
             resolution_level=0, min_resolution=0, use_semantic=False)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")


def _exif_cases():
    """tests/test_distortion.py's three EXIF cases as Pillow objects."""
    f35 = Image.Exif()
    f35.get_ifd(0x8769)[41989] = 50
    db = Image.Exif()
    db[271] = "Canon"
    db[272] = "Canon EOS 5D Mark IV"
    db.get_ifd(0x8769)[37386] = 35.0
    return {"f35": f35, "db": db, "none": None}


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_exif_parser_matches_pillow(tmp_path, ext):
    arr = (np.random.default_rng(4).random((48, 64)) * 255).astype(np.uint8)
    paths = []
    for name, exif in _exif_cases().items():
        p = str(tmp_path / f"{name}.{ext}")
        if exif is None:
            Image.fromarray(arr).save(p)
        else:
            Image.fromarray(arr).save(p, exif=exif.tobytes())
        paths.append(p)
        ours = texif.read_exif_tags(p)
        for key in ("Make", "Model", "FocalLength", "FocalLengthIn35mmFilm"):
            assert ours.get(key) == jexif.read_exif_tags(p).get(key), key
        assert (texif.focal_from_exif(p, 640, 480)
                == jexif.focal_from_exif(p, 640, 480))
    assert texif.focal_from_exif(paths[0], 640, 480)[1] == "exif35"
    assert texif.focal_from_exif(paths[1], 640, 480)[1] == "exif_db"
    assert texif.focal_from_exif(paths[2], 640, 480)[1] == "default"
    Kt, st = texif.scene_intrinsics_from_photos(paths, [640] * 3, [480] * 3)
    Kj, sj = jexif.scene_intrinsics_from_photos(paths, [640] * 3, [480] * 3)
    assert st == sj == "exif"
    np.testing.assert_array_equal(Kt, Kj)


def test_exif_bytes_read_by_pillow(tmp_path):
    arr = np.zeros((144, 192), np.uint8)
    for tags, want in ((dict(FocalLengthIn35mmFilm=33.75), 180.0),
                       (dict(Make="Canon", Model="Canon EOS 5D Mark IV",
                             FocalLength=35.0), 35.0 / 36.0 * 192)):
        p = str(tmp_path / "x.png")
        write_png(p, arr, exif=texif.exif_bytes(**tags))
        jf = jexif.focal_from_exif(p, 192, 144)
        assert jf == texif.focal_from_exif(p, 192, 144)
        assert jf[0] == pytest.approx(want, abs=1e-9)
    back = Image.open(p)
    assert dict(back.getexif())[272] == "Canon EOS 5D Mark IV"
    assert texif.read_exif_tags(str(tmp_path / "missing.png")) == {}


def _write_photos(root, exif=True, jpeg=False):
    sc = make_ridge_scene(np.random.default_rng(6), h=144, w=192, n_views=4,
                          fx=180.0, z0=4.0, spacing=0.25)
    d = os.path.join(root, "photos")
    if jpeg:                    # as tests/test_distortion.py writes them
        os.makedirs(d)
        exif = Image.Exif()
        exif.get_ifd(0x8769)[41989] = 33.75
        for i, im in enumerate(sc.images):
            Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(d, f"p{i:02d}.jpg"), quality=97, exif=exif)
    else:
        write_photos(d, sc.images, 33.75 if exif else None)
    return sc, d


def test_list_images_matches(tmp_path):
    _, d = _write_photos(str(tmp_path))
    for name in ("notes.txt", "a.JPG", "b.tiff"):
        open(os.path.join(d, name), "wb").close()
    assert list_images(d) == jax_list_images(d)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("photos"))
    sc, d = _write_photos(root, jpeg=True)
    captured = {}
    orig = jinc.incremental_sfm

    def jax_sfm(*args, **kw):
        captured["jax"] = orig(*args, **kw)
        return captured["jax"]

    with jax_draws() as records, pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinc, "incremental_sfm", jax_sfm)
        oj = jmvg.run_pipeline_photos(
            d, os.path.join(root, "jax"),
            dense_cfg=JaxDenseConfig(**SMALL, **FORCED), with_mesh=False,
            with_texture=False, estimate_distortion=False, verbose=False)
    port_sfm = tinc.incremental_sfm

    def sfm(*args, **kw):
        kw["sampler"] = Replay(records, fallback=tinc.default_sampler("cpu"))
        captured["port"] = port_sfm(*args, **kw)
        return sfm_result_from_numpy(captured["jax"])

    out = os.path.join(root, "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmvg, "incremental_sfm", sfm)
        ot = tmvg.run_pipeline_photos(
            d, out, dense_cfg=DenseConfig(**SMALL), with_mesh=False,
            with_texture=False, estimate_distortion=False, verbose=False,
            device="cpu")
    return sc, oj, ot, captured, out


def test_driver_matches_jax(driver_runs):
    sc, oj, ot, captured, out = driver_runs
    np.testing.assert_array_equal(ot["K"], oj["K"])
    assert ot["K"][0, 0] == 180.0
    rj, rt = captured["jax"], captured["port"]
    assert sorted(rt.poses) == sorted(rj.poses) == [0, 1, 2, 3]
    gt = np.stack([np.asarray(c.C) for c in sc.cameras])

    def err(r):
        return ate(np.stack([r.poses[i][1] for i in sorted(r.poses)]),
                   gt)["rmse"]

    assert abs(err(rt) - err(rj)) < 0.005, (err(rt), err(rj))
    n_t, n_j = len(ot["cloud"]["points"]), len(oj["cloud"]["points"])
    assert n_j > 100 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    assert abs((ot["depth"] > 0).mean() - (oj["depth"] > 0).mean()) < 0.02
    scene = read_mvs(os.path.join(out, "scene.mvs"))
    assert len(scene.images) == 4 and len(scene.points) > 50
    pts, _ = read_ply(os.path.join(out, "scene_dense.ply"))
    assert len(pts) == n_t


def test_sgm_jpeg_and_device_are_refused(driver_runs, tmp_path):
    """The SGM mode runs: from the JAX run's SfM result, both packages'
    dense step with fusion_mode -1 gives depth within 1% on >= 98% of
    each view's pixels and fused clouds within 5%; both packages load the
    JPEG folder to equal arrays, and the default device is cuda."""
    from hcmvs_tpu.io.images import load_image as jax_load_image
    from hcmvs_tpu_torch.io.images import load_image
    _, oj, _, captured, out = driver_runs
    d = os.path.join(os.path.dirname(out), "photos")
    paths = list_images(d)
    names = [os.path.basename(p) for p in paths]
    grays = [load_image(p, gray=True) for p in paths]
    h, w = grays[0].shape
    K, res = oj["K"], captured["jax"]
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
    sj = jmvg._dense_mesh_texture(
        res, jinc.sfm_to_scene(res, K, names, w, h), grays, K,
        str(tmp_path / "jax"), JaxDenseConfig(**SMALL, **FORCED), False,
        False, -1, False)
    res_t = sfm_result_from_numpy(res)
    st = tmvg._dense_mesh_texture(
        res_t, tinc.sfm_to_scene(res_t, K, names, w, h), grays, K,
        str(tmp_path / "port"), DenseConfig(**SMALL), False, False, False,
        torch.device("cpu"), -1)
    dj, dt = np.asarray(sj["depth"]), st["depth"]
    for i in range(len(paths)):
        vj, vt = dj[i] > 0, dt[i] > 0
        close = vj & vt & (np.abs(dt[i] - dj[i]) <= 0.01 * dj[i])
        assert (close | (~vj & ~vt)).mean() >= 0.98, i
    n_t, n_j = len(st["cloud"]["points"]), len(sj["cloud"]["points"])
    assert n_j > 100 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    assert all(p.endswith(".jpg") for p in paths)
    for p, g in zip(paths, grays):
        assert np.array_equal(g, jax_load_image(p, gray=True))
        assert np.array_equal(load_image(p), jax_load_image(p))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmvg.run_pipeline_photos(d, str(tmp_path / "o"))


def test_main_passes_the_jax_flags(tmp_path, monkeypatch):
    _, d = _write_photos(str(tmp_path), exif=False)
    seen = {}

    def fake(images_dir, out_dir, **kw):
        seen.update(kw, images_dir=images_dir, out_dir=out_dir)
        return {"sfm": tinc.SfMResult({}, np.zeros((0, 3)), [], []),
                "cloud": {"points": np.zeros((0, 3))},
                "distortion": np.zeros(3)}

    monkeypatch.setattr(tmvg, "run_pipeline_photos", fake)
    tmvg.main([d, "out", "--preset", "GLOBAL", "--focal-px", "200",
               "--no-distortion", "--no-mesh", "--flags",
               "resolution-level=1", "--device", "cpu"])
    assert seen["preset"] == "GLOBAL" and seen["device"] == "cpu"
    assert seen["K"][0, 0] == 200.0 and seen["K"][0, 2] == 96.0
    assert not seen["estimate_distortion"] and not seen["with_mesh"]
    assert seen["dense_cfg"].resolution_level == 1
    tmvg.main([d, "out"])
    assert seen["device"] == "cuda" and seen["K"] is None
    assert seen["preset"] == "SEQUENTIAL" and seen["fusion_mode"] == 0


def _photo_chain(h: int, w: int, which: str, root: str,
                 presets=()) -> dict:
    """chip_smoke.py phase 16's chain at H x W through one package (with
    ``presets``: SfM by those presets and the distortion refinement
    alone)."""
    from hcmvs_tpu_torch.utils.synth import blob_texture_fn, distort_images
    fx = 1200.0 * w / 1280
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=8,
                          fx=fx, spacing=0.25, texture_fn=blob_texture_fn(
                              np.random.default_rng(0), device="cpu"))
    K = np.asarray(sc.cameras[0].K)
    photos = os.path.join(root, "photos")
    write_photos(photos, distort_images(sc.images, K,
                                        np.array([-0.15, 0.0, 0.0])),
                 fx * 36.0 / w)
    return run_chain(sc, photos, which, root, presets)


def run_chain(sc, photos: str, which: str, root: str, presets=()) -> dict:
    """The chain of ``_photo_chain`` on the photo directory ``photos`` of
    the ridge scene ``sc`` through one package."""
    from hcmvs_tpu_torch.core.config import config_from_cli_flags
    from hcmvs_tpu_torch.eval.pose_eval import umeyama_align
    h, w = sc.depth_gt.shape
    if presets:
        return _photo_sfm(sc, photos, which, presets)
    flags = {"resolution-level": "0"}
    if which == "jax":
        from hcmvs_tpu.core.config import config_from_cli_flags as jflags
        out = jmvg.run_pipeline_photos(
            photos, os.path.join(root, which),
            dense_cfg=jflags(flags).replace(**FORCED), with_mesh=False,
            with_texture=False, verbose=False)
    else:
        out = tmvg.run_pipeline_photos(
            photos, os.path.join(root, which),
            dense_cfg=config_from_cli_flags(flags), with_mesh=False,
            with_texture=False, verbose=False, device="cpu")
    res = out["sfm"]
    reg = sorted(res.poses)
    gt = np.stack([np.asarray(sc.cameras[i].C) for i in reg])
    est = np.stack([res.poses[i][1] for i in reg])
    d0, gt_d = out["depth"][0], sc.depth_gt
    valid = d0 > 0
    acc = {}
    for name, scale in (("depth_acc_2pct", umeyama_align(est, gt)[0]),
                        ("depth_acc_2pct_median_scale",
                         float(np.median(gt_d[valid] / d0[valid])))):
        rel = np.abs(d0 * scale - gt_d) / gt_d
        acc[name] = float((rel < 0.02)[6:-6, 6:-6].mean())
    return {"package": which, "h": h, "w": w, "f": float(out["K"][0, 0]),
            "registered": len(reg), "k": [float(x) for x in
                                          out["distortion"]],
            "rms_px": res.reproj_rms, "ate": ate(est, gt)["rmse"],
            "points": len(out["cloud"]["points"]),
            "valid": float(valid.mean()), **acc}


def _photo_sfm(sc, photos: str, which: str, presets) -> dict:
    """SfM by each of ``presets`` ("incremental", "global"; default
    config), each followed by the distortion refinement, on the photos
    through one package, as ``run_pipeline_photos`` runs them."""
    if which == "jax":
        from hcmvs_tpu.io.images import load_image, to_gray
        from hcmvs_tpu.sfm.distortion import refine_with_distortion
        kw = {}
    else:
        from hcmvs_tpu_torch.io.images import load_image, to_gray
        from hcmvs_tpu_torch.sfm.distortion import refine_with_distortion
        kw = {"device": "cpu"}
    paths = list_images(photos)
    grays = [to_gray(load_image(p)).astype(np.float32) for p in paths]
    h, w = grays[0].shape
    K, _ = texif.scene_intrinsics_from_photos(paths, [w] * len(paths),
                                              [h] * len(paths))
    if which == "jax":
        from hcmvs_tpu.sfm.global_sfm import global_sfm
        inc = jinc
    else:
        from hcmvs_tpu_torch.sfm.global_sfm import global_sfm
        inc = tinc
    out = {"package": which, "h": h, "w": w, "f": float(K[0, 0])}
    for name, run in (("incremental", inc.incremental_sfm),
                      ("global", global_sfm)):
        if name not in presets:
            continue
        res = run(grays, K, **kw)
        rms0 = res.reproj_rms
        res, k = refine_with_distortion(res, K, **kw)
        reg = sorted(res.poses)
        gt = np.stack([np.asarray(sc.cameras[i].C) for i in reg])
        est = np.stack([res.poses[i][1] for i in reg])
        out[name] = {"registered": len(reg),
                     "sparse_points": len(res.points),
                     "k": [float(x) for x in k], "rms_unrefined_px": rms0,
                     "rms_px": res.reproj_rms, "ate": ate(est, gt)["rmse"]}
    return out


if __name__ == "__main__":
    import sys
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    h, w = int(sys.argv[1]), int(sys.argv[2])
    args = sys.argv[3:]
    presets = [a for a in args if a in ("incremental", "global")]
    if "sfm" in args:
        presets = ["incremental", "global"]
    for which in [a for a in args if a in ("jax", "port")] or ["jax",
                                                               "port"]:
        with tempfile.TemporaryDirectory() as root:
            print(_photo_chain(h, w, which, root, presets), flush=True)
