"""PyTorch port vs the JAX package: real-photo input, the committed JPEG
photo set of ``tests/data/jpeg/`` (chip_smoke.py phase 27's photos).

The port decodes JPEG itself (``native/jpeg.cpp``), the JAX package
through ``cv2.imread``; on the committed photos both packages' loaders
give equal arrays (color and gray), both read K = 1200 px from the
photos' EXIF, and the photo driver's own loading step gives the same
gray images.  The pipeline from a JPEG folder is held against the JAX
package at 144x192 by tests/test_torch_mvgmvs.py (its driver runs on
JPEG photos), the densify app from JPEG images by
tests/test_torch_densify.py.

Run as a script, ``PYTHONPATH=. python tests/test_torch_photos_jpeg.py
resize`` prints ``resize_image``'s seconds to halve a 6000x4000 gray and
RGB image (3 calls each); ``... H W [jax|port] [sfm|incremental|global]``
runs tests/test_torch_mvgmvs.py's chain (``run_pipeline_photos`` at
DenseConfig() plus resolution-level=0, or with ``sfm`` / a preset SfM
and the distortion refinement alone) on JPEG photos: at 960 1280 the committed ones, at any other size phase 27's
scene rendered at H x W and saved as the committed ones were
(``make_fixtures.save_jpeg_photos``).  chip_smoke.py's phase-27 gates
rest on its JAX readings.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(HERE, "data", "jpeg")
PHOTOS = os.path.join(JPEG_DIR, "photos")


def fixtures_module():
    """``tests/data/jpeg/make_fixtures.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(JPEG_DIR, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_photos_load_like_jax():
    pytest.importorskip("cv2")
    from hcmvs_tpu.io import exif as jexif
    from hcmvs_tpu.io import images as jimg
    from hcmvs_tpu_torch.io import exif as texif
    from hcmvs_tpu_torch.io import images as timg
    paths = timg.list_images(PHOTOS)
    assert paths == jimg.list_images(PHOTOS) and len(paths) == 8
    for p in paths:
        for gray in (False, True):
            ours, ref = timg.load_image(p, gray), jimg.load_image(p, gray)
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref), p
    dims = ([1280] * 8, [960] * 8)
    Kt, st = texif.scene_intrinsics_from_photos(paths, *dims)
    Kj, sj = jexif.scene_intrinsics_from_photos(paths, *dims)
    assert st == sj == "exif"
    np.testing.assert_array_equal(Kt, Kj)
    assert Kt[0, 0] == 1200.0


def test_driver_loads_the_photos_as_jax(monkeypatch, tmp_path):
    """``mvgmvs.run_pipeline_photos``' loading step on the committed JPEG
    folder: the JAX package's gray photos and K, before any geometry."""
    pytest.importorskip("cv2")
    from hcmvs_tpu.io.images import load_image, to_gray
    from hcmvs_tpu_torch.pipeline import mvgmvs as tmvg

    class Stop(Exception):
        pass

    seen = {}

    def sfm(grays, K, *args):
        seen.update(grays=grays, K=K)
        raise Stop

    monkeypatch.setattr(tmvg, "_run_sfm", sfm)
    with pytest.raises(Stop):
        tmvg.run_pipeline_photos(PHOTOS, str(tmp_path), verbose=False,
                                 device="cpu")
    assert seen["K"][0, 0] == 1200.0
    for g, p in zip(seen["grays"], sorted(os.listdir(PHOTOS))):
        ref = to_gray(load_image(os.path.join(PHOTOS, p))).astype(np.float32)
        assert np.array_equal(g, ref), p


def photo_set(h: int, w: int, root: str):
    """(scene, photo directory) of phase 27 at h x w: the committed photos
    at 960 x 1280 (the scene's geometry only), else rendered and saved as
    they were."""
    fx = fixtures_module()
    if (h, w) == tuple(fx.PHOTO_HW):
        from hcmvs_tpu_torch.utils.synth import make_ridge_scene
        sc = make_ridge_scene(
            np.random.default_rng(0), h=h, w=w, n_views=fx.PHOTO_VIEWS,
            fx=1200.0 * w / 1280, spacing=0.25,
            texture_fn=lambda xy: np.zeros(xy.shape[:-1], np.float32))
        return sc, PHOTOS
    sc, photos = fx.ridge_photos(h, w)
    photo_dir = os.path.join(root, "photos")
    fx.save_jpeg_photos(photo_dir, photos, 1200.0 * 36.0 / 1280)
    return sc, photo_dir


def resize_times(rounds: int = 3) -> dict:
    """Seconds of each of ``rounds`` calls of ``resize_image(img, 0.5)`` on
    a 6000x4000 float32 gray and RGB image (chip_smoke.py phase 27 takes
    the same on the card's host)."""
    import time
    from hcmvs_tpu_torch.io.images import resize_image
    rng = np.random.default_rng(0)
    out = {}
    for shape in ((4000, 6000), (4000, 6000, 3)):
        img = rng.random(shape, dtype=np.float32)
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            resize_image(img, 0.5)
            times.append(time.perf_counter() - t0)
        out["x".join(map(str, shape))] = times
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["resize"]:
        print(resize_times(), flush=True)
        sys.exit(0)
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)
    from test_torch_mvgmvs import run_chain
    h, w = int(sys.argv[1]), int(sys.argv[2])
    args = sys.argv[3:]
    presets = [a for a in args if a in ("incremental", "global")]
    if "sfm" in args:
        presets = ["incremental", "global"]
    for which in [a for a in args if a in ("jax", "port")] or ["jax",
                                                               "port"]:
        with tempfile.TemporaryDirectory() as root:
            sc, photos = photo_set(h, w, root)
            print(run_chain(sc, photos, which, root, presets), flush=True)
