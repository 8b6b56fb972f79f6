"""PyTorch port vs OpenCV: AVIF through ``hcmvs_tpu_torch/native/avif.cpp``
(the HEIF container and an AV1 decoder of key and intra-only frames) and
``io.images._avif`` (OpenCV 5.0's rules for libavif's output), held
byte-equal to ``cv2.imread`` (libavif 1.4 on libaom 3.14) in its three
modes.

- The committed kinds of ``tests/data/jpeg/formats/*.avif``
  (``make_fixtures.write_avif_kinds``): Pillow's qualities, speeds,
  chroma samplings, gray, alpha, Exif, orientation, aom tool switches
  (palette and intra block copy on screen content, filter intra, CfL,
  CDEF, loop restoration, tiles, delta q, 128x128 superblocks, quantiser
  matrices, film grain, lossless) and animations; cv2's encoder at 8, 10
  and 12 bits in colour, gray and BGRA; grids, an alpha item, irot /
  imir / clap and every nclx matrix in both ranges written around those
  payloads; each against cv2 here, and the kinds cv2 fails on raising
  NotImplementedError;
- a seeded random sweep of freshly encoded files (sizes, qualities,
  speeds, samplings, bit depths, alpha, gray, screen content, tool
  switches), 2,160 reads in all, against cv2;
- premultiplied alpha (cv2 reads it, the port refuses it by name) and a
  malformed file;
- the four committed 1280x960 views (chip_smoke.py phase 27's densify
  run) and a scene's images as AVIF loaded by the port's densify loading
  step as the JAX package's densify loads them;
- a failed g++ build raises.

As a script, ``PYTHONPATH=. python tests/test_torch_avif.py H W
[jax|port]`` densifies the AVIF views (the committed ones at 960 1280,
else the same scene encoded alike at H x W) with DenseConfig() and
resolution-level 0, the JAX package with the volume / rect backends
forced, and prints view 0's depth_acc_2pct: chip_smoke.py phase 27's
densify-avif reading.
"""

import io
import json
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hcmvs_tpu_torch import native  # noqa: E402
from hcmvs_tpu_torch.io import images as timg  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(HERE, "data", "jpeg")
MODES = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


def _fixtures():
    sys.path.insert(0, JPEG_DIR)
    try:
        import make_fixtures
    finally:
        sys.path.remove(JPEG_DIR)
    return make_fixtures


def _avif_names():
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        return sorted(n for n in json.load(f)["files"]
                      if n.startswith("formats/") and n.endswith(".avif"))


def assert_like_cv2(path: str) -> int:
    """The port's imread equals cv2.imread in the three modes, or raises
    NotImplementedError where cv2 returns nothing; returns the reads."""
    for mode, flag in MODES.items():
        ref = cv2.imread(path, flag)
        if ref is None:
            with pytest.raises(NotImplementedError):
                timg.imread(path, mode)
            continue
        ours = timg.imread(path, mode)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, (
            path, mode)
        assert np.array_equal(ours, ref), (path, mode)
    return len(MODES)


# ---- the committed kinds ----

@pytest.mark.parametrize("name", _avif_names())
def test_committed_kinds_match_opencv(name):
    assert_like_cv2(os.path.join(JPEG_DIR, name))


# ---- freshly encoded, seeded ----

def _natural(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: smooth blobs, noise and edges."""
    base = cv2.resize(rng.integers(0, 256, (max(2, h // 16), max(2, w // 16),
                                            3)).astype(np.uint8), (w, h),
                      interpolation=cv2.INTER_CUBIC).astype(np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    edges = ((xx // 23 + yy // 17) % 2) * 40.0
    img = base + rng.normal(0, 12, (h, w, 3)) + edges[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


_TOOLS = ({}, {"enable-cdef": "0"}, {"enable-restoration": "1"},
          {"enable-filter-intra": "0"}, {"enable-cfl-intra": "0"},
          {"tile-columns": "1", "tile-rows": "1"}, {"deltaq-mode": "1"},
          {"sb-size": "128"}, {"enable-qm": "1"}, {"reduced-tx-type-set": "1"},
          {"enable-tx64": "0"}, {"sharpness": "5"}, {"aq-mode": "1"},
          {"film-grain-test": "7"}, {"denoise-noise-level": "30"})


def _random_file(rng, path: str) -> None:
    """One AVIF of a random kind written to path."""
    h, w = int(rng.integers(4, 140)), int(rng.integers(4, 140))
    kind = int(rng.integers(0, 6))
    img = _natural(rng, h, w)
    q = int(rng.integers(0, 101))
    if kind <= 1:               # Pillow, colour (kind 1: with alpha)
        if kind == 1:
            img = np.dstack([img, rng.integers(0, 256, (h, w)).astype(
                np.uint8)])
        Image.fromarray(img).save(
            path, "AVIF", quality=q, speed=int(rng.integers(0, 11)),
            subsampling=("4:2:0", "4:2:2", "4:4:4", "4:0:0")[
                rng.integers(0, 4)],
            advanced=_TOOLS[rng.integers(0, len(_TOOLS))])
    elif kind == 2:             # screen content: palette, intra block copy
        scr = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        cols = rng.integers(0, 256, (int(rng.integers(2, 8)), 3))
        for _ in range(int(rng.integers(3, 30))):
            y, x = rng.integers(0, h), rng.integers(0, w)
            scr[y:y + rng.integers(2, 30), x:x + rng.integers(2, 40)] = \
                cols[rng.integers(0, len(cols))]
        Image.fromarray(scr).save(
            path, "AVIF", quality=q, subsampling=("4:2:0", "4:2:2", "4:4:4")[
                rng.integers(0, 3)], advanced={"tune-content": "screen"})
    else:                       # cv2: colour, gray, BGRA at 8-12 bits
        depth = int(rng.choice([8, 10, 12]))
        src = {3: img[..., ::-1], 4: img[..., 1],
               5: np.dstack([img[..., ::-1], img[..., :1]])}[kind]
        if depth > 8:
            src = src.astype(np.uint16) << (depth - 8)
        ok, buf = cv2.imencode(".avif", src, [cv2.IMWRITE_AVIF_DEPTH, depth,
                                              cv2.IMWRITE_AVIF_QUALITY, q])
        assert ok
        with open(path, "wb") as f:
            f.write(buf.tobytes())


@pytest.mark.parametrize("seed", range(12))
def test_random_kinds_match_opencv(tmp_path, seed):
    """60 random files a seed, each read in three modes (2,160 reads over
    the 12 seeds)."""
    rng = np.random.default_rng(1000 + seed)
    reads = 0
    for k in range(60):
        path = str(tmp_path / f"r{k}.avif")
        _random_file(rng, path)
        reads += assert_like_cv2(path)
    assert reads == 180


# ---- refused, malformed ----

def test_premultiplied_alpha_is_refused(tmp_path):
    """cv2 reads an alpha item the colour item is premultiplied by
    ('prem'); the port refuses it by name."""
    fx = _fixtures()
    rgb = fx.pattern(48, 64)
    alpha = fx.pil_av1(np.repeat(rgb[..., :1], 3, -1), quality=90,
                       subsampling="4:0:0")
    path = str(tmp_path / "prem.avif")
    with open(path, "wb") as f:
        f.write(fx.avif_alpha(fx.pil_av1(rgb, quality=70), alpha,
                              premultiplied=True))
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED).shape == (48, 64, 4)
    with pytest.raises(NotImplementedError, match="premultiplied"):
        timg.imread(path, "unchanged")


@pytest.mark.parametrize("cut", [40, 200, -30])
def test_cut_and_malformed_files_raise(tmp_path, cut):
    """A file cut short (cv2 fails on it) raises NotImplementedError
    naming AVIF."""
    data = open(os.path.join(JPEG_DIR, "formats", "avif_q50_s2.avif"),
                "rb").read()
    path = str(tmp_path / "cut.avif")
    with open(path, "wb") as f:
        f.write(data[:cut])
    assert cv2.imread(path) is None
    with pytest.raises(NotImplementedError, match="AVIF"):
        timg.imread(path)


def test_avif_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build of the AVIF decoder raises with g++'s output;
    nothing falls back to another decoder."""
    path = os.path.join(JPEG_DIR, "formats", "avif_420.avif")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native.EXTRA_FLAGS, "avif", ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        timg.imread(path)


# ---- scenes ----

def test_views_load_like_jax(tmp_path):
    """The four committed 1280x960 AVIF views (chip_smoke.py phase 27's
    densify-avif run) in a scene.mvs: both packages' load_image give equal
    arrays, and the port's densify loading step gives the images the JAX
    package's densify computes from them at resolution-level 0."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.io import images as jimg
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.pipeline.densify import _load_images
    fx = _fixtures()
    view_dir = os.path.join(JPEG_DIR, "avif_views")
    scene_path, _ = fx.jp2_view_scene(str(tmp_path), ext="avif")
    for i in range(fx.JP2_VIEWS):
        path = os.path.join(view_dir, f"v{i}.avif")
        for gray in (False, True):
            assert np.array_equal(timg.load_image(path, gray),
                                  jimg.load_image(path, gray)), (i, gray)
    cfg, jcfg = DenseConfig(resolution_level=0), JConfig(resolution_level=0)
    grays, colors = _load_images(read_mvs(scene_path), view_dir, cfg)
    for i in range(fx.JP2_VIEWS):
        img = jimg.load_image(os.path.join(view_dir, f"v{i}.avif"))
        scale = jimg.compute_resolution_scale(
            img.shape[1], img.shape[0], jcfg.resolution_level,
            jcfg.max_resolution, jcfg.min_resolution)
        img = jimg.resize_image(img, scale)
        assert np.array_equal(colors[i], img), i
        assert np.array_equal(grays[i], jimg.to_gray(img).astype(
            np.float32)), i


@pytest.mark.parametrize("kind", ["pillow_420", "cv2_10bit_alpha"])
def test_scene_avif_loads_like_jax(tmp_path, kind):
    """A 96x128 plane scene's images rewritten as AVIF (Pillow's 4:2:0, or
    cv2's 10-bit with alpha) and renamed in its scene.mvs: both packages'
    load_image give equal arrays, and the port's densify loading step
    (``pipeline.densify._load_images``) gives the images the JAX package's
    densify computes from them (load, scale to the working resolution at
    the default resolution-level 1, gray by BT.601)."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.io import images as jimg
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.io.mvs import read_mvs, write_mvs
    from hcmvs_tpu_torch.pipeline.densify import _load_images
    from hcmvs_tpu_torch.utils.synth import (make_plane_scene,
                                             write_plane_scene)
    sc = make_plane_scene(np.random.default_rng(0), h=96, w=128, n_views=3)
    scene_path, img_dir = write_plane_scene(str(tmp_path / "s"), sc)
    scene = read_mvs(scene_path)
    for k, im in enumerate(scene.images):
        png = os.path.join(img_dir, os.path.basename(im.name))
        rgb = np.repeat(cv2.imread(png, cv2.IMREAD_GRAYSCALE)[..., None], 3,
                        -1)
        rgb[..., 0] = np.roll(rgb[..., 0], 3 + k, axis=1)   # some colour
        im.name = os.path.splitext(im.name)[0] + ".avif"
        out = os.path.join(img_dir, os.path.basename(im.name))
        if kind == "pillow_420":
            Image.fromarray(rgb).save(out, "AVIF", quality=85)
        else:
            bgra = np.dstack([rgb[..., ::-1], np.full(rgb.shape[:2], 200,
                                                      np.uint8)])
            cv2.imwrite(out, bgra.astype(np.uint16) << 2,
                        [cv2.IMWRITE_AVIF_DEPTH, 10])
        for gray in (False, True):
            assert np.array_equal(timg.load_image(out, gray),
                                  jimg.load_image(out, gray)), (out, gray)
    write_mvs(scene_path, scene)
    cfg, jcfg = DenseConfig(), JConfig()
    grays, colors = _load_images(read_mvs(scene_path), img_dir, cfg)
    for i, im in enumerate(scene.images):
        img = jimg.load_image(os.path.join(img_dir,
                                           os.path.basename(im.name)))
        scale = jimg.compute_resolution_scale(
            img.shape[1], img.shape[0], jcfg.resolution_level,
            jcfg.max_resolution, jcfg.min_resolution)
        img = jimg.resize_image(img, scale)
        assert np.array_equal(colors[i], img), i
        assert np.array_equal(grays[i], jimg.to_gray(img).astype(
            np.float32)), i


def densify_views_at(h: int, w: int, which=("jax", "port")) -> None:
    """View 0's depth_acc_2pct of both packages' densify (DenseConfig(),
    resolution-level 0; the JAX package with the volume / rect backends
    forced) on the AVIF views: the committed ones at 960 x 1280, else the
    scene rendered and encoded alike at h x w."""
    import tempfile
    import time
    fx = _fixtures()
    with tempfile.TemporaryDirectory() as root:
        view_dir = os.path.join(JPEG_DIR, "avif_views")
        if (h, w) != (960, 1280):
            view_dir = os.path.join(root, "views")
            fx.avif_views(view_dir, fx.ridge_scene(h, w, fx.JP2_VIEWS).images)
        scene_path, sc = fx.jp2_view_scene(os.path.join(root, "scene"), h, w,
                                           ext="avif")
        gt = sc.depth_gt
        for name in which:
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            if name == "jax":
                from hcmvs_tpu.core.config import DenseConfig as JConfig
                from hcmvs_tpu.pipeline import densify as jd
                st = jd.densify(scene_path, view_dir, out, JConfig(
                    resolution_level=0, exact_backend="volume",
                    geo_backend="rect", volume_build="rect"), verbose=False)
            else:
                from hcmvs_tpu_torch.core.config import DenseConfig
                from hcmvs_tpu_torch.pipeline.densify import densify
                st = densify(scene_path, view_dir, out,
                             DenseConfig(resolution_level=0), verbose=False,
                             device="cpu")
            d0 = np.asarray(st["depth"][0])
            rel = np.abs(d0 - gt) / gt
            acc = float((rel < 0.02)[6:-6, 6:-6].mean())
            print(f"{name} {h}x{w}: view 0 depth_acc_2pct {acc!r}, valid "
                  f"{st['valid_frac']:.4f}, points {st['n_points']}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    densify_views_at(int(sys.argv[1]), int(sys.argv[2]),
                     tuple(sys.argv[3:]) or ("jax", "port"))
