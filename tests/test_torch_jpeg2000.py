"""PyTorch port vs OpenCV: JPEG 2000 through ``hcmvs_tpu_torch/native/
jpeg2000.cpp`` and ``io.images._jpeg2000``, held byte-equal to
``cv2.imread`` (OpenCV 5.0, OpenJPEG 2.5.3) in its three modes.

- Random images (numpy, seeded) through every Pillow JPEG 2000 option and
  through libopenjp2's own encoder (``make_fixtures.openjpeg_encode``:
  code-block styles, progression orders, precincts, tiles and tile-parts,
  SOP / EPH, POC, ROI, layers, precisions 8-16 and 20, odd sizes), JP2 and
  raw codestreams;
- the committed kinds of ``tests/data/jpeg/formats`` (PPT / PPM, palette,
  cdef, sYCC / ICC colour boxes, reordered tile-parts, cut codestreams:
  ``make_fixtures.write_jpeg2000_kinds``), each against cv2 here;
- the kinds cv2 fails on (signed samples, 1-7 bits, an image offset,
  sub-sampling, five components, gray + alpha unchanged, eYCC, CMYK, cut
  streams), each matched to its cv2 failure: NotImplementedError naming
  it; HTJ2K code-blocks, which no encoder here writes, refused by name;
- the decoded components against libopenjp2's (Pillow's 2.5.4, through
  ctypes) where cv2 reads nothing (signed, offset, sub-sampled, low
  precision);
- the four committed 1280x960 views loaded by both packages' load_image
  and by the port's densify loading step as the JAX package's densify
  loads them;
- a failed g++ build raises.

As a script, ``PYTHONPATH=. python tests/test_torch_jpeg2000.py H W
[jax|port]`` densifies the JPEG 2000 views (the committed ones at 960
1280, else the same scene encoded alike at H x W) with DenseConfig() and
resolution-level 0, the JAX package with the volume / rect backends
forced, and prints view 0's depth_acc_2pct: chip_smoke.py phase 27's
reading.
"""

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


def _random_image(seed: int, h: int, w: int, c: int = 3,
                  top: int = 255) -> np.ndarray:
    """A smooth field plus noise, (h, w, c) int32 in [0, top]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = [np.sin(x / rng.uniform(2, 9) + y / rng.uniform(2, 9) + k)
           * 0.35 + 0.5 + rng.normal(0, 0.08, (h, w)) for k in range(c)]
    return (np.clip(np.stack(out, -1), 0, 1) * top).astype(np.int32)


def assert_like_cv2(path: str, refusal: str = None):
    """The port's imread equals cv2.imread's array in each mode; where cv2
    reads nothing, the port raises NotImplementedError (matching
    ``refusal`` if given).  Returns the modes cv2 read."""
    read = []
    for mode, flag in MODES.items():
        ref = cv2.imread(path, flag)
        if ref is None:
            with pytest.raises(NotImplementedError, match=refusal):
                timg.imread(path, mode)
            continue
        ours = timg.imread(path, mode)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, \
            (path, mode, ours.shape, ref.shape)
        assert np.array_equal(ours, ref), (path, mode, int(np.abs(
            ours.astype(np.int64) - ref).max()))
        read.append(mode)
    return read


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


# ---- Pillow's options ----

_LOSSY = dict(irreversible=True, quality_mode="rates", quality_layers=[10])
PIL_OPTIONS = {
    "lossless": {},
    "lossy97": _LOSSY,
    "no_jp2": dict(no_jp2=True, **_LOSSY),
    "tiles32_rpcl": dict(tile_size=(32, 32), progression="RPCL",
                         irreversible=True),
    "res3": dict(num_resolutions=3),
    "cblk16_prec16": dict(codeblock_size=(16, 16), precinct_size=(16, 16),
                          **_LOSSY),
    "mct0": dict(mct=0, **_LOSSY),
    "res1": dict(num_resolutions=1, **_LOSSY),
    "layers_dB": dict(quality_mode="dB", quality_layers=[30, 40, 50],
                      irreversible=True),
    "lrcp_pcrl_offset_tiles": dict(tile_size=(24, 40), tile_offset=(0, 0),
                                   progression="PCRL"),
    "cprl_layers": dict(progression="CPRL", quality_mode="rates",
                        quality_layers=[40, 20, 5]),
    "plt_comment": dict(plt=True, comment="hcmvs", **_LOSSY),
    "cinema2k": dict(cinema_mode="cinema2k-24"),
}


PIL_MODES = ("RGB", "RGBA", "L", "I;16")


@pytest.mark.parametrize("option,mode", [
    (o, m) for o in sorted(PIL_OPTIONS) for m in PIL_MODES
    if o != "cinema2k" or m == "RGB"])      # cinema profiles are RGB
def test_pillow_options_read_like_cv2(tmp_path, option, mode):
    """A random image through each Pillow option, in each Pillow mode:
    byte-equal to cv2 in the three imread modes."""
    seed = sorted(PIL_OPTIONS).index(option) * 4 + PIL_MODES.index(mode)
    h, w = 37 + seed % 11, 61 - seed % 13
    if mode == "I;16":
        arr = _random_image(seed, h, w, 1, 65535)[..., 0].astype(np.uint16)
    else:
        arr = _random_image(seed, h, w, {"RGB": 3, "RGBA": 4, "L": 1}[mode])
        arr = arr.astype(np.uint8)
        arr = arr[..., 0] if mode == "L" else arr
    ext = ".j2k" if PIL_OPTIONS[option].get("no_jp2") else ".jp2"
    path = str(tmp_path / f"x{ext}")
    Image.fromarray(arr).save(path, "JPEG2000", **PIL_OPTIONS[option])
    # a raw one-component codestream reads in gray only (cv2 fails to
    # convert an unspecified colour space of one component to BGR)
    one = PIL_OPTIONS[option].get("no_jp2") and mode in ("L", "I;16")
    assert assert_like_cv2(path) == (["gray", "unchanged"] if one
                                     else ["color", "gray", "unchanged"])


# ---- libopenjp2's encoder ----

OPJ_KINDS = {
    # code-block styles: bypass, reset, terminate each pass, vertically
    # causal, predictable termination, segmentation symbols
    **{f"style{m}": dict(mode=m) for m in (1, 2, 4, 8, 16, 32, 63, 9, 5)},
    **{f"style{m}_lossless": dict(mode=m, irreversible=0, rates=None)
       for m in (1, 8, 63)},
    # progression orders with precincts, tiles and layers
    **{f"order{k}": dict(prog_order=k, precincts=[(32, 32), (16, 16),
                                                  (8, 8)],
                         tiles=(40, 32), numresolution=4)
       for k in range(5)},
    "sop_eph": dict(csty=6),
    "poc": dict(pocs=[(0, 0, 1, 2, 3, 4), (0, 0, 3, 4, 3, 1)],
                numresolution=4, rates=[40, 15, 5]),
    "roi": dict(roi_compno=0, roi_shift=6),
    "roi_lossless": dict(roi_compno=2, roi_shift=4, irreversible=0,
                         rates=None),
    **{f"tileparts_{f}": dict(tiles=(32, 32), tp_flag=f.encode())
       for f in "RLC"},
    "cblk4x64": dict(cblockw_init=4, cblockh_init=64),
    "cblk64x16_res6": dict(cblockw_init=64, cblockh_init=16,
                           numresolution=6),
    "mct0": dict(tcp_mct=0),
    "layers5": dict(rates=[80, 40, 20, 10, 4]),
    "tlm_plt": dict(extra=("TLM=YES", "PLT=YES")),
}


@pytest.mark.parametrize("jp2", [True, False], ids=["jp2", "j2k"])
@pytest.mark.parametrize("kind", sorted(OPJ_KINDS))
def test_openjpeg_kinds_read_like_cv2(tmp_path, kind, jp2):
    """A random RGB image at an odd size through libopenjp2 with each
    kind's options (9/7 in two layers unless stated): byte-equal to cv2."""
    fx = _fixtures()
    seed = 100 + sorted(OPJ_KINDS).index(kind)
    h, w = 45 + seed % 23, 71 - seed % 17
    img = _random_image(seed, h, w)
    kw = dict(irreversible=1, rates=[30, 8], numresolution=3,
              cblockw_init=16, cblockh_init=16)
    kw.update(OPJ_KINDS[kind])
    if kw["rates"] is None:
        del kw["rates"]
    data = fx.openjpeg_encode([img[..., k] for k in range(3)], jp2=jp2, **kw)
    path = _write(tmp_path / ("x.jp2" if jp2 else "x.j2k"), data)
    assert assert_like_cv2(path) == ["color", "gray", "unchanged"]


@pytest.mark.parametrize("prec,channels", [(9, 1), (10, 3), (12, 1),
                                           (12, 3), (16, 1), (16, 4),
                                           (20, 3), (13, 2)])
def test_precisions_read_like_cv2(tmp_path, prec, channels):
    """9-16 bits read unchanged as uint16 and cut to 8 in colour and gray;
    20 bits read only in colour and gray; gray + alpha not unchanged."""
    fx = _fixtures()
    img = _random_image(prec * 10 + channels, 33, 47, channels,
                        (1 << prec) - 1)
    path = _write(tmp_path / "x.jp2", fx.openjpeg_encode(
        [img[..., k] for k in range(channels)], prec=prec,
        color_space=fx.OPJ_GRAY if channels < 3 else fx.OPJ_SRGB,
        numresolution=3, irreversible=prec % 2, rates=[20]))
    read = assert_like_cv2(path)
    assert read[:2] == ["color", "gray"]
    assert ("unchanged" in read) == (prec <= 16 and channels != 2)


# ---- the committed kinds ----

def _committed():
    fmt = os.path.join(JPEG_DIR, "formats")
    return sorted(n for n in os.listdir(fmt) if n.endswith((".jp2", ".j2k")))


@pytest.mark.parametrize("name", _committed())
def test_committed_kinds_read_like_cv2(name):
    """Each JPEG 2000 file of tests/data/jpeg/formats against cv2 here
    (the manifest holds the same digests for the card's machine)."""
    assert_like_cv2(os.path.join(JPEG_DIR, "formats", name))


REFUSED = {
    "signed.j2k": ("JPEG 2000 with signed", ()),
    "gray1.jp2": ("1-bit samples", ()),
    "gray7.jp2": ("7-bit samples", ()),
    "rgb4.jp2": ("4-bit samples", ()),
    "offset.jp2": ("image offset", ()),
    "subsampled.jp2": ("sub-sampled", ()),
    "five.j2k": ("5 components", ()),
    "gray_alpha.jp2": ("two components", ("color", "gray")),
    "gray20.jp2": ("20-bit samples read unchanged", ("color", "gray")),
    "gray.j2k": ("1 channels in unspecified", ("gray", "unchanged")),
    "eycc.jp2": ("eYCC", ()),
    "cmyk.jp2": ("CMYK", ()),
    "cut_in_tile.j2k": ("longer than the stream", ()),
    "cut_after_tile.j2k": ("without EOC", ()),
    "cut.jp2": ("cut stream", ()),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_cv2_failures(name):
    """Where cv2 reads nothing from a kind, the port raises
    NotImplementedError naming it; the modes cv2 does read match."""
    what, reads = REFUSED[name]
    path = os.path.join(JPEG_DIR, "formats", name)
    assert tuple(assert_like_cv2(path, what)) == reads


def test_cut_after_a_tile_with_eoc_reads_missing_tiles_as_zero():
    """A codestream cut after its first tile-part, EOC appended: cv2 reads
    it, the tiles that are missing 0; the port gives the same array."""
    path = os.path.join(JPEG_DIR, "formats", "cut_after_tile_eoc.j2k")
    img = timg.imread(path, "unchanged")
    assert np.array_equal(img, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert (img[:, 24:] == 0).all() and img[:16, :24].any()


def test_htj2k_and_part2_refused_by_name(tmp_path):
    """High-Throughput code-blocks (the COD style bit 0x40, written by no
    encoder here) and a Part 2 multiple component transform are refused
    by name."""
    fx = _fixtures()
    img = _random_image(7, 16, 16)
    data = bytearray(fx.openjpeg_encode([img[..., k] for k in range(3)],
                                        jp2=False, numresolution=2))
    cod = bytes(data).index(b"\xff\x52")
    ht = bytearray(data)
    ht[cod + 12] |= 0x40                    # SPcod's code-block style
    mct = bytearray(data)
    mct[cod + 8] = 2                        # SGcod's transform
    for blob, what in ((ht, "HTJ2K"), (mct, "Part 2")):
        path = _write(tmp_path / "x.j2k", bytes(blob))
        with pytest.raises(NotImplementedError, match=what):
            timg.imread(path)


# ---- the decoded components against libopenjp2 ----

def _openjpeg_decode(path: str):
    """The components libopenjp2 (Pillow's) decodes, as int32 arrays."""
    import ctypes
    fx = _fixtures()
    lib = fx.libopenjp2()
    _, _, ImageT = fx._opj_structs()
    with open(path, "rb") as f:
        jp2 = f.read(4) != b"\xff\x4f\xff\x51"
    lib.opj_create_decompress.restype = ctypes.c_void_p
    codec = ctypes.c_void_p(lib.opj_create_decompress(2 if jp2 else 0))
    params = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_decoder_parameters(params)
    lib.opj_setup_decoder(codec, params)
    st = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(
        path.encode(), 1))
    img = ctypes.POINTER(ImageT)()
    try:
        assert lib.opj_read_header(st, codec, ctypes.byref(img))
        assert lib.opj_decode(codec, st, img)
        im = img.contents
        return [np.ctypeslib.as_array(im.comps[i].data,
                                      (im.comps[i].h, im.comps[i].w)).copy()
                for i in range(im.numcomps)]
    finally:
        lib.opj_stream_destroy(st)
        lib.opj_destroy_codec(codec)
        if img:
            lib.opj_image_destroy(img)


@pytest.mark.parametrize("kind", ["signed", "offset", "subsampled",
                                  "prec4_tiles", "prec1", "five_roi"])
def test_components_match_libopenjp2(tmp_path, kind):
    """Where cv2 reads nothing, the decoded components still equal
    libopenjp2's (signed samples, an image offset with tiles, 4:2:0
    sub-sampling, 4 and 1 bits, five components with ROI)."""
    fx = _fixtures()
    img = _random_image(300 + len(kind), 39, 53, 5)
    comps = [img[..., k] for k in range(3)]
    kw = dict(irreversible=1, rates=[20, 6], numresolution=3,
              cblockw_init=16, cblockh_init=16)
    if kind == "signed":
        kw.update(sgnd=1, prec=10)
        comps = [c * 4 - 512 for c in comps]
    elif kind == "offset":
        kw.update(offset=(13, 7), tiles=(24, 20))
    elif kind == "subsampled":
        kw.update(dxy=[(1, 1), (2, 2), (2, 2)])
        comps = [comps[0], comps[1][::2, ::2], comps[2][::2, ::2]]
    elif kind == "prec4_tiles":
        kw.update(prec=4, tiles=(16, 32))
        comps = [c >> 4 for c in comps]
    elif kind == "prec1":
        kw.update(prec=1, irreversible=0, rates=[5])
        comps = [c >> 7 for c in comps]
    else:
        comps = [img[..., k] for k in range(5)]
        kw.update(roi_compno=3, roi_shift=5)
    path = _write(tmp_path / "x.jp2", fx.openjpeg_encode(comps, **kw))
    with open(path, "rb") as f:
        ours = native.jp2_decode(f.read(), path)
    ref = _openjpeg_decode(path)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(NotImplementedError):
        timg.imread(path)


# ---- the views of the densify run, build ----

def test_views_load_like_jax(tmp_path):
    """The four committed 1280x960 views (chip_smoke.py phase 27's densify
    run) in a scene.mvs: both packages' load_image give equal arrays, and
    the port's densify loading step gives the images the JAX package's
    densify computes from them (load, scale to the working resolution,
    gray by BT.601) at the run's resolution-level 0."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.io import images as jimg
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.pipeline.densify import _load_images
    fx = _fixtures()
    view_dir = os.path.join(JPEG_DIR, "jp2_views")
    scene_path, _ = fx.jp2_view_scene(str(tmp_path))
    for i in range(fx.JP2_VIEWS):
        path = os.path.join(view_dir, f"v{i}.jp2")
        for gray in (False, True):
            assert np.array_equal(timg.load_image(path, gray),
                                  jimg.load_image(path, gray)), (i, gray)
    cfg, jcfg = DenseConfig(resolution_level=0), JConfig(resolution_level=0)
    grays, colors = _load_images(read_mvs(scene_path), view_dir, cfg)
    for i in range(fx.JP2_VIEWS):
        img = jimg.load_image(os.path.join(view_dir, f"v{i}.jp2"))
        scale = jimg.compute_resolution_scale(
            img.shape[1], img.shape[0], jcfg.resolution_level,
            jcfg.max_resolution, jcfg.min_resolution)
        img = jimg.resize_image(img, scale)
        assert np.array_equal(colors[i], img), i
        assert np.array_equal(grays[i], jimg.to_gray(img).astype(
            np.float32)), i


def test_jpeg2000_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build of the JPEG 2000 decoder raises with g++'s
    output; nothing falls back to another decoder."""
    path = os.path.join(JPEG_DIR, "formats", "pil_lossy.jp2")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native.EXTRA_FLAGS, "jpeg2000",
                        ("-ffp-contract=off", "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        timg.imread(path)


def densify_views_at(h: int, w: int, which=("jax", "port")) -> None:
    """View 0's depth_acc_2pct of both packages' densify (DenseConfig(),
    resolution-level 0; the JAX package with the volume / rect backends
    forced) on the JPEG 2000 views: the committed ones at 960 x 1280, else
    the scene rendered and encoded alike at h x w."""
    import tempfile
    import time
    fx = _fixtures()
    with tempfile.TemporaryDirectory() as root:
        view_dir = os.path.join(JPEG_DIR, "jp2_views")
        if (h, w) != (960, 1280):
            view_dir = os.path.join(root, "views")
            fx.jp2_views(view_dir, fx.ridge_scene(h, w, fx.JP2_VIEWS).images)
        scene_path, sc = fx.jp2_view_scene(os.path.join(root, "scene"), h, w)
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
