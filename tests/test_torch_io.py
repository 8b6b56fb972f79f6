"""PyTorch port vs the JAX package: scene, depth-map, point-cloud and image
I/O (``hcmvs_tpu_torch/io``).

The writers must produce the JAX package's bytes exactly, and each
package's reader must read the other's files back exactly.  The image
decoder is held against OpenCV (exactly, on 8-bit samples); ``resize_image``
against ``cv2.resize`` at ratios 2, 0.8 and 1.5 within 1e-5 (float32
sums in another order); ``to_gray`` and ``compute_resolution_scale``
against the JAX package's exactly.  Image tests skip where OpenCV is
missing (the JAX package's image module needs it).
"""

import os
import struct
import zlib

import numpy as np
import pytest

from hcmvs_tpu.io import dmap as jdmap
from hcmvs_tpu.io import mvs as jmvs
from hcmvs_tpu.io import ply as jply
from hcmvs_tpu_torch.io import dmap as tdmap
from hcmvs_tpu_torch.io import images as timg
from hcmvs_tpu_torch.io import mvs as tmvs
from hcmvs_tpu_torch.io import ply as tply


def _scene(mod, rng, n_pts, with_extras):
    plat = mod.Platform(name="rig")
    for k in range(2):
        plat.cameras.append(mod.CameraIntrinsic(
            name=f"c{k}", band_name="rgb" * k, width=64 * k, height=48 * k,
            K=rng.normal(size=(3, 3)), R=rng.normal(size=(3, 3)),
            C=rng.normal(size=3)))
    for _ in range(3):
        plat.poses.append(mod.Pose(R=rng.normal(size=(3, 3)),
                                   C=rng.normal(size=3)))
    images = [mod.ImageRecord(name=f"im{i}.png", mask_name="m" * i,
                              platform_id=0, camera_id=i % 2, pose_id=i,
                              id=i) for i in range(3)]
    counts = rng.integers(0, 5, n_pts).astype(np.int32)
    total = int(counts.sum())
    scene = mod.SceneMVS(
        platforms=[plat], images=images,
        points=rng.normal(size=(n_pts, 3)).astype(np.float32),
        point_view_counts=counts,
        point_view_ids=rng.integers(0, 3, total).astype(np.uint32),
        point_view_confs=rng.uniform(size=total).astype(np.float32))
    if with_extras:
        scene.point_normals = rng.normal(size=(n_pts, 3)).astype(np.float32)
        scene.point_colors = rng.integers(0, 256, (n_pts, 3)).astype(
            np.uint8)
        scene.transform = rng.normal(size=(4, 4))
    return scene


def _same_scene(a, b):
    assert len(a.platforms) == len(b.platforms)
    for pa, pb in zip(a.platforms, b.platforms):
        assert pa.name == pb.name
        for ca, cb in zip(pa.cameras, pb.cameras):
            assert (ca.name, ca.band_name, ca.width, ca.height) == \
                (cb.name, cb.band_name, cb.width, cb.height)
            for f in "KRC":
                assert np.array_equal(getattr(ca, f), getattr(cb, f))
        for qa, qb in zip(pa.poses, pb.poses):
            assert np.array_equal(qa.R, qb.R) and np.array_equal(qa.C, qb.C)
    assert [vars(i) for i in a.images] == [vars(i) for i in b.images]
    for f in ("points", "point_view_counts", "point_view_ids",
              "point_view_confs", "point_normals", "point_colors",
              "transform"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("n_pts,with_extras", [(0, False), (1, True),
                                               (257, False), (300, True)])
def test_mvs_bytes_and_readers_match(tmp_path, n_pts, with_extras):
    rng = np.random.default_rng(n_pts)
    pj, pt = str(tmp_path / "j.mvs"), str(tmp_path / "t.mvs")
    jmvs.write_mvs(pj, _scene(jmvs, np.random.default_rng(n_pts), n_pts,
                              with_extras))
    tmvs.write_mvs(pt, _scene(tmvs, rng, n_pts, with_extras))
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    _same_scene(tmvs.read_mvs(pj), jmvs.read_mvs(pt))
    _same_scene(tmvs.read_mvs(pt), jmvs.read_mvs(pj))


@pytest.mark.parametrize("normal,conf", [(True, True), (False, False),
                                         (True, False)])
def test_dmap_bytes_and_readers_match(tmp_path, normal, conf):
    rng = np.random.default_rng(1)
    h, w = 13, 17
    fields = dict(
        depth=rng.uniform(1, 5, (h, w)).astype(np.float32),
        normal=rng.normal(size=(h, w, 3)).astype(np.float32) if normal
        else None,
        conf=rng.uniform(size=(h, w)).astype(np.float32) if conf else None,
        K=rng.normal(size=(3, 3)), R=rng.normal(size=(3, 3)),
        C=rng.normal(size=3), d_min=0.5, d_max=7.25, image_size=(34, 26),
        image_name="view_07.png", view_ids=[7, 3, 11])
    pj, pt = str(tmp_path / "j.dmap"), str(tmp_path / "t.dmap")
    jdmap.write_dmap(pj, jdmap.DepthMapData(**fields))
    tdmap.write_dmap(pt, tdmap.DepthMapData(**fields))
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    for a, b in ((tdmap.read_dmap(pj), jdmap.read_dmap(pt)),
                 (tdmap.read_dmap(pt), jdmap.read_dmap(pj))):
        for k, v in vars(a).items():
            u = getattr(b, k)
            if isinstance(v, np.ndarray) or v is None:
                assert (v is None and u is None) or np.array_equal(v, u), k
            else:
                assert v == u, k


@pytest.mark.parametrize("normals,colors", [(False, False), (True, True),
                                            (False, True)])
def test_ply_bytes_and_readers_match(tmp_path, normals, colors):
    rng = np.random.default_rng(2)
    n = 41
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32) if normals else None
    col = rng.integers(0, 256, (n, 3)).astype(np.uint8) if colors else None
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.write_ply_points(pj, pts, nrm, col)
    tply.write_ply_points(pt, pts, nrm, col)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    for (va, ea), (vb, eb) in ((tply.read_ply(pj), jply.read_ply(pt)),
                               (tply.read_ply(pt), jply.read_ply(pj))):
        assert np.array_equal(va, vb) and ea.keys() == eb.keys()
        for k in ea:
            assert np.array_equal(ea[k], eb[k])


def _test_images():
    """8-bit gray, RGB and RGBA images: smooth ramps (OpenCV's encoder
    then picks the Average and Paeth row filters) plus noise."""
    rng = np.random.default_rng(5)
    h, w = 37, 53
    base = (np.add.outer(np.sin(np.arange(h) / 5.0),
                         np.cos(np.arange(w) / 7.0)) * 60 + 128)
    noise = rng.integers(0, 40, (h, w, 4))
    rgb = np.stack([base, base[::-1], 255 - base], -1) + noise[..., :3]
    return {"gray": base.astype(np.uint8),
            "rgb": np.clip(rgb, 0, 255).astype(np.uint8),
            "rgba": np.clip(np.concatenate([rgb, noise[..., 3:] * 6], -1),
                            0, 255).astype(np.uint8)}


@pytest.mark.parametrize("kind,ext", [("gray", ".png"), ("rgb", ".png"),
                                      ("rgba", ".png"), ("gray", ".pgm"),
                                      ("rgb", ".ppm")])
def test_decoder_matches_opencv(tmp_path, kind, ext):
    cv2 = pytest.importorskip("cv2")
    from hcmvs_tpu.io.images import load_image as jload
    img = _test_images()[kind]
    path = str(tmp_path / f"im{ext}")
    bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    assert cv2.imwrite(path, bgr)
    for gray in (False, True):
        ours = timg.load_image(path, gray=gray)
        ref = jload(path, gray=gray)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert np.array_equal(ours, ref), (gray, np.abs(ours - ref).max())


def test_png_writer_round_trips(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for kind, img in _test_images().items():
        path = str(tmp_path / f"{kind}.png")
        timg.write_png(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            back = back[..., [2, 1, 0, 3][:img.shape[2]]]
        assert np.array_equal(back, img), kind
        ours = timg.load_image(path)
        ref = img if img.ndim == 2 else img[..., :3]
        if img.ndim == 2:
            ref = np.repeat(ref[..., None], 3, -1)
        assert np.array_equal(ours, ref.astype(np.float32) / 255.0)


def _png(color: int, depth: int, interlace: int = 0, w: int = 2, h: int = 2,
         raw: bytes = bytes(64)) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _filtered_rows(img: np.ndarray, bpp: int) -> bytes:
    """PNG scanlines of (H, W*bpp) uint8 ``img`` with row y filtered by
    type y % 5 (None, Sub, Up, Average, Paeth; PNG spec section 9)."""
    out = bytearray()
    prev = [0] * img.shape[1]
    for y, row in enumerate(img.tolist()):
        kind = y % 5
        out.append(kind)
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[kind]
            out.append((v - pred) & 0xFF)
        prev = row
    return bytes(out)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_decoder_all_row_filters(tmp_path, kind):
    """All five PNG row filters, against the image itself and OpenCV."""
    cv2 = pytest.importorskip("cv2")
    img = _test_images()[kind]
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png({1: 0, 3: 2, 4: 6}[c], 8, w=w, h=h,
                     raw=_filtered_rows(img.reshape(h, w * c), c)))
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    ours = timg.load_image(path)
    assert np.array_equal(ours, rgb[..., :3].astype(np.float32) / 255.0)
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert np.array_equal(ours, ref.astype(np.float32) / 255.0)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
def test_png_writer_row_filters(tmp_path, filters):
    """The writer's row filters: with row y filtered by type y % 5 its
    scanlines are ``_filtered_rows``'s; every file decodes back to the
    image, by the port (row by row, or as a wavefront where Average or
    Paeth is used) and by OpenCV."""
    cv2 = pytest.importorskip("cv2")
    for kind, img in _test_images().items():
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        rows = [y % 5 for y in range(h)] if filters == "mixed" else filters
        path = str(tmp_path / f"{kind}.png")
        timg.write_png(path, img, rows)
        with open(path, "rb") as f:
            data = f.read()
        (n,) = struct.unpack_from(">I", data, 33)     # the IDAT after IHDR
        assert data[37:41] == b"IDAT"
        scan = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
        assert np.array_equal(scan.reshape(h, -1)[:, 0],
                              np.broadcast_to(rows, (h,)))
        if filters == "mixed":
            assert scan.tobytes() == _filtered_rows(img.reshape(h, w * c), c)
        assert np.array_equal(timg._decode_png(data, path),
                              img.reshape(h, w, c))
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            back = back[..., [2, 1, 0, 3][:c]]
        assert np.array_equal(back, img), kind


def test_ply_body_starting_with_a_line_break_byte(tmp_path):
    """A binary body whose first byte is 0x0a or 0x0d reads back exactly
    (the JAX package's reader strips such bytes and then fails)."""
    for first in (b"\x0a", b"\x0d"):
        pts = np.frombuffer((first + b"\x00\x80\x3f") * 12, "<f4")
        pts = pts.reshape(4, 3).copy()
        path = str(tmp_path / "p.ply")
        tply.write_ply_points(path, pts, colors=np.full((4, 3), 13,
                                                        np.uint8))
        back, extras = tply.read_ply(path)
        assert np.array_equal(back, pts)
        assert (extras["colors"] == 13).all()


def _jpeg_frame(marker: int, precision: int = 8, n_comp: int = 3) -> bytes:
    """SOI and a frame header of ``marker`` (the decoder stops there)."""
    body = struct.pack(">BHHB", precision, 2, 2, n_comp) + b"".join(
        bytes([k + 1, 0x11, 0]) for k in range(n_comp))
    return (b"\xff\xd8\xff" + bytes([marker])
            + struct.pack(">H", len(body) + 2) + body + b"\xff\xd9")


def _tiff_compressed(compression: int) -> bytes:
    """A little-endian TIFF header and IFD naming ``compression``."""
    tags = ((256, 2), (257, 2), (258, 8), (259, compression), (262, 1),
            (273, 8), (277, 1), (279, 4))
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", t, 4, 1, v) for t, v in tags)
    return b"II*\0" + struct.pack("<I", 12) + bytes(4) + ifd + bytes(4)


@pytest.mark.parametrize("data,what", [
    (_jpeg_frame(0xC9), "arithmetic"), (_jpeg_frame(0xC3), "lossless"),
    (_jpeg_frame(0xC1, precision=12), "12-bit"),
    (_jpeg_frame(0xC0, n_comp=4), "CMYK"),
    (_jpeg_frame(0xDE), "hierarchical"),
    (_tiff_compressed(7), "JPEG-in-TIFF"),
    (b"BM" + bytes(12) + struct.pack("<IiiHHI", 40, 2, 2, 1, 32, 3)
     + bytes(20), "bit fields"),
    (b"GIF89a" + bytes(16), "unknown")])
def test_unsupported_images_raise(tmp_path, data, what):
    path = str(tmp_path / "x.img")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match=what):
        timg.load_image(path)
    with pytest.raises(FileNotFoundError):
        timg.load_image(str(tmp_path / "missing.png"))


def test_png_depths_and_palette_decode(tmp_path):
    """16-bit and palette PNGs decode (tests/test_torch_masks.py holds
    every colour type and depth against OpenCV); a palette image without
    its PLTE chunk is malformed."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_png(0, 16))
    raw = timg._decode_png(_png(0, 16), path)
    assert raw.dtype == np.uint16 and raw.shape == (2, 2, 1) and not raw.any()
    assert np.array_equal(timg.load_image(path), np.zeros((2, 2, 3)))
    with pytest.raises(ValueError, match="PLTE"):
        timg._decode_png(_png(3, 8), path)


@pytest.mark.parametrize("scale", [2.0, 0.8, 1.5, 0.5, 0.37])
def test_resize_and_gray_match_opencv(scale):
    pytest.importorskip("cv2")
    from hcmvs_tpu.io import images as jimg
    rng = np.random.default_rng(6)
    for shape in ((45, 61, 3), (45, 61)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        ours, ref = timg.resize_image(img, scale), jimg.resize_image(img,
                                                                     scale)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    rgb = rng.uniform(0, 1, (45, 61, 3)).astype(np.float32)
    assert np.array_equal(timg.to_gray(rgb), jimg.to_gray(rgb))
    for args in ((1280, 960, 0, 3200, 640), (1280, 960, 1, 3200, 640),
                 (4000, 3000, 1, 3200, 640), (800, 600, 2, 0, 0),
                 (640, 480, 3, 3200, 640)):
        assert (timg.compute_resolution_scale(*args)
                == jimg.compute_resolution_scale(*args))


def test_depth_png_is_readable(tmp_path):
    cv2 = pytest.importorskip("cv2")
    depth = np.random.default_rng(7).uniform(1, 3, (20, 30)).astype(
        np.float32)
    depth[:4] = 0
    path = str(tmp_path / "d.png")
    timg.save_depth_png(path, depth)
    rgb = cv2.imread(path)[..., ::-1]
    assert rgb.shape == (20, 30, 3) and not rgb[:4].any()
    assert np.array_equal(rgb[4:], timg.jet_colormap(
        (depth[4:] - depth[4:].min()) / (depth[4:].max()
                                          - depth[4:].min())))
    assert os.path.getsize(path) > 0
