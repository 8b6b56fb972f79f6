"""PyTorch port vs OpenCV: the image decoders of ``hcmvs_tpu_torch/io/
images.py`` (``imread``, ``load_image``, ``load_semantic_mask``), and
``build_pyramid`` / ``pad_to_multiple`` vs the JAX package's.

Every decoder is held byte-equal to ``cv2.imread`` in its three modes
(IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED) on files written here:
JPEGs by ``cv2.imwrite`` (qualities 50 / 95 / 100, 4:4:4 / 4:2:2 /
4:2:0 / 4:4:0 / 4:1:1, progressive, optimized Huffman tables, restart
markers, gray) at sizes 1x1, 7x9, 17x33 and 61x83 (partial MCUs) and by
Pillow (an RGB-transform file, progressive 4:2:0, CMYK, and YCCK by a
byte edit); progressive files cut after each of their scans (read
block-smoothed); the 8 EXIF orientations on JPEG and PNG (Pillow); BMP
and TIFF variants by ``cv2.imwrite`` and Pillow and by the small writers
below (4-bit and RLE BMP, top-down rows, 16-bit, bit fields and OS/2
headers; tiled, planar and predictor-2 TIFF), JPEG-in-TIFF (RGB, gray,
YCbCr, tiled), palette, CMYK, float, signed, bilevel and min-is-white
TIFF; Adam7 PNG by the writer below (neither library writes it); P1-P6
PNM at several maxvals; WebP by cv2, Pillow and libwebp's own encoder
(through make_fixtures' ctypes binding: token partitions, both loop
filters, sharpness, segments) and with ALPH chunks, animations and EXIF
written by make_fixtures; GIF, Sun raster and PAM by its writers, Radiance
HDR and PFM by cv2 and by hand, YCbCr TIFF by Pillow; an AVIF reads as
cv2 reads it and JPEG 2000 that cv2 fails on raises naming itself (JPEG
2000 and AVIF themselves: tests/test_torch_jpeg2000.py and
tests/test_torch_avif.py).  A scene's images as WebP and GIF
load as the JAX package loads them.
The committed fixtures of ``tests/data/jpeg/`` match their manifest's
digests, which are re-derived from cv2 here, so the manifest cannot go
stale.  ``build_pyramid`` and ``pad_to_multiple`` equal the JAX
package's exactly on uint8 and float32.  Tests skip where OpenCV is
missing.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest

from hcmvs_tpu_torch.io import images as timg

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}
SIZES = ((1, 1), (7, 9), (17, 33), (61, 83))
JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")


def _fixtures():
    """tests/data/jpeg/make_fixtures.py as a module (its writers)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(JPEG_DIR, "make_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pattern(h: int, w: int, c: int = 3, seed: int = 0) -> np.ndarray:
    """(h, w, c) uint8: colour ramps plus noise (every chroma sampling's
    edges and the IDCT's clamping get exercised)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 110 * np.sin(x / (3 + k) + y / (5 + k))
                    for k in range(c)], -1)
    return np.clip(img + rng.normal(0, 25, img.shape), 0,
                   255).astype(np.uint8)


def assert_like_cv2(path: str, modes=("color", "gray", "unchanged")):
    for mode in modes:
        ref = cv2.imread(path, FLAGS[mode])
        assert ref is not None, path
        ours = timg.imread(path, mode)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, \
            (path, mode, ours.shape, ref.shape)
        assert np.array_equal(ours, ref), (path, mode)
    if "color" in modes:
        ref = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        assert np.array_equal(timg.load_image(path),
                              ref.astype(np.float32) / 255.0)


JPEG_CASES = {
    "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
    "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
    "s420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
    "s440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
    "s411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "progressive420": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
    "gray": [],
    "gray_progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_matches_opencv(tmp_path, case):
    gray = case.startswith("gray")
    for h, w in SIZES:
        img = pattern(h, w, 1 if gray else 3, seed=h)
        for q in (50, 95, 100):
            path = str(tmp_path / f"{case}_{h}x{w}_q{q}.jpg")
            assert cv2.imwrite(path, img[..., 0] if gray else img,
                               [cv2.IMWRITE_JPEG_QUALITY, q]
                               + JPEG_CASES[case])
            assert_like_cv2(path)


@pytest.mark.parametrize("kw", [dict(keep_rgb=True), dict(subsampling=1),
                                dict(progressive=True, subsampling=2,
                                     optimize=True)],
                         ids=["rgb", "s422", "progressive"])
def test_pillow_jpegs_match_opencv(tmp_path, kw):
    """Pillow's files: an RGB-transform one (Adobe APP14, no JFIF), 4:2:2
    and progressive 4:2:0 with optimized tables."""
    for h, w in SIZES[1:]:
        path = str(tmp_path / f"{h}x{w}.jpg")
        Image.fromarray(pattern(h, w, seed=w)).save(path, "JPEG",
                                                    quality=90, **kw)
        assert_like_cv2(path)


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_exif_orientation_matches_opencv(tmp_path, ext):
    """The 8 EXIF orientations: applied by imread's color and gray modes
    (and so by load_image), ignored unchanged and by load_semantic_mask,
    as cv2 does; a 9x14 image keeps every flip and transpose visible."""
    rgb = pattern(9, 14, seed=3)
    for value in range(1, 9):
        exif = Image.Exif()
        exif[274] = value
        path = str(tmp_path / f"o{value}.{ext}")
        Image.fromarray(rgb).save(path, exif=exif.tobytes(),
                                  **({"quality": 95} if ext == "jpg"
                                     else {}))
        assert_like_cv2(path)
        if value >= 5:
            assert timg.load_image(path, gray=True).shape == (14, 9)
        mask = timg.load_semantic_mask(path)
        assert mask.shape == (9, 14)


@pytest.mark.parametrize("progressive", [0, 1])
def test_truncated_jpegs(tmp_path, progressive):
    """A file that ends after its last scan, without EOI, reads as cv2
    reads it (libjpeg supplies the EOI); one cut inside a scan, or with no
    scan, raises naming the fault."""
    ok, buf = cv2.imencode(".jpg", pattern(33, 47), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
        progressive])
    data = buf.tobytes()
    path = str(tmp_path / "no_eoi.jpg")
    with open(path, "wb") as f:
        f.write(data[:-2])
    assert_like_cv2(path)
    for name, bad in (("cut", data[:len(data) // 2]),
                      ("no_scan", data[:data.index(b"\xff\xda")] +
                       b"\xff\xd9")):
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match="JPEG"):
            timg.imread(path)


FOUR_COMPONENTS = {"cmyk": dict(), "cmyk_s420": dict(subsampling=2),
                   "cmyk_progressive": dict(progressive=True),
                   "ycck": dict(), "no_adobe": dict()}


@pytest.mark.parametrize("kind", sorted(FOUR_COMPONENTS))
def test_four_component_jpegs_match_opencv(tmp_path, kind):
    """Pillow's CMYK JPEGs (Adobe APP14, transform 0, inverted), the same
    with the transform byte set to 2 (YCCK) or with no APP14 at all
    (straight CMYK), through OpenCV's CMYK -> BGR / gray."""
    import io
    for h, w in SIZES:
        buf = io.BytesIO()
        Image.fromarray(pattern(h, w, seed=h + w)).convert("CMYK").save(
            buf, "JPEG", quality=85, **FOUR_COMPONENTS[kind])
        data = buf.getvalue()
        at = data.index(b"Adobe")
        if kind == "ycck":
            data = data[:at + 11] + b"\2" + data[at + 12:]
        elif kind == "no_adobe":
            (length,) = struct.unpack_from(">H", data, at - 2)
            data = data[:at - 4] + data[at - 2 + length:]
        path = str(tmp_path / f"{kind}_{h}x{w}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        assert_like_cv2(path)


@pytest.mark.parametrize("case", ["s444", "s422", "s420", "s440", "s411",
                                  "gray"])
def test_progressive_cuts_match_opencv(tmp_path, case):
    """cv2's progressive files cut after each of their scans, an EOI
    appended: libjpeg-turbo block-smooths the coefficients the cut left
    not fully known (and interpolates DC where a component has no AC
    yet); heights 40 and 17 end on a short iMCU row at 4:2:0 / 4:4:0."""
    cut = _fixtures().cut_after_scans
    gray = case == "gray"
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if not gray:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   JPEG_CASES[case][1]]
    for h, w in ((7, 9), (17, 33), (40, 72), (61, 83)):
        img = pattern(h, w, 1 if gray else 3, seed=h * w)
        for q in (50, 90):
            ok, enc = cv2.imencode(".jpg", img[..., 0] if gray else img,
                                   [cv2.IMWRITE_JPEG_QUALITY, q] + params)
            data = enc.tobytes()
            k = 1
            while True:
                try:
                    part = cut(data, k)
                except ValueError:
                    break
                path = str(tmp_path / f"{case}_{h}x{w}_q{q}_k{k}.jpg")
                with open(path, "wb") as f:
                    f.write(part)
                assert_like_cv2(path)
                k += 1
            assert k > 3, k


@pytest.mark.parametrize("what", ["DNL", "fractional"])
def test_jpegs_cv2_fails_on_raise(tmp_path, what):
    """A height given by a DNL marker, and sampling factors whose ratios
    are not whole (Y 3x1 against 2x1 chroma), byte-edited into a 4:4:4
    file: cv2 reads neither, and the port raises naming the feature."""
    ok, enc = cv2.imencode(".jpg", pattern(16, 16, seed=2),
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111])
    data = bytearray(enc.tobytes())
    sof = data.index(b"\xff\xc0")
    if what == "DNL":
        data[sof + 5:sof + 7] = b"\0\0"
        data = data[:-2] + b"\xff\xdc\x00\x04\x00\x10\xff\xd9"
    else:
        data[sof + 11], data[sof + 14], data[sof + 17] = 0x31, 0x21, 0x11
    path = str(tmp_path / f"{what}.jpg")
    _write(path, bytes(data))
    assert cv2.imread(path) is None
    with pytest.raises(NotImplementedError, match=what):
        timg.imread(path)


# ---- BMP ----

def _rle8(rows: np.ndarray) -> bytes:
    """RLE8 rows (bottom row first): the first pixels of a row in absolute
    mode, the rest as runs, an end-of-line after each row."""
    out = bytearray()
    for row in rows:
        x = 0
        if len(row) >= 3:
            n = min(5, len(row))
            out += bytes([0, n]) + row[:n].tobytes() + b"\0" * (n % 2)
            x = n
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 255:
                n += 1
            out += bytes([n, row[x]])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(rows: np.ndarray) -> bytes:
    """RLE4 rows: a run of each pixel pair (its two nibbles alternating),
    the last three pixels of a row in absolute mode when it has them."""
    out = bytearray()
    for row in rows:
        x, w = 0, len(row)
        tail = 3 if w >= 3 else 0
        while x < w - tail:
            n = min(2, w - tail - x)
            pair = (row[x] << 4) | (row[x + 1] if n == 2 else 0)
            out += bytes([n, pair])
            x += n
        if tail:
            nib = list(row[x:]) + [0]
            packed = bytes((nib[i] << 4) | nib[i + 1] for i in (0, 2))
            out += bytes([0, 3]) + packed
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _bmp(pixels: np.ndarray, bpp: int, palette=None, rle: bool = False,
         top_down: bool = False) -> bytes:
    """A BMP (BITMAPINFOHEADER): ``pixels`` (h, w) palette indices for
    ``bpp`` <= 8, else (h, w, 3|4) BGR(X) bytes."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    comp = 0
    if rle:
        body, comp = (_rle8(rows), 1) if bpp == 8 else (_rle4(rows), 2)
    else:
        stride = ((w * bpp + 31) // 32) * 4
        if bpp <= 8:
            bits = np.unpackbits(rows.astype(np.uint8)[..., None],
                                 axis=-1)[..., 8 - bpp:]
            packed = np.packbits(bits.reshape(h, -1), axis=1)
        else:
            packed = rows.reshape(h, -1)
        body = b"".join(r.tobytes().ljust(stride, b"\0") for r in packed)
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       comp, len(body), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + pal + body)


def _palette(n: int, gray: bool):
    v = np.linspace(0, 255, n).astype(int)
    return [(x, x, x) if gray else (x, 255 - x, (x * 7) % 256) for x in v]


def _bmp_cases():
    idx16 = (pattern(13, 11, 1, 5)[..., 0] // 16)
    idx256 = pattern(13, 11, 1, 6)[..., 0]
    rgb = pattern(13, 11, seed=7)
    return {
        "bits1": _bmp(idx256 > 128, 1, _palette(2, False)),
        "bits4": _bmp(idx16, 4, _palette(16, False)),
        "bits4_gray": _bmp(idx16, 4, _palette(16, True)),
        "bits8": _bmp(idx256, 8, _palette(256, False)),
        "bits8_short_palette": _bmp(idx256 % 100, 8, _palette(100, False)),
        "rle8": _bmp(idx256 // 40, 8, _palette(256, False), rle=True),
        "rle8_gray": _bmp(idx256 // 40, 8, _palette(256, True), rle=True),
        "rle4": _bmp(idx16, 4, _palette(16, False), rle=True),
        "bits24_top_down": _bmp(rgb, 24, top_down=True),
        "bits32": _bmp(np.concatenate([rgb, rgb[..., :1]], -1), 32),
        "bits8_top_down": _bmp(idx256, 8, _palette(256, True),
                               top_down=True),
        **_bmp_header_cases(),
    }


def _bmp_header_cases():
    """16-bit pixels (5-5-5 plain and as bit fields, 5-6-5), 32-bit bit
    fields (masks in either order: OpenCV reads BGRA whatever they are)
    and OS/2 core headers, written by make_fixtures' BMP writer."""
    fx = _fixtures()
    rng = np.random.default_rng(14)
    words = rng.integers(0, 1 << 16, (13, 11))
    rgb = pattern(13, 11, 4, seed=15)
    idx = pattern(13, 11, 1, 16)[..., 0]
    w, h = 11, 13
    pal3 = bytes(rng.integers(0, 256, 768).astype(np.uint8))
    gray3 = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    return {
        "bits16": fx.bmp(w, h, 16, fx.bmp_rows(words, 16)),
        "bitfields555": fx.bmp(w, h, 16, fx.bmp_rows(words, 16), 3,
                               (0x7C00, 0x3E0, 0x1F)),
        "bitfields565": fx.bmp(w, h, 16, fx.bmp_rows(words, 16), 3,
                               (0xF800, 0x7E0, 0x1F)),
        "bitfields32": fx.bmp(w, h, 32, fx.bmp_rows(rgb, 32), 3,
                              (0xFF0000, 0xFF00, 0xFF)),
        "bitfields32_swapped": fx.bmp(w, h, 32, fx.bmp_rows(rgb, 32), 3,
                                      (0xFF, 0xFF00, 0xFF0000)),
        "os2_24": fx.bmp(w, h, 24, fx.bmp_rows(rgb[..., :3], 24),
                         core=True),
        "os2_8": fx.bmp(w, h, 8, fx.bmp_rows(idx, 8), palette=pal3,
                        core=True),
        "os2_8_gray": fx.bmp(w, h, 8, fx.bmp_rows(idx, 8), palette=gray3,
                             core=True),
        "os2_4": fx.bmp(w, h, 4, b"".join(
            bytes((a << 4) | b for a, b in zip(r[0::2], r[1::2])).ljust(
                8, b"\0") for r in (np.concatenate(
                    [idx >> 4, np.zeros((h, 1), np.uint8)], 1)[::-1])),
            palette=pal3[:48], core=True),
    }


@pytest.mark.parametrize("case", sorted(_bmp_cases()) + ["cv2", "pillow"])
def test_bmp_matches_opencv(tmp_path, case):
    path = str(tmp_path / f"{case}.bmp")
    if case == "cv2":
        for name, img in (("c", pattern(13, 11, seed=8)),
                          ("g", pattern(5, 3, 1, 9)[..., 0])):
            path = str(tmp_path / f"{name}.bmp")
            cv2.imwrite(path, img)
            assert_like_cv2(path)
        return
    if case == "pillow":
        rgb = pattern(9, 10, seed=10)
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            path = str(tmp_path / f"{mode}.bmp")
            im = Image.fromarray(rgb)
            im = (Image.fromarray(np.dstack([rgb, rgb[..., :1]]))
                  if mode == "RGBA" else im.convert(mode))
            im.save(path)
            assert_like_cv2(path)
        return
    with open(path, "wb") as f:
        f.write(_bmp_cases()[case])
    assert_like_cv2(path)


# ---- TIFF ----

def _tiff(img: np.ndarray, tile=None, planar: bool = False,
          predictor: int = 1, deflate: bool = False, rows: int = 3,
          big_endian: bool = False, orientation=None, photometric=None,
          compression=None) -> bytes:
    """A TIFF of (h, w, c) uint8 / uint16 samples (gray, RGB or RGBA with
    unassociated alpha): strips of ``rows`` rows or ``tile`` (tw, th)
    tiles, chunky or planar, predictor 1 or 2, raw or Deflate; the
    photometric and compression tags can be named outright."""
    end = ">" if big_endian else "<"
    h, w, c = img.shape
    depth = img.dtype.itemsize * 8
    planes = [img[..., k:k + 1] for k in range(c)] if planar else [img]
    tw, th = tile if tile else (w, rows)
    chunks = []
    for plane in planes:
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw,
                           plane.shape[2]), img.dtype)
        padded[:h, :w] = plane
        for ty in range(0, h, th):
            for tx in range(0, w if tile else 1, tw):
                part = padded[ty:ty + th, tx:tx + tw]
                if not tile:
                    part = part[:min(th, h - ty), :w]
                if predictor == 2:
                    part = np.diff(part, axis=1, prepend=np.zeros_like(
                        part[:, :1]))
                raw = part.astype(end + f"u{depth // 8}").tobytes()
                chunks.append(zlib.compress(raw) if deflate else raw)
    head = 8
    data_at = head
    blobs = b"".join(chunks)
    offsets = np.cumsum([0] + [len(x) for x in chunks[:-1]]) + data_at
    extra_at = data_at + len(blobs)
    arrays = {}

    def field(tag, typ, values):
        arrays[tag] = (typ, list(values))

    field(256, 4, [w])
    field(257, 4, [h])
    field(258, 3, [depth] * c)
    field(259, 3, [compression or (8 if deflate else 1)])
    field(262, 3, [photometric if photometric is not None
                   else 1 if c == 1 else 2])
    if orientation:
        field(274, 3, [orientation])
    field(277, 3, [c])
    field(284, 3, [2 if planar else 1])
    if predictor != 1:
        field(317, 3, [predictor])
    if c == 4:
        field(338, 3, [2])
    if tile:
        field(322, 4, [tw])
        field(323, 4, [th])
        field(324, 4, offsets)
        field(325, 4, [len(x) for x in chunks])
    else:
        field(273, 4, offsets)
        field(278, 4, [rows])
        field(279, 4, [len(x) for x in chunks])
    tags = sorted(arrays)
    ifd_at = extra_at
    out_of_line = b""
    ifd_size = 2 + 12 * len(tags) + 4
    entries = b""
    for tag in tags:
        typ, values = arrays[tag]
        code = "H" if typ == 3 else "I"
        raw = struct.pack(end + code * len(values), *values)
        if len(raw) <= 4:
            entries += struct.pack(end + "HHI", tag, typ, len(values)) \
                + raw.ljust(4, b"\0")
        else:
            at = ifd_at + ifd_size + len(out_of_line)
            entries += struct.pack(end + "HHII", tag, typ, len(values), at)
            out_of_line += raw
    magic = b"MM\0*" if big_endian else b"II*\0"
    return (magic + struct.pack(end + "I", ifd_at) + blobs
            + struct.pack(end + "H", len(tags)) + entries
            + struct.pack(end + "I", 0) + out_of_line)


def _tiff_cases():
    rgb = pattern(11, 13, seed=11)
    rgba = np.concatenate([rgb, pattern(11, 13, 1, 12)], -1)
    g16 = (pattern(11, 13, 1, 13).astype(np.uint16) * 257
           + np.arange(13, dtype=np.uint16)[:, None])
    rgb16 = rgb.astype(np.uint16) * 250 + 7
    return {
        "strips": _tiff(rgb),
        "tiles": _tiff(rgb, tile=(16, 16)),
        "planar": _tiff(rgb, planar=True, deflate=True),
        "planar_tiles": _tiff(rgba, tile=(16, 16), planar=True),
        "predictor": _tiff(rgb, predictor=2, deflate=True),
        "predictor16": _tiff(rgb16, predictor=2, deflate=True,
                             big_endian=True),
        "predictor_raw": _tiff(rgb, predictor=2),     # ignored unless coded
        "gray16_tiles": _tiff(g16, tile=(16, 32), deflate=True),
        "rgba": _tiff(rgba, rows=4),
        "big_endian": _tiff(rgb, big_endian=True),
        "flipped": _tiff(rgb, orientation=3),
        "mirrored": _tiff(rgba, orientation=2),
        "flipped_v": _tiff(g16, orientation=4),
    }


@pytest.mark.parametrize("case", sorted(_tiff_cases()) + ["cv2", "pillow"])
def test_tiff_matches_opencv(tmp_path, case):
    if case == "cv2":       # LZW with the horizontal predictor, 8 / 16-bit
        for name, img in (("c8", pattern(9, 12, seed=14)),
                          ("c16", pattern(9, 12, seed=15).astype(np.uint16)
                           * 257), ("g8", pattern(9, 12, 1, 16)[..., 0]),
                          ("g16", pattern(9, 12, 1, 17)[..., 0]
                           .astype(np.uint16) * 251),
                          ("bgra", pattern(9, 12, 4, 18))):
            path = str(tmp_path / f"{name}.tif")
            cv2.imwrite(path, img)
            assert_like_cv2(path)
        return
    if case == "pillow":
        rgb = pattern(9, 12, seed=19)
        for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            for mode in ("RGB", "L", "RGBA"):
                path = str(tmp_path / f"{comp}_{mode}.tif")
                im = (Image.fromarray(np.dstack([rgb, rgb[..., :1]]))
                      if mode == "RGBA" else
                      Image.fromarray(rgb).convert(mode))
                im.save(path, compression=comp)
                assert_like_cv2(path)
        return
    path = str(tmp_path / f"{case}.tif")
    with open(path, "wb") as f:
        f.write(_tiff_cases()[case])
    if case == "gray16_tiles":      # cv2 skews its 8-bit read of these
        assert_like_cv2(path, ("unchanged",))
        with pytest.raises(NotImplementedError, match="tiled"):
            timg.imread(path, "gray")
        return
    assert_like_cv2(path)


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("what,make", [
    ("orientation 6", lambda p: Image.fromarray(pattern(4, 5)).save(
        p, tiffinfo={274: 6})),
    # new-style JPEG-in-TIFF (compression 7) reads; the old style does not
    ("JPEG-in-TIFF", lambda p: _write(p, _tiff(pattern(8, 8),
                                               compression=6))),
    # palette images read; a palette with an extra sample does not
    ("palette", lambda p: _write(p, _tiff(pattern(4, 5, 2),
                                          photometric=3))),
    # CMYK reads; other inks do not
    ("CMYK", lambda p: Image.fromarray(pattern(4, 5)).convert("CMYK").save(
        p, tiffinfo={332: 2})),
    # float reads unchanged; cv2 fails on it as 8-bit
    ("float", lambda p: Image.fromarray(pattern(4, 5, 1)[..., 0].astype(
        np.float32)).save(p))])
def test_tiff_outside_scope_raises(tmp_path, what, make):
    path = str(tmp_path / "x.tif")
    make(path)
    with pytest.raises(NotImplementedError, match=what.split()[0]):
        timg.imread(path)


def _tiff_kind(kind: str, h: int, w: int, tmp_path) -> str:
    """A TIFF of ``kind`` at h x w written by cv2 or Pillow; its path."""
    import io
    rgb = pattern(h, w, seed=h * w + len(kind))
    path = str(tmp_path / f"{kind}_{h}x{w}.tif")
    pil = Image.fromarray(rgb)
    if kind.startswith("jpeg_cv2"):
        cv2.imwrite(path, rgb[..., 0] if kind.endswith("gray") else rgb,
                    [cv2.IMWRITE_TIFF_COMPRESSION,
                     cv2.IMWRITE_TIFF_COMPRESSION_JPEG])
    elif kind in ("float32", "int16"):
        img = (rgb.astype(np.float32) / 7.0 - 3.0 if kind == "float32"
               else rgb.astype(np.int16) * 250 - 30000)
        cv2.imwrite(path, img if w % 2 else img[..., 0])
    elif kind == "min_is_white":
        buf = io.BytesIO()
        (pil.convert("1") if w % 2 else pil.convert("L")).save(buf, "TIFF")
        _write(path, _fixtures().min_is_white(buf.getvalue()))
    else:
        im, kw = {
            "jpeg_rgb": (pil, dict(compression="jpeg", quality=70)),
            "jpeg_gray": (pil.convert("L"), dict(compression="jpeg")),
            "jpeg_ycbcr": (pil.convert("YCbCr"), dict(compression="jpeg")),
            "jpeg_tiles": (pil, dict(compression="jpeg", tile=(16, 16))),
            "palette": (pil.convert("P"), dict(compression="tiff_lzw")),
            "palette4": (pil.convert("P", palette=Image.ADAPTIVE,
                                     colors=16), {}),
            "cmyk": (pil.convert("CMYK"),
                     dict(compression="tiff_adobe_deflate")),
            "bilevel": (pil.convert("1"), {})}[kind]
        im.save(path, **kw)
    return path


TIFF_KINDS = ("jpeg_rgb", "jpeg_gray", "jpeg_ycbcr", "jpeg_tiles",
              "jpeg_cv2", "jpeg_cv2_gray", "palette", "palette4", "cmyk",
              "float32", "int16", "bilevel", "min_is_white")


@pytest.mark.parametrize("kind", TIFF_KINDS)
def test_tiff_kinds_match_opencv(tmp_path, kind):
    """JPEG-in-TIFF (strips of an RGB or gray image decoded raw, a YCbCr
    one through libjpeg's colour conversion, with the JPEGTables), palette
    (8- and 4-bit), CMYK, float32 and signed 16-bit (cv2's writes),
    bilevel and min-is-white (1- and 8-bit) TIFFs as cv2 reads them;
    float as 8-bit is where cv2 reads nothing and the port raises."""
    sizes = ((17, 23), (33, 47), (40, 64)) if kind.startswith(
        "jpeg_cv2") else ((1, 1), (7, 9), (33, 47), (40, 70))
    for h, w in sizes:
        path = _tiff_kind(kind, h, w, tmp_path)
        if kind == "float32":
            assert_like_cv2(path, ("unchanged",))
            for mode in ("color", "gray"):
                assert cv2.imread(path, FLAGS[mode]) is None
                with pytest.raises(NotImplementedError, match="float"):
                    timg.imread(path, mode)
            continue
        assert_like_cv2(path)


# ---- PNG (Adam7) ----

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _adam7_png(img: np.ndarray, depth: int, color: int,
               palette=None) -> bytes:
    """An interlaced PNG of (h, w, c) samples: each Adam7 pass's rows
    filtered None, Sub and Up in turn."""
    h, w, c = img.shape
    bpp = max(depth * c // 8, 1)
    scan = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8)
        elif depth < 8:
            bits = np.unpackbits(sub.astype(np.uint8), axis=-1)
            bits = bits[..., 8 - depth:]
            rows = np.packbits(bits.reshape(sub.shape[0], -1), axis=1)
        else:
            rows = sub.reshape(sub.shape[0], -1).astype(np.uint8)
        prev = np.zeros(rows.shape[1], np.uint8)
        for k, row in enumerate(rows):
            kind = k % 3
            pred = (np.zeros_like(row) if kind == 0 else prev if kind == 2
                    else np.concatenate([np.zeros(bpp, np.uint8),
                                         row[:-bpp]]))
            scan += bytes([kind]) + (row - pred).astype(np.uint8).tobytes()
            prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    plte = b"" if palette is None else chunk(b"PLTE", bytes(
        np.asarray(palette, np.uint8).reshape(-1)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 1))
            + plte + chunk(b"IDAT", zlib.compress(bytes(scan)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["gray8", "rgb8", "rgba16", "gray1",
                                  "gray16", "palette4", "gray_alpha8"])
def test_adam7_png_matches_opencv(tmp_path, case):
    for h, w in ((1, 1), (3, 9), (13, 11), (17, 20)):
        img = pattern(h, w, 4, seed=h * w)
        if case == "gray8":
            data = _adam7_png(img[..., :1], 8, 0)
        elif case == "rgb8":
            data = _adam7_png(img[..., :3], 8, 2)
        elif case == "rgba16":
            data = _adam7_png(img.astype(np.uint16) * 257 + 3, 16, 6)
        elif case == "gray16":
            data = _adam7_png(img[..., :1].astype(np.uint16) * 255, 16, 0)
        elif case == "gray1":
            data = _adam7_png(img[..., :1] >> 7, 1, 0)
        elif case == "palette4":
            data = _adam7_png(img[..., :1] >> 4, 4, 3,
                              _palette(16, False))
        else:
            data = _adam7_png(img[..., :2], 8, 4)
        path = str(tmp_path / f"{case}_{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(data)
        assert_like_cv2(path)


# ---- PNM ----

def _ascii(kind: str, img: np.ndarray, maxval) -> bytes:
    h, w = img.shape[:2]
    head = f"{kind}\n# a comment\n{w} {h}\n" + ("" if maxval is None
                                               else f"{maxval}\n")
    rows = "\n".join(" ".join(str(int(v)) for v in row.reshape(-1))
                     for row in img)
    return (head + rows + "\n").encode()


@pytest.mark.parametrize("case", ["P1", "P2_100", "P2_255", "P2_1000",
                                  "P3_200", "P3_65535", "P4", "P5_100",
                                  "P5_65535", "P6_255", "P6_4095"])
def test_pnm_matches_opencv(tmp_path, case):
    kind, _, maxval = case.partition("_")
    maxval = int(maxval) if maxval else None
    c = 3 if kind in ("P3", "P6") else 1
    rng = np.random.default_rng(len(case))
    img = rng.integers(0, (maxval or 1) + 1, (7, 10, c))
    if kind in ("P2", "P3"):
        img[0, 0] = maxval + 5                  # past maxval: cut to it
    if kind in ("P1", "P2", "P3"):
        data = _ascii(kind, img, maxval)
    elif kind == "P4":
        data = (b"P4\n10 7\n"
                + np.packbits(img[..., 0].astype(np.uint8), axis=1).tobytes())
    else:
        dtype = ">u2" if maxval > 255 else np.uint8
        data = (f"{kind}\n10 7\n{maxval}\n".encode()
                + img.astype(dtype).tobytes())
    path = str(tmp_path / f"{case}.pnm")
    with open(path, "wb") as f:
        f.write(data)
    assert_like_cv2(path)


# ---- WebP, GIF, Radiance HDR, PFM, PAM, Sun raster, YCbCr TIFF ----

def assert_like_cv2_or_refused(path: str, undefined=()):
    """Each mode equals cv2's read, or raises NotImplementedError where cv2
    returns nothing; in the ``undefined`` modes (where cv2 returns memory
    it never wrote) the port raises NotImplementedError saying so."""
    for mode in FLAGS:
        if mode in undefined:
            with pytest.raises(NotImplementedError, match="unwritten"):
                timg.imread(path, mode)
            continue
        ref = cv2.imread(path, FLAGS[mode])
        if ref is None:
            with pytest.raises(NotImplementedError):
                timg.imread(path, mode)
            continue
        ours = timg.imread(path, mode)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, \
            (path, mode, ours.shape, ref.shape)
        assert np.array_equal(ours, ref, equal_nan=True), (path, mode)


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: sines plus a little noise (lossy coders keep
    structure, so every prediction mode and filter gets used)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 3 + y / 7),
                    128 + 90 * np.cos(y / 4 - x / 9),
                    128 + 80 * np.sin((x + y) / 5)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0,
                   255).astype(np.uint8)


# (h, w, quality, libwebp options): edge sizes, 1-8 token partitions,
# both loop filters, sharpness, segments, the filter off
WEBP_LOSSY = {
    "1x1": (1, 1, 80, {}),
    "3x17_p8_simple": (3, 17, 20, dict(method=0, partitions=3,
                                       filter_type=0)),
    "33x19_p4_sharp": (33, 19, 50, dict(method=2, partitions=2,
                                        sharpness=7, strength=100)),
    "61x47_seg": (61, 47, 95, dict(method=6, segments=4, sns=100,
                                   autofilter=1)),
    "17x64_q0": (17, 64, 0, dict(method=1, partitions=1, filter_type=0,
                                 sharpness=2)),
}


@pytest.mark.parametrize("case", sorted(WEBP_LOSSY))
def test_lossy_webp_matches_opencv(tmp_path, case):
    h, w, quality, opts = WEBP_LOSSY[case]
    path = str(tmp_path / f"{case}.webp")
    _write(path, _fixtures().webp_encode(_smooth(h, w, 3), quality, **opts))
    assert_like_cv2(path)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_webp_alpha_filters_match_opencv(tmp_path, kind):
    """ALPH chunks under each filter (none, horizontal, vertical,
    gradient), raw and lossless-coded, at an odd size."""
    fx = _fixtures()
    rgb = _smooth(21, 35, 4)
    alpha = _smooth(21, 35, 5)[..., 1]
    for comp in (False, True):
        path = str(tmp_path / f"a{kind}{comp}.webp")
        _write(path, fx.webp_with_alpha(rgb, alpha, kind, comp, 60.0))
        assert_like_cv2(path)


@pytest.mark.parametrize("colors", [1, 3, 12, 60, 0])
def test_lossless_webp_matches_opencv(tmp_path, colors):
    """Lossless files (Pillow, and libwebp's fastest method): palettes of
    1 to 60 colours (colour indexing bundling 8 to 1 pixels), and a photo
    (0) with alpha."""
    rng = np.random.default_rng(colors)
    if colors:
        pal = rng.integers(0, 256, (colors, 4)).astype(np.uint8)
        idx = rng.integers(0, colors, (29, 37))
        img = pal[idx]
    else:
        img = np.concatenate([_smooth(29, 37, 6), _smooth(29, 37, 7)[..., :1]],
                             -1)
    for k, data in enumerate((
            _pil_bytes(Image.fromarray(img), "WEBP", lossless=True,
                       quality=100, method=6),
            _fixtures().webp_encode(img, 0, lossless=1, method=0))):
        path = str(tmp_path / f"l{k}.webp")
        _write(path, data)
        assert_like_cv2(path)


def _pil_bytes(im, fmt, **kw) -> bytes:
    import io
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def test_webp_orientation_and_animation_match_opencv(tmp_path):
    """EXIF orientations 3 and 8 (turned in the colour and gray modes),
    and an animation whose first frame lies at an offset of a larger
    canvas: cv2 reads that frame on a transparent canvas."""
    fx = _fixtures()
    rgb = _smooth(20, 30, 8)
    for orient in (3, 8):
        exif = Image.Exif()
        exif[274] = orient
        path = str(tmp_path / f"o{orient}.webp")
        _write(path, _pil_bytes(Image.fromarray(rgb), "WEBP", quality=70,
                                exif=exif.tobytes()))
        assert_like_cv2(path)
    rgba = np.concatenate([rgb, _smooth(20, 30, 9)[..., :1]], -1)
    for alpha in (False, True):
        path = str(tmp_path / f"anim{alpha}.webp")
        _write(path, fx.webp_animation(
            (26, 40), [(fx.webp_encode(rgba if alpha else rgb, 60), 2, 4),
                       (fx.webp_encode(rgb, 60), 0, 0)], alpha))
        assert_like_cv2(path)


@pytest.mark.parametrize("seed", range(4))
def test_gif_matches_opencv(tmp_path, seed):
    """Random GIFs of the fixture writer: table sizes 2-256 (2- to 8-bit
    minimum code sizes, codes up to 12 bits), global or local tables (or
    none: cv2's default table),
    interlaced or not, transparency and disposal, frames smaller than the
    logical screen, a second frame, 87a and 89a."""
    fx = _fixtures()
    rng = np.random.default_rng(seed)
    for k in range(6):
        n = int(2 ** rng.integers(1, 9))
        table = rng.integers(0, 256, (n, 3))
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        sh, sw = h + int(rng.integers(0, 5)), w + int(rng.integers(0, 5))
        top, left = int(rng.integers(0, sh - h + 1)), \
            int(rng.integers(0, sw - w + 1))
        idx = rng.integers(0, n, (h, w))
        local = rng.random() < 0.4
        control = (int(rng.integers(0, 4)),
                   int(rng.integers(0, n)) if rng.random() < 0.6 else None)
        frames = [fx.gif_frame(idx, left, top, table if local else None,
                               bool(rng.random() < 0.5),
                               control if rng.random() < 0.8 else None)]
        if rng.random() < 0.4:
            frames.append(fx.gif_frame(rng.integers(0, n, (h, w)), left, top,
                                       control=(1, int(rng.integers(0, n)))))
        path = str(tmp_path / f"{k}.gif")
        _write(path, fx.gif(sw, sh, frames,
                            None if local or k == 5 else table,
                            int(rng.integers(0, n)),
                            b"87a" if rng.random() < 0.3 else b"89a"))
        assert_like_cv2(path)


def test_pillow_gifs_match_opencv(tmp_path):
    """Pillow's GIFs: interlaced (its default from 16 rows), transparent,
    animated."""
    rgb = _smooth(40, 50, 10)
    im = Image.fromarray(rgb).convert("P")
    frames = [Image.fromarray(_smooth(40, 50, s)).convert("P")
              for s in (11, 12)]
    for name, data in (
            ("plain", _pil_bytes(im, "GIF")),
            ("transparent", _pil_bytes(im, "GIF", transparency=7)),
            ("anim", _pil_bytes(frames[0], "GIF", save_all=True,
                                append_images=frames[1:], duration=40))):
        path = str(tmp_path / f"{name}.gif")
        _write(path, data)
        assert_like_cv2(path)


def test_hdr_matches_opencv(tmp_path):
    """cv2's run-length and flat files (widths below 8 are flat), every
    exponent with mantissas 0-255, and a run-length file with a flat last
    scanline."""
    rng = np.random.default_rng(15)
    for w in (1, 7, 8, 33):
        img = np.exp(rng.normal(0, 3, (5, w, 3))).astype(np.float32)
        img[0, 0] = 0
        for params in ([], [cv2.IMWRITE_HDR_COMPRESSION,
                            cv2.IMWRITE_HDR_COMPRESSION_NONE]):
            path = str(tmp_path / f"{w}_{len(params)}.hdr")
            _write(path, cv2.imencode(".hdr", img, params)[1].tobytes())
            assert_like_cv2(path)
    px = np.stack([np.arange(256 * 4) % 256, (np.arange(256 * 4) * 7) % 256,
                   255 - np.arange(256 * 4) % 256,
                   np.repeat(np.arange(256), 4)], -1).astype(np.uint8)
    path = str(tmp_path / "all.hdr")
    _write(path, b"#?RGBE\nEXPOSURE=1.5\nFORMAT=32-bit_rle_rgbe\n\n"
           b"-Y 32 +X 32\n" + px.tobytes())
    assert_like_cv2(path)


@pytest.mark.parametrize("case", ["pfm", "pam", "sun", "hdr_header"])
def test_small_formats_match_opencv(tmp_path, case):
    """PFM (colour and gray, both byte orders, several scales), PAM (every
    tuple type, 8- and 16-bit, maxval 1; the alpha types' colour read, and
    RGB_ALPHA's gray, are memory cv2 never wrote), Sun raster (1, 8, 24 and 32
    bits, colour maps, odd widths, types 0-3) and Radiance headers cv2
    refuses (other orientations, no FORMAT line): equal to cv2, or
    NotImplementedError where cv2 reads nothing."""
    fx = _fixtures()
    rng = np.random.default_rng(16)
    files, undefined = [], {}
    if case == "pfm":
        for c, scale, w in ((3, -1.0, 5), (1, 2.5, 6), (3, 4.0, 1),
                            (1, -0.25, 9)):
            vals = rng.normal(0, 200, (4, w, c)).astype(np.float32)
            vals.flat[0] = 2.5
            vals.flat[-1] = np.nan
            files.append((b"PF\n" if c == 3 else b"Pf\n")
                         + f"{w} 4\n{scale}\n".encode()
                         + vals.astype("<f4" if scale < 0 else ">f4")
                         .tobytes())
        files.append(cv2.imencode(".pfm", rng.normal(0, 3, (4, 5, 3))
                                  .astype(np.float32))[1].tobytes())
    elif case == "pam":
        for kind, depth in (("GRAYSCALE", 1), ("RGB", 3),
                            ("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4),
                            (None, 1), (None, 3), (None, 4),
                            ("BLACKANDWHITE", 1), ("FOO", 3)):
            for maxval in (1, 100, 255, 1000, 65535):
                raster = rng.integers(0, maxval + 1, (4, 7, depth))
                files.append(fx.pam(7, 4, depth, maxval, kind, raster.astype(
                    ">u2" if maxval > 255 else np.uint8).tobytes()))
                undefined[len(files) - 1] = (
                    () if maxval == 1 or not kind or "ALPHA" not in kind
                    else ("color",) if depth == 2 else ("color", "gray"))
    elif case == "sun":
        for depth in (1, 8, 24, 32):
            for kind in (0, 1, 2, 3):
                for mapped in (False, True):
                    w = int(rng.integers(1, 20))
                    nbytes = (w * depth + 7) // 8
                    rows = rng.integers(0, 256, (5, nbytes)).astype(np.uint8)
                    cmap = (rng.integers(0, 256, (1 << depth, 3))
                            if mapped and depth <= 8 else None)
                    files.append(fx.sun(w, 5, depth, rows, kind, cmap))
        gray = rng.integers(0, 256, (1 << 8, 1)).repeat(3, 1)
        files.append(fx.sun(9, 3, 8, rng.integers(0, 256, (3, 9)).astype(
            np.uint8), 1, gray))
    else:
        body = b"\x10\x20\x30\x81" * 6
        for head in (b"+Y 2 +X 3", b"-Y 2 -X 3", b"+X 3 -Y 2", b"-Y2+X3"):
            files.append(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + head
                         + b"\n" + body)
        files.append(b"#?RADIANCE\n\n-Y 2 +X 3\n" + body)
    for k, data in enumerate(files):
        path = str(tmp_path / f"{k}.{case[:3]}")
        _write(path, data)
        assert_like_cv2_or_refused(path, undefined.get(k, ()))


def test_ycbcr_tiff_matches_opencv(tmp_path):
    """YCbCr TIFF (Pillow's): uncompressed with every Y, Cb and Cr code,
    also under other ReferenceBlackWhite and luma coefficients; LZW and
    Deflate."""
    y, cb = np.mgrid[0:256, 0:256]
    codes = np.stack([y, cb, (y * 7 + cb * 13) % 256], -1).astype(np.uint8)
    small = Image.fromarray(_smooth(23, 31, 17)).convert("YCbCr")
    for k, (im, kw) in enumerate((
            (Image.fromarray(codes, "YCbCr"), {}),
            (Image.fromarray(codes, "YCbCr"),
             {"tiffinfo": {532: (16.0, 235.0, 128.0, 240.0, 128.0, 240.0),
                           529: (0.2126, 0.7152, 0.0722)}}),
            (small, {"compression": "tiff_lzw"}),
            (small, {"compression": "tiff_adobe_deflate"}))):
        path = str(tmp_path / f"{k}.tif")
        im.save(path, "TIFF", **kw)
        assert_like_cv2(path)


def test_jpeg2000_and_avif_are_refused_by_name(tmp_path):
    """cv2 reads JPEG 2000 (the JP2 box and a raw codestream) and AVIF.
    Both now read as cv2 reads them (tests/test_torch_jpeg2000.py and
    tests/test_torch_avif.py hold every kind); a JPEG 2000 file cv2 fails
    on (signed samples) raises NotImplementedError naming it."""
    jp2 = cv2.imencode(".jp2", pattern(64, 64))[1].tobytes()
    img = pattern(16, 24)
    for name, data in (("x.jp2", jp2),
                       ("x.j2k", jp2[jp2.index(b"\xff\x4f\xff\x51"):])):
        path = str(tmp_path / name)
        _write(path, data)
        assert np.array_equal(timg.imread(path), cv2.imread(path)), name
    signed = _fixtures().openjpeg_encode(
        [img[..., 0].astype(np.int32) - 128], jp2=False, sgnd=1,
        color_space=2, numresolution=2)
    cases = [("s.j2k", signed, "JPEG 2000 with signed"),
             ("x.avif", _pil_bytes(Image.fromarray(img), "AVIF"), None)]
    for name, data, what in cases:
        path = str(tmp_path / name)
        _write(path, data)
        assert (cv2.imread(path) is None) == (name == "s.j2k"), name
        if what is None:
            assert np.array_equal(timg.imread(path), cv2.imread(path)), name
            continue
        with pytest.raises(NotImplementedError, match=what):
            timg.imread(path)


@pytest.mark.parametrize("kind", ["webp_lossy", "webp_lossless", "gif"])
def test_scene_webp_and_gif_load_like_jax(tmp_path, kind):
    """A 96x128 plane scene's images rewritten as WebP (cv2's lossy, a
    lossless one with alpha) or GIF (Pillow's palette) and renamed in its
    scene.mvs: both packages' load_image give equal arrays, and the port's
    densify loading step (``pipeline.densify._load_images``) gives the
    images the JAX package's densify computes from them (load, scale to
    the working resolution, gray by BT.601)."""
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
    ext = ".gif" if kind == "gif" else ".webp"
    for k, im in enumerate(scene.images):
        png = os.path.join(img_dir, os.path.basename(im.name))
        rgb = np.repeat(cv2.imread(png, cv2.IMREAD_GRAYSCALE)[..., None], 3,
                        -1)
        rgb[..., 0] = np.roll(rgb[..., 0], 3 + k, axis=1)   # some colour
        im.name = os.path.splitext(im.name)[0] + ext
        out = os.path.join(img_dir, os.path.basename(im.name))
        if kind == "webp_lossy":
            cv2.imwrite(out, rgb[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 90])
        elif kind == "webp_lossless":
            alpha = np.full(rgb.shape[:2] + (1,), 200, np.uint8)
            Image.fromarray(np.concatenate([rgb, alpha], -1)).save(
                out, "WEBP", lossless=True)
        else:
            Image.fromarray(rgb).convert("P").save(out)
        for gray in (False, True):
            assert np.array_equal(timg.load_image(out, gray),
                                  jimg.load_image(out, gray)), (out, gray)
    write_mvs(scene_path, scene)
    cfg, jcfg = DenseConfig(), JConfig()
    grays, colors = _load_images(read_mvs(scene_path), img_dir, cfg)
    scale = None
    for k, im in enumerate(scene.images):
        img = jimg.load_image(os.path.join(img_dir, im.name))
        if scale is None:
            scale = jimg.compute_resolution_scale(
                img.shape[1], img.shape[0], jcfg.resolution_level,
                jcfg.max_resolution, jcfg.min_resolution)
        img = jimg.resize_image(img, scale)
        assert colors[k].dtype == img.dtype and np.array_equal(colors[k],
                                                               img), k
        assert np.array_equal(grays[k], jimg.to_gray(img).astype(
            np.float32)), k


# ---- fixtures, helpers, build ----

def test_fixture_manifest_matches_opencv_and_port():
    """The manifest's digests are cv2's (re-derived here), and the port's
    decodes give them in all three modes (and raise where cv2 reads
    nothing)."""
    fixtures = _fixtures()
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    assert manifest == fixtures.manifest_entries(JPEG_DIR)
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(JPEG_DIR) for n in names
               if not n.endswith(".pyc"))
    assert size < int(2.3 * 2 ** 20)
    for name, digests in manifest.items():
        for mode, want in digests.items():
            if want is None:
                with pytest.raises(NotImplementedError):
                    timg.imread(os.path.join(JPEG_DIR, name), mode)
                continue
            img = timg.imread(os.path.join(JPEG_DIR, name), mode)
            assert list(img.shape) == want["shape"], (name, mode)
            assert hashlib.sha256(img.tobytes()).hexdigest() \
                == want["sha256"], (name, mode)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_build_pyramid_and_pad_match_jax(dtype):
    from hcmvs_tpu.io import images as jimg
    rng = np.random.default_rng(21)
    for shape in ((37, 50, 3), (37, 50), (1, 7), (64, 96), (5, 2, 3)):
        img = rng.uniform(0, 255 if dtype == "uint8" else 1, shape)
        img = img.astype(dtype)
        ours, ref = timg.build_pyramid(img, 4), jimg.build_pyramid(img, 4)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), a.shape
        for m in (1, 8, 16):
            (pa, hw_a), (pb, hw_b) = (timg.pad_to_multiple(img, m, 0.5),
                                      jimg.pad_to_multiple(img, m, 0.5))
            assert hw_a == hw_b and np.array_equal(pa, pb)


def test_webp_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build of the WebP decoder raises with g++'s output;
    nothing falls back to another decoder."""
    from hcmvs_tpu_torch import native
    path = str(tmp_path / "x.webp")
    _write(path, cv2.imencode(".webp", pattern(8, 8))[1].tobytes())
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        timg.imread(path)


def test_jpeg_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build of the decoder raises with g++'s output; nothing
    falls back to another decoder."""
    from hcmvs_tpu_torch import native
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, pattern(8, 8))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        timg.imread(path)
