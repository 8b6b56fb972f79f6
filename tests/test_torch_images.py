"""PyTorch port vs OpenCV: the image decoders of ``hcmvs_tpu_torch/io/
images.py`` (``imread``, ``load_image``, ``load_semantic_mask``), and
``build_pyramid`` / ``pad_to_multiple`` vs the JAX package's.

Every decoder is held byte-equal to ``cv2.imread`` in its three modes
(IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED) on files written here:
JPEGs by ``cv2.imwrite`` (qualities 50 / 95 / 100, 4:4:4 / 4:2:2 /
4:2:0 / 4:4:0 / 4:1:1, progressive, optimized Huffman tables, restart
markers, gray) at sizes 1x1, 7x9, 17x33 and 61x83 (partial MCUs) and by
Pillow (an RGB-transform file, progressive 4:2:0); the 8 EXIF
orientations on JPEG and PNG (Pillow); BMP and TIFF variants by
``cv2.imwrite`` and Pillow and by the small writers below (4-bit and RLE
BMP, top-down rows; tiled, planar and predictor-2 TIFF); Adam7 PNG by the
writer below (neither library writes it); P1-P6 PNM at several maxvals.
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
          big_endian: bool = False, orientation=None) -> bytes:
    """A TIFF of (h, w, c) uint8 / uint16 samples (gray, RGB or RGBA with
    unassociated alpha): strips of ``rows`` rows or ``tile`` (tw, th)
    tiles, chunky or planar, predictor 1 or 2, raw or Deflate."""
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
    field(259, 3, [8 if deflate else 1])
    field(262, 3, [1 if c == 1 else 2])
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


@pytest.mark.parametrize("what,make", [
    ("orientation 6", lambda p: Image.fromarray(pattern(4, 5)).save(
        p, tiffinfo={274: 6})),
    ("JPEG-in-TIFF", lambda p: Image.fromarray(pattern(16, 16)).save(
        p, compression="jpeg")),
    ("palette", lambda p: Image.fromarray(pattern(4, 5)).convert("P").save(
        p)),
    ("CMYK", lambda p: Image.fromarray(pattern(4, 5)).convert("CMYK").save(
        p)),
    ("float", lambda p: Image.fromarray(pattern(4, 5, 1)[..., 0].astype(
        np.float32)).save(p))])
def test_tiff_outside_scope_raises(tmp_path, what, make):
    path = str(tmp_path / "x.tif")
    make(path)
    with pytest.raises(NotImplementedError, match=what.split()[0]):
        timg.imread(path)


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


# ---- fixtures, helpers, build ----

def test_fixture_manifest_matches_opencv_and_port():
    """The manifest's digests are cv2's (re-derived here), and the port's
    decodes give them in all three modes."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(JPEG_DIR, "make_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    assert manifest == fixtures.manifest_entries(JPEG_DIR)
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(JPEG_DIR) for n in names
               if not n.endswith(".pyc"))
    assert size < 2 * 2 ** 20
    for name, digests in manifest.items():
        for mode, want in digests.items():
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
