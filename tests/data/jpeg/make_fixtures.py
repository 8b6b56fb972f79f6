"""Writes the fixtures of the port's image decoders and their manifest
(needs numpy, torch, Pillow and OpenCV; runs on the CPU).

    PYTHONPATH=. python tests/data/jpeg/make_fixtures.py
    PYTHONPATH=. python tests/data/jpeg/make_fixtures.py variants

(the second keeps the photos and the JPEG 2000 and AVIF views and
rewrites the rest and the manifest)

- ``photos/p00.jpg`` .. ``p07.jpg``: chip_smoke.py phase 16's scene, the
  ridge of ``make_ridge_scene(default_rng(0))`` at 1280x960 with the blob
  texture, focal 1200 px, views 0.25 apart, put through a radial
  distortion k1 = -0.15 (``distort_images``), as 8-bit RGB (the gray
  render three times) baseline 4:2:0 JPEGs at quality 95 whose APP1
  EXIF holds FocalLengthIn35mmFilm = 33.75 (-> 1200 px).
- ``variants/``: small images (48x64, a seeded pattern), one feature
  each: every chroma sampling cv2 writes, progressive, restart markers,
  optimized Huffman tables, gray, an RGB (Adobe transform 0) file, EXIF
  orientations 6 and 8, and a PNG whose ``eXIf`` chunk holds orientation
  6; a CMYK JPEG (Pillow's, Adobe APP14, inverted) and the same with the
  APP14 transform byte set to 2 (YCCK), cv2 progressive 4:2:0 files cut
  after their first 3 and 6 scans with an EOI appended (read
  block-smoothed), one 40 rows high (a short last iMCU row).
- ``formats/``: TIFF and BMP kinds: JPEG-in-TIFF (Pillow's RGB and
  YCbCr, cv2's ``IMWRITE_TIFF_COMPRESSION_JPEG``), palette, CMYK, float32
  and signed 16-bit (cv2), bilevel min-is-white (Pillow's bilevel TIFF
  with tag 262 set to 0 and its bits inverted); BMPs whose headers are
  written here: 16-bit 5-5-5, bit fields 5-6-5 and 32-bit, OS/2 core
  header at 8 and 24 bits.
- ``formats/*.jp2``, ``*.j2k``: JPEG 2000 kinds (``write_jpeg2000_kinds``):
  Pillow's options, cv2's encoder at 8 and 16 bits, libopenjp2's encoder
  through ctypes (``openjpeg_encode``: code-block styles, progressions,
  SOP / EPH, POC, ROI, tile-parts, precisions, TLM / PLT), and by hand
  packet headers in PPT / PPM, PLM / CRG / COM markers, palette, cdef,
  sYCC / eYCC / CMYK / ICC colour boxes, reordered tile-parts and cut
  codestreams; with the kinds cv2 fails on.
- ``formats/*.avif``: AVIF kinds (``write_avif_kinds``): Pillow's
  qualities, speeds, chroma samplings, alpha, Exif and aom tool switches
  (palette, intra block copy, filter intra, CfL, CDEF, restoration,
  tiles, delta q, 128x128 superblocks, quantiser matrices, film grain,
  lossless), animations; cv2's encoder at 8, 10 and 12 bits; and HEIF
  boxes written here around Pillow's AV1 payloads (grids, an alpha item,
  idat, irot / imir / clap, every nclx matrix in both ranges); with the
  kinds cv2 fails on.
- ``jp2_views/v0.jp2`` .. ``v3.jp2``: views 0-3 of the photos' ridge
  scene at 1280x960, undistorted, as colour 9/7 JP2 files in two quality
  layers, RPCL, 512x512 tiles and precincts (chip_smoke.py phase 27's
  densify run); ``avif_views/v0.avif`` .. ``v3.avif``: the same views as
  Pillow's AVIF at quality 90, 4:2:0, 8-bit, 2 x 2 tiles (phase 27's
  densify-avif run).
- ``manifest.json``: for each file and each of ``cv2.imread``'s
  IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED, the shape and the
  sha256 of the array cv2 returns (C order, cv2's BGR channel order), or
  null where cv2 returns none (a float TIFF read as 8-bit): the port
  raises NotImplementedError there.

``tests/test_torch_images.py`` re-derives every digest from cv2, so the
manifest cannot go stale; ``chip_smoke.py`` holds the port's decodes to
it where no cv2 exists.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHOTO_HW = (960, 1280)
PHOTO_VIEWS = 8
PHOTO_K1 = -0.15
PHOTO_QUALITY = 95
MODES = ("color", "gray", "unchanged")


def ridge_scene(h: int, w: int, n_views: int = PHOTO_VIEWS,
                device: str = "cpu"):
    """Phase 16's ridge at h x w (focal 1200 w / 1280, views 0.25 apart,
    blob texture summed in torch on ``device``), rendered."""
    from hcmvs_tpu_torch.utils.synth import blob_texture_fn, make_ridge_scene
    return make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                            n_views=n_views, fx=1200.0 * w / 1280,
                            spacing=0.25, texture_fn=blob_texture_fn(
                                np.random.default_rng(0), device=device))


def ridge_photos(h: int, w: int, n_views: int = PHOTO_VIEWS,
                 device: str = "cpu"):
    """(scene, uint8 photos): ``ridge_scene`` through k1."""
    from hcmvs_tpu_torch.utils.synth import distort_images
    sc = ridge_scene(h, w, n_views, device)
    K = np.asarray(sc.cameras[0].K)
    photos = distort_images(sc.images, K, np.array([PHOTO_K1, 0.0, 0.0]))
    return sc, [(np.clip(p, 0, 1) * 255).astype(np.uint8) for p in photos]


def focal_exif(focal_35mm: float) -> bytes:
    """An EXIF block holding FocalLengthIn35mmFilm, as Pillow writes it."""
    from PIL import Image
    exif = Image.Exif()
    exif.get_ifd(0x8769)[41989] = focal_35mm
    return exif.tobytes()


def save_jpeg_photos(photo_dir: str, photos, focal_35mm: float):
    """Each (H, W) uint8 photo as ``p%02d.jpg``: RGB, baseline 4:2:0,
    quality 95, FocalLengthIn35mmFilm in its EXIF; returns the paths."""
    from PIL import Image
    os.makedirs(photo_dir, exist_ok=True)
    paths = []
    for i, im in enumerate(photos):
        paths.append(os.path.join(photo_dir, f"p{i:02d}.jpg"))
        Image.fromarray(np.repeat(im[..., None], 3, -1)).save(
            paths[-1], "JPEG", quality=PHOTO_QUALITY, subsampling=2,
            exif=focal_exif(focal_35mm))
    return paths


def pattern(h: int = 48, w: int = 64) -> np.ndarray:
    """(h, w, 3) uint8 RGB: smooth colour ramps plus seeded noise, so that
    every chroma sampling and the upsampling's edges are exercised."""
    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / 5 + y / 9),
                    128 + 90 * np.cos(x / 7 - y / 4),
                    128 + 90 * np.sin((x + y) / 6)], -1)
    return np.clip(img + rng.normal(0, 18, img.shape), 0,
                   255).astype(np.uint8)


def write_variants(var_dir: str):
    """The small variants; returns their paths."""
    import cv2
    from PIL import Image
    os.makedirs(var_dir, exist_ok=True)
    rgb = pattern()
    bgr = rgb[..., ::-1]
    out = []
    cv2_cases = {
        "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
        "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
        "s420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
        "s440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
        "s411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111],
        "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
        "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    }
    for name, params in cv2_cases.items():
        out.append(os.path.join(var_dir, f"{name}.jpg"))
        cv2.imwrite(out[-1], bgr, [cv2.IMWRITE_JPEG_QUALITY, 90] + params)
    out.append(os.path.join(var_dir, "gray.jpg"))
    cv2.imwrite(out[-1], rgb[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    out.append(os.path.join(var_dir, "rgb.jpg"))
    Image.fromarray(rgb).save(out[-1], "JPEG", quality=90, keep_rgb=True)
    for orient in (6, 8):
        exif = Image.Exif()
        exif[274] = orient
        out.append(os.path.join(var_dir, f"orient{orient}.jpg"))
        Image.fromarray(rgb).save(out[-1], "JPEG", quality=90,
                                  exif=exif.tobytes())
    exif = Image.Exif()
    exif[274] = 6
    out.append(os.path.join(var_dir, "orient6.png"))
    Image.fromarray(rgb).save(out[-1], "PNG", exif=exif.tobytes())
    return out


def cut_after_scans(data: bytes, k: int) -> bytes:
    """A JPEG's bytes up to its (k + 1)-th SOS marker, then EOI: the file
    as its first ``k`` scans leave it."""
    pos, seen = 2, 0
    while pos < len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or \
                0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if marker == 0xD8:
            pos += 2
            continue
        if marker == 0xDA:
            if seen == k:
                return data[:pos] + b"\xff\xd9"
            seen += 1
        (length,) = struct.unpack_from(">H", data, pos + 2)
        pos += 2 + length
    raise ValueError(f"fewer than {k + 1} scans")


def write_jpeg_kinds(var_dir: str):
    """CMYK, YCCK and cut progressive JPEGs; returns their paths."""
    import cv2
    from PIL import Image
    rgb = pattern()
    out = [os.path.join(var_dir, n) for n in (
        "cmyk.jpg", "ycck.jpg", "prog_cut3.jpg", "prog_cut6.jpg",
        "prog_cut3_h40.jpg")]
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", quality=90)
    cmyk = buf.getvalue()
    at = cmyk.index(b"Adobe") + 11          # the APP14 transform byte
    ycck = cmyk[:at] + b"\2" + cmyk[at + 1:]
    files = [cmyk, ycck]
    for img, k in ((rgb, 3), (rgb, 6), (rgb[:40], 3)):
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, 90,
                                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111])
        files.append(cut_after_scans(enc.tobytes(), k))
    for path, data in zip(out, files):
        with open(path, "wb") as f:
            f.write(data)
    return out


def min_is_white(data: bytes) -> bytes:
    """An uncompressed gray TIFF turned min-is-white: IFD0's photometric
    (tag 262) set to 0 and every strip's bytes inverted."""
    out = bytearray(data)
    end = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(end + "I", data, 4)
    (n,) = struct.unpack_from(end + "H", data, ifd)
    fields = {}
    for e in range(n):
        at = ifd + 2 + 12 * e
        tag, typ, count = struct.unpack_from(end + "HHI", data, at)
        code = "H" if typ == 3 else "I"
        inline = count * struct.calcsize(code) <= 4
        where = at + 8 if inline else struct.unpack_from(end + "I", data,
                                                         at + 8)[0]
        fields[tag] = (at, struct.unpack_from(end + code * count, data,
                                              where))
    struct.pack_into(end + "H", out, fields[262][0] + 8, 0)
    for off, cnt in zip(fields[273][1], fields[279][1]):
        out[off:off + cnt] = bytes(b ^ 0xFF for b in data[off:off + cnt])
    return bytes(out)


def bmp(w: int, h: int, bpp: int, body: bytes, comp: int = 0,
        masks=(), palette=b"", core: bool = False) -> bytes:
    """A BMP file written here: the OS/2 core header (12 bytes, 3-byte
    palette entries) with ``core``, else BITMAPINFOHEADER with the bit
    field ``masks`` (R, G, B) after it."""
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, comp,
                           len(body), 2835, 2835, 0, 0)
    extra = struct.pack("<" + "I" * len(masks), *masks) + palette
    offset = 14 + len(info) + len(extra)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + extra + body)


def bmp_rows(pixels: np.ndarray, bpp: int) -> bytes:
    """Bottom-up rows, each padded to 4 bytes: ``pixels`` (h, w) 8-bit
    indices or 16-bit words, or (h, w, c) bytes."""
    h = pixels.shape[0]
    rows = pixels.reshape(h, -1).astype("<u2" if bpp == 16 else np.uint8)
    stride = ((pixels.shape[1] * bpp + 31) // 32) * 4
    return b"".join(r.tobytes().ljust(stride, b"\0") for r in rows[::-1])


def write_formats(fmt_dir: str):
    """The TIFF and BMP kinds; returns their paths."""
    import cv2
    from PIL import Image
    os.makedirs(fmt_dir, exist_ok=True)
    rgb = pattern()
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(13)
    files = {}

    def pil(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "TIFF", **kw)
        return buf.getvalue()

    files["jpeg.tif"] = pil(Image.fromarray(rgb), compression="jpeg",
                            quality=80)
    files["jpeg_ycbcr.tif"] = pil(Image.fromarray(rgb).convert("YCbCr"),
                                  compression="jpeg", quality=80)
    files["palette.tif"] = pil(Image.fromarray(rgb).convert("P"))
    files["cmyk.tif"] = pil(Image.fromarray(rgb).convert("CMYK"))
    files["min_is_white.tif"] = min_is_white(pil(
        Image.fromarray(rgb[..., 0]).convert("1")))
    for name, img, params in (
            # 40 rows: at 48 cv2's strips are not whole JPEG rows of 8 and
            # its own write fails
            ("jpeg_cv2.tif", bgr[:40], [cv2.IMWRITE_TIFF_COMPRESSION,
                                        cv2.IMWRITE_TIFF_COMPRESSION_JPEG]),
            ("float32.tif", bgr.astype(np.float32) / 7.0 - 3.0, []),
            ("int16.tif", rgb[..., 1].astype(np.int16) * 250 - 30000, [])):
        ok, enc = cv2.imencode(".tif", img, params)
        files[name] = enc.tobytes()
    words = rng.integers(0, 1 << 16, (h, w))
    files["rgb555.bmp"] = bmp(w, h, 16, bmp_rows(words, 16))
    files["bitfields565.bmp"] = bmp(w, h, 16, bmp_rows(words, 16), 3,
                                    (0xF800, 0x7E0, 0x1F))
    bgra = np.concatenate([bgr, rgb[..., :1]], -1)
    files["bitfields32.bmp"] = bmp(w, h, 32, bmp_rows(bgra, 32), 3,
                                   (0xFF0000, 0xFF00, 0xFF))
    files["os2_24.bmp"] = bmp(w, h, 24, bmp_rows(bgr, 24), core=True)
    files["os2_8.bmp"] = bmp(w, h, 8, bmp_rows(rgb[..., 2], 8),
                             palette=bytes(rng.integers(0, 256, 768)
                                           .astype(np.uint8)), core=True)
    out = []
    for name, data in files.items():
        out.append(os.path.join(fmt_dir, name))
        with open(out[-1], "wb") as f:
            f.write(data)
    return out


def libwebp():
    """Pillow's bundled libwebp, for its advanced encoding API (token
    partitions, the simple loop filter, sharpness, alpha options)."""
    import ctypes
    import glob
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])


# WebPConfig's fields (libwebp 1.x): byte offsets of the int fields set
_WEBP_CONFIG = {"lossless": 0, "method": 8, "segments": 24, "sns": 28,
                "strength": 32, "sharpness": 36, "filter_type": 40,
                "autofilter": 44, "alpha_compression": 48,
                "alpha_filtering": 52, "alpha_quality": 56,
                "partitions": 72, "near_lossless": 92, "exact": 96}


def webp_encode(img: np.ndarray, quality: float = 80.0, **options) -> bytes:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 as a WebP through libwebp's
    WebPEncode with the WebPConfig ``options`` (the keys of
    ``_WEBP_CONFIG``; token partitions need method 0-2, where libwebp
    writes tokens straight to their partitions)."""
    import ctypes
    lib = libwebp()
    h, w, c = img.shape
    cfg = ctypes.create_string_buffer(512)
    pic = ctypes.create_string_buffer(1024)
    abi = 0x0209
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in options.items():
        struct.pack_into("<i", cfg, _WEBP_CONFIG[key], int(value))
    if not lib.WebPValidateConfig(cfg) or \
            not lib.WebPPictureInitInternal(pic, abi):
        raise RuntimeError(f"invalid WebP options {options}")
    struct.pack_into("<iiii", pic, 0, 0, 0, w, h)
    buf = np.ascontiguousarray(img)
    imp = lib.WebPPictureImportRGB if c == 3 else lib.WebPPictureImportRGBA
    if not imp(pic, buf.ctypes.data_as(ctypes.c_void_p), w * c):
        raise RuntimeError("WebPPictureImport failed")
    writer = ctypes.create_string_buffer(64)
    lib.WebPMemoryWriterInit(writer)
    # WebPPicture's writer and custom_ptr
    struct.pack_into("<QQ", pic, 96,
                     ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value,
                     ctypes.addressof(writer))
    ok = lib.WebPEncode(cfg, pic)
    mem, size = struct.unpack_from("<QQ", writer, 0)
    out = ctypes.string_at(mem, size)
    lib.WebPMemoryWriterClear(writer)
    lib.WebPPictureFree(pic)
    if not ok:
        raise RuntimeError(f"WebPEncode failed ({options})")
    return out


def riff_chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff_chunks(data: bytes) -> list:
    """(tag, body) of a WebP file's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_file(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def vp8x(flags: int, w: int, h: int) -> bytes:
    return riff_chunk(b"VP8X", struct.pack("<I", flags)
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def alpha_filtered(alpha: np.ndarray, kind: int) -> np.ndarray:
    """The residuals of the ALPH filter ``kind`` (0 none, 1 horizontal, 2
    vertical, 3 gradient) of an (H, W) alpha plane: the first row from
    its left neighbour, the first column (below the first row) from the
    pixel above."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    if kind:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if kind == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif kind == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1],
                                   0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def webp_with_alpha(rgb: np.ndarray, alpha: np.ndarray, kind: int,
                    compressed: bool, quality: float = 80.0) -> bytes:
    """A VP8X file: libwebp's lossy ``rgb`` and an ALPH chunk written
    here, its ``alpha`` under filter ``kind``, raw or (``compressed``)
    as a lossless stream (Pillow's lossless encode of the residuals as
    green, its 5-byte VP8L header dropped); the chunk's pre-processing
    bits say level reduction when ``compressed``."""
    import io
    from PIL import Image
    h, w = alpha.shape
    res = alpha_filtered(alpha, kind)
    if compressed:
        buf = io.BytesIO()
        zeros = np.zeros_like(res)
        Image.fromarray(np.stack([zeros, res, zeros], -1)).save(
            buf, "WEBP", lossless=True, quality=100, method=6)
        vp8l = dict(riff_chunks(buf.getvalue()))[b"VP8L"]
        body = bytes([1 | kind << 2 | 1 << 4]) + vp8l[5:]
    else:
        body = bytes([kind << 2]) + res.tobytes()
    vp8 = dict(riff_chunks(webp_encode(rgb, quality)))[b"VP8 "]
    return webp_file(vp8x(0x10, w, h) + riff_chunk(b"ALPH", body)
                     + riff_chunk(b"VP8 ", vp8))


def webp_animation(canvas_hw, frames, alpha: bool) -> bytes:
    """An animated WebP of ``frames`` ((still WebP bytes, x, y) each, x
    and y even) on a canvas of ``canvas_hw``."""
    h, w = canvas_hw
    body = vp8x(0x02 | (0x10 if alpha else 0), w, h)
    body += riff_chunk(b"ANIM", struct.pack("<IH", 0, 0))
    for data, x, y in frames:
        inner = [(t, b) for t, b in riff_chunks(data)
                 if t in (b"ALPH", b"VP8 ", b"VP8L")]
        fw, fh = _webp_size(data)
        head = b"".join(v.to_bytes(3, "little")
                        for v in (x // 2, y // 2, fw - 1, fh - 1, 100))
        body += riff_chunk(b"ANMF", head + b"\0" + b"".join(
            riff_chunk(t, b) for t, b in inner))
    return webp_file(body)


def _webp_size(data: bytes):
    chunks = dict(riff_chunks(data))
    if b"VP8L" in chunks:
        (bits,) = struct.unpack_from("<I", chunks[b"VP8L"], 1)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    frame = chunks[b"VP8 "]
    return (struct.unpack_from("<H", frame, 6)[0] & 0x3FFF,
            struct.unpack_from("<H", frame, 8)[0] & 0x3FFF)


def lzw_gif(idx: np.ndarray, min_size: int) -> bytes:
    """GIF's LZW of a run of indices (codes least significant bit first,
    a Clear first and whenever the table is full)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    width, table, nxt = min_size + 1, {}, eoi + 1
    emit(clear, width)
    prev = None
    for p in idx.reshape(-1).tolist():
        if prev is None:
            prev = (p,)
            continue
        key = prev + (p,)
        if key in table:
            prev = key
            continue
        emit(table[prev] if len(prev) > 1 else prev[0], width)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear, width)
            table, nxt, width = {}, eoi + 1, min_size + 1
        prev = (p,)
    if prev is not None:
        emit(table[prev] if len(prev) > 1 else prev[0], width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_frame(idx: np.ndarray, left: int = 0, top: int = 0, local=None,
              interlace: bool = False, control=None) -> bytes:
    """A GIF image (graphic control extension (disposal, transparent
    index or None) first when ``control``)."""
    h, w = idx.shape
    out = b""
    if control is not None:
        disposal, transparent = control
        flags = disposal << 2 | (transparent is not None)
        out += b"\x21\xf9\x04" + bytes([flags]) + struct.pack(
            "<HB", 5, transparent or 0) + b"\0"
    flags = 0x40 if interlace else 0
    if local is not None:
        flags |= 0x80 | (int(np.log2(len(local))) - 1)
    out += b"\x2c" + struct.pack("<4HB", left, top, w, h, flags)
    if local is not None:
        out += np.asarray(local, np.uint8).tobytes()
    rows = idx
    if interlace:
        rows = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                   np.arange(2, h, 4), np.arange(1, h, 2)])]
    min_size = max(2, int(np.ceil(np.log2(max(2, int(idx.max()) + 1)))))
    data = lzw_gif(rows, min_size)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return out + bytes([min_size]) + blocks + b"\0"


def gif(w: int, h: int, frames, table=None, background: int = 0,
        version: bytes = b"89a") -> bytes:
    flags = 0
    if table is not None:
        flags = 0xF0 | (int(np.log2(len(table))) - 1)
    out = b"GIF" + version + struct.pack("<2H3B", w, h, flags, background, 0)
    if table is not None:
        out += np.asarray(table, np.uint8).tobytes()
    return out + b"".join(frames) + b"\x3b"


def sun(w: int, h: int, depth: int, rows: np.ndarray, kind: int = 1,
        cmap=None) -> bytes:
    """A Sun raster written here: ``rows`` (h, bytes) padded to 16 bits
    a row (type 2: then run-length coded), ``cmap`` (n, 3) RGB written as
    three planes."""
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    body = b"".join(r.tobytes().ljust(pitch, b"\0") for r in rows)
    if kind == 2:                      # byte-encoded: 0x80 runs
        out, i = bytearray(), 0
        while i < len(body):
            j = i
            while j < len(body) and body[j] == body[i] and j - i < 256:
                j += 1
            if j - i >= 3 or body[i] == 0x80:    # a run, or one 0x80
                out += (bytes([0x80, j - i - 1, body[i]]) if j - i > 1
                        else b"\x80\0")
                i = j
            else:
                out.append(body[i])
                i += 1
        body = bytes(out)
    cm = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind,
                       1 if cmap is not None else 0, len(cm)) + cm + body


def pam(w: int, h: int, depth: int, maxval: int, kind, raster: bytes
        ) -> bytes:
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
    if kind:
        head += f"TUPLTYPE {kind}\n"
    return (head + "ENDHDR\n").encode() + raster


def write_image_kinds(fmt_dir: str):
    """The WebP, GIF, Radiance HDR, PFM, PAM, Sun raster and YCbCr TIFF
    kinds; returns their paths."""
    import io
    import cv2
    from PIL import Image
    os.makedirs(fmt_dir, exist_ok=True)
    rgb = pattern()
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(14)
    y, x = np.mgrid[0:h, 0:w]
    alpha = np.clip(128 + 120 * np.sin(x / 5) * np.cos(y / 7)
                    + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    files = {}

    def pil(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    # lossy WebP: cv2's own, then libwebp's encoder at several qualities
    # and methods (segments, 1-8 token partitions, both loop filters,
    # sharpness, the loop filter off)
    ok, enc = cv2.imencode(".webp", bgr)
    files["webp_cv2.webp"] = enc.tobytes()
    for name, quality, opts in (
            ("webp_q5_m0_p8_simple", 5, dict(method=0, partitions=3,
                                              filter_type=0)),
            ("webp_q30_m1_p2_simple", 30, dict(method=1, partitions=1,
                                               filter_type=0, sharpness=3)),
            ("webp_q60_m2_p4_sharp6", 60, dict(method=2, partitions=2,
                                               sharpness=6, strength=90)),
            ("webp_q90_m4_seg4", 90, dict(method=4, segments=4, sns=100,
                                          autofilter=1)),
            ("webp_q100_m6_seg1", 100, dict(method=6, segments=1)),
            ("webp_q75_nofilter", 75, dict(method=3, strength=0))):
        files[name + ".webp"] = webp_encode(rgb, quality, **opts)
    # a flat half: skipped macroblocks (the skip probability) and DC
    # prediction on the left edge
    flat = rgb.copy()
    flat[:, :w // 2] = 120
    files["webp_flat_m0.webp"] = webp_encode(flat, 80, method=0)
    # lossy with alpha: libwebp's own alpha, and ALPH chunks written here
    # under each filter, raw and compressed
    files["webp_alpha_libwebp.webp"] = webp_encode(
        rgba, 80, alpha_filtering=2, alpha_quality=60)
    for kind, fname in enumerate(("none", "horizontal", "vertical",
                                  "gradient")):
        for comp in (False, True):
            files[f"webp_alpha_{fname}_{'vp8l' if comp else 'raw'}.webp"] \
                = webp_with_alpha(rgb, alpha, kind, comp)
    # lossless: RGB and RGBA (predictors, cross colour, subtract green,
    # colour cache, meta prefix codes), and palettes of 2, 4, 16 and 200
    # colours (colour indexing bundling 8, 4, 2 and 1 pixels)
    files["webp_lossless.webp"] = pil(Image.fromarray(rgb), "WEBP",
                                      lossless=True, quality=100, method=6)
    files["webp_lossless_alpha.webp"] = pil(Image.fromarray(rgba), "WEBP",
                                            lossless=True, quality=50,
                                            method=4)
    files["webp_lossless_fast.webp"] = webp_encode(rgba, 0, lossless=1,
                                                   method=0, exact=1)
    # a mosaic whose tiles take the predictors the pattern does not (above,
    # above-right, above-left, the clamped gradient)
    quads = [np.sin(x * 1.7), np.sin((x + y) * 1.3), np.sin((x - y) * 1.1)]
    mosaic = np.stack([q * 100 + 128 for q in quads], -1)
    mosaic[24:, 32:] = np.stack([x * 3 + y * 2, x * 2 + y * 4,
                                 255 - x - y * 3], -1)[24:, 32:]
    mosaic[:24, :32] = mosaic[:24, :32, :1]
    mosaic[:24, 32:] = mosaic[:24, 32:, 1:2]
    mosaic[24:, :32] = mosaic[24:, :32, 2:]
    files["webp_lossless_mosaic.webp"] = pil(
        Image.fromarray(np.clip(mosaic, 0, 255).astype(np.uint8)), "WEBP",
        lossless=True, quality=100, method=6)
    for n in (2, 4, 16, 200):
        pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        pal[:, 3] = 255 if n != 4 else pal[:, 3]
        idx = (x // 3 + y // 5 + rng.integers(0, 2, (h, w))) % n
        files[f"webp_palette{n}.webp"] = pil(Image.fromarray(pal[idx]),
                                             "WEBP", lossless=True,
                                             quality=100, method=5)
    # EXIF orientation 6, and animations (the first frame is what cv2
    # reads: one lossy on a larger canvas, at an offset; one lossless
    # with alpha)
    exif = Image.Exif()
    exif[274] = 6
    files["webp_orient6.webp"] = pil(Image.fromarray(rgb), "WEBP",
                                     quality=80, exif=exif.tobytes())
    files["webp_anim.webp"] = webp_animation(
        (h + 8, w + 6), [(webp_encode(rgb, 70), 4, 6),
                         (webp_encode(rgb[::-1], 70), 0, 0)], alpha=False)
    small = rgba[:24, :32]
    files["webp_anim_alpha.webp"] = webp_animation(
        (24, 32), [(pil(Image.fromarray(small), "WEBP", lossless=True), 0,
                    0), (pil(Image.fromarray(small[::-1]), "WEBP",
                             lossless=True), 0, 0)], alpha=True)
    # GIF: 87a and 89a, global and local tables, interlaced, transparent
    # (BGRA unchanged), a logical screen larger than the frame (the
    # background colour around it), an animation, 2- to 12-bit codes
    pal = rng.integers(0, 256, (256, 3))
    idx16 = (x // 4 + y // 3) % 16
    files["gif87a.gif"] = gif(w, h, [gif_frame(idx16)], pal[:16],
                              version=b"87a")
    files["gif_local_interlaced.gif"] = gif(
        w, h, [gif_frame(idx16, local=pal[16:32], interlace=True)])
    files["gif_transparent.gif"] = gif(w, h, [gif_frame(idx16,
                                                        control=(0, 5))],
                                       pal[:16])
    files["gif_screen.gif"] = gif(w + 10, h + 6, [gif_frame(
        idx16[:40, :50], left=7, top=3, control=(2, None))], pal[:16],
        background=9)
    files["gif_anim.gif"] = gif(w, h, [gif_frame(idx16, control=(1, None)),
                                       gif_frame(idx16[::-1],
                                                 control=(0, 3))],
                                pal[:16])
    files["gif_2color.gif"] = gif(w, h, [gif_frame(
        rng.integers(0, 2, (h, w)))], pal[:2])
    files["gif_256.gif"] = gif(64, 64, [gif_frame(
        rng.integers(0, 256, (64, 64)))], pal)
    files["gif_pillow.gif"] = pil(Image.fromarray(rgb).convert("P"), "GIF")
    # Radiance HDR: cv2's run-length file and flat file; every exponent
    # and the mantissa edges (written flat); a run-length file whose last
    # scanline is flat (cv2 reads the rest flat)
    hdr_img = np.exp(rng.normal(0, 2.5, (h, w, 3))).astype(np.float32)
    files["hdr_rle.hdr"] = cv2.imencode(".hdr", hdr_img)[1].tobytes()
    files["hdr_flat.hdr"] = cv2.imencode(".hdr", hdr_img, [
        cv2.IMWRITE_HDR_COMPRESSION,
        cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes()
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 32 +X 32\n"
    e = np.arange(1024) % 256
    mant = np.array([0, 1, 2, 127, 128, 129, 254, 255])
    px = np.stack([mant[np.arange(1024) % 8], mant[(np.arange(1024) // 8)
                                                   % 8],
                   255 - mant[np.arange(1024) % 8], e], -1)
    files["hdr_exponents.hdr"] = head + px.astype(np.uint8).tobytes()
    top = cv2.imencode(".hdr", hdr_img[:-1])[1].tobytes()
    files["hdr_rle_then_flat.hdr"] = top.replace(
        f"-Y {h - 1} +X {w}\n".encode(), f"-Y {h} +X {w}\n".encode()) + \
        px[:w].astype(np.uint8).tobytes()
    # PFM (little- and big-endian, colour and gray) and PAM
    flt = (rgb[:24, :32].astype(np.float32) / 37.0 - 2.0)
    files["pfm_color.pfm"] = cv2.imencode(".pfm", flt[..., ::-1].copy())[
        1].tobytes()
    files["pfm_gray_be.pfm"] = "Pf\n32 24\n2.5\n".encode() + \
        flt[::-1, :, 1].astype(">f4").tobytes()
    files["pam_rgb.pam"] = pam(w, h, 3, 255, "RGB", rgb.tobytes())
    files["pam_gray16.pam"] = pam(w, h, 1, 65535, "GRAYSCALE",
                                  (rgb[..., 0].astype(">u2") * 257
                                   + x.astype(">u2")).tobytes())
    files["pam_bw.pam"] = pam(w, h, 1, 1, "BLACKANDWHITE",
                              (rgb[..., :1] > 128).astype(np.uint8)
                              .tobytes())
    files["pam_gray_alpha_bw.pam"] = pam(w, h, 2, 1, "GRAYSCALE_ALPHA",
                                         (rgb[..., :2] > 100).astype(
                                             np.uint8).tobytes())
    for c in (3, 4):
        files[f"pam_cv2_{c}ch.pam"] = cv2.imencode(
            ".pam", np.ascontiguousarray(rgba[..., :c]))[1].tobytes()
    # Sun raster: cv2's 8- and 24-bit; 1- and 8-bit with colour maps (one
    # all gray), 1-bit without, 24-bit of an odd width (rows padded to 16
    # bits), 32-bit; byte-encoded and RGB-order files, on which cv2 fails
    files["sun_cv2_24.ras"] = cv2.imencode(".ras", bgr)[1].tobytes()
    files["sun_cv2_8.ras"] = cv2.imencode(".ras", rgb[..., 1])[1].tobytes()
    bits = np.packbits(rgb[..., 0] > 128, axis=1)
    files["sun_1bit.ras"] = sun(w, h, 1, bits)
    files["sun_1bit_map.ras"] = sun(w, h, 1, bits,
                                    cmap=[[200, 30, 40], [10, 220, 90]])
    cmap = rng.integers(0, 256, (256, 3))
    files["sun_8bit_map.ras"] = sun(w, h, 8, rgb[..., 2], cmap=cmap)
    files["sun_8bit_graymap.ras"] = sun(w, h, 8, rgb[..., 2],
                                        cmap=np.repeat(cmap[:, :1], 3, 1))
    files["sun_24_odd.ras"] = sun(w - 1, h, 24, bgr[:, :w - 1].reshape(
        h, -1))
    xbgr = np.concatenate([alpha[..., None], bgr], -1)
    files["sun_32.ras"] = sun(w, h, 32, xbgr.reshape(h, -1))
    files["sun_rle.ras"] = sun(w, h, 8, rgb[..., 2], kind=2)
    files["sun_rgb.ras"] = sun(w, h, 24, rgb.reshape(h, -1), kind=3)
    # YCbCr TIFF, uncompressed (Pillow writes ReferenceBlackWhite), LZW
    # and Deflate (libtiff's default ReferenceBlackWhite), and one with
    # other references and luma coefficients
    ycc = Image.fromarray(rgb).convert("YCbCr")
    files["ycbcr.tif"] = pil(ycc, "TIFF")
    files["ycbcr_lzw.tif"] = pil(ycc, "TIFF", compression="tiff_lzw")
    files["ycbcr_deflate.tif"] = pil(ycc, "TIFF",
                                     compression="tiff_adobe_deflate")
    files["ycbcr_refbw.tif"] = pil(ycc, "TIFF", tiffinfo={
        532: (16.0, 235.0, 128.0, 240.0, 128.0, 240.0),
        529: (0.2126, 0.7152, 0.0722)})
    out = []
    for name, data in files.items():
        out.append(os.path.join(fmt_dir, name))
        with open(out[-1], "wb") as f:
            f.write(data)
    return out


def photo_webps(fmt_dir: str):
    """p00 (the committed 1280x960 photo) as a lossy WebP at quality 90
    and as a lossless one; returns their paths."""
    from PIL import Image
    im = Image.open(os.path.join(HERE, "photos", "p00.jpg"))
    out = [os.path.join(fmt_dir, "p00_q90.webp"),
           os.path.join(fmt_dir, "p00_lossless.webp")]
    im.save(out[0], "WEBP", quality=90)
    im.save(out[1], "WEBP", lossless=True)
    return out


# ---- JPEG 2000 ----

def libopenjp2():
    """Pillow's bundled libopenjp2 (OpenJPEG 2.5), for the encoder options
    Pillow does not expose (code-block styles, SOP / EPH, POC, ROI,
    precisions, signed samples, offsets, sub-sampling, TLM / PLT)."""
    import ctypes
    import glob
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
    for fn in ("opj_create_compress", "opj_image_create",
               "opj_stream_create_default_file_stream"):
        getattr(lib, fn).restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          ctypes.c_int]
    return lib


def _opj_structs():
    """ctypes layouts of openjpeg.h 2.5's opj_cparameters_t,
    opj_image_cmptparm_t and the head of opj_image_t / opj_image_comp_t."""
    import ctypes
    U, I = ctypes.c_uint32, ctypes.c_int

    class Poc(ctypes.Structure):
        _fields_ = ([(n, U) for n in ("resno0 compno0 layno1 resno1 compno1 "
                                      "layno0 precno0 precno1").split()]
                    + [("prg1", I), ("prg", I),
                       ("progorder", ctypes.c_char * 5), ("tile", U)]
                    + [(n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0",
                                                     "ty1")]
                    + [(n, U) for n in ("layS resS compS prcS layE resE "
                                        "compE prcE txS txE tyS tyE dx dy "
                                        "lay_t res_t comp_t prc_t tx0_t "
                                        "ty0_t").split()])

    class CParams(ctypes.Structure):
        _fields_ = (
            [(n, I) for n in ("tile_size_on cp_tx0 cp_ty0 cp_tdx cp_tdy "
                              "cp_disto_alloc cp_fixed_alloc "
                              "cp_fixed_quality").split()]
            + [("cp_matrice", ctypes.c_void_p),
               ("cp_comment", ctypes.c_char_p), ("csty", I),
               ("prog_order", I), ("POC", Poc * 32), ("numpocs", U),
               ("tcp_numlayers", I), ("tcp_rates", ctypes.c_float * 100),
               ("tcp_distoratio", ctypes.c_float * 100)]
            + [(n, I) for n in ("numresolution cblockw_init cblockh_init "
                                "mode irreversible roi_compno roi_shift "
                                "res_spec").split()]
            + [("prcw_init", I * 33), ("prch_init", I * 33),
               ("infile", ctypes.c_char * 4096),
               ("outfile", ctypes.c_char * 4096), ("index_on", I),
               ("index", ctypes.c_char * 4096)]
            + [(n, I) for n in ("image_offset_x0 image_offset_y0 "
                                "subsampling_dx subsampling_dy decod_format "
                                "cod_format jpwl_epc_on "
                                "jpwl_hprot_MH").split()]
            + [(n, I * 16) for n in ("jpwl_hprot_TPH_tileno jpwl_hprot_TPH "
                                     "jpwl_pprot_tileno jpwl_pprot_packno "
                                     "jpwl_pprot").split()]
            + [(n, I) for n in ("jpwl_sens_size jpwl_sens_addr "
                                "jpwl_sens_range jpwl_sens_MH").split()]
            + [("jpwl_sens_TPH_tileno", I * 16), ("jpwl_sens_TPH", I * 16),
               ("cp_cinema", I), ("max_comp_size", I), ("cp_rsiz", I),
               ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
               ("tcp_mct", ctypes.c_char), ("jpip_on", I),
               ("mct_data", ctypes.c_void_p), ("max_cs_size", I),
               ("rsiz", ctypes.c_uint16)])

    class CmptParm(ctypes.Structure):
        _fields_ = [(n, U) for n in "dx dy w h x0 y0 prec bpp sgnd".split()]

    class Comp(ctypes.Structure):
        _fields_ = ([(n, U) for n in ("dx dy w h x0 y0 prec bpp sgnd "
                                      "resno_decoded factor").split()]
                    + [("data", ctypes.POINTER(ctypes.c_int32)),
                       ("alpha", ctypes.c_uint16)])

    class Image(ctypes.Structure):
        _fields_ = ([(n, U) for n in "x0 y0 x1 y1 numcomps".split()]
                    + [("color_space", I), ("comps", ctypes.POINTER(Comp))])

    return CParams, CmptParm, Image


# OPJ_COLOR_SPACE, OPJ_PROG_ORDER
OPJ_SRGB, OPJ_GRAY = 1, 2
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def openjpeg_encode(comps, jp2: bool = True, prec=8, sgnd: int = 0,
                    color_space: int = OPJ_SRGB, offset=(0, 0), dxy=None,
                    extra=(), **params) -> bytes:
    """A JP2 file (or with ``jp2`` False a raw codestream) of the (h, w)
    integer components ``comps`` through libopenjp2's encoder: ``prec``
    (one or per component), ``sgnd``, the image ``offset`` (x0, y0),
    per-component sub-sampling ``dxy``, ``extra`` encoder options ("TLM=YES",
    "PLT=YES"), and opj_cparameters_t fields as ``params`` (plus ``rates``
    for the layers' compression ratios, ``precincts`` as (w, h) from the
    top resolution down, ``pocs`` as (resno0, compno0, layno1, resno1,
    compno1, order), ``tiles`` (w, h), ``tp_flag`` b"R" / b"L" / b"C")."""
    import ctypes
    import tempfile
    lib = libopenjp2()
    CParams, CmptParm, Image = _opj_structs()
    n = len(comps)
    parms = (CmptParm * n)()
    x0, y0 = offset
    dxy = dxy or [(1, 1)] * n
    for i, c in enumerate(comps):
        p = parms[i]
        p.dx, p.dy = dxy[i]
        p.h, p.w = c.shape
        p.x0, p.y0 = -(-x0 // p.dx), -(-y0 // p.dy)
        p.prec = p.bpp = prec if np.isscalar(prec) else prec[i]
        p.sgnd = sgnd
    img = ctypes.cast(lib.opj_image_create(n, parms, color_space),
                      ctypes.POINTER(Image))
    im = img.contents
    h, w = comps[0].shape
    im.x0, im.y0 = x0, y0
    im.x1, im.y1 = x0 + w * dxy[0][0], y0 + h * dxy[0][1]
    for i, c in enumerate(comps):
        flat = np.ascontiguousarray(c, np.int32).ravel()
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers, p.cp_disto_alloc = 1, 1
    p.image_offset_x0, p.image_offset_y0 = x0, y0
    for key, value in params.items():
        if key == "rates":
            p.tcp_numlayers = len(value)
            for j, r in enumerate(value):
                p.tcp_rates[j] = r
        elif key == "precincts":
            p.csty |= 1
            p.res_spec = len(value)
            for j, (pw, ph) in enumerate(value):
                p.prcw_init[j], p.prch_init[j] = pw, ph
        elif key == "pocs":
            p.numpocs = len(value)
            for j, (r0, c0, l1, r1, c1, prg) in enumerate(value):
                q = p.POC[j]
                q.resno0, q.compno0, q.layno1 = r0, c0, l1
                q.resno1, q.compno1, q.prg1, q.tile = r1, c1, prg, 1
        elif key == "tiles":
            p.tile_size_on = 1
            p.cp_tdx, p.cp_tdy = value
        elif key == "tp_flag":
            p.tp_on, p.tp_flag = b"\1", value
        elif key == "tcp_mct":
            p.tcp_mct = bytes([value])
        else:
            setattr(p, key, value)
    codec = ctypes.c_void_p(lib.opj_create_compress(2 if jp2 else 0))
    if not lib.opj_setup_encoder(codec, ctypes.byref(p), img):
        raise RuntimeError(f"opj_setup_encoder refused {params}")
    if extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        if not lib.opj_encoder_set_extra_options(codec, opts):
            raise RuntimeError(f"opj_encoder_set_extra_options({extra})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.jp2")
        st = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(
            path.encode(), 0))
        ok = (lib.opj_start_compress(codec, img, st)
              and lib.opj_encode(codec, st) and lib.opj_end_compress(codec,
                                                                     st))
        lib.opj_stream_destroy(st)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        if not ok:
            raise RuntimeError(f"OpenJPEG failed to encode ({params})")
        with open(path, "rb") as f:
            return f.read()


def jp2_box(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + tag + body


def jp2_file(codestream: bytes, colr: bytes, boxes: bytes = b"") -> bytes:
    """A JP2 file around a raw codestream: signature, ftyp, jp2h (ihdr from
    the codestream's SIZ, the colr box body ``colr``, then ``boxes``) and
    jp2c."""
    w, h, x0, y0 = struct.unpack_from(">IIII", codestream, 8)
    (nc,) = struct.unpack_from(">H", codestream, 40)
    bpc = codestream[42]
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h - y0, w - x0, nc, bpc,
                                        7, 0, 0))
    return (jp2_box(b"jP  ", b"\r\n\x87\n")
            + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", ihdr + jp2_box(b"colr", colr) + boxes)
            + jp2_box(b"jp2c", codestream))


def enumerated(cs: int) -> bytes:
    """A colr box body of the enumerated colour space ``cs`` (16 sRGB,
    17 gray, 18 sYCC, 24 eYCC, 12 CMYK)."""
    return struct.pack(">BBBI", 1, 0, 0, cs)


def j2k_markers(cs: bytes):
    """[(offset, marker, segment bytes)] of a raw codestream's main header
    and tile-part headers, and the offsets of its tile-parts' SOT
    markers."""
    pos, out, sots = 2, [], []
    while pos < len(cs):
        (m,) = struct.unpack_from(">H", cs, pos)
        if m == 0xFFD9:
            break
        if m == 0xFF90:
            (psot,) = struct.unpack_from(">I", cs, pos + 6)
            sots.append(pos)
            pos += psot
            continue
        (n,) = struct.unpack_from(">H", cs, pos + 2)
        out.append((pos, m, cs[pos:pos + 2 + n]))
        pos += 2 + n
    return out, sots


def tile_parts(cs: bytes):
    """(main header, [tile-part bytes]) of a raw codestream."""
    _, sots = j2k_markers(cs)
    ends = sots[1:] + [cs.rindex(b"\xff\xd9")]
    return cs[:sots[0]], [cs[a:b] for a, b in zip(sots, ends)]


def packet_headers_out(cs: bytes, ppm: bool) -> bytes:
    """A one-tile-part codestream written with SOP and EPH markers, its
    packet headers moved into a PPT marker (``ppm`` False) or the main
    header's PPM marker: each packet's header and EPH leave the tile's
    data, its SOP and body stay."""
    head, parts = tile_parts(cs)
    (part,) = parts
    (lsot,) = struct.unpack_from(">H", part, 2)
    sod = part.index(b"\xff\x93", 2 + lsot) + 2
    data = part[sod:]
    starts = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0x91]
    headers, bodies = b"", b""
    for a, b in zip(starts, starts[1:] + [len(data)]):
        packet = data[a:b]
        eph = packet.index(b"\xff\x92") + 2
        headers += packet[6:eph]
        bodies += packet[:6] + packet[eph:]
    if ppm:
        seg = b"\0" + struct.pack(">I", len(headers)) + headers
        head += b"\xff\x60" + struct.pack(">H", 2 + len(seg)) + seg
        tph = part[12:sod - 2]
    else:
        seg = b"\0" + headers
        tph = part[12:sod - 2] + b"\xff\x61" + struct.pack(">H",
                                                           2 + len(seg)) + seg
    sot = bytearray(part[:12])
    struct.pack_into(">I", sot, 6, 12 + len(tph) + 2 + len(bodies))
    return head + bytes(sot) + tph + b"\xff\x93" + bodies + b"\xff\xd9"


def insert_main_markers(cs: bytes, segments: bytes) -> bytes:
    """``segments`` (whole marker segments) put in the main header right
    after SIZ."""
    (lsiz,) = struct.unpack_from(">H", cs, 4)
    at = 4 + lsiz
    return cs[:at] + segments + cs[at:]


def write_jpeg2000_kinds(fmt_dir: str):
    """The JPEG 2000 kinds (JP2 and raw codestreams of the pattern, small):
    Pillow's options, cv2's encoder at 8 and 16 bits, libopenjp2's
    code-block styles, progressions, SOP / EPH, POC, ROI, tile-parts,
    precisions and TLM / PLT; written by hand: packet headers in PPT / PPM,
    PLM / CRG / COM markers, a palette, channel definitions, sYCC, eYCC,
    CMYK and ICC colour boxes, reordered tile-parts and cut codestreams;
    and the kinds cv2 fails on (signed, 1-7 bits, an image offset,
    sub-sampling, five components).  Returns their paths."""
    import cv2
    from PIL import Image
    os.makedirs(fmt_dir, exist_ok=True)
    rgb = pattern(32, 40)
    comps = [rgb[..., k].astype(np.int32) for k in range(3)]
    # lossless kinds and kinds cv2 fails on, smaller
    small = [c[:16, :24] for c in comps]
    tiny = [c[:8, :8] for c in comps]
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(19)
    alpha = np.clip(128 + 100 * np.sin(np.arange(w) / 4)[None] +
                    rng.normal(0, 10, (h, w)), 0, 255).astype(np.int32)
    files = {}

    def pil(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    im = Image.fromarray(rgb)
    lossy = dict(irreversible=True, quality_mode="rates",
                 quality_layers=[12])
    for name, img, kw in (
            ("pil_lossless.jp2", Image.fromarray(rgb[:16, :24]), {}),
            ("pil_lossy.jp2", im, lossy),
            ("pil_raw.j2k", im, dict(no_jp2=True, **lossy)),
            ("pil_tiles_rpcl.jp2", pattern(64, 80),
             dict(tile_size=(32, 32), progression="RPCL", num_resolutions=3,
                  irreversible=True, quality_mode="rates",
                  quality_layers=[20])),
            ("pil_cblk16_prec16.jp2", im, dict(codeblock_size=(16, 16),
                                               precinct_size=(16, 16),
                                               **lossy)),
            ("pil_mct0.jp2", im, dict(mct=0, **lossy)),
            ("pil_one_res.jp2", im, dict(num_resolutions=1, **lossy)),
            ("pil_layers_plt_comment.jp2", im,
             dict(irreversible=True, quality_mode="rates",
                  quality_layers=[40, 20, 8], plt=True,
                  comment="hcmvs JPEG 2000 fixture")),
            ("pil_rgba.jp2", Image.fromarray(np.concatenate(
                [rgb, alpha[..., None].astype(np.uint8)], -1)), lossy),
            ("pil_gray8.jp2", im.convert("L"), lossy),
            ("pil_gray16.jp2", Image.fromarray(
                (rgb[:16, :24, 1].astype(np.uint16) * 257 + 5).astype(
                    np.uint16)), {})):
        files[name] = pil(img if isinstance(img, Image.Image)
                          else Image.fromarray(img), **kw)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    # (cv2's encoder takes 32 rows and columns at least; the lossless
    # ones at 16 levels a channel)
    coarse = bgr[:, :32] // 16
    for name, img, rate in (("cv2_lossless.jp2", coarse * 17, 1000),
                            ("cv2_lossy.jp2", bgr, 80),
                            ("cv2_16bit.jp2",
                             (coarse // 4).astype(np.uint16) * 21845, 1000),
                            ("cv2_16bit_lossy.jp2",
                             bgr.astype(np.uint16) * 250, 150)):
        ok, enc = cv2.imencode(".jp2", np.ascontiguousarray(img), [
            cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, rate])
        files[name] = enc.tobytes()
    # libopenjp2: code-block styles (bypass 1, reset 2, terminate each
    # pass 4, vertically causal 8, predictable termination 16,
    # segmentation symbols 32), lossy in two layers (passes cut) and
    # lossless
    two = dict(irreversible=1, rates=[30, 8], numresolution=3,
               cblockw_init=16, cblockh_init=16)
    for name, mode in (("bypass", 1), ("reset", 2), ("termall", 4),
                       ("vsc", 8), ("pterm", 16), ("segsym", 32),
                       ("all", 63)):
        files[f"style_{name}.jp2"] = openjpeg_encode(comps, mode=mode, **two)
    files["style_all_lossless.j2k"] = openjpeg_encode(
        small, jp2=False, mode=63, numresolution=3, cblockw_init=8,
        cblockh_init=8)
    files["style_bypass_vsc_lossless.jp2"] = openjpeg_encode(
        small, mode=9, numresolution=2)
    # every progression order, with precincts, tiles and layers
    for k, order in enumerate(PROGRESSIONS):
        files[f"order_{order.lower()}.j2k"] = openjpeg_encode(
            comps, jp2=False, prog_order=k, precincts=[(16, 16), (8, 8)],
            tiles=(24, 16), numresolution=3, irreversible=k % 2,
            rates=[60, 20], cblockw_init=8, cblockh_init=8)
    files["sop_eph.jp2"] = openjpeg_encode(comps, csty=6, **two)
    files["poc.j2k"] = openjpeg_encode(
        comps, jp2=False, rates=[30, 10, 4], numresolution=3,
        pocs=[(0, 0, 1, 2, 3, 4), (0, 0, 3, 3, 3, 0)])
    files["roi.jp2"] = openjpeg_encode(comps, roi_compno=0, roi_shift=5,
                                       **two)
    files["roi_lossless.j2k"] = openjpeg_encode(
        small, jp2=False, roi_compno=1, roi_shift=3, numresolution=2)
    for flag in "RLC":
        files[f"tileparts_{flag}.j2k"] = openjpeg_encode(
            small, jp2=False, tiles=(16, 16), tp_flag=flag.encode(),
            numresolution=3, irreversible=1, rates=[60, 20])
    files["tlm_plt.j2k"] = openjpeg_encode(comps, jp2=False,
                                           extra=("TLM=YES", "PLT=YES"),
                                           **two)
    # precisions: 9-16 bits read (cut to 8 in colour and gray); 1-7 bits
    # and signed samples are kinds cv2 fails on
    g, sg, tg = comps[1], small[1], tiny[1]
    for name, prec, cs_, cc in (
            ("gray9.jp2", 9, OPJ_GRAY, [sg << 1 | 1]),
            ("gray12.jp2", 12, OPJ_GRAY, [sg << 4 | 9]),
            ("rgb10.jp2", 10, OPJ_SRGB, [c << 2 for c in small]),
            ("rgb_8_10_12.jp2", (8, 10, 12), OPJ_SRGB,
             [small[0], small[1] << 2, small[2] << 4]),
            ("gray20.jp2", 20, OPJ_GRAY, [sg << 12]),
            ("gray1.jp2", 1, OPJ_GRAY, [tg >> 7]),
            ("rgb4.jp2", 4, OPJ_SRGB, [c >> 4 for c in tiny]),
            ("gray7.jp2", 7, OPJ_GRAY, [tg >> 1])):
        files[name] = openjpeg_encode(cc, prec=prec, color_space=cs_,
                                      numresolution=2)
    files["signed.j2k"] = openjpeg_encode([tg - 128], jp2=False, sgnd=1,
                                          color_space=OPJ_GRAY,
                                          numresolution=2)
    files["offset.jp2"] = openjpeg_encode([tg], color_space=OPJ_GRAY,
                                          offset=(5, 3), numresolution=2)
    files["subsampled.jp2"] = openjpeg_encode(
        [tiny[0], tiny[1][::2, ::2], tiny[2][::2, ::2]],
        dxy=[(1, 1), (2, 2), (2, 2)], numresolution=2)
    files["five.j2k"] = openjpeg_encode(tiny + tiny[:2], jp2=False,
                                        numresolution=2)
    files["gray_alpha.jp2"] = openjpeg_encode([g, alpha],
                                              color_space=OPJ_GRAY, **two)
    files["gray.j2k"] = openjpeg_encode([g], jp2=False, color_space=OPJ_GRAY,
                                        **two)
    files["rgba.j2k"] = openjpeg_encode(comps + [alpha], jp2=False, **two)
    # by hand: packet headers in PPT / PPM; PLM, CRG and COM markers
    sop = openjpeg_encode(comps, jp2=False, csty=6, **two)
    files["ppt.j2k"] = packet_headers_out(sop, ppm=False)
    files["ppm.jp2"] = jp2_file(packet_headers_out(sop, ppm=True),
                                enumerated(16))
    com = b"\0\1" + b"fixture"
    files["plm_crg_com.j2k"] = insert_main_markers(openjpeg_encode(
        comps, jp2=False, **two),
        b"\xff\x57" + struct.pack(">HBB", 6, 0, 2) + b"\x05\x07"
        + b"\xff\x63" + struct.pack(">H", 2 + 12) + bytes(12)
        + b"\xff\x64" + struct.pack(">H", 2 + len(com)) + com)
    # by hand: JP2 colour boxes around raw codestreams
    raw3 = openjpeg_encode(comps, jp2=False, tcp_mct=0, **two)
    files["sycc.jp2"] = jp2_file(raw3, enumerated(18))
    files["eycc.jp2"] = jp2_file(raw3, enumerated(24))
    files["icc.jp2"] = jp2_file(raw3, b"\2\0\0" + bytes(range(128)))
    files["cmyk.jp2"] = jp2_file(openjpeg_encode(comps + [alpha], jp2=False,
                                                 **two), enumerated(12))
    # a palette: 8-bit indices into 48 RGB entries (pclr + cmap)
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    idx = (np.arange(h)[:, None] // 3 + np.arange(w)[None] // 5) % 48
    index = openjpeg_encode([idx.astype(np.int32)], jp2=False,
                            color_space=OPJ_GRAY, numresolution=3)
    pclr = jp2_box(b"pclr", struct.pack(">HB", 48, 3) + b"\7\7\7"
                   + pal.tobytes())
    cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                     for i in range(3)))
    files["palette.jp2"] = jp2_file(index, enumerated(16), pclr + cmap)
    # channel definitions: stored B, G, R, A, put in order by cdef
    bgra = openjpeg_encode([comps[2], comps[1], comps[0], alpha], jp2=False,
                           tcp_mct=0, **two)
    cdef = jp2_box(b"cdef", struct.pack(">H", 4) + b"".join(
        struct.pack(">HHH", cn, typ, asoc) for cn, typ, asoc in (
            (0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0))))
    files["cdef_bgra.jp2"] = jp2_file(bgra, enumerated(16), cdef)
    # tile-parts out of order: each tile's parts interleaved with the
    # others', the tiles last to first
    head, parts = tile_parts(files["tileparts_R.j2k"])
    by_tile = {}
    for part in parts:
        by_tile.setdefault(struct.unpack_from(">H", part, 4)[0],
                           []).append(part)
    order = []
    for k in range(max(len(v) for v in by_tile.values())):
        for t in sorted(by_tile, reverse=True):
            if k < len(by_tile[t]):
                order.append(by_tile[t][k])
    files["tileparts_shuffled.j2k"] = head + b"".join(order) + b"\xff\xd9"
    # cut codestreams: inside a tile-part (cv2 fails), after a tile-part
    # with EOC appended (the missing tiles read 0) or without (cv2 fails),
    # a JP2 cut in its codestream (cv2 fails)
    tiled = files["order_rpcl.j2k"]
    head, parts = tile_parts(tiled)
    files["cut_in_tile.j2k"] = tiled[:len(head) + len(parts[0]) // 2]
    files["cut_after_tile_eoc.j2k"] = head + parts[0] + b"\xff\xd9"
    files["cut_after_tile.j2k"] = head + parts[0]
    files["cut.jp2"] = files["pil_lossy.jp2"][:-60]
    out = []
    for name, data in files.items():
        out.append(os.path.join(fmt_dir, name))
        with open(out[-1], "wb") as f:
            f.write(data)
    return out


# the densify run on JPEG 2000 views (chip_smoke.py phase 27): views 0-3
# of phase 27's ridge scene, undistorted, each a colour 9/7 codestream in
# two quality layers (ratios 600 and 150), RPCL, 512x512 tiles and
# precincts
JP2_VIEWS = 4
JP2_VIEW_LAYERS = [600, 150]


def jp2_view_scene(root: str, h: int = PHOTO_HW[0], w: int = PHOTO_HW[1],
                   n_views: int = JP2_VIEWS, ext: str = "jp2"):
    """(scene.mvs path, scene): the views' ridge scene (``ridge_scene``'s
    geometry at h x w, untextured) written under ``root``, its images
    named ``v%d.<ext>``: densify's input with ``--images-dir`` the views'
    directory."""
    from hcmvs_tpu_torch.io.mvs import read_mvs, write_mvs
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             write_ridge_scene)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views, fx=1200.0 * w / 1280,
                          spacing=0.25,
                          texture_fn=lambda xy: np.zeros(xy.shape[:-1],
                                                         np.float32))
    scene_path, _ = write_ridge_scene(root, sc)
    scene = read_mvs(scene_path)
    for i, im in enumerate(scene.images):
        im.name = f"v{i}.{ext}"
    write_mvs(scene_path, scene)
    return scene_path, sc


def jp2_views(view_dir: str, images):
    """Each (H, W) float image in [0, 1] as ``v%d.jp2`` (its gray level in
    three channels); returns the paths."""
    from PIL import Image
    os.makedirs(view_dir, exist_ok=True)
    paths = []
    for i, g in enumerate(images):
        u8 = (np.clip(g, 0, 1) * 255).astype(np.uint8)
        paths.append(os.path.join(view_dir, f"v{i}.jp2"))
        Image.fromarray(np.repeat(u8[..., None], 3, -1)).save(
            paths[-1], "JPEG2000", irreversible=True, quality_mode="rates",
            quality_layers=JP2_VIEW_LAYERS, progression="RPCL",
            tile_size=(512, 512), precinct_size=(512, 512))
    return paths


# ---- AVIF: Pillow's and cv2's writers, and the HEIF boxes around an AV1
# payload written here for the kinds no writer makes

def box(tag: bytes, body: bytes) -> bytes:
    """An ISOBMFF box."""
    return struct.pack(">I", 8 + len(body)) + tag + body


def full_box(tag: bytes, version: int, flags: int, body: bytes) -> bytes:
    """An ISOBMFF full box."""
    return box(tag, struct.pack(">I", (version << 24) | flags) + body)


def boxes_of(data: bytes, start: int = 0, end: int = None) -> list:
    """[(tag, payload start, end)] of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((tag, pos + 8, pos + size))
        pos += size
    return out


def avif_parts(data: bytes) -> dict:
    """The primary item of a single-image AVIF written by libavif:
    {"obus": its AV1 payload, "props": {tag: box bytes} of its
    properties (av1C, ispe, pixi, colr)}."""
    meta = next((s, e) for t, s, e in boxes_of(data) if t == b"meta")
    sub = {t: (s, e) for t, s, e in boxes_of(data, meta[0] + 4, meta[1])}
    s, e = sub[b"iloc"]
    v = data[s]
    osz, lsz = data[s + 4] >> 4, data[s + 4] & 15
    bsz = data[s + 5] >> 4
    pos = s + 6
    n = struct.unpack(">H", data[pos:pos + 2])[0]
    pos += 2
    locs = {}
    for _ in range(n):
        iid = struct.unpack(">H", data[pos:pos + 2])[0]
        pos += 2 + (2 if v else 0) + 2
        base = int.from_bytes(data[pos:pos + bsz], "big")
        pos += bsz
        ne = struct.unpack(">H", data[pos:pos + 2])[0]
        pos += 2
        chunks = []
        for _ in range(ne):
            off = int.from_bytes(data[pos:pos + osz], "big")
            ln = int.from_bytes(data[pos + osz:pos + osz + lsz], "big")
            pos += osz + lsz
            chunks.append(data[base + off:base + off + ln])
        locs[iid] = b"".join(chunks)
    s, e = sub[b"pitm"]
    primary = struct.unpack(">H", data[s + 4:s + 6])[0]
    s, e = sub[b"iprp"]
    parts = {t: (a, b) for t, a, b in boxes_of(data, s, e)}
    props = [data[a - 8:b] for _, a, b in boxes_of(data, *parts[b"ipco"])]
    a, b = parts[b"ipma"]
    pos = a + 4
    assoc = {}
    for _ in range(struct.unpack(">I", data[pos:pos + 4])[0]):
        iid, k = struct.unpack(">HB", data[pos + 4:pos + 7])
        assoc[iid] = [x & 0x7F for x in data[pos + 7:pos + 7 + k]]
        pos += 7 + k
    return {"obus": locs[primary],
            "props": {props[i - 1][4:8]: props[i - 1]
                      for i in assoc[primary]}}


def pil_av1(img: np.ndarray, **kw) -> dict:
    """``avif_parts`` of Pillow's AVIF of img."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", **kw)
    return avif_parts(buf.getvalue())


def nclx(cp: int, tc: int, mc: int, full: int) -> bytes:
    return box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc,
                                              full << 7))


ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"


def heif_file(items, primary: int, refs=(), brands=(b"avif", b"mif1",
                                                   b"miaf"),
              idat: bool = False) -> bytes:
    """A HEIF file: items is a list of (id, type, data, [(property box,
    essential)]), refs (type, from, [to]); the data in an mdat (or with
    ``idat`` in the meta box's idat), located by iloc version 1."""
    props, ipma = [], []
    for iid, _, _, plist in items:
        marks = []
        for pb, ess in plist:
            if pb not in props:
                props.append(pb)
            marks.append(((1 if ess else 0) << 7) | (props.index(pb) + 1))
        ipma.append(struct.pack(">HB", iid, len(marks)) + bytes(marks))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = full_box(b"pitm", 0, 0, struct.pack(">H", primary))
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        full_box(b"infe", 2, 0, struct.pack(">HH", iid, 0) + typ + b"\0")
        for iid, typ, _, _ in items))
    iref = (full_box(b"iref", 0, 0, b"".join(
        box(t, struct.pack(">HH", f, len(to)) + b"".join(
            struct.pack(">H", x) for x in to)) for t, f, to in refs))
        if refs else b"")
    iprp = box(b"iprp", box(b"ipco", b"".join(props)) + full_box(
        b"ipma", 0, 0, struct.pack(">I", len(ipma)) + b"".join(ipma)))
    ftyp = box(b"ftyp", brands[0] + bytes(4) + b"".join(brands))
    payload = b"".join(d for _, _, d, _ in items)

    def iloc(base):
        body = struct.pack(">BBH", 0x44, 0x00, len(items))
        at = 0
        for iid, _, d, _ in items:
            body += struct.pack(">HHHHII", iid, 1 if idat else 0, 0, 1,
                                base + at, len(d))
            at += len(d)
        return full_box(b"iloc", 1, 0, body)

    def meta(base):
        return full_box(b"meta", 0, 0, hdlr + pitm + iloc(base) + iinf + iref
                        + iprp + (box(b"idat", payload) if idat else b""))
    if idat:
        return ftyp + meta(0)
    base = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(base) + box(b"mdat", payload)


def avif_with(parts: dict, extra=(), drop=(), **heif_kw) -> bytes:
    """``parts`` (``avif_parts``) as a one-item HEIF file, its property
    boxes ``drop``ped by tag and ``extra`` (box, essential) added."""
    plist = [(b, t == b"av1C") for t, b in parts["props"].items()
             if t not in drop] + list(extra)
    return heif_file([(1, b"av01", parts["obus"], plist)], 1, **heif_kw)


def avif_grid(cells, rows: int, cols: int, out_w: int, out_h: int,
              flags: int = 0) -> bytes:
    """A grid item of rows x cols AV1 items (``avif_parts`` of equal
    cells), output out_w x out_h."""
    fw = 4 if flags & 1 else 2
    grid = struct.pack(">BBBB", 0, flags, rows - 1, cols - 1) + \
        out_w.to_bytes(fw, "big") + out_h.to_bytes(fw, "big")
    c0 = cells[0]["props"]
    ispe = full_box(b"ispe", 0, 0, struct.pack(">II", out_w, out_h))
    items = [(1, b"grid", grid, [(ispe, False), (c0[b"colr"], False),
                                 (c0[b"pixi"], False)])]
    for k, c in enumerate(cells):
        items.append((2 + k, b"av01", c["obus"],
                      [(b, t == b"av1C") for t, b in c["props"].items()]))
    return heif_file(items, 1, refs=[(b"dimg", 1, list(
        range(2, 2 + len(cells))))])


def avif_alpha(color: dict, alpha: dict, premultiplied: bool = False) -> bytes:
    """A colour item and an alpha auxiliary item (``avif_parts`` each)."""
    aux = full_box(b"auxC", 0, 0, ALPHA_URN)
    items = [(1, b"av01", color["obus"],
              [(b, t == b"av1C") for t, b in color["props"].items()]),
             (2, b"av01", alpha["obus"],
              [(b, t == b"av1C") for t, b in alpha["props"].items()
               if t != b"colr"] + [(aux, True)])]
    refs = [(b"auxl", 2, [1])] + ([(b"prem", 1, [2])] if premultiplied
                                   else [])
    return heif_file(items, 1, refs=refs)


def avif_exif(parts: dict, orient: int) -> bytes:
    """``parts`` with an Exif item ('cdsc' to it) holding orientation
    ``orient``."""
    from PIL import Image
    ex = Image.Exif()
    ex[0x0112] = orient
    tiff = ex.tobytes()
    if tiff.startswith(b"Exif\0\0"):
        tiff = tiff[6:]
    items = [(1, b"av01", parts["obus"],
              [(b, t == b"av1C") for t, b in parts["props"].items()]),
             (2, b"Exif", struct.pack(">I", 0) + tiff, [])]
    return heif_file(items, 1, refs=[(b"cdsc", 2, [1])])


def screen(h: int = 64, w: int = 96, seed: int = 21) -> np.ndarray:
    """(h, w, 3) uint8: flat rectangles of a few colours, text and a
    repeated patch (aom's screen-content tools, palette and intra block
    copy, pick it)."""
    import cv2
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 230, np.uint8)
    cols = rng.integers(0, 256, (5, 3))
    for _ in range(14):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y:y + rng.integers(3, 24), x:x + rng.integers(3, 30)] = \
            cols[rng.integers(0, 5)]
    cv2.putText(img, "AV1 42", (4, h // 2), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (20, 20, 120), 1)
    img[h - 20:h - 4, w - 20:w - 4] = img[4:20, 4:20]
    return img


def write_avif_kinds(fmt_dir: str):
    """The AVIF kinds (small images of the pattern): Pillow's qualities,
    speeds, chroma samplings, gray, alpha, Exif, orientation (irot) and
    aom tool switches (palette and intra block copy on screen content,
    filter intra, CfL, CDEF, loop restoration, tiles, delta q, 128x128
    superblocks, quantiser matrices, film grain, lossless), an animation
    (avis) with
    and without alpha; cv2's encoder at 8, 10 and 12 bits in colour,
    gray and BGRA; written here around those AV1 payloads: grids, an
    alpha item, an idat, irot / imir / clap, every nclx matrix in both
    ranges, no colr, an unknown property; and the kinds cv2 fails on (no
    ispe, no avif brand, an unknown essential property, the matrices
    libavif does not convert).  Returns their paths."""
    import cv2
    from PIL import Image
    os.makedirs(fmt_dir, exist_ok=True)
    rgb = pattern(48, 64)
    files = {}

    def pil(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "AVIF", **kw)
        return buf.getvalue()

    for q, speed in ((10, 6), (50, 2), (90, 9), (100, 6)):
        files[f"avif_q{q}_s{speed}.avif"] = pil(rgb, quality=q, speed=speed)
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        files[f"avif_{sub.replace(':', '')}.avif"] = pil(
            rgb, quality=70, subsampling=sub)
    files["avif_gray.avif"] = pil(rgb[..., 1], quality=70)
    alpha = np.clip(128 + 100 * np.sin(np.arange(64) / 4)[None]
                    + np.zeros((48, 1)), 0, 255).astype(np.uint8)
    files["avif_alpha.avif"] = pil(np.dstack([rgb, alpha]), quality=70)
    ex = Image.Exif()
    ex[0x0110] = "hcmvs"
    files["avif_exif.avif"] = pil(rgb, quality=70, exif=ex.tobytes())
    ex[0x0112] = 6
    files["avif_orientation6.avif"] = pil(rgb, quality=70, exif=ex.tobytes())
    big = pattern(96, 136)
    tools = {"palette_ibc": ({"tune-content": "screen"}, screen()),
             "palette": ({"tune-content": "screen", "enable-intrabc": "0"},
                         screen()),
             "filter_intra_off": ({"enable-filter-intra": "0"}, rgb),
             "cfl_off": ({"enable-cfl-intra": "0"}, rgb),
             "cdef_off": ({"enable-cdef": "0"}, rgb),
             "restoration": ({"enable-restoration": "1"}, big),
             "tiles": ({"tile-columns": "1", "tile-rows": "1"}, big),
             "deltaq": ({"deltaq-mode": "1"}, big),
             "sb128": ({"sb-size": "128"}, big),
             "qm": ({"enable-qm": "1"}, rgb),
             "sharpness7": ({"sharpness": "7"}, rgb),
             "film_grain": ({"film-grain-test": "1"}, rgb),
             "film_grain_denoised": ({"denoise-noise-level": "25"}, big)}
    for name, (adv, img) in tools.items():
        files[f"avif_{name}.avif"] = pil(img, quality=60, speed=4,
                                         advanced=adv)
    files["avif_lossless.avif"] = pil(rgb, lossless=True)
    frames = [Image.fromarray(np.roll(rgb, 7 * k, 1)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   duration=100, quality=60)
    files["avif_animation.avif"] = buf.getvalue()
    frames = [Image.fromarray(np.dstack([np.roll(rgb, 7 * k, 1), alpha]))
              for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   duration=100, quality=60)
    files["avif_animation_alpha.avif"] = buf.getvalue()
    bgr = rgb[..., ::-1]
    for depth in (8, 10, 12):
        up = (lambda a: a) if depth == 8 else (
            lambda a: a.astype(np.uint16) << (depth - 8))
        opts = [cv2.IMWRITE_AVIF_DEPTH, depth, cv2.IMWRITE_AVIF_QUALITY, 80]
        for name, img in (("color", bgr), ("gray", bgr[..., 1]),
                          ("bgra", np.dstack([bgr, alpha]))):
            files[f"cv2_{name}{depth}.avif"] = cv2.imencode(
                ".avif", up(img), opts)[1].tobytes()
    # around Pillow's AV1 payloads
    parts = pil_av1(rgb, quality=70)
    cells = [pil_av1(np.roll(pattern(64, 64), 9 * k, 0), quality=40)
             for k in range(4)]
    files["avif_grid.avif"] = avif_grid(cells, 2, 2, 128, 128)
    files["avif_grid_cropped.avif"] = avif_grid(cells, 2, 2, 122, 100)
    files["avif_grid_32bit.avif"] = avif_grid(cells[:2], 1, 2, 128, 64, 1)
    gray_alpha = pil_av1(np.repeat(alpha[..., None], 3, -1), quality=90,
                         subsampling="4:0:0")
    files["avif_alpha_item.avif"] = avif_alpha(parts, gray_alpha)
    files["avif_idat.avif"] = avif_with(parts, idat=True)
    files["avif_irot1.avif"] = avif_with(parts, [(box(b"irot", b"\1"), True)])
    files["avif_imir.avif"] = avif_with(parts, [(box(b"imir", b"\1"), True)])
    files["avif_clap.avif"] = avif_with(parts, [(box(b"clap", struct.pack(
        ">8I", 32, 1, 24, 1, 0, 1, 0, 1)), True)])
    files["avif_no_colr.avif"] = avif_with(parts, drop=[b"colr"])
    files["avif_unknown_property.avif"] = avif_with(
        parts, [(box(b"xyzw", b"1234"), False)])
    small = pil_av1(rgb[:24, :32], quality=70)
    four44 = pil_av1(rgb[:24, :32], quality=70, subsampling="4:4:4")
    for mc in range(15):
        for full in (0, 1):
            src = four44 if mc == 0 else small
            name = f"avif_nclx_mc{mc}_{'full' if full else 'limited'}.avif"
            files[name] = avif_with(src, [(nclx(1, 13, mc, full), False)],
                                    drop=[b"colr"])
    files["avif_nclx_mc12_bt2020.avif"] = avif_with(
        small, [(nclx(9, 16, 12, 0), False)], drop=[b"colr"])
    files["avif_nclx_mc12_smpte431.avif"] = avif_with(
        small, [(nclx(11, 17, 12, 1), False)], drop=[b"colr"])
    # cv2 fails on these
    files["avif_nclx_mc0_420.avif"] = avif_with(
        small, [(nclx(1, 13, 0, 1), False)], drop=[b"colr"])
    files["avif_grid_odd.avif"] = avif_grid(cells, 2, 2, 121, 100)
    files["avif_no_ispe.avif"] = avif_with(parts, drop=[b"ispe"])
    files["avif_mif1_brand.avif"] = avif_with(parts, brands=(b"mif1",
                                                              b"miaf"))
    files["avif_unknown_essential.avif"] = avif_with(
        parts, [(box(b"xyzw", b"1234"), True)])
    paths = []
    for name, data in files.items():
        paths.append(os.path.join(fmt_dir, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


# the AVIF views (avif_views/): Pillow's aom at quality 90, 4:2:0, 8-bit,
# as 2 x 2 tiles
AVIF_VIEW_OPTIONS = {"quality": 90, "subsampling": "4:2:0", "speed": 6,
                     "advanced": {"tile-rows": "1", "tile-columns": "1"}}


def avif_views(view_dir: str, images):
    """Each (H, W) float image in [0, 1] as ``v%d.avif`` (its gray level in
    three channels, AVIF_VIEW_OPTIONS); returns the paths."""
    from PIL import Image
    os.makedirs(view_dir, exist_ok=True)
    paths = []
    for i, g in enumerate(images):
        u8 = (np.clip(g, 0, 1) * 255).astype(np.uint8)
        paths.append(os.path.join(view_dir, f"v{i}.avif"))
        Image.fromarray(np.repeat(u8[..., None], 3, -1)).save(
            paths[-1], "AVIF", **AVIF_VIEW_OPTIONS)
    return paths


IMAGE_EXTENSIONS = (".jpg", ".png", ".tif", ".bmp", ".webp", ".gif",
                    ".hdr", ".pfm", ".pam", ".ras", ".jp2", ".j2k", ".avif")


def cv2_digests(path: str) -> dict:
    """{mode: {"shape", "sha256"} or None} of ``cv2.imread``'s three
    reads (None where cv2 returns none)."""
    import cv2
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    out = {}
    for mode in MODES:
        img = cv2.imread(path, flags[mode])
        if img is None:
            out[mode] = None
            continue
        img = np.ascontiguousarray(img)
        out[mode] = {"shape": list(img.shape),
                     "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    return out


def manifest_entries(root: str = HERE) -> dict:
    """{relative path: cv2_digests} of every fixture under ``root``."""
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, names in os.walk(root) for f in names
                   if f.endswith(IMAGE_EXTENSIONS))
    return {f: cv2_digests(os.path.join(root, f)) for f in files}


def main(argv=()) -> int:
    import cv2
    if "variants" not in argv:
        h, w = PHOTO_HW
        _, photos = ridge_photos(h, w)
        save_jpeg_photos(os.path.join(HERE, "photos"), photos,
                         1200.0 * 36.0 / 1280)
        views = ridge_scene(h, w, JP2_VIEWS).images
        jp2_views(os.path.join(HERE, "jp2_views"), views)
        avif_views(os.path.join(HERE, "avif_views"), views)
    write_variants(os.path.join(HERE, "variants"))
    write_jpeg_kinds(os.path.join(HERE, "variants"))
    write_formats(os.path.join(HERE, "formats"))
    write_image_kinds(os.path.join(HERE, "formats"))
    photo_webps(os.path.join(HERE, "formats"))
    write_jpeg2000_kinds(os.path.join(HERE, "formats"))
    write_avif_kinds(os.path.join(HERE, "formats"))
    manifest = {"cv2": cv2.__version__, "files": manifest_entries()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
