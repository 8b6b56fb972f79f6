"""Writes the fixtures of the port's image decoders and their manifest
(needs numpy, torch, Pillow and OpenCV; runs on the CPU).

    PYTHONPATH=. python tests/data/jpeg/make_fixtures.py
    PYTHONPATH=. python tests/data/jpeg/make_fixtures.py variants

(the second keeps the photos and rewrites the rest and the manifest)

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


def ridge_photos(h: int, w: int, n_views: int = PHOTO_VIEWS,
                 device: str = "cpu"):
    """(scene, uint8 photos): phase 16's ridge at h x w (focal 1200 w /
    1280, blob texture summed in torch on ``device``) through k1."""
    from hcmvs_tpu_torch.utils.synth import (blob_texture_fn,
                                             distort_images,
                                             make_ridge_scene)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views, fx=1200.0 * w / 1280,
                          spacing=0.25, texture_fn=blob_texture_fn(
                              np.random.default_rng(0), device=device))
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
                   if f.endswith((".jpg", ".png", ".tif", ".bmp")))
    return {f: cv2_digests(os.path.join(root, f)) for f in files}


def main(argv=()) -> int:
    import cv2
    if "variants" not in argv:
        h, w = PHOTO_HW
        _, photos = ridge_photos(h, w)
        save_jpeg_photos(os.path.join(HERE, "photos"), photos,
                         1200.0 * 36.0 / 1280)
    write_variants(os.path.join(HERE, "variants"))
    write_jpeg_kinds(os.path.join(HERE, "variants"))
    write_formats(os.path.join(HERE, "formats"))
    manifest = {"cv2": cv2.__version__, "files": manifest_entries()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
