"""Image decoding, grayscale conversion, resizing and pyramids without
OpenCV (port of ``hcmvs_tpu/io/images.py``).

The JAX package decodes with ``cv2.imread``; the machine the port runs
on has no OpenCV, PIL or imageio, so this module decodes every format the
JAX package reads itself, to the arrays ``cv2.imread`` returns (OpenCV
5.0 with libjpeg-turbo 3.1, libpng 1.6, libtiff 4.7): ``imread(path,
mode)`` with mode "color" (IMREAD_COLOR: (H, W, 3) BGR uint8), "gray"
(IMREAD_GRAYSCALE: (H, W) uint8) or "unchanged" (IMREAD_UNCHANGED: the
stored channels and depth, colour in BGR(A) order).

- JPEG: ``native/jpeg.cpp`` (baseline, extended and progressive Huffman,
  8-bit, 1, 3 or 4 components (gray, YCbCr or RGB, CMYK or YCCK), any
  integral chroma sampling, restart markers, progressive files whose
  scans stop early, block-smoothed as libjpeg-turbo does), bit-equal to
  libjpeg-turbo's ISLOW IDCT, fancy upsampling and colour tables; gray is
  the Y plane (OpenCV's BT.601 of the BGR for CMYK).
- PNG: every colour type and bit depth (gray at 1/2/4/8/16 bits, gray +
  alpha, RGB and RGBA at 8/16, palette at 1/2/4/8 with its ``tRNS``
  alpha), non-interlaced or Adam7 (seven passes, each unfiltered on its
  own, then scattered), all five row filters; gray through libpng's
  rgb_to_gray.
- PNM: P1-P6; ASCII samples scaled to 0-255 (``v * 255 // maxval``) when
  maxval < 256, binary ones raw; maxval 256-65535 gives 16-bit samples.
- BMP: 1/4/8-bit palette (a gray palette reads as one channel unchanged),
  16-bit 5-5-5 and 5-6-5 (bit fields), 24- and 32-bit (bit fields read
  as BGRA), bottom-up and top-down, RLE8 and RLE4, Windows and OS/2
  headers (an OS/2 file reads gray unchanged, as OpenCV's reader leaves
  it unmarked as colour).
- TIFF: strips and tiles, uncompressed, LZW, JPEG (with its JPEGTables),
  Deflate and PackBits, predictor 1 and 2, 1-, 8- and 16-bit gray
  (min-is-black or min-is-white), RGB and RGBA, palette, CMYK, YCbCr
  (JPEG-compressed), signed 16-bit and float32 samples, chunky and
  planar; RGBA premultiplied by its alpha, 16-bit RGB rounded to 8 bits,
  palette, CMYK, bilevel and min-is-white as libtiff's RGBA interface
  does them; signed samples read as their bits (int16 unchanged), float
  only unchanged (cv2 reads no 8-bit image of it); uncompressed, LZW and
  Deflate YCbCr (1x1 sampling) through libtiff's float tables.
- WebP: ``native/webp.cpp`` (lossy, lossless, alpha, the first frame of
  an animation, EXIF orientation in the colour and gray modes).
- GIF, Radiance HDR, PFM, PAM, Sun raster: ``io/image_formats.py``, each
  with the rules its cv2 reader follows.
- JPEG 2000: ``native/jpeg2000.cpp`` (the JP2 box or a raw codestream,
  everything of Part 1 but HTJ2K), bit-equal to the components OpenJPEG
  2.5.3 gives cv2, read into arrays by OpenCV's rules (``_jpeg2000``);
  signed components, precisions below 8 bits, image offsets, sub-sampled
  components, two components unchanged and cut streams raise
  NotImplementedError, as cv2 fails on them.
- AVIF: ``native/avif.cpp`` (the HEIF container with grids, the alpha
  item and the first sample of an ``avis`` sequence; AV1 key and
  intra-only frames with every coding tool, 4:0:0-4:4:4 at 8-12 bits),
  bit-equal to the planes libaom gives libavif, converted by libavif's
  and OpenCV's rules (``_avif``); superres, premultiplied alpha and the
  files cv2 fails on raise NotImplementedError.

Gray of a colour file: PNG through libpng's rgb_to_gray, the others
through OpenCV's BT.601 fixed point (16-bit samples cut to 8 first).
EXIF orientation (IFD0 tag 274) is applied in the color and gray modes to
JPEG (its first APP1) and PNG (``eXIf``), as cv2 applies it, never in the
unchanged mode; a TIFF's orientation tag flips it (2-4), and 5-8 raise,
where cv2 5.0 fails.  Whatever is outside this scope raises
NotImplementedError naming it (arithmetic, lossless, hierarchical or
12-bit JPEG, a JPEG height from a DNL marker or fractional sampling, on
which cv2 fails too; old-style JPEG, subsampled uncompressed YCbCr,
CIELab or mask TIFF, other inks than CMYK; 16-bit BMP bit fields other than 5-5-5
and 5-6-5, on which cv2 fails); a corrupt file raises ValueError.

``load_image`` lays ``imread`` out as the JAX package's: (H, W, 3) RGB
float32 in [0, 1], or (H, W) with ``gray=True``; ``load_semantic_mask``
reads label images unchanged (16-bit labels stay 16-bit).

PNG row filters: when every row uses None, Sub or Up, rows are decoded
one after another, each vectorised over the whole row (Sub is a
per-channel running sum modulo 256).  Average and Paeth depend on the
reconstructed pixel to their left as well as on the row above, so an
image that uses them (OpenCV's encoder picks them for smooth images) is
decoded as a wavefront: all pixels of one anti-diagonal y + x at once,
H + W numpy steps whatever the row filters.  Filters act on bytes, so a
16-bit sample is two byte channels and a row of sub-byte samples one
byte channel until the filters are undone.  The writer takes the row
filter(s) to use (Up by default) and writes 8- or 16-bit samples.

``resize_image`` and ``resize_linear`` are ``cv2.resize`` bit for bit
(OpenCV 5.0, probed with impulse images and orders of sums): INTER_AREA
when shrinking, as exact area-overlap weights (cv2's
``computeResizeAreaTab``) summed along x and then y in float32, or its
fast path at integer ratios; INTER_LINEAR when enlarging, positions in
float64 and each blend ``fma(p1 - p0, t, p0)``; uint8 through cv2's
fixed-point INTER_LINEAR and rounded sums.  ``resize_mask`` is
INTER_NEAREST's index rule; ``build_pyramid`` is ``cv2.pyrDown`` level
by level.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from hcmvs_tpu_torch import native
from hcmvs_tpu_torch.io import image_formats
from hcmvs_tpu_torch.io.exif import _exif_block, _read_ifd, orientation

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the PNG spec allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# cv2's gray conversions of colour files with IMREAD_GRAYSCALE (a JPEG
# gives its Y plane): PNM, BMP and TIFF through OpenCV's BT.601 fixed
# point (``image_formats.bt601``), PNG through libpng's rgb_to_gray(0.299,
# 0.587) (scaled by 2**15, truncated; grey pixels pass unchanged)
_GRAY_PNG = (9797, 19234, 3737, 15, 0)


def _paeth(a, b, c):
    """The Paeth predictor of the PNG spec (section 9.4), elementwise."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(kinds, a, b, c):
    """Each row filter's prediction from the samples to the left (a),
    above (b) and above-left (c); ``kinds`` broadcasts against them.  Only
    the filters present are computed."""
    pred = np.zeros_like(a)
    for k in np.unique(kinds):
        if k:
            p = (a if k == 1 else b if k == 2 else (a + b) >> 1 if k == 3
                 else _paeth(a, b, c))
            pred = np.where(kinds == k, p, pred)
    return pred


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 samples from the filtered ones ``raw`` and the row
    filter types ``kinds`` (H,).  Pixel (y, x) depends on (y, x - 1),
    (y - 1, x) and (y - 1, x - 1), so each anti-diagonal y + x = k is
    decoded in one step, from a skewed copy whose row k + 2 holds it
    (pixel (y, x) at [x + y + 2, y + 1], so that a step reads contiguous
    memory; column 0 and the entries before each image row's first pixel
    are the zeros the filters see outside the image)."""
    h, w, _ = raw.shape
    rows = np.arange(1, h + 1)[:, None]
    diag = rows + np.arange(w)[None, :] + 1            # x + y + 2
    skew = (h + w + 2, h + 1, raw.shape[2])
    src = np.zeros(skew, np.int16)
    src[diag, rows] = raw
    out = np.zeros(skew, np.int16)
    kind = np.zeros((h + 1, 1), np.int16)
    kind[1:, 0] = kinds
    for j in range(2, h + w + 1):
        lo, hi = max(1, j - w), min(h, j - 1) + 1       # 0 <= x = j - r - 1 < w
        a, b, c = out[j - 1, lo:hi], out[j - 1, lo - 1:hi - 1], \
            out[j - 2, lo - 1:hi - 1]
        pred = _predict(kind[lo:hi], a, b, c)
        out[j, lo:hi] = (src[j, lo:hi] + pred) & 0xFF
    return out[diag, rows].astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) bytes from the (H, 1 + stride) filtered scanlines
    ``rows``, with ``bpp`` bytes a filter unit."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())}")
    units = stride // bpp
    if (kinds >= 3).any():
        return _unfilter_wavefront(rows[:, 1:].reshape(h, units, bpp),
                                   kinds).reshape(h, stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(kinds[y]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(units, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        else:
            cur = line + prev
        out[y] = cur
        prev = out[y]
    return out


def _png_samples(raw: np.ndarray, h: int, w: int, depth: int,
                 ch: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered scanlines: uint16 for 16-bit
    (big-endian pairs), sub-byte samples unpacked (not yet scaled)."""
    if depth == 16:
        pairs = raw[:, :w * ch * 2].reshape(h, w, ch, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if depth < 8:
        vals = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        vals = (vals * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        return vals[:, :w, None].astype(np.uint8)
    return raw[:, :w * ch].reshape(h, w, ch)


# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _decode_png(data: bytes, path: str) -> np.ndarray:
    """(H, W, C) samples of a PNG as ``cv2.imread(path, IMREAD_UNCHANGED)``
    returns them, but in RGB(A) channel order: uint16 for 16-bit files,
    else uint8; gray below 8 bits scaled to 0-255; gray + alpha as four
    channels (gray three times); palette images expanded to RGB, or RGBA
    when a ``tRNS`` chunk gives alpha; an RGB image with a ``tRNS`` colour
    gains alpha (0 on that colour, else opaque)."""
    pos, idat, header, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_TYPES:
        raise NotImplementedError(f"{path}: PNG colour type {color}")
    ch, depths = _PNG_TYPES[color]
    if depth not in depths:
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {color}")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bits = depth * ch
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        stride = (pw * bits + 7) // 8
        rows = stream[at:at + ph * (stride + 1)]
        at += ph * (stride + 1)
        if rows.size < ph * (stride + 1):
            raise ValueError(f"{path}: truncated PNG image data")
        try:
            raw = _unfilter(rows.reshape(ph, stride + 1), max(bits // 8, 1))
        except ValueError as exc:
            raise ValueError(f"{path}: {exc}") from None
        out[y0::dy, x0::dx] = _png_samples(raw, ph, pw, depth, ch)
    if depth < 8 and color == 0:
        out = out * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        idx = out[..., 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError(f"{path}: palette index beyond PLTE")
        out = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)[:len(plte)]
            alpha[:len(t)] = t
            out = np.concatenate([out, alpha[idx][..., None]], -1)
    elif color == 4:
        out = out[..., [0, 0, 0, 1]]
    elif color == 2 and trns is not None and len(trns) >= 6:
        key = np.frombuffer(trns[:6], ">u2").astype(out.dtype)
        alpha = np.where((out == key).all(-1), 0, np.iinfo(out.dtype).max)
        out = np.concatenate([out, alpha[..., None].astype(out.dtype)], -1)
    return np.ascontiguousarray(out)


def _pnm_header(data: bytes, n: int) -> Tuple[list, int]:
    """The first ``n`` header tokens after the magic, and the offset of
    the raster (one whitespace byte after the last token)."""
    tokens, pos = [], 2
    while len(tokens) < n:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    return tokens, pos + 1


def _ascii_values(text: bytes, count: int, digits: bool) -> np.ndarray:
    """The first ``count`` numbers of an ASCII raster (comments skipped);
    ``digits``: one digit a number, spaces optional (P1)."""
    lines = [ln.split(b"#", 1)[0] for ln in text.splitlines()]
    body = b" ".join(lines)
    if digits:
        vals = np.frombuffer(body, np.uint8)
        vals = vals[(vals == ord("0")) | (vals == ord("1"))] - ord("0")
    else:
        vals = np.array(body.split()[:count], np.int64)
    if vals.size < count:
        raise ValueError("truncated ASCII PNM raster")
    return vals[:count].astype(np.int64)


def _decode_pnm(data: bytes, path: str) -> np.ndarray:
    """(H, W, C) samples of a PBM / PGM / PPM (P1-P6) in RGB order, as
    cv2 reads them: bitmaps as 0 (black) / 255; ASCII samples scaled by
    ``v * 255 // maxval`` (and cut to maxval) below maxval 256, binary ones
    raw; uint16 samples for maxval 256-65535."""
    kind = data[1:2]
    bitmap = kind in b"14"
    (w, h, *rest), pos = _pnm_header(data, 2 if bitmap else 3)
    maxval = 1 if bitmap else rest[0]
    if not 0 < maxval <= 65535:
        raise ValueError(f"{path}: PNM maxval {maxval}")
    c = 3 if kind in b"36" else 1
    n = h * w * c
    try:
        if kind == b"4":
            rows = np.frombuffer(data, np.uint8, h * ((w + 7) // 8), pos)
            vals = np.unpackbits(rows.reshape(h, -1), axis=1)[:, :w]
        elif kind in b"123":
            vals = _ascii_values(data[pos - 1:], n, kind == b"1")
            vals = np.minimum(vals, maxval)
            if maxval < 256 and not bitmap:
                vals = vals * 255 // maxval
        else:
            vals = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8,
                                 n, pos)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    if bitmap:
        vals = np.where(vals != 0, 0, 255)
    dtype = np.uint16 if maxval > 255 else np.uint8
    return np.asarray(vals).astype(dtype).reshape(h, w, c)


def _bmp_rle(data: bytes, pos: int, w: int, h: int, four: bool
             ) -> np.ndarray:
    """(h, w) palette indices of an RLE8 / RLE4 raster, first row the
    bottom one, as OpenCV's BMP reader walks it: pixels a run skips keep
    index 0; an RLE8 run that ends a row moves to the next one, and an
    end-of-line right after it does not skip another row."""
    idx = np.zeros((h, w), np.uint8)
    x = y = 0
    wrapped = False
    n = len(data)

    def advance(k):
        nonlocal x, y
        while True:
            step = min(k, w - x)
            x += step
            k -= step
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if k <= 0:
                return

    while y < h and pos + 2 <= n:
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:                                    # a run
            if x + count > w:
                raise ValueError("BMP RLE run past the row")
            if four:
                pair = np.array([code >> 4, code & 15], np.uint8)
                idx[y, x:x + count] = pair[np.arange(count) % 2]
                x += count
            else:
                idx[y, x:x + count] = code
                x += count
                wrapped = x >= w
                if wrapped:
                    x, y = 0, y + 1
        elif code > 2:                               # absolute pixels
            if x + code > w:
                raise ValueError("BMP RLE run past the row")
            nbytes = (code + 1) // 2 if four else code
            raw = np.frombuffer(data, np.uint8, nbytes, pos)
            pos += (nbytes + 1) & ~1
            if four:
                raw = np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            idx[y, x:x + code] = raw[:code]
            x += code
            wrapped = False
        elif code == 1:                              # end of bitmap
            break
        else:                                        # end of line / delta
            if code == 2:
                advance(data[pos])
                pos += 2
            elif four or not (wrapped and x == 0):
                advance(w - x)
            wrapped = False
    return idx


def _bmp_pixels16(rows: np.ndarray, w: int, five65: bool) -> np.ndarray:
    """(H, W, 3) RGB of 16-bit BMP rows as OpenCV expands them
    (icvCvt_BGR5552BGR / BGR5652BGR: each field shifted to the top of its
    byte, the low bits zero)."""
    t = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
    b = (t << 3) & 0xF8
    if five65:
        g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
    else:
        g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
    return np.stack([r, g, b], -1).astype(np.uint8)


def _decode_bmp(data: bytes, path: str) -> Tuple[np.ndarray, bool]:
    """(H, W, 3|4) RGB(A) samples of a BMP and whether it reads as gray
    unchanged (through OpenCV's BT.601 gray, which leaves a gray palette's
    values as they are): a palette whose 2**bpp entries are all gray, or
    any OS/2 file (OpenCV's reader leaves those unmarked as colour).

    Headers as OpenCV's BmpDecoder reads them: the OS/2 core header (12
    bytes: 16-bit sizes, 3-byte palette entries) and every header of 36
    bytes or more (Windows 3 to 5, OS/2 2), whose bit fields OpenCV reads
    just past the header; 16-bit pixels as 5-5-5 (no bit fields, or those
    masks) or 5-6-5, other 16-bit masks failing in cv2; 32-bit bit
    fields read as BGRA whatever the masks, and four channels unchanged."""
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp, colours, entry = 0, 0, 3
        if bpp not in (1, 4, 8, 24, 32):
            raise NotImplementedError(f"{path}: {bpp}-bit OS/2 BMP")
    elif hsize >= 36:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        (colours,) = struct.unpack_from("<I", data, 46)
        entry = 4
    else:
        raise NotImplementedError(f"{path}: BMP header of {hsize} bytes")
    top_down, h = h < 0, abs(h)
    if bpp not in (1, 4, 8, 16, 24, 32) or comp not in (0, 1, 2, 3) or \
            (comp == 1 and bpp != 8) or (comp == 2 and bpp != 4) or \
            (comp == 3 and bpp not in (16, 32)):
        raise NotImplementedError(f"{path}: {bpp}-bit BMP of compression "
                                  f"{comp}")
    five65 = False
    if bpp == 16 and comp == 3:
        masks = struct.unpack_from("<III", data, 14 + hsize)
        if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
            raise NotImplementedError(
                f"{path}: 16-bit BMP bit fields "
                f"{', '.join(hex(m) for m in masks)} (cv2 fails on them)")
        five65 = masks[0] == 0xF800
    gray = hsize == 12
    stride = ((w * bpp + 31) // 32) * 4
    if bpp <= 8:
        count = (1 << bpp) if hsize == 12 else (colours or (1 << bpp))
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(data, np.uint8, count * entry, 14 + hsize)
        pal[:count] = entries.reshape(-1, entry)[:, 2::-1]
        gray = gray or bool((pal[:1 << bpp] == pal[:1 << bpp, :1]).all())
        if comp:
            idx = _bmp_rle(data, offset, w, h, comp == 2)
        else:
            rows = np.frombuffer(data, np.uint8, stride * h,
                                 offset).reshape(h, stride)
            if bpp == 8:
                idx = rows[:, :w]
            else:
                bits = np.unpackbits(rows, axis=1).reshape(h, -1, bpp)
                idx = (bits * (1 << np.arange(bpp - 1, -1, -1))).sum(-1)
                idx = idx[:, :w].astype(np.uint8)
        rgb = pal[idx]
    else:
        rows = np.frombuffer(data, np.uint8, stride * h,
                             offset).reshape(h, stride)
        if bpp == 16:
            rgb = _bmp_pixels16(rows, w, five65)
        else:
            c = bpp // 8
            order = [2, 1, 0, 3] if bpp == 32 and comp == 3 else [2, 1, 0]
            rgb = rows[:, :w * c].reshape(h, w, c)[..., order]
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb), gray


# TIFF tags
_T_WIDTH, _T_HEIGHT, _T_BITS, _T_COMPRESSION = 256, 257, 258, 259
_T_PHOTOMETRIC, _T_STRIPS, _T_ORIENT, _T_SPP, _T_ROWS = 262, 273, 274, 277, 278
_T_STRIP_BYTES, _T_PLANAR, _T_PREDICTOR, _T_TILE_W = 279, 284, 317, 322
_T_TILE_H, _T_TILES, _T_TILE_BYTES, _T_EXTRA, _T_FORMAT = (323, 324, 325,
                                                         338, 339)
_T_COLORMAP, _T_INKSET, _T_JPEG_TABLES = 320, 332, 347
_T_LUMA, _T_SUBSAMPLING, _T_REF_BW = 529, 530, 532
# none, LZW, JPEG, Deflate (two codes), PackBits
_TIFF_CODECS = (1, 5, 7, 8, 32946, 32773)
# photometric interpretations outside the module's scope
_TIFF_PHOTOMETRIC = {4: "mask", 8: "CIELab"}
# (photometric, samples a pixel) -> the bit depths read: min-is-white and
# min-is-black gray, RGB(A), palette, CMYK, YCbCr
_TIFF_LAYOUTS = {(0, 1): (1, 8), (1, 1): (1, 8, 16, 32), (2, 3): (8, 16, 32),
                 (2, 4): (8, 16), (3, 1): (1, 2, 4, 8), (5, 4): (8,),
                 (6, 3): (8,)}


def _lzw(src: bytes) -> bytes:
    """TIFF LZW (MSB-first codes of 9-12 bits, Clear 256, EOI 257, the
    width growing one code early)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, acc, nbits, prev = 9, 0, 0, None
    for byte in src:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = (acc >> nbits) & ((1 << width) - 1)
            if code == 256:
                table, width, prev = table[:258], 9, None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt LZW data")
            out += entry
            prev = entry
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _packbits(src: bytes) -> bytes:
    out, pos = bytearray(), 0
    while pos < len(src):
        n = src[pos]
        pos += 1
        if n < 128:
            out += src[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += src[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


def _tiff_chunk(raw: bytes, comp: int, tables: bytes = b"",
                ycbcr: bool = False, path: str = "TIFF") -> bytes:
    """A strip's or tile's samples: decompressed, or a JPEG one decoded
    (``tables`` the JPEGTables stream its abbreviated stream leans on) as
    libtiff's RGBA interface has libjpeg decode it: without colour
    conversion for an RGB or gray image, through libjpeg's YCbCr -> RGB
    for a YCbCr one (``ycbcr``)."""
    if comp == 7:
        body = raw[2:] if raw[:2] == b"\xff\xd8" else raw
        head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
        stream = (head or b"\xff\xd8") + body
        if ycbcr:
            return native.jpeg_decode(stream, "color", path)[
                ..., ::-1].tobytes()
        return native.jpeg_decode(stream, "raw", path).tobytes()
    if comp == 5:
        if raw[:2] == b"\x00\x01":
            raise NotImplementedError("old-style (LSB-first) LZW TIFF")
        return _lzw(raw)
    if comp in (8, 32946):
        return zlib.decompress(raw)
    if comp == 32773:
        return _packbits(raw)
    return raw


def _as_tuple(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _tiff_samples(chunk: bytes, rows: int, cols: int, cpp: int,
                  bits: int, stored: np.dtype) -> np.ndarray:
    """(rows, cols, cpp) samples of a decompressed strip or tile; below 8
    bits each row starts on a byte (MSB first)."""
    if bits >= 8:
        return np.frombuffer(chunk, stored, rows * cols * cpp).reshape(
            rows, cols, cpp)
    stride = -(-cols * cpp * bits // 8)
    packed = np.frombuffer(chunk, np.uint8, rows * stride).reshape(
        rows, stride)
    unpacked = np.unpackbits(packed, axis=1)[:, :cols * cpp * bits]
    weights = 1 << np.arange(bits - 1, -1, -1)
    return (unpacked.reshape(rows, cols * cpp, bits) * weights).sum(
        -1).astype(np.uint8).reshape(rows, cols, cpp)


def _tiff_rgba(img: np.ndarray, photo: int, bits: int, tags: dict
               ) -> np.ndarray:
    """libtiff's RGBA interface (tif_getimage.c), which cv2 reads these
    through: min-is-white inverted, bilevel and palette indices through
    their maps (a colormap of 16-bit entries cut to its high byte unless
    every entry is below 256), CMYK as (255 - k) (255 - c) / 255 per
    channel with opaque alpha.  Other images pass unchanged."""
    top = (1 << bits) - 1
    if photo in (0, 1) and bits < 8:
        scale = 255 // top
        img = (img if photo else top - img) * scale
        return img.astype(np.uint8)
    if photo == 0:
        return (top - img).astype(img.dtype)
    if photo == 3:
        cmap = np.asarray(tags[_T_COLORMAP], np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return np.moveaxis(cmap[:, img[..., 0]].astype(np.uint8), 0, -1)
    if photo == 5:
        k = 255 - img[..., 3:].astype(np.int64)
        rgb = k * (255 - img[..., :3].astype(np.int64)) // 255
        alpha = np.full(k.shape, 255)
        return np.concatenate([rgb, alpha], -1).astype(np.uint8)
    return img


def _ycbcr_rgb(img: np.ndarray, tags: dict) -> np.ndarray:
    """8-bit YCbCr samples to RGB as libtiff's RGBA interface converts
    them (tif_color.c, TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB): the luma
    coefficients (tag 529, default 0.299, 0.587, 0.114) give 16-bit
    fixed-point factors from float32 arithmetic; ReferenceBlackWhite (tag
    532, default 0, 255, 128, 255, 128, 255) maps each code through
    float32 ``(c - black) * range / (white - black)``, truncated, into
    integer tables; the sums are clamped to 0..255."""
    f = np.float32
    lr, lg, lb = (f(v) for v in _as_tuple(tags.get(_T_LUMA,
                                                   (0.299, 0.587, 0.114))))
    ref = [f(v) for v in _as_tuple(tags.get(
        _T_REF_BW, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))]

    def fix(x):                     # libtiff's FIX: float product, + 0.5
        x = min(max(x, f(0)), f(2))
        return int(float(x * f(65536)) + 0.5)

    f1 = f(2) - f(2) * lr
    f3 = f(2) - f(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)

    def code2v(c, black, white, scale):
        span = white - black
        v = (c.astype(f) - black) * f(scale) / (span if span != 0 else f(1))
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, ref[4] - f(128), ref[5] - f(128), 127)
    cb = code2v(x, ref[2] - f(128), ref[3] - f(128), 127)
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    half = 1 << 15
    cr_r, cb_b = (d1 * cr + half) >> 16, (d3 * cb + half) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + half
    yy = y_tab[img[..., 0]]
    cbi, cri = img[..., 1], img[..., 2]
    rgb = np.stack([yy + cr_r[cri], yy + ((cb_g[cbi] + cr_g[cri]) >> 16),
                    yy + cb_b[cbi]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _decode_tiff(data: bytes, path: str) -> Tuple[np.ndarray, bool, int]:
    """(H, W, C) samples of a TIFF's first image in RGB(A) order (uint8,
    uint16 (signed samples as their bits) or float32), as cv2 reads them:
    flipped by the orientation tag, 8-bit unassociated alpha
    premultiplied, min-is-white, bilevel, palette and CMYK images as
    libtiff's RGBA interface gives them, JPEG strips decoded with the
    JPEGTables, the predictor undone only under LZW or Deflate (libtiff
    ignores it elsewhere); whether the image is tiled; and its sample
    format (1 unsigned, 2 signed, 3 float)."""
    end = "<" if data[:2] == b"II" else ">"
    tags = _read_ifd(data, struct.unpack_from(end + "I", data, 4)[0], end)
    w, h = tags.get(_T_WIDTH), tags.get(_T_HEIGHT)
    spp = tags.get(_T_SPP, 1)
    bits = set(_as_tuple(tags.get(_T_BITS, 1)))
    comp = tags.get(_T_COMPRESSION, 1)
    photo = tags.get(_T_PHOTOMETRIC, 1)
    planar = tags.get(_T_PLANAR, 1) == 2
    pred = tags.get(_T_PREDICTOR, 1)
    fmt = set(_as_tuple(tags.get(_T_FORMAT, 1)))
    orient = tags.get(_T_ORIENT, 1)
    if comp == 6:
        raise NotImplementedError(f"{path}: old-style JPEG-in-TIFF")
    if comp not in _TIFF_CODECS:
        raise NotImplementedError(f"{path}: TIFF compression {comp}")
    if photo in _TIFF_PHOTOMETRIC:
        raise NotImplementedError(f"{path}: {_TIFF_PHOTOMETRIC[photo]} "
                                  f"TIFF")
    if len(bits) != 1 or len(fmt) != 1:
        raise NotImplementedError(f"{path}: TIFF of mixed samples "
                                  f"{tags.get(_T_BITS)} / {sorted(fmt)}")
    depth, fmt = bits.pop(), fmt.pop()
    if (photo, spp) not in _TIFF_LAYOUTS:
        raise NotImplementedError(f"{path}: TIFF of {spp} samples a pixel "
                                  f"and photometric {photo} (gray, RGB, "
                                  f"RGBA, palette or CMYK only)")
    if depth not in _TIFF_LAYOUTS[photo, spp] or \
            (fmt, depth) not in ((1, depth), (2, 16), (3, 32)) or \
            (depth == 32) != (fmt == 3):
        kind = {1: "unsigned", 2: "signed", 3: "float"}.get(fmt, fmt)
        raise NotImplementedError(f"{path}: TIFF of {depth}-bit {kind} "
                                  f"samples, photometric {photo}")
    if photo == 5 and tags.get(_T_INKSET, 1) != 1:
        raise NotImplementedError(f"{path}: TIFF separated into inks "
                                  f"other than CMYK")
    if comp == 7 and (depth != 8 or photo not in (1, 2, 6) or planar):
        raise NotImplementedError(f"{path}: JPEG-in-TIFF of photometric "
                                  f"{photo}, {depth}-bit"
                                  + (", planar" if planar else ""))
    if photo == 6 and comp != 7 and \
            _as_tuple(tags.get(_T_SUBSAMPLING, (2, 2))) != (1, 1):
        raise NotImplementedError(
            f"{path}: YCbCr TIFF subsampled "
            f"{_as_tuple(tags.get(_T_SUBSAMPLING, (2, 2)))} (1, 1 only)")
    if pred not in (1, 2) or (pred == 2 and depth not in (8, 16)):
        raise NotImplementedError(f"{path}: TIFF predictor {pred} on "
                                  f"{depth}-bit samples")
    if orient not in (1, 2, 3, 4):
        raise NotImplementedError(f"{path}: TIFF orientation {orient} "
                                  f"(cv2 fails on it)")
    code = {8: "u1", 16: "u2", 32: "f4"}.get(depth, "u1")
    stored = np.dtype(end + code)
    dtype = stored.newbyteorder("=")
    tables = bytes(tags.get(_T_JPEG_TABLES, ())) if comp == 7 else b""
    nplanes, cpp = (spp, 1) if planar else (1, spp)
    tiled = _T_TILES in tags
    if tiled:
        tw, th = tags[_T_TILE_W], tags[_T_TILE_H]
        offsets, counts = tags[_T_TILES], tags[_T_TILE_BYTES]
    else:
        tw, th = w, min(tags.get(_T_ROWS, h), h)
        offsets, counts = tags[_T_STRIPS], tags[_T_STRIP_BYTES]
    across, down = -(-w // tw), -(-h // th)
    offsets, counts = _as_tuple(offsets), _as_tuple(counts)
    out = np.zeros((nplanes, down * th, across * tw, cpp), dtype)
    for k, (off, cnt) in enumerate(zip(offsets, counts)):
        plane, k = divmod(k, across * down)
        ty, tx = divmod(k, across)
        if plane >= nplanes:
            break
        try:
            raw = _tiff_chunk(data[off:off + cnt], comp, tables,
                              photo == 6, path)
        except (ValueError, zlib.error) as exc:
            raise ValueError(f"{path}: {exc}") from None
        rows = th if tiled else min(th, h - ty * th)
        need = rows * -(-tw * cpp * depth // 8)
        if len(raw) < need:
            raise ValueError(f"{path}: truncated TIFF strip or tile")
        chunk = _tiff_samples(raw, rows, tw, cpp, depth, stored).astype(
            dtype)
        if pred == 2 and comp in (5, 8, 32946):
            chunk = np.cumsum(chunk, axis=1, dtype=dtype)
        out[plane, ty * th:ty * th + rows, tx * tw:(tx + 1) * tw] = chunk
    out = out[:, :h, :w]
    img = np.moveaxis(out[..., 0], 0, -1) if planar else out[0]
    img = {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1],
           4: img[::-1]}[orient]
    img = _tiff_rgba(img, photo, depth, tags)
    if photo == 6 and comp != 7:
        img = _ycbcr_rgb(img, tags)
    if photo == 2 and spp == 4 and depth == 8 and \
            _as_tuple(tags.get(_T_EXTRA, 0))[0] == 2:
        img = _premultiply(img)
    return np.ascontiguousarray(img), tiled, fmt


def _png_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's rgb_to_gray(0.299, 0.587) of 8- or 16-bit RGB samples
    (scaled by 2**15: truncated at 8 bits, rounded at 16; gray pixels
    pass unchanged)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    cr, cg, cb, shift, rnd = _GRAY_PNG
    if rgb.dtype == np.uint16:
        rnd = 1 << 14
    y = (r * cr + g * cg + b * cb + rnd) >> shift
    return np.where((r == g) & (r == b), r, y).astype(rgb.dtype)


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """libtiff's RGBA interface on 8-bit unassociated alpha: each colour
    times alpha / 255, rounded."""
    a = rgba[..., 3:].astype(np.int64)
    rgb = (rgba[..., :3].astype(np.int64) * a + 127) // 255
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _orient(img: np.ndarray, value: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: the view of ``img`` for EXIF
    orientation 1-8."""
    if value >= 5:
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(value, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _jpeg(data: bytes, mode: str, path: str) -> np.ndarray:
    """A JPEG's ``imread``: the native decode, turned by the EXIF
    orientation of its first APP1 segment (the one cv2 reads) unless
    ``mode`` is "unchanged"."""
    img = native.jpeg_decode(data, mode, path)
    if mode != "unchanged":
        off, n = native.jpeg_header(data, path)["app1"]
        if n >= 6 and data[off:off + 6] == b"Exif\0\0":
            img = _orient(img, orientation(data[off + 6:off + n]))
    return img


def _other_format(data: bytes, path: str):
    """The decoder ``(data, mode, path) -> array`` of the formats whose
    modes follow their own rules (WebP, GIF, Radiance HDR, PFM, PAM, Sun
    raster, JPEG 2000, AVIF), by signature; None for the rest."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _webp
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return image_formats.decode_gif
    if data[:2] in (b"PF", b"Pf"):
        return image_formats.decode_pfm
    if data[:2] == b"P7":
        return image_formats.decode_pam
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return image_formats.decode_hdr
    if data[:4] == image_formats.SUN_MAGIC:
        return image_formats.decode_sun
    if data[:12] == _JP2_SIGNATURE or data[:4] == b"\xff\x4f\xff\x51":
        return _jpeg2000
    if data[4:8] == b"ftyp" and _avif_brand(data):
        return _avif
    return None


def _avif_brand(data: bytes) -> bool:
    """An ISOBMFF file whose ftyp names the avif or avis brand (major or
    compatible), as libavif's avifPeekCompatibleFileType asks."""
    size = struct.unpack(">I", data[:4])[0]
    if size < 16 or size > len(data):
        return data[8:12] in (b"avif", b"avis")
    brands = [data[8:12]] + [data[k:k + 4] for k in range(16, size - 3, 4)]
    return bool({b"avif", b"avis"} & set(brands))


_JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"


def _yuv_bgr(y, u, v) -> np.ndarray:
    """cvtColor's COLOR_YUV2BGR of 8-bit samples: coefficients 2.032,
    -0.395, -0.581 and 1.140 in 14-bit fixed point, rounded, saturated."""
    def descale(x):
        return (x + (1 << 13)) >> 14
    u, v = u - 128, v - 128
    bgr = np.stack([y + descale(u * 33292),
                    y + descale(u * -6472 + v * -9519),
                    y + descale(v * 18678)], -1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def _jpeg2000(data: bytes, mode: str, path: str) -> np.ndarray:
    """A JPEG 2000 file's ``imread`` (a JP2 box or a raw codestream) by
    OpenCV 5.0's rules for OpenJPEG's output: the depth from the
    codestream's highest precision (8 bits: uint8; 9-16: uint16 unchanged,
    cut by ``>> (precision - 8)`` in the colour and gray modes; above 16
    bits only those modes), every channel shifted alike and saturated; the
    JP2 colour space decides the channels: sRGB (and an unknown or
    unspecified one, as a raw codestream's) reads RGB(A) as BGR(A) and
    gray through cvtColor's BGR2GRAY (one or two components: the first), gray repeats
    its one component, sYCC converts through cvtColor's YUV2BGR (gray: its
    Y); the JP2 palette and channel definitions applied first.  Raises
    NotImplementedError naming each kind cv2 fails on: other than 1-4
    components, signed ones, a precision below 8 bits, sub-sampled
    components or an image offset, two components read unchanged, eYCC or
    CMYK, or a stream OpenJPEG's strict decoder refuses (a cut one)."""
    head = native.jp2_info(data, path)
    n, comps = head["components"], head["comps"]
    if not 1 <= n <= 4:
        raise NotImplementedError(f"{path}: JPEG 2000 of {n} components "
                                  f"(cv2 reads 1 to 4)")
    if any(c[1] for c in comps):
        raise NotImplementedError(f"{path}: JPEG 2000 with signed "
                                  f"components (cv2 fails on them)")
    prec = max(c[0] for c in comps)
    if prec < 8:
        raise NotImplementedError(f"{path}: JPEG 2000 of {prec}-bit "
                                  f"samples (cv2 fails below 8 bits)")
    if mode == "unchanged":
        out_ch, out_prec = n, (8 if prec == 8 else 16)
        if prec > 16:
            raise NotImplementedError(f"{path}: JPEG 2000 of {prec}-bit "
                                      f"samples read unchanged (cv2 fails "
                                      f"above 16 bits)")
        if n == 2:
            raise NotImplementedError(f"{path}: JPEG 2000 of two components "
                                      f"(gray and alpha) read unchanged "
                                      f"(cv2 fails on it)")
    else:
        out_ch, out_prec = (1 if mode == "gray" else 3), 8
    if head["x0"] or head["y0"] or any(c[2:4] != (1, 1) for c in comps):
        raise NotImplementedError(f"{path}: JPEG 2000 with an image offset "
                                  f"or sub-sampled components (cv2 fails: "
                                  f"\"tiles are not supported\")")
    space = native.JP2_COLOR_SPACES[head["colour_space"]]
    if space not in ("unknown", "unspecified", "sRGB", "gray", "sYCC"):
        raise NotImplementedError(f"{path}: JPEG 2000 in {space} (cv2 fails "
                                  f"to convert it)")
    planes = native.jp2_decode(data, path)
    shift = max(prec - out_prec, 0)
    dtype = np.uint8 if out_prec == 8 else np.uint16

    def cut(ks):
        top = (1 << out_prec) - 1
        return np.stack([np.clip(planes[k] >> shift, 0, top) for k in ks],
                        -1).astype(dtype)

    fails = NotImplementedError(f"{path}: JPEG 2000 of {len(planes)} "
                                f"channels in {space}, read into {out_ch} "
                                f"(cv2 fails on it)")
    if space == "gray":
        if out_ch == 4:
            raise fails
        img = cut([0] * out_ch)
    elif space == "sYCC":
        if out_ch == 1:
            img = cut([0])
        elif out_ch == 3 and len(planes) >= 3 and dtype == np.uint8:
            y, u, v = (planes[k].astype(np.int64) >> shift for k in range(3))
            img = _yuv_bgr(*(np.clip(c, 0, 255) for c in (y, u, v)))
        else:
            raise fails
    elif out_ch == 1:
        if len(planes) <= 2:
            img = cut([0])
        elif dtype == np.uint8:
            img = image_formats.gray_cvt(cut([2, 1, 0]))[..., None]
        else:
            raise fails
    elif len(planes) >= out_ch:
        img = cut([2, 1, 0, 3][:out_ch])
    else:
        raise fails
    return np.ascontiguousarray(img[..., 0] if out_ch == 1 else img)


def _avif_alpha_bgr8(y, u, v, head, full, mc, cp) -> np.ndarray:
    """The BGR libavif gives OpenCV for a 10- or 12-bit image with alpha
    read into 8 bits (libyuv's *AlphaToARGB routes): 10-bit samples
    straight through libyuv's 10-bit pixel (chroma upsampled at full
    precision), 12-bit 4:2:0 through its 12-bit pixel with the chroma
    repeated, other 12-bit images cut to 8 bits first like the images
    without alpha."""
    depth, ssx, ssy = head["depth"], head["ssx"], head["ssy"]
    h, w = y.shape
    if depth == 12 and not (ssx and ssy):
        return image_formats.avif_bgr((y, u, v), depth, ssx, ssy, full, mc, 8,
                                      cp)
    if ssx and depth == 10:
        u, v = (image_formats.libyuv_chroma(p, h, w, ssy) for p in (u, v))
    elif ssx:
        rows, cols = np.arange(h) >> ssy, np.arange(w) >> ssx
        u, v = (p[rows[:, None], cols[None, :]] for p in (u, v))
    return image_formats.libyuv_bgr_high(y, u, v, depth, full, mc)


def _avif(data: bytes, mode: str, path: str) -> np.ndarray:
    """An AVIF file's ``imread`` by OpenCV 5.0's rules for libavif's
    output (``native/avif.cpp`` decodes the planes libaom gives libavif):
    the image's channels are 1 (4:0:0) or 3, plus its alpha; a 4:0:0
    image is its Y plane as it stands (10 and 12 bits cut to 8 by
    convertTo's rounding, ``rint(v / 2**(depth - 8))``, except
    unchanged), repeated to BGR in the colour mode; colour images go
    through libavif's avifImageYUVToRGB (``image_formats.avif_bgr``) into
    8 bits, or into the image's depth (uint16) unchanged, with the CICP
    and range of the colr nclx property (else the AV1 sequence header's);
    alpha is a fourth channel unchanged (BGRA), dropped in the colour
    mode, ignored by cvtColor's BGR2GRAY in the gray mode; irot, imir,
    clap and an Exif item's orientation are ignored, as cv2 ignores
    them.  Raises NotImplementedError naming each kind the port does not
    decode or cv2 fails on (gray with alpha, premultiplied or
    limited-range alpha)."""
    head, planes = native.avif_decode(data, path)
    depth, mono, alpha = head["depth"], head["monochrome"], head["alpha"]
    if mono and alpha:
        raise NotImplementedError(f"{path}: AVIF gray with alpha (two "
                                  f"channels; cv2 fails on it)")
    if alpha and head["premultiplied"]:
        raise NotImplementedError(f"{path}: AVIF with premultiplied alpha")
    if alpha and not head["alpha_full_range"]:
        raise NotImplementedError(f"{path}: AVIF with limited-range alpha")
    out_depth = depth if mode == "unchanged" else 8
    dtype = np.uint8 if out_depth == 8 else np.uint16
    if mono:
        y = planes[0].astype(np.int64)
        if out_depth < depth:
            y = np.clip(np.rint(y / (1 << (depth - 8))), 0, 255)
        img = y.astype(dtype)
        if mode == "color":
            img = np.repeat(img[..., None], 3, -1)
    else:
        key = "nclx_" if head["nclx"] else ""
        full, mc, cp = (head[key + k] for k in ("full_range", "mc", "cp"))
        y, u, v = planes[:3]
        try:
            yuv_mc = image_formats.libyuv_matrix(mc, cp)
            if alpha and out_depth == 8 and depth > 8 and yuv_mc:
                img = _avif_alpha_bgr8(y, u, v, head, full, yuv_mc, cp)
            else:
                img = image_formats.avif_bgr((y, u, v), depth, head["ssx"],
                                             head["ssy"], full, mc,
                                             out_depth, cp)
        except NotImplementedError as exc:
            raise NotImplementedError(f"{path}: AVIF with {exc}") from None
        if mode == "unchanged" and alpha:
            a = planes[3]
            img = np.concatenate([img, a[..., None].astype(dtype)], -1)
        elif mode == "gray":
            img = image_formats.gray_cvt(img)
    return img


def _webp(data: bytes, mode: str, path: str) -> np.ndarray:
    """A WebP's ``imread``: the native decode (``native/webp.cpp``), BGRA
    unchanged where the file has alpha, else BGR; gray through cvtColor;
    turned by the orientation in its EXIF chunk unless ``mode`` is
    "unchanged"."""
    head = native.webp_info(data, path)
    channels = {"gray": 1, "color": 3}.get(
        mode, 4 if head["has_alpha"] else 3)
    img = native.webp_decode(data, channels, path)
    if mode == "unchanged":
        return img
    off, n = head["exif"]
    if n:
        block = data[off:off + n]
        if block.startswith(b"Exif\0\0"):
            block = block[6:]
        img = _orient(img, orientation(block))
    return img


MODES = ("color", "gray", "unchanged")


def imread(path: str, mode: str = "color") -> np.ndarray:
    """The array ``cv2.imread(path, flag)`` returns, for ``mode`` "color"
    (IMREAD_COLOR), "gray" (IMREAD_GRAYSCALE) or "unchanged"
    (IMREAD_UNCHANGED); raises FileNotFoundError for a missing file,
    NotImplementedError naming a format or feature outside the module's
    scope and ValueError for a corrupt file."""
    if mode not in MODES:
        raise ValueError(f"imread mode {mode!r} (one of {MODES})")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return _jpeg(data, mode, path)
    other = _other_format(data, path)
    if other is not None:
        return other(data, mode, path)
    gray_file = False
    if data[:8] == _PNG_SIGNATURE:
        fmt = "png"
        raw = _decode_png(data, path)
    elif data[:1] == b"P" and data[1:2] in b"123456" and len(data) > 2:
        fmt = "pnm"
        raw = _decode_pnm(data, path)
    elif data[:2] == b"BM":
        fmt = "bmp"
        raw, gray_file = _decode_bmp(data, path)
    elif data[:4] in (b"II*\0", b"MM\0*"):
        fmt = "tiff"
        raw, tiled, sample_format = _decode_tiff(data, path)
        if mode != "unchanged":
            if sample_format == 3:
                raise NotImplementedError(f"{path}: float TIFF read as "
                                          f"8-bit (cv2 fails on it)")
            if tiled and raw.dtype == np.uint16 and raw.shape[2] == 1:
                raise NotImplementedError(f"{path}: 16-bit gray tiled TIFF "
                                          f"read as 8-bit (cv2 misreads "
                                          f"it)")
        elif sample_format == 2:
            raw = raw.view(np.int16)
    else:
        raise NotImplementedError(
            f"{path}: unknown image format (JPEG, PNG, PNM, PAM, PFM, BMP, "
            f"TIFF, WebP, GIF, Radiance HDR, Sun raster and JPEG 2000 "
            f"only)")
    if mode == "unchanged":
        if gray_file:
            return image_formats.bt601(raw[..., :3])
        if raw.shape[2] == 1:
            return np.ascontiguousarray(raw[..., 0])
        return np.ascontiguousarray(raw[..., [2, 1, 0, 3][:raw.shape[2]]])
    if raw.shape[2] in (2, 4):
        raw = raw[..., :-1]                    # alpha dropped, as cv2
    if raw.dtype == np.uint16 and fmt != "png":
        if fmt == "tiff" and raw.shape[2] == 3:
            raw = ((raw.astype(np.int64) * 255 + 32767) // 65535)
        else:
            raw = raw >> 8
        raw = raw.astype(np.uint8)
    if mode == "gray":
        if raw.shape[2] == 1:
            img = raw[..., 0]
        else:
            img = (_png_gray(raw) if fmt == "png"
                   else image_formats.bt601(raw))
    else:
        img = (np.repeat(raw, 3, axis=2) if raw.shape[2] == 1
               else raw[..., ::-1])
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)      # the high byte, as cv2
    if fmt == "png":
        img = _orient(img, orientation(_exif_block(data)))
    return np.ascontiguousarray(img)


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 in [0, 1]; RGB (H, W, 3) or gray (H, W)."""
    img = imread(path, "gray" if gray else "color")
    if not gray:
        img = img[..., ::-1]
    return img.astype(np.float32) / 255.0


def load_semantic_mask(path: str) -> np.ndarray:
    """A semantic-segmentation mask as an (H, W) int32 label map (ref:
    Image::maskName, frame_main/libs/MVS/Image.h:75-99, read by
    GenerateDepthPrior, SceneDensify.cpp:1550-1950), read as
    ``cv2.IMREAD_UNCHANGED`` reads it.  8/16-bit single-channel files are
    their own labels; in a colour-coded mask each distinct colour becomes
    one label, numbered in the order of a code built from the channels in
    cv2's BGR(A) order, as the JAX package numbers them."""
    raw = imread(path, "unchanged")
    if raw.ndim == 2:
        return raw.astype(np.int32)
    flat = raw.reshape(-1, raw.shape[2]).astype(np.int64)
    code = flat[:, 0]
    for c in range(1, raw.shape[2]):
        code = code * 256 + flat[:, c]
    _, labels = np.unique(code, return_inverse=True)
    return labels.reshape(raw.shape[:2]).astype(np.int32)


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index of each output cell:
    floor(dst * n_src / n_dst) in cv2's double arithmetic, clamped."""
    inv = 1.0 / (n_dst / n_src)
    return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64),
                      n_src - 1)


def resize_mask(mask: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of a label map to ``shape_hw`` (labels
    must not blend), as ``cv2.resize(..., INTER_NEAREST)``."""
    h, w = shape_hw
    if mask.shape == (h, w):
        return mask
    ys = _nearest_index(mask.shape[0], h)
    xs = _nearest_index(mask.shape[1], w)
    return mask.astype(np.int32)[ys[:, None], xs[None, :]]


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) -> gray (H, W) with the BT.601 weights cv2 uses."""
    if img.ndim == 2:
        return img
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(img.dtype)


def compute_resolution_scale(width: int, height: int, resolution_level: int,
                             max_resolution: int, min_resolution: int
                             ) -> float:
    """Scale factor for a resolution level (ref: frame_main/libs/MVS/
    Image.cpp RecomputeMaxResolution — halve the max dimension
    ``resolution_level`` times, clamp into [min_resolution,
    max_resolution])."""
    max_dim = max(width, height)
    target = max_dim >> resolution_level
    if max_resolution > 0:
        target = min(target, max_resolution)
    if min_resolution > 0:
        target = max(target, min(min_resolution, max_dim))
    return target / max_dim


def _area_taps(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """INTER_AREA along one axis as taps: (n_dst, k) source indices and
    weights, each output cell averaging the source cells it overlaps, by
    overlap (cv2 ``computeResizeAreaTab``, including its 1e-3 threshold on
    partial cells); k is the most cells one output cell touches."""
    scale = 1.0 / (n_dst / n_src)
    fsx1 = np.arange(n_dst) * scale
    fsx2 = fsx1 + scale
    cell = np.minimum(scale, n_src - fsx1)
    sx2 = np.minimum(np.floor(fsx2), n_src - 1).astype(np.int64)
    sx1 = np.minimum(np.ceil(fsx1), sx2).astype(np.int64)
    left = np.where(sx1 - fsx1 > 1e-3,
                    ((sx1 - fsx1) / cell).astype(np.float32), 0.0)
    right = np.where(fsx2 - sx2 > 1e-3, (np.minimum(np.minimum(
        fsx2 - sx2, 1.0), cell) / cell).astype(np.float32), 0.0)
    full = (1.0 / cell).astype(np.float32)
    k = int((sx2 - sx1).max()) + 2
    pos = (sx1 - 1)[:, None] + np.arange(k)
    wts = np.where(pos == (sx1 - 1)[:, None], left[:, None],
                   np.where(pos < sx2[:, None], full[:, None],
                            np.where(pos == sx2[:, None], right[:, None],
                                     0.0)))
    return np.clip(pos, 0, n_src - 1), wts


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``: the product of two float32 values is exact
    in float64, the sum is rounded there and then to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _linear_coords(n_src: int, n_dst: int, f32: bool):
    """INTER_LINEAR's source index and float32 fraction along one axis:
    half-pixel centres, the position in float64 (``f32``: cast to float32
    first, as cv2 does for a source one pixel high or wide)."""
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    if f32:
        f = f.astype(np.float32).astype(np.float64)
    sx = np.floor(f)
    return sx.astype(np.int64), (f - sx).astype(np.float32)


def _resize_linear_f32(x: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(INTER_LINEAR)`` of float32 (H, W, C): along x, then
    along y, each output ``fma(p1 - p0, t, p0)`` in float32 with both
    taps clamped into the image; a source one pixel high or wide takes
    cv2's other route (float32 positions, a clamped tap weighted 0,
    ``p0 * (1 - t) + p1 * t``)."""
    h, w = x.shape[:2]
    old = h == 1 or w == 1
    for axis, (n, m) in enumerate(((w, new_w), (h, new_h))):
        ax = 1 - axis
        sx, t = _linear_coords(n, m, old)
        i0, i1 = np.clip(sx, 0, n - 1), np.clip(sx + 1, 0, n - 1)
        shape = (-1,) + (1,) * (x.ndim - ax - 1)
        p0, p1 = np.take(x, i0, ax), np.take(x, i1, ax)
        if old:
            if ax == 1:
                t = np.where((sx < 0) | (sx >= n - 1), np.float32(0), t)
            t = t.reshape(shape)
            x = p0 * (np.float32(1) - t) + p1 * t
        else:
            x = _fma32(p1 - p0, t.reshape(shape), p0)
    return x


def _linear_taps_u8(n_src: int, n_dst: int, columns: bool):
    """cv2.resize's INTER_LINEAR taps for uint8 along one axis: the two
    source indices and their 11-bit fixed-point weights (saturate_cast<
    short>(w * 2048), rounding to nearest), positions in float32.  Along
    columns a tap left of the first or right of the last source column
    takes that column whole (weights 2048, 0); along rows the weights
    stay and both indices are clamped."""
    i0, f = _linear_coords(n_src, n_dst, True)
    if columns:
        edge = (i0 < 0) | (i0 >= n_src - 1)
        f[edge] = 0
        i0 = np.clip(i0, 0, n_src - 1)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return (np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1),
            w0, w1)


def _resize_linear_u8(src: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(INTER_LINEAR)`` of uint8 (H, W, C) as int64: rows
    summed horizontally with 11-bit weights, then
    ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``
    vertically."""
    h, w = src.shape[:2]
    x0, x1, a0, a1 = _linear_taps_u8(w, new_w, columns=True)
    y0, y1, b0, b1 = _linear_taps_u8(h, new_h, columns=False)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    return (((b0[:, None, None] * (rows[y0] >> 4)) >> 16)
            + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2


def _resize_area(x: np.ndarray, new_h: int, new_w: int,
                 u8: bool) -> np.ndarray:
    """``cv2.resize(INTER_AREA)`` shrinking (H, W, C) float32 (``u8``:
    uint8 samples as int64): ``resizeArea``'s float32 sums, along x
    (tap after tap of ``_area_taps``) then along y, rounded to nearest
    for uint8; at integer ratios its fast path instead (``_area_fast``)."""
    h, w = x.shape[:2]
    kx, ky = w / new_w, h / new_h
    if kx == int(kx) and ky == int(ky):
        return _area_fast(x, int(ky), int(kx), u8)
    x = x.astype(np.float32)
    for ax, (n, m) in ((1, (w, new_w)), (0, (h, new_h))):
        idx, wts = _area_taps(n, m)
        wts = wts.astype(np.float32)
        shape = (-1,) + (1,) * (x.ndim - ax - 1)
        out = np.take(x, idx[:, 0], ax) * wts[:, 0].reshape(shape)
        for j in range(1, idx.shape[1]):
            live = (wts[:, j] != 0).reshape(shape)
            out = np.where(live, out + np.take(x, idx[:, j], ax)
                           * wts[:, j].reshape(shape), out)
        x = out
    return np.rint(x) if u8 else x


def _area_fast(x: np.ndarray, ky: int, kx: int, u8: bool) -> np.ndarray:
    """``resizeAreaFast``: each output the sum of its ky x kx block, row
    by row in groups of four (``((a + b) + c) + d``), times 1 / area; at
    2 x 2, uint8 is ``(a + b + c + d + 2) >> 2`` and one-channel float32
    ``((a00 + a01) + (a10 + a11)) * 0.25`` over the samples its 4-lane
    SIMD loop covers."""
    h, w, cn = x.shape
    nh, nw = h // ky, w // kx
    blocks = [x[i::ky, j::kx][:nh, :nw] for i in range(ky) for j in range(kx)]
    if u8 and (ky, kx) == (2, 2):
        return (blocks[0] + blocks[1] + blocks[2] + blocks[3] + 2) >> 2
    area = ky * kx
    total = None
    for g in range(0, area - 3, 4):
        part = ((blocks[g] + blocks[g + 1]) + blocks[g + 2]) + blocks[g + 3]
        total = part if total is None else total + part
    for g in range(area // 4 * 4, area):
        total = blocks[g] if total is None else total + blocks[g]
    out = total.astype(np.float32) * np.float32(1.0 / area)
    if u8:
        return np.rint(out)
    if (ky, kx) == (2, 2) and cn == 1:
        simd = ((blocks[0] + blocks[1]) + (blocks[2] + blocks[3])) \
            * np.float32(0.25)
        lanes = np.arange(nw)[None, :, None] < nw // 4 * 4
        out = np.where(lanes, simd, out)
    return out


def _resize(img: np.ndarray, new_h: int, new_w: int, area: bool
            ) -> np.ndarray:
    """cv2.resize of (H, W[, C]) to (new_h, new_w), INTER_AREA (``area``)
    or INTER_LINEAR, bit for bit for uint8 and float32 samples; other
    dtypes go through float32 and back.  INTER_LINEAR of uint8 at an
    exact 2 x 2 reduction is INTER_AREA's fast path, as cv2 swaps it in
    (for float32 it is not)."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    u8 = img.dtype == np.uint8
    x = x.astype(np.int64) if u8 else x.astype(np.float32, copy=False)
    if u8 and (h, w) == (2 * new_h, 2 * new_w):
        area = True
    if area:
        out = _resize_area(x, new_h, new_w, u8)
    elif u8:
        out = _resize_linear_u8(x, new_h, new_w)
    else:
        out = _resize_linear_f32(x, new_h, new_w)
    if u8:
        out = np.clip(out, 0, 255)
    return out.astype(img.dtype).reshape((new_h, new_w) + img.shape[2:])


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Resize (H, W[, C]) by ``scale`` like ``cv2.resize``: INTER_AREA
    when shrinking, INTER_LINEAR when enlarging."""
    if scale == 1.0:
        return img
    h, w = img.shape[:2]
    new_w, new_h = max(1, round(w * scale)), max(1, round(h * scale))
    return _resize(img, new_h, new_w, area=scale < 1.0)


def resize_linear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Resize (H, W[, C]) to (new_h, new_w) like ``cv2.resize``'s default,
    INTER_LINEAR, whichever way the size goes."""
    if img.shape[:2] == (new_h, new_w):
        return img
    return _resize(img, new_h, new_w, area=False)


def _reflect101(n: int, m: int) -> np.ndarray:
    """(m, 5) source indices of pyrDown's taps 2i-2 .. 2i+2 under
    BORDER_REFLECT_101."""
    idx = 2 * np.arange(m)[:, None] + np.arange(-2, 3)
    if n == 1:
        return np.zeros_like(idx)
    idx = np.abs(idx)
    return np.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _pyr_scalar(t):
    """cv2's scalar [1 4 6 4 1] sum of five float32 taps."""
    f = np.float32
    return ((t[2] * f(6) + (t[1] + t[3]) * f(4)) + t[0]) + t[4]


def _pyr_sse_h(t):
    """The same sum in cv2's horizontal SSE loop (v_muladd is a multiply
    and an add at its SSE3 baseline)."""
    f = np.float32
    return t[2] * f(6) + ((t[1] + t[3]) * f(4) + (t[0] + t[4]))


def _pyr_sse_v(t):
    """The same sum in cv2's vertical SSE loop."""
    return (((t[1] + t[3]) + t[2]) * np.float32(4)
            + ((t[0] + t[4]) + (t[2] + t[2])))


def _pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown``: the 5 x 5 [1 4 6 4 1]^2 / 256 kernel, BORDER_
    REFLECT_101, output ((H + 1) // 2, (W + 1) // 2); integer samples
    rounded ((sum + 128) >> 8), float32 ones summed in cv2's order (its
    4-lane SSE loops inside, scalar code at the borders and the tail)."""
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    ix, iy = _reflect101(w, ow), _reflect101(h, oh)
    x = img.reshape(h, w, cn)
    if img.dtype == np.float32:
        # the horizontal SSE loop covers output pixels 1 .. n_px (4
        # samples a step; 3-channel images one pixel a step while 4
        # samples remain), the vertical one the first multiple of 4
        # samples of each row
        inner = max(min(int((w - 3) / 2) + 1, ow) - 1, 0)
        n_px = (max(0, (inner * 3 - 4) // 3 + 1) if cn == 3
                else (inner * cn // 4) * 4 // cn)
        px = np.arange(ow)[None, :, None]
        taps = [x[:, ix[:, j]] for j in range(5)]
        rows = np.where((px >= 1) & (px <= n_px), _pyr_sse_h(taps),
                        _pyr_scalar(taps))
        taps = [rows[iy[:, j]] for j in range(5)]
        sample = np.arange(ow * cn).reshape(1, ow, cn)
        out = np.where(sample < (ow * cn // 4) * 4, _pyr_sse_v(taps),
                       _pyr_scalar(taps)) * np.float32(1 / 256)
    elif img.dtype in (np.uint8, np.uint16):
        x = x.astype(np.int64)
        k = (1, 4, 6, 4, 1)
        rows = sum(k[j] * x[:, ix[:, j]] for j in range(5))
        out = sum(k[j] * rows[iy[:, j]] for j in range(5))
        out = (out + 128) >> 8
    else:
        raise NotImplementedError(f"build_pyramid of {img.dtype} images "
                                  f"(uint8, uint16, float32 only)")
    return out.astype(img.dtype).reshape((oh, ow) + img.shape[2:])


def build_pyramid(img: np.ndarray, levels: int) -> List[np.ndarray]:
    """Half-resolution pyramid, level 0 = input (``cv2.pyrDown`` each
    level)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_pyr_down(pyr[-1]))
    return pyr


def pad_to_multiple(img: np.ndarray, multiple: int,
                    value: float = 0.0) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pad H and W up to a multiple; returns the padded image and the
    original (H, W) so outputs can be cropped back (``value`` is unused,
    as in the JAX package)."""
    h, w = img.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (h, w)
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge"), (h, w)


def write_png(path: str, img: np.ndarray, filters=2,
              exif: Optional[bytes] = None) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA samples as a PNG
    (zlib level 6): 16-bit for a uint16 array, else 8-bit.  ``filters`` is
    the row filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of every
    row, or a sequence of one per row.  ``exif``: a TIFF EXIF block
    (``io.exif.exif_bytes``) written as an ``eXIf`` chunk."""
    depth = 16 if np.asarray(img).dtype == np.uint16 else 8
    img = np.ascontiguousarray(img, np.uint16 if depth == 16 else np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[c]
    # filters act on bytes: a 16-bit sample is two (big-endian) channels
    x = img.reshape(h, w, c).astype(">u2" if depth == 16 else np.uint8)
    x = x.view(np.uint8).reshape(h, w, -1).astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    ul = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    kinds = np.broadcast_to(np.asarray(filters, np.int16), (h,))[:, None, None]
    pred = _predict(kinds, a, b, ul)
    raw = np.concatenate([kinds[:, :, 0].astype(np.uint8),
                          ((x - pred) & 0xFF).astype(np.uint8)
                          .reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                           0, 0)))
        if exif:
            f.write(chunk(b"eXIf", exif))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def list_images(directory: str) -> List[str]:
    """The image files of a directory (by extension), sorted by name."""
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm"}
    names = sorted(n for n in os.listdir(directory)
                   if os.path.splitext(n)[1].lower() in exts)
    return [os.path.join(directory, n) for n in names]


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to the jet colormap: (..., 3) uint8 RGB (ref:
    the reference's jet-coloured depth PNGs, DepthMap.cpp:2526)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def save_depth_png(path: str, depth: np.ndarray,
                   d_min: float = None, d_max: float = None) -> None:
    """Write a jet-coloured depth PNG (invalid = black), the debug
    artifact the reference dumps per stage."""
    valid = depth > 0
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    x = (depth - d_min) / max(d_max - d_min, 1e-9)
    rgb = jet_colormap(x)
    rgb[~valid] = 0
    write_png(path, rgb)
