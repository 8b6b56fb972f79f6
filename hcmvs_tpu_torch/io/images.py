"""Image loading, grayscale conversion and resizing without OpenCV (port of
the main-path functions of ``hcmvs_tpu/io/images.py``).

The JAX package decodes with ``cv2``; the machine the port runs on has no
OpenCV, PIL or imageio, so this module decodes the formats itself with
numpy and ``zlib``: binary PGM/PPM (``P5``/``P6``, maxval 255) and
non-interlaced PNG of every colour type and bit depth (gray at 1/2/4/8/16
bits, gray + alpha, RGB and RGBA at 8/16, palette at 1/2/4/8 with its
``tRNS`` alpha) with all five row filters.  ``load_image`` lays results
out as the JAX package's: (H, W, 3) RGB float32 in [0, 1] (gray files
replicated to three channels and alpha dropped, 16-bit samples cut to
their high byte, as ``cv2.IMREAD_COLOR`` does), or (H, W) with
``gray=True``.  ``load_semantic_mask`` reads label images unchanged, as
``cv2.IMREAD_UNCHANGED`` does (16-bit labels stay 16-bit).  Any other
format (JPEG, interlaced PNG, ASCII PNM) raises NotImplementedError
naming it.

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

``resize_image`` follows ``cv2.resize``: INTER_AREA when shrinking, as
exact area-overlap weights (cv2's ``computeResizeAreaTab``, right for
non-integer ratios too), INTER_LINEAR when enlarging (half-pixel centres,
clamped edges); each is two separable weight matrices.  ``resize_mask``
is INTER_NEAREST's index rule.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the PNG spec allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# cv2's gray conversions of 8-bit colour files with IMREAD_GRAYSCALE:
# PNM through its BT.601 fixed point (R, G, B scaled by 2**14, rounded),
# PNG through libpng's rgb_to_gray(0.299, 0.587) (scaled by 2**15,
# truncated; grey pixels pass unchanged)
_GRAY_PNM = (4899, 9617, 1868, 14, 1 << 13)
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


def _decode_png(data: bytes, path: str) -> np.ndarray:
    """(H, W, C) samples of a non-interlaced PNG as ``cv2.imread(path,
    IMREAD_UNCHANGED)`` returns them, but in RGB(A) channel order: uint16
    for 16-bit files, else uint8; gray below 8 bits scaled to 0-255; gray
    + alpha as four channels (gray three times); palette images expanded
    to RGB, or RGBA when a ``tRNS`` chunk gives alpha; an RGB image with
    a ``tRNS`` colour gains alpha (0 on that colour, else opaque)."""
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
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG")
    if color not in _PNG_TYPES:
        raise NotImplementedError(f"{path}: PNG colour type {color}")
    ch, depths = _PNG_TYPES[color]
    if depth not in depths:
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {color}")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bits = depth * ch
    stride = (w * bits + 7) // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    try:
        raw = _unfilter(rows, max(bits // 8, 1))
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    if depth == 16:                      # big-endian samples
        pairs = raw.reshape(h, w, ch, 2).astype(np.uint16)
        out = (pairs[..., 0] << 8) | pairs[..., 1]
    elif depth < 8:
        vals = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        vals = (vals * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        out = vals[:, :w, None].astype(np.uint8)
        if color == 0:
            out = out * np.uint8(255 // ((1 << depth) - 1))
    else:
        out = raw.reshape(h, w, ch)
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


def _pnm_tokens(data: bytes, n: int) -> Tuple[list, int]:
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


def _decode_pnm(data: bytes, path: str) -> np.ndarray:
    """(H, W, C) uint8 samples of a binary PGM (P5) or PPM (P6)."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise NotImplementedError(f"{path}: PNM type {magic.decode()} "
                                  f"(binary P5/P6 only)")
    (w, h, maxval), pos = _pnm_tokens(data, 3)
    if maxval != 255:
        raise NotImplementedError(f"{path}: PNM maxval {maxval} (255 only)")
    c = 1 if magic == b"P5" else 3
    return np.frombuffer(data, np.uint8, h * w * c, pos).reshape(h, w, c)


def _gray(rgb: np.ndarray, png: bool) -> np.ndarray:
    """cv2's RGB -> gray conversion for the file type and sample depth
    (16-bit PNG samples through libpng's 16-bit path, which rounds)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    cr, cg, cb, shift, rnd = _GRAY_PNG if png else _GRAY_PNM
    if rgb.dtype == np.uint16:
        rnd = 1 << 14
    y = (r * cr + g * cg + b * cb + rnd) >> shift
    if png:
        y = np.where((r == g) & (r == b), r, y)
    return y.astype(rgb.dtype)


def _read_samples(path: str) -> Tuple[np.ndarray, bool]:
    """(H, W, C) samples of an image file (RGB(A) order; see
    ``_decode_png``) and whether it is a PNG."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data, path), True
    if data[:1] == b"P" and data[1:2] in b"123456":
        return _decode_pnm(data, path), False
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(f"{path}: JPEG is not decoded without "
                                  f"OpenCV (PNG, PGM, PPM only)")
    raise NotImplementedError(f"{path}: unknown image format (PNG, PGM, "
                              f"PPM only)")


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 in [0, 1]; RGB (H, W, 3) or gray (H, W)."""
    raw, png = _read_samples(path)
    if raw.shape[2] in (2, 4):
        raw = raw[..., :-1]                    # drop alpha, as cv2 does
    if gray:
        img = raw[..., 0] if raw.shape[2] == 1 else _gray(raw, png)
    else:
        img = np.repeat(raw, 3, axis=2) if raw.shape[2] == 1 else raw
    if img.dtype == np.uint16:
        img = img >> 8                         # the high byte, as cv2
    return img.astype(np.float32) / 255.0


def load_semantic_mask(path: str) -> np.ndarray:
    """A semantic-segmentation mask as an (H, W) int32 label map (ref:
    Image::maskName, frame_main/libs/MVS/Image.h:75-99, read by
    GenerateDepthPrior, SceneDensify.cpp:1550-1950).  8/16-bit
    single-channel files are their own labels; in a colour-coded mask each
    distinct colour becomes one label, numbered in the order of a code
    built from the channels in cv2's BGR(A) order, as the JAX package
    numbers them."""
    raw, _ = _read_samples(path)
    if raw.shape[2] == 1:
        return raw[..., 0].astype(np.int32)
    bgr = raw[..., [2, 1, 0, 3][:raw.shape[2]]]
    flat = bgr.reshape(-1, raw.shape[2]).astype(np.int64)
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


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_AREA weights: each output cell averages the
    source cells it overlaps, by overlap (cv2 ``computeResizeAreaTab``,
    including its 1e-3 threshold on partial cells)."""
    scale = 1.0 / (n_dst / n_src)
    wts = np.zeros((n_dst, n_src), np.float64)
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx2 = min(math.floor(fsx2), n_src - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            wts[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        wts[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            wts[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return wts


def _linear_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_LINEAR weights: half-pixel centres, edges
    clamped (cv2 ``resize``'s coefficient setup)."""
    scale = 1.0 / (n_dst / n_src)
    wts = np.zeros((n_dst, n_src), np.float64)
    for dx in range(n_dst):
        f = np.float32((dx + 0.5) * scale - 0.5)
        sx = math.floor(f)
        fx = np.float32(f - np.float32(sx))
        if sx < 0:
            fx, sx = np.float32(0.0), 0
        if sx >= n_src - 1:
            fx, sx = np.float32(0.0), n_src - 1
        wts[dx, sx] += np.float32(1.0) - fx
        if fx:
            wts[dx, sx + 1] += fx
    return wts


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Resize (H, W[, C]) by ``scale`` like ``cv2.resize``: INTER_AREA
    when shrinking, INTER_LINEAR when enlarging."""
    if scale == 1.0:
        return img
    h, w = img.shape[:2]
    new_w, new_h = max(1, round(w * scale)), max(1, round(h * scale))
    weights = _area_weights if scale < 1.0 else _linear_weights
    return _resample(img, weights(h, new_h), weights(w, new_w))


def _resample(img: np.ndarray, wy: np.ndarray, wx: np.ndarray
              ) -> np.ndarray:
    """Rows through the (new_h, H) weights ``wy``, columns through the
    (new_w, W) weights ``wx``, in float64; the input's dtype back."""
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(out, wx, axes=(1, 1)), -1, 1)
    return out.astype(img.dtype)


def resize_linear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Resize (H, W[, C]) to (new_h, new_w) like ``cv2.resize``'s default,
    INTER_LINEAR, whichever way the size goes."""
    h, w = img.shape[:2]
    if (h, w) == (new_h, new_w):
        return img
    return _resample(img, _linear_weights(h, new_h),
                     _linear_weights(w, new_w))


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
