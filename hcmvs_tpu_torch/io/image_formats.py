"""The image formats ``cv2.imread`` (OpenCV 5.0) reads beyond JPEG, PNG,
PNM, BMP and TIFF, decoded without OpenCV to the arrays it returns
(``io.images.imread`` dispatches here by signature):

- PFM (``PF`` colour, ``Pf`` gray): float32 samples, rows stored bottom
  to top, little-endian when the scale is negative; every sample times
  float32(1 / |scale|).  Unchanged: float32 (BGR for colour); the 8-bit
  mode of the file's own channel count rounds half to even and saturates
  (NaN, infinities and magnitudes past 2**31 read 0, as a SSE conversion
  gives them); the other mode fails in cv2.
- PAM (P7): the tuple types cv2 knows (BLACKANDWHITE, GRAYSCALE,
  GRAYSCALE_ALPHA, RGB, RGB_ALPHA; without TUPLTYPE one channel or three
  below maxval 256), 8- or 16-bit samples, taken in the file's channel
  order (cv2 swaps no channels: an RGB file reads as if it were BGR; its
  gray is BT.601 of the samples as R, G, B); 16-bit samples cut to their
  high byte in the 8-bit modes; maxval 1 reads the first (W + 7) // 8
  bytes of each row as packed bits, 0 black and 1 white.
- Sun raster, Radiance HDR, GIF: see their decoders below.

Where cv2 returns nothing the decoders raise NotImplementedError naming
the case; where its result depends on memory it never wrote (the colour
mode of an alpha PAM) they raise it too; a corrupt file raises
ValueError.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

# OpenCV's BT.601 fixed point (R, G, B weights scaled by 2**14, rounded)
_GRAY_CV = (4899, 9617, 1868, 14, 1 << 13)


def bt601(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's gray of 8-bit RGB samples (icvCvt_BGR2Gray_8u_C3C1R, and
    cvtColor's BGR2GRAY with R and B in place)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    cr, cg, cb, shift, rnd = _GRAY_CV
    return ((r * cr + g * cg + b * cb + rnd) >> shift).astype(np.uint8)


def saturate_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV's saturate_cast<uchar> of float32 samples: rounded half to
    even (cvRound), NaN, infinities and values outside the int32 range
    giving INT_MIN, hence 0; then clamped to 0..255."""
    v = np.asarray(v, np.float32)
    ok = np.isfinite(v) & (np.abs(v) < np.float32(2 ** 31))
    r = np.where(ok, np.rint(np.where(ok, v, 0)), -1.0)
    return np.clip(r, 0, 255).astype(np.uint8)


# ---- PFM ----

def _pfm_token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """One header token: the bytes up to the next whitespace byte, which
    ends it (cv2 reads byte by byte and stops at the first)."""
    end = pos
    while end < len(data) and not data[end:end + 1].isspace():
        end += 1
    if end >= len(data):
        raise ValueError("truncated PFM header")
    return data[pos:end], end + 1


def _leading_number(token: bytes, pattern: str) -> float:
    """``atoi`` / ``atof`` of a token: its longest leading number, 0 if
    none."""
    m = re.match(pattern, token.decode("latin-1").lstrip())
    return float(m.group(0)) if m else 0.0


def decode_pfm(data: bytes, mode: str, path: str) -> np.ndarray:
    """A PFM as cv2 reads it in ``mode`` (see the module docstring)."""
    if data[2:3] != b"\n":
        raise ValueError(f"{path}: PFM magic not followed by a line break")
    color = data[1:2] == b"F"
    tok, pos = _pfm_token(data, 3)
    w = int(_leading_number(tok, r"[+-]?\d+"))
    tok, pos = _pfm_token(data, pos)
    h = int(_leading_number(tok, r"[+-]?\d+"))
    tok, pos = _pfm_token(data, pos)
    scale = _leading_number(
        tok, r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: PFM of {w} x {h} pixels")
    if scale == 0:
        raise ValueError(f"{path}: PFM scale 0")
    c = 3 if color else 1
    if (mode == "gray" and color) or (mode == "color" and not color):
        raise NotImplementedError(
            f"{path}: {'colour' if color else 'gray'} PFM read as "
            f"{mode} (cv2 fails on it)")
    try:
        vals = np.frombuffer(data, "<f4" if scale < 0 else ">f4",
                             h * w * c, pos)
    except ValueError:
        raise ValueError(f"{path}: truncated PFM raster") from None
    img = vals.astype(np.float32).reshape(h, w, c)[::-1]
    if color:
        img = img[..., ::-1]
    img = img * np.float32(1.0 / abs(scale))
    if not color:
        img = img[..., 0]
    if mode != "unchanged":
        img = saturate_u8(img)
    return np.ascontiguousarray(img)


# ---- PAM ----

_PAM_TUPLES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
               "RGB_ALPHA")


def _pam_header(data: bytes, path: str) -> Tuple[dict, int]:
    """The fields of a PAM header and the raster's offset."""
    if data[2:3] not in (b"\n", b"\r"):
        raise ValueError(f"{path}: PAM magic not followed by a line break")
    fields, pos = {}, 3
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError(f"{path}: PAM header without ENDHDR")
        line = data[pos:end].strip()
        pos = end + 1
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        key, value = key.decode("latin-1"), value.strip().decode("latin-1")
        if key == "ENDHDR":
            break
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE"):
            raise ValueError(f"{path}: PAM header field {key!r}")
        if key in fields and key != "TUPLTYPE":
            raise ValueError(f"{path}: PAM header repeats {key}")
        if key != "TUPLTYPE":
            if not value.isdigit():
                raise ValueError(f"{path}: PAM {key} {value!r}")
            value = int(value)
        fields[key] = value
    missing = {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"} - set(fields)
    if missing:
        raise ValueError(f"{path}: PAM header without {sorted(missing)}")
    return fields, pos


def decode_pam(data: bytes, mode: str, path: str) -> np.ndarray:
    """A PAM (P7) as cv2 reads it in ``mode`` (see the module
    docstring)."""
    f, pos = _pam_header(data, path)
    w, h, c, maxval = f["WIDTH"], f["HEIGHT"], f["DEPTH"], f["MAXVAL"]
    kind = f.get("TUPLTYPE", "")
    if not 0 < maxval <= 65535 or w <= 0 or h <= 0:
        raise ValueError(f"{path}: PAM of {w} x {h}, maxval {maxval}")
    if kind and kind not in _PAM_TUPLES:
        raise NotImplementedError(f"{path}: PAM tuple type {kind!r} (cv2 "
                                  f"fails on it)")
    if not kind and not (c in (1, 3) and maxval < 256):
        raise NotImplementedError(
            f"{path}: PAM of {c} channels, maxval {maxval} without "
            f"TUPLTYPE (cv2 fails on it)")
    if not 1 <= c <= 4:
        raise NotImplementedError(f"{path}: PAM of {c} channels")
    wide = maxval > 255
    try:
        raw = np.frombuffer(data, ">u2" if wide else np.uint8, h * w * c,
                            pos).reshape(h, w, c)
    except ValueError:
        raise ValueError(f"{path}: truncated PAM raster") from None
    if maxval == 1:
        if mode == "unchanged" and c in (2, 4):
            raise NotImplementedError(f"{path}: {c}-channel PAM of maxval "
                                      f"1 read unchanged (cv2 fails on it)")
        rows = raw.reshape(h, -1)[:, :(w + 7) // 8].astype(np.uint8)
        bits = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        if mode == "gray" or (mode == "unchanged" and c == 1):
            return np.ascontiguousarray(bits)
        return np.repeat(bits[..., None], 3, -1)
    if mode == "unchanged":
        img = raw.astype(np.uint16 if wide else np.uint8)
        return np.ascontiguousarray(img[..., 0] if c == 1 else img)
    x = (raw >> 8).astype(np.uint8) if wide else raw
    if mode == "color":
        if c in (2, 4):
            raise NotImplementedError(
                f"{path}: {c}-channel PAM read as colour (cv2 leaves part "
                f"of the image unwritten)")
        return np.ascontiguousarray(np.repeat(x, 3, -1) if c == 1 else x)
    if c == 1:
        return np.ascontiguousarray(x[..., 0])
    if c == 3:
        return bt601(x)
    if c == 4:
        raise NotImplementedError(f"{path}: 4-channel PAM read as gray (cv2 "
                                  f"leaves part of the image unwritten)")
    # GRAYSCALE_ALPHA: cv2 steps over the row's bytes two at a time and
    # writes each gray sample three times, so the first (W + 1) // 2
    # pixels' grays fill the row, each thrice
    flat = x.reshape(h, -1)[:, 0::2][:, :(w + 1) // 2]
    return np.ascontiguousarray(np.repeat(flat, 3, axis=1)[:, :w])


# ---- Sun raster ----

SUN_MAGIC = b"\x59\xa6\x6a\x95"


def decode_sun(data: bytes, mode: str, path: str) -> np.ndarray:
    """A Sun raster as cv2 reads it in ``mode``: depths 1, 8, 24 and 32,
    types 0 (old) and 1 (standard), rows padded to 16 bits; 1- and 8-bit
    samples through the colour map (R, G and B planes of 2**depth entries)
    or, without one, as gray in the colour mode (1-bit: 0 black, 1
    white) and as zeros in the gray and unchanged modes, as cv2 gives
    them; 24-bit pixels
    stored B, G, R and 32-bit ones X, B, G, R.  A file whose colour map
    is all gray reads as one channel unchanged, as does a 1- or 8-bit one
    without a map.  cv2 5.0 fails on types 2 (byte-encoded) and 3 (RGB
    order): its header check compares them with the image's OpenCV type
    instead of the file's type field."""
    if len(data) < 32:
        raise ValueError(f"{path}: truncated Sun raster header")
    w, h, depth, _, kind, maptype, maplen = np.frombuffer(
        data, ">u4", 7, 4).astype(np.int64)
    if w <= 0 or h <= 0 or w >= 2 ** 31 or h >= 2 ** 31:
        raise ValueError(f"{path}: Sun raster of {w} x {h} pixels")
    if depth not in (1, 8, 24, 32):
        raise NotImplementedError(f"{path}: {depth}-bit Sun raster (cv2 "
                                  f"fails on it)")
    if kind in (2, 3):
        raise NotImplementedError(
            f"{path}: Sun raster of type {kind} "
            f"({'byte-encoded' if kind == 2 else 'RGB order'}; cv2 5.0 "
            f"fails on it)")
    if kind not in (0, 1):
        raise NotImplementedError(f"{path}: Sun raster of type {kind}")
    entries = 1 << depth if depth <= 8 else 0
    if maptype == 1 and 0 < maplen == 3 * entries:
        cmap = np.frombuffer(data, np.uint8, maplen, 32).reshape(3, -1).T
    elif maptype == 1 and 0 < maplen < 3 * entries:
        raise NotImplementedError(f"{path}: Sun raster colour map of "
                                  f"{maplen // 3} entries (cv2 reads "
                                  f"entries it never set)")
    elif maptype == 0 and maplen == 0:
        cmap = None
    else:
        raise NotImplementedError(f"{path}: Sun raster colour map of type "
                                  f"{maptype}, {maplen} bytes (cv2 fails "
                                  f"on it)")
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    try:
        rows = np.frombuffer(data, np.uint8, pitch * h,
                             32 + maplen).reshape(h, pitch)
    except ValueError:
        raise ValueError(f"{path}: truncated Sun raster") from None
    if depth <= 8:
        idx = (np.unpackbits(rows, axis=1)[:, :w] if depth == 1
               else rows[:, :w])
        if cmap is None:
            gray = idx * np.uint8(255) if depth == 1 else idx
            if mode == "color":
                return np.repeat(gray[..., None], 3, -1)
            # cv2 maps the samples through a gray table it fills only
            # from a colour map: all zeros here
            return np.zeros((h, w), np.uint8)
        rgb = cmap[idx]
        if mode == "gray" or (mode == "unchanged"
                              and (cmap == cmap[:, :1]).all()):
            return bt601(cmap)[idx] if mode == "gray" else rgb[..., 0]
        return np.ascontiguousarray(rgb[..., ::-1])
    c = depth // 8
    bgr = rows[:, :w * c].reshape(h, w, c)[..., c - 3:]
    if mode == "gray":
        return bt601(bgr[..., ::-1])
    return np.ascontiguousarray(bgr)


# ---- Radiance HDR ----

def gray_cvt(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(BGR2GRAY)`` of 8-bit samples: B, G, R weights
    scaled by 2**15 (3735, 19235, 9798), rounded, as cv2 computes the gray
    of HDR and GIF (``native/webp.cpp`` computes the same for WebP)."""
    b, g, r = (bgr[..., k].astype(np.int64) for k in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        np.uint8)


def _hdr_lines(data: bytes):
    """The header's lines as C's ``fgets`` into a 128-byte buffer gives
    them (a longer line in pieces of 127 bytes), each with its offset
    after it."""
    pos = 0
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(data)) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def _rgbe_scanlines(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """(h, w, 4) RGBE bytes of the pixels after the header, as
    ``RGBE_ReadPixels_RLE`` reads them: scanlines of width 8 to 32767
    whose first four bytes are 2, 2 and the width are run-length coded
    channel by channel (a byte above 128 a run of the next byte, else a
    count of literal bytes); the first scanline that is not, and every
    one after it, is read flat, four bytes a pixel (so are all of an image
    narrower than 8 or wider than 32767)."""
    out = np.empty((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    y = 0
    if 8 <= w <= 0x7FFF:
        while y < h:
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise ValueError("truncated HDR scanline")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break
            if (head[2] << 8) | head[3] != w:
                raise ValueError("HDR scanline of the wrong width")
            pos += 4
            line = np.empty(4 * w, np.uint8)
            at = 0
            for ch in range(4):
                stop = (ch + 1) * w
                while at < stop:
                    if pos + 2 > len(data):
                        raise ValueError("truncated HDR scanline")
                    count, value = data[pos], data[pos + 1]
                    if count > 128:
                        count -= 128
                        if count > stop - at:
                            raise ValueError("bad HDR scanline data")
                        line[at:at + count] = value
                        pos += 2
                    else:
                        if count == 0 or count > stop - at or \
                                pos + 1 + count > len(data):
                            raise ValueError("bad HDR scanline data")
                        line[at:at + count] = buf[pos + 1:pos + 1 + count]
                        pos += 1 + count
                    at += count
            out[y] = line.reshape(4, w).T
            y += 1
    rest = (h - y) * w * 4
    if pos + rest > len(data):
        raise ValueError("truncated HDR pixels")
    out[y:] = buf[pos:pos + rest].reshape(h - y, w, 4)
    return out


def decode_hdr(data: bytes, mode: str, path: str) -> np.ndarray:
    """A Radiance HDR as cv2 reads it in ``mode``: the header's lines up
    to an empty one, of which ``FORMAT=32-bit_rle_rgbe`` must be one, then
    the size line ``-Y <h> +X <w>`` (the one orientation cv2 reads);
    each pixel (R, G, B, E) is ``float32(ldexp(1, E - 136))`` times each
    mantissa (0 where E is 0), in BGR order.  Unchanged: float32; colour:
    each sample times 255, saturated to 8 bits; gray: cvtColor's gray of
    the colour read."""
    lines = _hdr_lines(data)
    fmt_ok = False
    for line, pos in lines:
        if line in (b"\n", b""):
            break
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            fmt_ok = True
    else:
        raise ValueError(f"{path}: HDR header without an empty line")
    if not fmt_ok:
        raise NotImplementedError(f"{path}: HDR without FORMAT=32-bit_rle_"
                                  f"rgbe (cv2 fails on it)")
    size, pos = next(lines, (b"", len(data)))
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", size)
    if not m:
        raise NotImplementedError(f"{path}: HDR size line "
                                  f"{size[:20]!r} (cv2 reads -Y h +X w "
                                  f"only)")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise ValueError(f"{path}: HDR of {w} x {h} pixels")
    try:
        rgbe = _rgbe_scanlines(data, pos, w, h)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    e = rgbe[..., 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    img = rgbe[..., 2::-1].astype(np.float32) * f[..., None]
    if mode == "unchanged":
        return img
    with np.errstate(over="ignore"):
        bgr = saturate_u8(img * np.float32(255))
    return gray_cvt(bgr) if mode == "gray" else bgr


# ---- GIF ----

def lzw_lsb(src: bytes, min_size: int, limit: int) -> bytes:
    """Variable-width LZW with codes packed least significant bit first
    (GIF's): Clear ``1 << min_size`` resets the table and the width to
    ``min_size + 1``, the next code ends the data; the width grows when
    the table's next free code reaches ``1 << width``, up to 12 bits,
    where the table stops growing until the next Clear.  Decodes at most
    ``limit`` bytes."""
    clear = 1 << min_size
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    width, acc, nbits, prev = min_size + 1, 0, 0, None
    for byte in src:
        acc |= byte << nbits
        nbits += 8
        while nbits >= width:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nbits -= width
            if code == clear:
                del table[clear + 2:]
                width, prev = min_size + 1, None
                continue
            if code == clear + 1:
                return bytes(out)
            if code < len(table):
                entry = table[code]
                if prev is not None and len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table) and prev is not None:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt LZW data")
            out += entry
            if len(out) >= limit:
                return bytes(out[:limit])
            prev = entry
            if len(table) >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _gif_sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The bytes of a run of data sub-blocks starting at ``pos``, and the
    offset past its terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF data sub-blocks")
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        if pos + 1 + n > len(data):
            raise ValueError("truncated GIF data sub-block")
        pos += 1 + n


def _gif_table(data: bytes, pos: int, flags: int) -> Tuple[np.ndarray, int]:
    """The colour table a descriptor's ``flags`` announce at ``pos``
    ((n, 3) RGB, or None) and the offset past it."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise ValueError("truncated GIF colour table")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), \
        pos + 3 * n


def _gif_frames(data: bytes, pos: int):
    """(graphic control, image descriptor offset) of each frame: the
    control is (disposal, transparent index or None) of the last graphic
    control extension before the image, or None."""
    gce = None
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            return
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError("truncated GIF extension")
            label = data[pos + 1]
            body, end = _gif_sub_blocks(data, pos + 2)
            if label == 0xF9 and len(body) >= 4:
                gce = ((body[0] >> 2) & 7,
                       body[3] if body[0] & 1 else None)
            pos = end
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise ValueError("truncated GIF image descriptor")
            yield gce, pos
            gce = None
            _, pos = _gif_table(data, pos + 10, data[pos + 9])
            _, pos = _gif_sub_blocks(data, pos + 1)
        else:
            raise ValueError(f"GIF block 0x{kind:02x}")


def decode_gif(data: bytes, mode: str, path: str) -> np.ndarray:
    """A GIF (87a or 89a) as cv2 reads it in ``mode``: the first frame,
    on a canvas of the logical screen's size filled with the global
    table's background colour (alpha 0; black without one); the frame's
    pixels, LZW-decoded (interlaced rows in their four passes), through
    its local or the global colour table (without either, gray levels
    with entry 1 white, as cv2's default) with alpha 255, except the pixels of the
    transparent index its graphic control extension names, which keep
    the canvas.  BGRA unchanged when the last graphic control extension
    of the file (of whichever frame) names a transparent index, else BGR;
    gray through cvtColor."""
    try:
        return _decode_gif(data, mode)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None


def _decode_gif(data: bytes, mode: str) -> np.ndarray:
    if len(data) < 13:
        raise ValueError("truncated GIF header")
    sw, sh = np.frombuffer(data, "<u2", 2, 6).astype(np.int64)
    flags, bg = data[10], data[11]
    if sw == 0 or sh == 0:
        raise ValueError(f"GIF screen of {sw} x {sh} pixels")
    gct, pos = _gif_table(data, 13, flags)
    frames = list(_gif_frames(data, pos))
    if not frames:
        raise ValueError("GIF without an image")
    controls = [g for g, _ in frames if g is not None]
    alpha_out = mode == "unchanged" and bool(controls) and \
        controls[-1][1] is not None
    gce, pos = frames[0]
    left, top, w, h = np.frombuffer(data, "<u2", 4, pos + 1).astype(
        np.int64)
    iflags = data[pos + 9]
    if w == 0 or h == 0 or left + w > sw or top + h > sh:
        raise ValueError(f"GIF frame of {w} x {h} at ({left}, {top}) "
                         f"outside the {sw} x {sh} screen")
    lct, pos = _gif_table(data, pos + 10, iflags)
    table = lct if lct is not None else gct
    if table is None:
        # no table in the file: cv2's default, gray levels with entry 1
        # white
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        table[1] = 255
    if pos >= len(data):
        raise ValueError("truncated GIF image data")
    min_size = data[pos]
    if not 2 <= min_size <= 11:
        raise ValueError(f"GIF LZW code size {min_size}")
    stream, _ = _gif_sub_blocks(data, pos + 1)
    idx = np.frombuffer(lzw_lsb(stream, min_size, w * h), np.uint8)
    if idx.size < w * h:
        raise ValueError("GIF image data ends early")
    idx = idx.reshape(h, w)
    if iflags & 0x40:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    canvas = np.zeros((sh, sw, 4), np.uint8)
    if gct is not None and bg < len(gct):
        canvas[..., :3] = gct[bg, ::-1]
    if int(idx.max()) >= len(table):
        raise ValueError("GIF colour index beyond its table")
    rgba = np.concatenate([table[idx, ::-1],
                           np.full((h, w, 1), 255, np.uint8)], -1)
    keep = np.ones((h, w), bool)
    if gce is not None and gce[1] is not None:
        keep = idx != gce[1]
    win = canvas[top:top + h, left:left + w]
    win[keep] = rgba[keep]
    if alpha_out:
        return canvas
    bgr = np.ascontiguousarray(canvas[..., :3])
    return gray_cvt(bgr) if mode == "gray" else bgr


# ---- AVIF: libavif 1.4's YUV -> RGB, as OpenCV 5.0 calls it

# libyuv's YuvConstants (ub, ug, vg, vr, yg, yb) for the matrices libavif
# hands to it: BT.601 (matrix coefficients 5, 6 and unspecified 2), BT.709
# (1) and BT.2020 non-constant luminance (9), limited and full range
# (read from libyuv inside OpenCV's libavif)
_LIBYUV = {(601, 0): (128, 25, 52, 102, 18997, -1160),
           (601, 1): (113, 22, 46, 90, 16320, 32),
           (709, 0): (128, 14, 34, 115, 18997, -1160),
           (709, 1): (119, 12, 30, 101, 16320, 32),
           (2020, 0): (128, 12, 42, 107, 19003, -1160),
           (2020, 1): (120, 11, 37, 94, 16320, 32)}
_LIBYUV_MATRIX = {1: 709, 2: 601, 5: 601, 6: 601, 9: 2020}


def libyuv_matrix(mc: int, cp: int):
    """The matrix coefficients libavif hands to libyuv for (mc, cp), or
    None: BT.601 / 709 / 2020-NCL themselves, and chroma-derived NCL (12)
    of BT.709, BT.601 and BT.2020 primaries (unspecified ones as BT.709)
    as that standard's matrix."""
    if mc == 12:
        mc = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}.get(cp)
    return mc if mc in _LIBYUV_MATRIX else None
# libavif's (kr, kb) of the matrices it converts itself
_AVIF_KR_KB = {1: (0.2126, 0.0722), 2: (0.299, 0.114), 4: (0.30, 0.11),
               5: (0.299, 0.114), 6: (0.299, 0.114), 7: (0.212, 0.087),
               9: (0.2627, 0.0593)}
# libavif's colour primaries (rX, rY, gX, gY, bX, bY, wX, wY) by their
# CICP code, BT.709's for the codes it does not know (read from OpenCV's
# libavif through avifColorPrimariesGetValues)
_BT709_PRIMARIES = (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329)
_AVIF_PRIMARIES = {
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.31, 0.316),
    5: (0.64, 0.33, 0.29, 0.6, 0.15, 0.06, 0.3127, 0.329),
    6: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    7: (0.63, 0.34, 0.31, 0.595, 0.155, 0.07, 0.3127, 0.329),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.31, 0.316),
    9: (0.708, 0.292, 0.17, 0.797, 0.131, 0.046, 0.3127, 0.329),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.314, 0.351),
    12: (0.68, 0.32, 0.265, 0.69, 0.15, 0.06, 0.3127, 0.329),
    22: (0.63, 0.34, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.329)}


def _kr_kb_from_primaries(cp: int):
    """libavif's kr and kb of chroma-derived non-constant luminance
    (matrix 12, H.273 equations 32-37) from the primaries, in float32 in
    its order of operations."""
    rx, ry, gx, gy, bx, by, wx, wy = (np.float32(v) for v in
                                      _AVIF_PRIMARIES.get(cp,
                                                          _BT709_PRIMARIES))
    one = np.float32(1)
    rz, gz, bz, wz = (one - (rx + ry), one - (gx + gy), one - (bx + by),
                      one - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return kr, kb


def _up2_linear(s: np.ndarray, n: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any along the last axis to n samples:
    the first and last sample copied, (3 a + b + 2) >> 2 between."""
    s = s.astype(np.int64)
    d = np.empty(s.shape[:-1] + (n,), np.int64)
    d[..., 0] = s[..., 0]
    m = ((n - 1) & ~1) // 2
    if m > 0:
        d[..., 1:2 * m:2] = (s[..., :m] * 3 + s[..., 1:m + 1] + 2) >> 2
        d[..., 2:2 * m + 1:2] = (s[..., :m] + s[..., 1:m + 1] * 3 + 2) >> 2
    d[..., n - 1] = s[..., (n - 1) // 2]
    return d


def _up2_bilinear(near: np.ndarray, far: np.ndarray, n: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Bilinear_Any of a row pair to n samples: the
    near row weighted 3 to the far row's 1 at the two ends, 9:3:3:1
    between."""
    a, b = near.astype(np.int64), far.astype(np.int64)
    d = np.empty(a.shape[:-1] + (n,), np.int64)
    d[..., 0] = (3 * a[..., 0] + b[..., 0] + 2) >> 2
    m = ((n - 1) & ~1) // 2
    if m > 0:
        a0, a1 = a[..., :m], a[..., 1:m + 1]
        b0, b1 = b[..., :m], b[..., 1:m + 1]
        d[..., 1:2 * m:2] = (a0 * 9 + a1 * 3 + b0 * 3 + b1 + 8) >> 4
        d[..., 2:2 * m + 1:2] = (a0 * 3 + a1 * 9 + b0 + b1 * 3 + 8) >> 4
    last = (n - 1) // 2
    d[..., n - 1] = (3 * a[..., last] + b[..., last] + 2) >> 2
    return d


def libyuv_chroma(c: np.ndarray, h: int, w: int, ssy: int) -> np.ndarray:
    """A chroma plane at full size as libyuv's *ToARGBMatrixFilter
    upsamples it (bilinear for 4:2:0, linear along rows for 4:2:2)."""
    if not ssy:
        return _up2_linear(c, w)
    # output row 0 and (for even h) the last from their own chroma row;
    # rows 2k+1, 2k+2 from chroma rows k and k+1, each nearer one first
    near, far = [0], [0]
    for r in range(1, h - (0 if h & 1 else 1)):
        k = (r - 1) // 2
        near.append(k if r & 1 else k + 1)
        far.append(k + 1 if r & 1 else k)
    if not h & 1 and h > 1:
        near.append((h - 1) // 2)
        far.append((h - 1) // 2)
    near, far = np.asarray(near[:h]), np.asarray(far[:h])
    return _up2_bilinear(c[near], c[far], w)


def _libyuv_bgr(y, u, v, key, y32=None) -> np.ndarray:
    """libyuv's YuvPixel of 8-bit samples (u, v at full size): 16.6 fixed
    point with the YuvConstants of ``key``, BGR uint8 (``y32``: the luma
    as libyuv widens it, ``y * 0x0101`` for 8 bits)."""
    ub, ug, vg, vr, yg, yb = _LIBYUV[key]
    if y32 is None:
        y32 = y.astype(np.int64) * 0x0101
    y1 = ((y32 * yg) & 0xFFFFFFFF) >> 16
    y1 = y1 + yb
    ui, vi = u.astype(np.int64) - 128, v.astype(np.int64) - 128
    bgr = (y1 + ui * ub, y1 - (ui * ug + vi * vg), y1 + vi * vr)
    return np.stack([np.clip(c >> 6, 0, 255) for c in bgr], -1).astype(
        np.uint8)


def libyuv_bgr_high(y, u, v, depth: int, full: int, mc: int) -> np.ndarray:
    """libyuv's YuvPixel10 / YuvPixel12 (u, v at full size): the luma
    widened to 16 bits (``(y << 6) | (y >> 4)`` at 10 bits, ``(y << 4) |
    (y >> 8)`` at 12), the chroma cut to 8 bits and saturated."""
    s = depth - 8
    y = y.astype(np.int64)
    y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
    u8, v8 = (np.clip(p.astype(np.int64) >> s, 0, 255) for p in (u, v))
    return _libyuv_bgr(None, u8, v8, (_LIBYUV_MATRIX[mc], full), y32)


def _avif_float_bgr(y, u, v, depth, ssx, ssy, full, mc, out_depth, cp=1):
    """libavif's own YUV -> RGB (avifImageYUVAnyToRGBAnySlow and its fast
    paths, which compute the same): samples to float32 through its unorm
    tables, chroma upsampled bilinearly (9/16, 3/16, 3/16, 1/16 of the
    nearest, the adjacent column, the adjacent row and the diagonal
    sample, in that order), identity, YCgCo or kr / kb arithmetic in
    float32, clamped to [0, 1], ``(uint)(0.5 + x * max)``."""
    f32 = np.float32
    h, w = y.shape
    top = (1 << depth) - 1
    bias_y = f32(0 if full else 16 << (depth - 8))
    bias_uv = f32(1 << (depth - 1))
    range_y = f32(top if full else 219 << (depth - 8))
    range_uv = f32(top if full else 224 << (depth - 8))
    code = np.arange(top + 1, dtype=f32)
    t_y = ((code - bias_y) / range_y).astype(f32)
    t_uv = (t_y if mc == 0 else ((code - bias_uv) / range_uv).astype(f32))
    Y = t_y[np.minimum(y, top)]

    def chroma(c):
        c = np.minimum(c, top)
        if not ssx:
            return t_uv[c]
        j, i = np.arange(h)[:, None], np.arange(w)[None, :]
        uj, ui = j >> ssy, i >> ssx
        adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0,
                         np.where(i % 2 != 0, 1, -1))
        adj_r = (np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), 0,
                          np.where(j % 2 != 0, 1, -1)) if ssy
                 else np.zeros_like(j))
        return (((t_uv[c[uj, ui]] * f32(9 / 16)
                  + t_uv[c[uj, ui + adj_c]] * f32(3 / 16))
                 + t_uv[c[uj + adj_r, ui]] * f32(3 / 16))
                + t_uv[c[uj + adj_r, ui + adj_c]] * f32(1 / 16))

    if u is None:
        R = G = B = Y
    else:
        cb, cr = chroma(u), chroma(v)
        if mc == 0:
            G, B, R = Y, cb, cr
        elif mc == 8:
            t = (Y - cb).astype(f32)
            G, B, R = (Y + cb).astype(f32), (t - cr).astype(f32), (
                t + cr).astype(f32)
        else:
            kr, kb = (_kr_kb_from_primaries(cp) if mc == 12 else
                      (f32(k) for k in _AVIF_KR_KB[mc]))
            kg = f32(f32(f32(1) - kr) - kb)
            R = (Y + (f32(2) * (f32(1) - kr)) * cr).astype(f32)
            B = (Y + (f32(2) * (f32(1) - kb)) * cb).astype(f32)
            G = (Y - ((f32(2) * ((kr * (f32(1) - kr) * cr)
                                 + (kb * (f32(1) - kb) * cb))) / kg)
                 ).astype(f32)
    scale = f32((1 << out_depth) - 1)
    dtype = np.uint8 if out_depth == 8 else np.uint16
    return np.stack([(f32(0.5) + np.clip(c, f32(0), f32(1)) * scale)
                     .astype(dtype) for c in (B, G, R)], -1)


def avif_bgr(planes, depth: int, ssx: int, ssy: int, full: int, mc: int,
             out_depth: int, cp: int = 1) -> np.ndarray:
    """libavif 1.4's avifImageYUVToRGB of (Y, U, V) planes into BGR of
    ``out_depth`` bits, as OpenCV 5.0 asks it (chroma upsampling
    automatic, libyuv allowed): 8-bit output of BT.601 / 709 / 2020-NCL
    (matrix 1, 2, 5, 6, 9) goes through libyuv, high bit depths cut to 8
    bits first (``>> (depth - 8)``); the rest through libavif's float
    conversion (matrix 12 with kr, kb from the colour primaries ``cp``).
    Raises NotImplementedError where libavif fails (YCgCo in limited
    range, identity other than 4:4:4, matrices it does not convert)."""
    y, u, v = planes
    h, w = y.shape
    if mc == 8 and not full:
        raise NotImplementedError("YCgCo in limited range (libavif fails)")
    if mc == 0 and (ssx or ssy):
        raise NotImplementedError("identity matrix with sub-sampled chroma "
                                  "(libavif fails)")
    if mc not in (0, 8, 12) and mc not in _AVIF_KR_KB:
        raise NotImplementedError(f"matrix coefficients {mc} (libavif "
                                  f"fails, or is not followed here)")
    yuv_mc = libyuv_matrix(mc, cp)
    if out_depth == 8 and yuv_mc:
        mc = yuv_mc
        shift = depth - 8
        y8, u8, v8 = (p >> shift for p in (y, u, v))
        if ssx:
            u8, v8 = (libyuv_chroma(p, h, w, ssy) for p in (u8, v8))
        return _libyuv_bgr(y8, u8, v8, (_LIBYUV_MATRIX[mc], full))
    return _avif_float_bgr(y, u, v, depth, ssx, ssy, full, mc, out_depth,
                           cp)
