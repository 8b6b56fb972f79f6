"""EXIF intrinsics bootstrap for the real-photo frontend (PyTorch port of
``hcmvs_tpu/io/exif.py``).

The reference pipeline's step 0 seeds per-image focal lengths from EXIF +
a camera sensor-width database before any geometry runs (ref:
frame_main/MvgMvsPipeline.py:181-183 openMVG_main_SfMInit_ImageListing
with its sensor_width_camera_database.txt):

  focal_px = FocalLengthIn35mmFilm * max(w, h) / 36.0        (preferred)
  focal_px = FocalLength_mm / sensor_width_mm * max(w, h)    (via DB)
  focal_px = 1.2 * max(w, h)                                 (fallback)

The principal point is the image centre; distortion starts at zero and is
estimated in BA (sfm/distortion.py).

The tags are read without an imaging library: the TIFF structure of the
EXIF block (IFD0 and the Exif sub-IFD 0x8769) is parsed from a JPEG's
APP1 segment or a PNG's ``eXIf`` chunk; no pixel is decoded.  The tag
names and values are those Pillow's ``getexif`` gives (rationals and
doubles as floats), and an unreadable file gives {}, as the JAX package's
reader.  ``exif_bytes`` writes such a block (``io.images.write_png``
embeds it).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

# Sensor widths in millimetres for common camera families -- a compact
# analog of OpenMVG's sensor_width_camera_database.txt (keys are matched
# as lowercase substrings of "Make Model").
SENSOR_WIDTH_DB_MM: Dict[str, float] = {
    "canon eos 5d": 36.0, "canon eos 6d": 35.8, "canon eos r": 36.0,
    "canon eos 80d": 22.5, "canon eos 90d": 22.3, "canon eos rebel": 22.3,
    "canon powershot": 7.6,
    "nikon d8": 35.9, "nikon d7": 23.5, "nikon d5": 23.5, "nikon z": 35.9,
    "sony ilce-7": 35.8, "sony ilce-6": 23.5, "sony dsc-rx100": 13.2,
    "fujifilm x": 23.5,
    "olympus": 17.3, "panasonic dmc": 17.3, "om digital": 17.3,
    "iphone": 4.8, "pixel": 6.17, "samsung sm-": 6.4,
    "dji": 6.3, "gopro": 6.17,
}

DEFAULT_FOCAL_FACTOR = 1.2    # focal_px = 1.2 * max(w, h) when unknown

EXIF_IFD = 0x8769
TAG_NAMES = {271: "Make", 272: "Model", EXIF_IFD: "ExifOffset",
             37386: "FocalLength", 41989: "FocalLengthIn35mmFilm"}
_NAME_TAGS = {v: k for k, v in TAG_NAMES.items()}
# TIFF field types: (struct code, bytes per value)
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}


def _rational(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def _read_ifd(tiff: bytes, off: int, end: str) -> Dict[int, object]:
    """One IFD's entries {tag: value}; entries of unknown type or out of
    the block are skipped."""
    out: Dict[int, object] = {}
    if off + 2 > len(tiff):
        return out
    (n,) = struct.unpack_from(end + "H", tiff, off)
    for e in range(n):
        pos = off + 2 + 12 * e
        if pos + 12 > len(tiff):
            break
        tag, typ, count = struct.unpack_from(end + "HHI", tiff, pos)
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        at = pos + 8 if nbytes <= 4 else struct.unpack_from(
            end + "I", tiff, pos + 8)[0]
        if at + nbytes > len(tiff):
            continue
        if typ == 2:
            out[tag] = tiff[at:at + count].split(b"\0", 1)[0].decode(
                "latin-1")
            continue
        vals = struct.unpack_from(end + code * count, tiff, at)
        if typ in (5, 10):
            vals = tuple(num / den if den else float("nan")
                         for num, den in zip(vals[::2], vals[1::2]))
        out[tag] = vals[0] if count == 1 else vals
    return out


def parse_exif(tiff: bytes) -> Dict[int, object]:
    """{tag id: value} of a TIFF-structured EXIF block: IFD0 merged with
    the Exif sub-IFD."""
    if tiff[:2] == b"II":
        end = "<"
    elif tiff[:2] == b"MM":
        end = ">"
    else:
        return {}
    if len(tiff) < 8 or struct.unpack_from(end + "H", tiff, 2)[0] != 42:
        return {}
    tags = _read_ifd(tiff, struct.unpack_from(end + "I", tiff, 4)[0], end)
    sub = tags.get(EXIF_IFD)
    if isinstance(sub, int):
        tags.update(_read_ifd(tiff, sub, end))
    return tags


def _exif_block(data: bytes) -> Optional[bytes]:
    """The TIFF block of a JPEG's APP1 ``Exif`` segment or a PNG's
    ``eXIf`` chunk."""
    if data[:2] == b"\xff\xd8":
        pos = 2
        while pos + 4 <= len(data) and data[pos] == 0xFF:
            marker = data[pos + 1]
            if marker in (0xD9, 0xDA):          # end of image / scan
                return None
            (length,) = struct.unpack_from(">H", data, pos + 2)
            body = data[pos + 4:pos + 2 + length]
            if marker == 0xE1 and body[:6] == b"Exif\0\0":
                return body[6:]
            pos += 2 + length
        return None
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        pos = 8
        while pos + 8 <= len(data):
            length, kind = struct.unpack_from(">I4s", data, pos)
            if kind == b"eXIf":
                body = data[pos + 8:pos + 8 + length]
                return body[6:] if body[:6] == b"Exif\0\0" else body
            if kind == b"IEND":
                return None
            pos += 12 + length
    return None


def read_exif_tags(path: str) -> Dict[str, object]:
    """Best-effort EXIF read; returns {} on any failure."""
    try:
        with open(path, "rb") as f:
            block = _exif_block(f.read())
        tags = parse_exif(block) if block else {}
    except (OSError, struct.error, UnicodeDecodeError):
        return {}
    return {TAG_NAMES.get(k, str(k)): v for k, v in tags.items()}


def _field(v) -> Tuple[int, int, bytes]:
    """(TIFF type, count, little-endian bytes) of a tag value."""
    if isinstance(v, str):
        b = v.encode("latin-1") + b"\0"
        return 2, len(b), b
    if isinstance(v, float):
        return 12, 1, struct.pack("<d", v)
    return 3, 1, struct.pack("<H", int(v))


def _ifd_bytes(fields, start: int) -> bytes:
    """One little-endian IFD at offset ``start`` ((tag, type, count, raw)
    sorted by tag), its out-of-line values after it, no next IFD."""
    data_at = start + 2 + 12 * len(fields) + 4
    head, data = struct.pack("<H", len(fields)), b""
    for tag, typ, count, raw in sorted(fields):
        if len(raw) <= 4:
            head += struct.pack("<HHI", tag, typ, count) + raw.ljust(4, b"\0")
        else:
            head += struct.pack("<HHII", tag, typ, count,
                                data_at + len(data))
            data += raw
    return head + struct.pack("<I", 0) + data


def exif_bytes(**tags) -> bytes:
    """A little-endian TIFF EXIF block holding ``tags`` by name (``Make``,
    ``Model`` in IFD0; ``FocalLength``, ``FocalLengthIn35mmFilm`` in the
    Exif sub-IFD): strings as ASCII, floats as DOUBLE, ints as SHORT --
    the types Pillow writes them with."""
    ifd0 = [(_NAME_TAGS[k], *_field(v)) for k, v in tags.items()
            if k in ("Make", "Model")]
    sub = [(_NAME_TAGS[k], *_field(v)) for k, v in tags.items()
           if k not in ("Make", "Model")]
    if not sub:
        return b"II*\0" + struct.pack("<I", 8) + _ifd_bytes(ifd0, 8)
    # IFD0 points (a LONG, inline) at the sub-IFD, which follows it
    size0 = len(_ifd_bytes(ifd0 + [(EXIF_IFD, 4, 1, bytes(4))], 8))
    ifd0.append((EXIF_IFD, 4, 1, struct.pack("<I", 8 + size0)))
    return (b"II*\0" + struct.pack("<I", 8) + _ifd_bytes(ifd0, 8)
            + _ifd_bytes(sub, 8 + size0))


def focal_from_exif(path: str, width: int, height: int
                    ) -> Tuple[float, str]:
    """Estimate focal length in pixels for one photo.

    Returns (focal_px, source) with source one of "exif35", "exif_db",
    "default" -- the listing step's precedence (ref:
    MvgMvsPipeline.py:181-183; OpenMVG SfMInit_ImageListing main).
    """
    dim = float(max(width, height))
    tags = read_exif_tags(path)
    f35 = _rational(tags.get("FocalLengthIn35mmFilm"))
    if f35 and f35 > 0:
        return f35 * dim / 36.0, "exif35"
    f_mm = _rational(tags.get("FocalLength"))
    if f_mm and f_mm > 0:
        ident = (str(tags.get("Make", "")) + " "
                 + str(tags.get("Model", ""))).strip().lower()
        for key, sensor_mm in SENSOR_WIDTH_DB_MM.items():
            if key in ident:
                return f_mm / sensor_mm * dim, "exif_db"
    return DEFAULT_FOCAL_FACTOR * dim, "default"


def intrinsics_from_photo(path: str, width: int, height: int):
    """(K, source): pinhole intrinsics seeded from EXIF, principal point
    at the image centre."""
    f, source = focal_from_exif(path, width, height)
    K = np.array([[f, 0.0, width / 2.0],
                  [0.0, f, height / 2.0],
                  [0.0, 0.0, 1.0]])
    return K, source


def scene_intrinsics_from_photos(paths, widths, heights):
    """Shared-intrinsics bootstrap for an image directory: the median
    focal over images that carry EXIF (single-camera assumption)."""
    if len(set(zip(widths, heights))) > 1:
        raise ValueError(
            "scene_intrinsics_from_photos: images have mixed sizes "
            f"({sorted(set(zip(widths, heights)))}); shared-intrinsics "
            "bootstrap requires a single capture size -- resize the "
            "images or pass per-image intrinsics explicitly")
    focals, sources = [], []
    for p, w, h in zip(paths, widths, heights):
        f, s = focal_from_exif(p, w, h)
        focals.append(f)
        sources.append(s)
    informative = [f for f, s in zip(focals, sources) if s != "default"]
    f = float(np.median(informative if informative else focals))
    w, h = widths[0], heights[0]
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    src = ("exif" if informative else "default")
    return K, src
