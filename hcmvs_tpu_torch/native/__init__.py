"""Host-side C++ components, bound with ctypes (port of
``hcmvs_tpu/native/__init__.py``, plus a JPEG decoder of the port's own).

- ``maxflow.cpp``: a Boykov-Kolmogorov-style s-t max-flow / min-cut, the
  graph-cut solver of surface reconstruction (ref: SceneReconstruct.cpp
  :58-101, IBFS);
- ``raster.cpp``: two-pass z-buffer rasterization with per-pixel face ids
  and perspective-correct barycentrics (ref: TRasterMesh, Mesh.cpp
  :3532-3586);
- ``jpeg.cpp``: baseline, extended and progressive Huffman JPEG decoding
  to the samples ``cv2.imread`` gives with libjpeg-turbo (its ISLOW IDCT,
  fancy upsampling and colour tables), behind ``io.images``;
- ``webp.cpp``: WebP decoding (lossy VP8, lossless VP8L, alpha, the
  first frame of an animation) to the samples ``cv2.imread`` gives with
  libwebp (its fancy upsampling and fixed-point colour conversion);
- ``jpeg2000.cpp``: JPEG 2000 decoding (the JP2 box or a raw codestream)
  to the components OpenJPEG 2.5.3 gives cv2 (its 9/7 in float32, its
  reconstruction of cut passes, its palette and channel definitions);
- ``avif.cpp``: AVIF decoding (the HEIF container: items, grids, the
  alpha item, the first sample of an image sequence) and an AV1 decoder
  of key and intra-only frames, to the YUV (and alpha) planes libaom
  gives libavif for cv2; ``io.images._avif`` converts them as libavif
  does.

``maxflow.cpp`` and ``raster.cpp`` are byte-for-byte the JAX package's;
``jpeg.cpp``, ``webp.cpp``, ``jpeg2000.cpp`` and ``avif.cpp`` are the
port's own (the JAX package decodes with OpenCV, which the port's machine
does not have).  All are compiled with
the JAX package's flags, ``g++ -O3 -march=native -std=c++17 -shared
-fPIC`` (the flags matter: without ``-march=native`` g++ forms no fused
multiply-adds on x86 and the barycentrics differ in the last bit), so the
two packages give equal outputs; ``jpeg2000.cpp`` adds
``-ffp-contract=off`` (``EXTRA_FLAGS``), since OpenJPEG rounds every
multiply and add of its wavelet and colour transform on its own.  Each is
compiled at first use into
``_build/<name>-<hash>.so`` beside this file (listed in ``.gitignore``;
the hash covers the source, the flags and the CPU that ``-march=native``
resolves to, so a copy of the tree on another machine builds anew) and
loaded with ctypes.  A failed build raises with the compiler's output;
there is no fallback.  The plain versions, scipy's integer max-flow
(``maxflow_scipy``) and the numpy rasterizer of ``mesh.mesh_ops``, are
reached only by asking for them; the image decoders have none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
# flags of one source on top of GXX_FLAGS
EXTRA_FLAGS = {"jpeg2000": ("-ffp-contract=off",)}

_libs: Dict[str, ctypes.CDLL] = {}
_arch: Dict[str, str] = {}


def native_arch() -> str:
    """What ``-march=native`` means to this machine's g++ (for example
    "sapphirerapids"); raises if g++ cannot be run."""
    if "march" not in _arch:
        try:
            proc = subprocess.run(["g++", "-march=native", "-Q",
                                   "--help=target"], capture_output=True,
                                  text=True, timeout=60)
        except OSError as exc:
            raise RuntimeError(f"g++ could not be run: {exc}") from exc
        found = [ln.split()[-1] for ln in proc.stdout.splitlines()
                 if ln.strip().startswith("-march=") and len(ln.split()) > 1]
        _arch["march"] = found[0] if found else "unknown"
    return _arch["march"]


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless this exact build exists; returns the
    shared object's path.  Raises RuntimeError with g++'s output if the
    compile fails.  The object is written under a temporary name and
    renamed into place, so processes building at once do not collide."""
    src = SRC_DIR / f"{name}.cpp"
    flags = GXX_FLAGS + EXTRA_FLAGS.get(name, ())
    key = " ".join(flags + (native_arch(),)).encode()
    digest = hashlib.sha256(src.read_bytes() + key).hexdigest()[:16]
    so_path = BUILD_DIR / f"{name}-{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_BYTES = ctypes.c_char_p
_MSG = ctypes.c_char_p

_SIGNATURES = {
    "maxflow": [("hcmvs_maxflow", ctypes.c_double,
                 [ctypes.c_int32, ctypes.c_int64, _I32, _I32, _F32, _F32,
                  _F32, _F32, _U8])],
    "raster": [("hcmvs_rasterize", None,
                [ctypes.c_int32, ctypes.c_int32, _F64, _I32, _F64, _F64,
                 _F64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                 _F32, _I32, _F32])],
    "jpeg": [("hcmvs_jpeg_header", ctypes.c_int,
              [_BYTES, ctypes.c_int64, _I64, _MSG, ctypes.c_int]),
             ("hcmvs_jpeg_decode", ctypes.c_int,
              [_BYTES, ctypes.c_int64, ctypes.c_int32, _U8, ctypes.c_int64,
               _MSG, ctypes.c_int])],
    "webp": [("hcmvs_webp_info", ctypes.c_int,
              [_BYTES, ctypes.c_int64, _I64, _MSG, ctypes.c_int]),
             ("hcmvs_webp_decode", ctypes.c_int,
              [_BYTES, ctypes.c_int64, ctypes.c_int32, _U8, ctypes.c_int64,
               _MSG, ctypes.c_int])],
    "jpeg2000": [("hcmvs_jp2_info", ctypes.c_int,
                  [_BYTES, ctypes.c_int64, _I64, _MSG, ctypes.c_int]),
                 ("hcmvs_jp2_decode", ctypes.c_int,
                  [_BYTES, ctypes.c_int64, _I32, ctypes.c_int64, _I64,
                   _MSG, ctypes.c_int])],
    "avif": [("hcmvs_avif_info", ctypes.c_int,
              [_BYTES, ctypes.c_int64, _I64, _MSG, ctypes.c_int]),
             ("hcmvs_avif_decode", ctypes.c_int,
              [_BYTES, ctypes.c_int64, _U16, ctypes.c_int64, _I64, _MSG,
               ctypes.c_int])],
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp`` ("maxflow", "raster", "jpeg",
    "webp", "jpeg2000" or "avif"), built on first use, with its
    functions' argument types declared."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, restype, argtypes in _SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


JPEG_MODES = {"color": 0, "gray": 1, "unchanged": 2, "raw": 3}


def _jpeg_status(rc: int, msg, path: str) -> None:
    """Raises for a nonzero status of the JPEG decoder: 1 an unsupported
    feature (NotImplementedError), 2 a corrupt or truncated stream
    (ValueError), each naming it."""
    if rc == 1:
        raise NotImplementedError(f"{path}: {msg.value.decode()}")
    if rc:
        raise ValueError(f"{path}: {msg.value.decode()}")


def jpeg_header(data: bytes, path: str = "JPEG") -> Dict[str, int]:
    """The frame of a JPEG file: width, height, components, precision,
    sof (the SOF marker), colour_space (0 gray, 1 YCbCr, 2 RGB), app1
    (offset, length) of the first APP1 segment's body, progressive,
    restart_interval.  Raises as ``jpeg_decode`` does."""
    info = np.zeros(10, np.int64)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("jpeg").hcmvs_jpeg_header(
        data, len(data), info, msg, len(msg)), msg, path)
    keys = ("width", "height", "components", "precision", "sof",
            "colour_space")
    out = {k: int(v) for k, v in zip(keys, info)}
    out.update(app1=(int(info[6]), int(info[7])),
               progressive=int(info[8]), restart_interval=int(info[9]))
    return out


def jpeg_decode(data: bytes, mode: str = "color",
                path: str = "JPEG") -> np.ndarray:
    """The samples ``cv2.imread`` gives for a JPEG file's bytes, without
    EXIF orientation: ``mode`` "color" (H, W, 3) BGR, "gray" (H, W) (the Y
    plane of a YCbCr file), "unchanged" (gray for one component, else
    BGR) or "raw" (H, W, components): the decoded samples without colour
    conversion, as libtiff reads a JPEG-in-TIFF strip.  Raises
    NotImplementedError naming an unsupported feature and ValueError
    naming the fault of a corrupt or truncated stream."""
    head = jpeg_header(data, path)
    h, w = head["height"], head["width"]
    gray = mode == "gray" or (mode == "unchanged"
                              and head["components"] == 1)
    shape = ((h, w, head["components"]) if mode == "raw"
             else (h, w) if gray else (h, w, 3))
    out = np.empty(shape, np.uint8)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("jpeg").hcmvs_jpeg_decode(
        data, len(data), JPEG_MODES[mode], out, out.size, msg, len(msg)),
        msg, path)
    return out


def webp_info(data: bytes, path: str = "WebP") -> Dict[str, int]:
    """The canvas of a WebP file: width, height, has_alpha (the BGRA cv2
    reads unchanged), animated, and exif (offset, length) of its EXIF
    chunk ((0, 0) without one).  Raises as ``webp_decode`` does."""
    info = np.zeros(8, np.int64)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("webp").hcmvs_webp_info(
        data, len(data), info, msg, len(msg)), msg, path)
    keys = ("width", "height", "has_alpha", "animated")
    out = {k: int(v) for k, v in zip(keys, info)}
    out["exif"] = (int(info[4]), int(info[5]))
    return out


def webp_decode(data: bytes, channels: int = 4,
                path: str = "WebP") -> np.ndarray:
    """A WebP file's canvas as libwebp decodes it for cv2 (a still image;
    the first frame of an animation on a transparent canvas): (H, W, 4)
    BGRA with alpha 255 where the file has none, (H, W, 3) BGR, or for
    ``channels`` 1 (H, W) gray as cv2's cvtColor computes it from the
    BGR.  Raises NotImplementedError naming an unsupported feature and
    ValueError naming the fault of a corrupt or truncated file."""
    head = webp_info(data, path)
    shape = (head["height"], head["width"]) + (
        (channels,) if channels > 1 else ())
    out = np.empty(shape, np.uint8)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("webp").hcmvs_webp_decode(
        data, len(data), channels, out, out.size, msg, len(msg)), msg, path)
    return out


# OpenJPEG's OPJ_COLOR_SPACE, as jp2_info reports it
JP2_COLOR_SPACES = {-1: "unknown", 0: "unspecified", 1: "sRGB", 2: "gray",
                    3: "sYCC", 4: "eYCC", 5: "CMYK"}
_JP2_MAX_COMPS = 16


def jp2_info(data: bytes, path: str = "JPEG 2000") -> Dict:
    """The header of a JPEG 2000 file (the JP2 box or a raw codestream) as
    OpenJPEG's opj_read_header gives it: width, height, components (the
    codestream's), colour_space (a key of JP2_COLOR_SPACES), channels (after
    the JP2 palette), x0, y0 (the image offset), rsiz, and comps: for each
    of the first 16 components (precision, signed, dx, dy, x0, y0).  Raises
    as ``jp2_decode`` does."""
    info = np.zeros(8 + 6 * _JP2_MAX_COMPS, np.int64)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("jpeg2000").hcmvs_jp2_info(
        data, len(data), info, msg, len(msg)), msg, path)
    keys = ("width", "height", "components", "colour_space", "channels",
            "x0", "y0", "rsiz")
    out = {k: int(v) for k, v in zip(keys, info)}
    n = min(out["components"], _JP2_MAX_COMPS)
    out["comps"] = [tuple(int(v) for v in info[8 + 6 * i:14 + 6 * i])
                    for i in range(n)]
    return out


def jp2_decode(data: bytes, path: str = "JPEG 2000") -> list:
    """A JPEG 2000 file's channels as OpenJPEG 2.5.3's opj_decode gives
    them to cv2, after the JP2 palette and channel definitions: a list of
    (h, w) int32 arrays (a sub-sampled component at its own size).
    Raises NotImplementedError naming a feature or stream on which cv2's
    OpenJPEG fails (a cut stream among them) and ValueError naming the
    fault of a corrupt one."""
    head = jp2_info(data, path)
    n = max(head["channels"], head["components"])
    if n > _JP2_MAX_COMPS:
        raise NotImplementedError(f"{path}: JPEG 2000 of {n} channels")
    cap = n * head["width"] * head["height"]   # no component is larger
    out = np.empty(cap, np.int32)
    info = np.zeros(5 * _JP2_MAX_COMPS, np.int64)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("jpeg2000").hcmvs_jp2_decode(
        data, len(data), out, cap, info, msg, len(msg)), msg, path)
    planes, at = [], 0
    for k in range(head["channels"]):
        w, h = int(info[5 * k + 2]), int(info[5 * k + 3])
        planes.append(out[at:at + w * h].reshape(h, w))
        at += w * h
    return planes


_AVIF_KEYS = ("width", "height", "depth", "ssx", "ssy", "monochrome",
              "full_range", "cp", "tc", "mc", "nclx", "nclx_cp", "nclx_tc",
              "nclx_mc", "nclx_full_range", "alpha", "premultiplied")


def _avif_status(rc: int, msg, path: str) -> None:
    """Raises NotImplementedError for a nonzero status of the AVIF decoder
    (1 a feature it does not decode, 2 a file it cannot read, on which
    cv2's libavif fails too), naming it."""
    if rc:
        kind = "not decoded" if rc == 1 else "cv2 fails on it"
        raise NotImplementedError(f"{path}: {msg.value.decode()} ({kind})")


def avif_info(data: bytes, path: str = "AVIF") -> Dict[str, int]:
    """The header of an AVIF file without decoding it: width and height
    (of ispe, the grid or a sequence's sample entry), depth, ssx, ssy,
    monochrome, full_range, cp, tc, mc (the AV1 sequence header's colour
    config), nclx (1 with a colr nclx property) and its nclx_cp,
    nclx_tc, nclx_mc, nclx_full_range, alpha (an alpha auxiliary image)
    and premultiplied (its prem reference).  Raises as ``avif_decode``
    does."""
    info = np.zeros(len(_AVIF_KEYS), np.int64)
    msg = ctypes.create_string_buffer(256)
    _avif_status(library("avif").hcmvs_avif_info(
        data, len(data), info, msg, len(msg)), msg, path)
    return {k: int(v) for k, v in zip(_AVIF_KEYS, info)}


def avif_decode(data: bytes, path: str = "AVIF") -> Tuple[Dict, list]:
    """An AVIF file's planes as libaom decodes them for libavif: (info,
    planes) with info as ``avif_info``'s (the decoded size) plus
    alpha_depth and alpha_full_range, planes [Y, U, V] (uint16, each at
    its own size; [Y] for 4:0:0) then the alpha image's Y if present.
    Raises NotImplementedError naming a feature ``native/avif.cpp`` does
    not decode or the fault of a file cv2's libavif fails on too."""
    head = avif_info(data, path)
    cap = 4 * max(head["width"], 1) * max(head["height"], 1) + 64
    out = np.empty(cap, np.uint16)
    keys = _AVIF_KEYS + ("alpha_depth", "alpha_full_range")
    info = np.zeros(len(keys), np.int64)
    msg = ctypes.create_string_buffer(256)
    _avif_status(library("avif").hcmvs_avif_decode(
        data, len(data), out, cap, info, msg, len(msg)), msg, path)
    head = {k: int(v) for k, v in zip(keys, info)}
    w, h = head["width"], head["height"]
    cw, ch = (w + head["ssx"]) >> head["ssx"], (h + head["ssy"]) >> head["ssy"]
    sizes = [(h, w)] + ([] if head["monochrome"] else [(ch, cw)] * 2)
    if head["alpha"]:
        sizes.append((h, w))
    planes, at = [], 0
    for ph, pw in sizes:
        planes.append(out[at:at + ph * pw].reshape(ph, pw))
        at += ph * pw
    return head, planes


def maxflow(n_nodes: int, eu: np.ndarray, ev: np.ndarray,
            cap_uv: np.ndarray, cap_vu: Optional[np.ndarray],
            cap_src: np.ndarray, cap_snk: np.ndarray
            ) -> Tuple[float, np.ndarray]:
    """s-t max-flow / min-cut.

    Args:
      n_nodes: number of non-terminal nodes.
      eu, ev: (E,) pairwise edge endpoints.
      cap_uv: (E,) capacity u->v.
      cap_vu: (E,) capacity v->u, or None for symmetric.
      cap_src: (n,) source->v terminal capacities.
      cap_snk: (n,) v->sink terminal capacities.

    Returns:
      (flow_value, source_side) with source_side a (n,) bool array, True
      for nodes on the source side of the min cut.
    """
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    if len(eu) != len(ev) or len(cap_uv) != len(eu):
        raise ValueError("edge arrays differ in length")
    if len(eu) and (min(eu.min(), ev.min()) < 0
                    or max(eu.max(), ev.max()) >= n_nodes):
        raise ValueError("edge endpoint out of range")
    cap_uv = np.ascontiguousarray(cap_uv, np.float32)
    cap_vu = (cap_uv if cap_vu is None
              else np.ascontiguousarray(cap_vu, np.float32))
    cap_src = np.ascontiguousarray(cap_src, np.float32)
    cap_snk = np.ascontiguousarray(cap_snk, np.float32)
    if len(cap_vu) != len(eu) or not len(cap_src) == len(cap_snk) == n_nodes:
        raise ValueError("capacity arrays do not match the graph")
    out = np.zeros(n_nodes, np.uint8)
    flow = library("maxflow").hcmvs_maxflow(
        np.int32(n_nodes), np.int64(len(eu)), eu, ev, cap_uv, cap_vu,
        cap_src, cap_snk, out)
    return float(flow), out.astype(bool)


def maxflow_scipy(n_nodes, eu, ev, cap_uv, cap_vu, cap_src, cap_snk,
                  quantum: float = 1e-3) -> Tuple[float, np.ndarray]:
    """The plain version of ``maxflow``: scipy's integer max-flow on
    capacities quantized to ``quantum``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow
    cap_vu = cap_uv if cap_vu is None else cap_vu
    S, T = n_nodes, n_nodes + 1
    nz_s = np.nonzero(cap_src > 0)[0]
    nz_t = np.nonzero(cap_snk > 0)[0]
    src = np.concatenate([eu, ev, np.full(len(nz_s), S), nz_t])
    dst = np.concatenate([ev, eu, nz_s, np.full(len(nz_t), T)])
    cap = np.concatenate([cap_uv, cap_vu, cap_src[nz_s], cap_snk[nz_t]])
    icap = np.round(cap / quantum).astype(np.int64)
    # keep strictly-positive caps alive through quantization; true zeros
    # must stay zero (they are non-edges)
    icap = np.where(cap > 0, np.maximum(icap, 1), 0)
    graph = coo_matrix((icap, (src, dst)),
                       shape=(n_nodes + 2, n_nodes + 2)).tocsr()
    graph.sum_duplicates()
    res = maximum_flow(graph, S, T)
    resid = graph - res.flow
    resid.data = (resid.data > 0).astype(np.int64)
    resid.eliminate_zeros()
    order = breadth_first_order(resid, S, directed=True,
                                return_predecessors=False)
    side = np.zeros(n_nodes, bool)
    side[order[order < n_nodes]] = True
    return float(res.flow_value) * quantum, side


def rasterize(vertices: np.ndarray, faces: np.ndarray, K: np.ndarray,
              R: np.ndarray, C: np.ndarray, h: int, w: int,
              with_attrs: bool = True):
    """Z-buffer rasterization of a mesh into an (h, w) view.

    Returns (depth f32 (h, w), 0 = empty; face_id i32 (h, w), -1 = empty;
    bary f32 (h, w, 3) perspective-correct barycentrics).  Pass 1 keeps
    the least depth, pass 2 gives a pixel to the last face whose depth
    matches it within 1e-4 relative (``mesh_ops``' numpy rasterizer is
    the same in Python)."""
    V = np.ascontiguousarray(vertices, np.float64)
    F = np.ascontiguousarray(faces, np.int32)
    if V.ndim != 2 or V.shape[1] != 3 or F.ndim != 2 or F.shape[1] != 3:
        raise ValueError("vertices and faces must be (N, 3)")
    if len(F) and (F.min() < 0 or F.max() >= len(V)):
        raise ValueError("face index out of range")
    depth = np.zeros((h, w), np.float32)
    fid = np.zeros((h, w), np.int32)
    bary = np.zeros((h, w, 3), np.float32)
    library("raster").hcmvs_rasterize(
        np.int32(len(V)), np.int32(len(F)), V, F,
        np.ascontiguousarray(K, np.float64).reshape(3, 3),
        np.ascontiguousarray(R, np.float64).reshape(3, 3),
        np.ascontiguousarray(C, np.float64).reshape(3),
        np.int32(h), np.int32(w), np.int32(1 if with_attrs else 0),
        depth, fid, bary)
    return depth, fid, bary
