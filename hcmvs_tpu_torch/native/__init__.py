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
  fancy upsampling and colour tables), behind ``io.images``.

``maxflow.cpp`` and ``raster.cpp`` are byte-for-byte the JAX package's;
``jpeg.cpp`` is the port's own (the JAX package decodes with OpenCV,
which the port's machine does not have).  All three are compiled with
the JAX package's flags, ``g++ -O3 -march=native -std=c++17 -shared
-fPIC`` (the flags matter: without ``-march=native`` g++ forms no fused
multiply-adds on x86 and the barycentrics differ in the last bit), so the
two packages give equal outputs.  Each is compiled at first use into
``_build/<name>-<hash>.so`` beside this file (listed in ``.gitignore``;
the hash covers the source, the flags and the CPU that ``-march=native``
resolves to, so a copy of the tree on another machine builds anew) and
loaded with ctypes.  A failed build raises with the compiler's output;
there is no fallback.  The plain versions, scipy's integer max-flow
(``maxflow_scipy``) and the numpy rasterizer of ``mesh.mesh_ops``, are
reached only by asking for them; the JPEG decoder has none.
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
    key = " ".join(GXX_FLAGS + (native_arch(),)).encode()
    digest = hashlib.sha256(src.read_bytes() + key).hexdigest()[:16]
    so_path = BUILD_DIR / f"{name}-{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(src)]
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
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp`` ("maxflow", "raster" or
    "jpeg"), built on first use, with its functions' argument types
    declared."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, restype, argtypes in _SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


JPEG_MODES = {"color": 0, "gray": 1, "unchanged": 2}


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
    plane of a YCbCr file) or "unchanged" (gray for one component, else
    BGR).  Raises NotImplementedError naming an unsupported feature and
    ValueError naming the fault of a corrupt or truncated stream."""
    head = jpeg_header(data, path)
    h, w = head["height"], head["width"]
    gray = mode == "gray" or (mode == "unchanged"
                              and head["components"] == 1)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(256)
    _jpeg_status(library("jpeg").hcmvs_jpeg_decode(
        data, len(data), JPEG_MODES[mode], out, out.size, msg, len(msg)),
        msg, path)
    return out


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
