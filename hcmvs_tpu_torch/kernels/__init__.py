"""The port's hand-written CUDA kernels: build, load, launch.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``_build/<hash of sources and flags>/`` beside this file (listed in
``.gitignore``).  A failed build raises with the compiler's output; there
is no fallback.  The library is loaded with ``ctypes``: pointers come from
``Tensor.data_ptr()`` and the stream from PyTorch's current stream.

Each launcher below checks device, dtype, shape and contiguity, allocates
its output with ``torch.empty``, launches on the current stream, raises if
the launch was refused, and adds one to its entry of ``launches`` for each
launch (kernels B and D launch once per row chunk, E once per chunk of
views).  C and E take an optional leading axis of K candidates (C in
groups of 8 on the grid, E as a grid axis): a stack launches them as
often as one hypothesis does.

``csrc/earlier/`` keeps the designs that kernels B, C and D had before
their redesign.  They are built into a library of their own and taken
only inside ``earlier_designs()``, so that the two designs can be timed
against each other on the card; no path calls them.

The callers in ``hcmvs_tpu_torch.ops`` choose between a launcher and the
kernel's plain PyTorch version with ``use_kernel``: CPU tensors take the
plain version, CUDA tensors the kernel.  ``plain_versions()`` is the one
switch that sends CUDA tensors through the plain versions too; it exists
so that a run on the card can be compared with the kernels, and is never
on by default.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
EARLIER = CSRC / "earlier"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LIB_NAME = "libhcmvs_kernels.so"

# launches of each kernel since the last reset_launches()
launches: Dict[str, int] = {"rect_build": 0, "volume_lookup": 0,
                            "rect_lookup": 0, "volume_lookup_multi": 0,
                            "zncc_warped": 0}

_state = {"lib": None, "earlier_lib": None, "earlier": False, "plain": False}

# kernels B and D: items (P x C) and table entries (P x D) a launch, at
# most (32-bit index work).  Rows are independent, so a larger lookup is
# launched in chunks of whole rows under this cap; a chunk's row count is
# a multiple of ROW_ALIGN, so every chunk's field, output and table rows
# start 16-byte aligned as the whole arrays do.
MAX_ITEMS = 2 ** 31 - 1
ROW_ALIGN = 64

# kernel E keeps every view's sums in registers: views per launch, at most
# (zncc_warped.cu kMaxViews; covers the 10-neighbour operating point).
# More views are launched in chunks of this many.
ZNCC_MAX_VIEWS = 10


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def plain_versions():
    """Inside this block CUDA tensors take the kernels' plain PyTorch
    versions instead of the kernels (for comparing the two on the card)."""
    old = _state["plain"]
    _state["plain"] = True
    try:
        yield
    finally:
        _state["plain"] = old


@contextlib.contextmanager
def earlier_designs():
    """Inside this block kernels B, C and D launch their earlier designs
    (``csrc/earlier/``, built on first use), for timing them against the
    current ones; the launchers and their checks are the same."""
    old = _state["earlier"]
    _state["earlier"] = True
    try:
        yield
    finally:
        _state["earlier"] = old


def use_kernel(t: torch.Tensor) -> bool:
    """Whether a tensor goes to the kernel (True) or to the plain version
    (False): the kernel for a CUDA tensor, the plain version for a CPU
    tensor or inside ``plain_versions()``; any other device raises."""
    if t.device.type == "cuda":
        return not _state["plain"]
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _sources(src_dir: Path = CSRC):
    """The translation units of ``src_dir`` and the shared headers."""
    return sorted(list(src_dir.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return str(path)


def _run_all(cmds, log: Path) -> None:
    """Run the commands side by side, append their output to ``log``, and
    raise with the first failure's command and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with log.open("a") as fh:
        fh.write("".join(outs))
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build(src_dir: Path = CSRC) -> Path:
    """Compile the kernels of ``src_dir`` (the library by default,
    ``EARLIER`` for the earlier designs) unless this exact build exists;
    returns the library's path.  One nvcc per source, all started
    together, then one link.  Raises with nvcc's output if a compile
    fails."""
    digest = hashlib.sha256()
    for src in _sources(src_dir):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    log = out_dir / "build.log"
    log.write_text("")
    nvcc = _nvcc()
    units = [s for s in _sources(src_dir) if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in units]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
              for s, o in zip(units, objs)], log)
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]], log)
    os.replace(tmp, lib)
    return lib


def _load(path: Path) -> ctypes.CDLL:
    """Load a kernel library and declare the C entry points it has."""
    lib = ctypes.CDLL(str(path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "volume_lookup": [p, p, p, i64, i, i, p],
        "rect_build": [p, p, p, p, p, p, p, i, i, i, i, i64, p],
        "rect_lookup": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p],
        "volume_lookup_multi": [p, p, p, p, i64, i, i, i, p],
        "zncc_warped": [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                        p]}
    for name, argtypes in signatures.items():
        if hasattr(lib, f"hcmvs_{name}"):
            fn = getattr(lib, f"hcmvs_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    if hasattr(lib, "hcmvs_error_string"):
        lib.hcmvs_error_string.argtypes = [i]
        lib.hcmvs_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if _state["lib"] is None:
        _state["lib"] = _load(build())
    return _state["lib"]


def earlier_library() -> ctypes.CDLL:
    """The library of the earlier designs of kernels B, C and D (built on
    first use)."""
    if _state["earlier_lib"] is None:
        _state["earlier_lib"] = _load(build(EARLIER))
    return _state["earlier_lib"]


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def row_chunks(p: int, c: int, d: int):
    """(start, stop) row ranges of a (P, C) lookup on a (P, D) table, each
    under ``MAX_ITEMS`` items and table entries (kernels B and D index
    with 32-bit integers); one range when the whole lookup fits."""
    rows = max(ROW_ALIGN, MAX_ITEMS // max(c, d) // ROW_ALIGN * ROW_ALIGN)
    return [(s, min(s + rows, p)) for s in range(0, max(p, 1), rows)]


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` (the earlier design inside
    ``earlier_designs()``, where it has one) on the current stream."""
    lib = library()
    entry = f"hcmvs_{name}"
    if _state["earlier"] and hasattr(earlier_library(), entry):
        fn = getattr(earlier_library(), entry)
    else:
        fn = getattr(lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.hcmvs_error_string(rc).decode()})")
    launches[name] += 1


def _check_depth(kernel: str, tab: torch.Tensor, f: torch.Tensor) -> None:
    """Kernels B and D take (P, D) u16 tables, D a multiple of 128 (the
    rect build's 128 planes, the per-plane build's 128 n), and (P, C)
    fields."""
    if tab.dim() != 2 or f.dim() != 2 or tab.shape[1] % 128 \
            or tab.shape[1] < 128:
        raise ValueError(f"{kernel} takes (P, D) tables, D a multiple of "
                         f"128, and (P, C) fields, got "
                         f"{tuple(tab.shape)}, {tuple(f.shape)}")


def volume_lookup(tab: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Kernel B: tab (P, D) u16, D a multiple of 128, f (P, S)
    f32 -> (P, S) f32; any P, in launches of ``row_chunks``."""
    if tab.device.type != "cuda":
        raise ValueError("volume_lookup kernel needs CUDA tensors")
    _check_depth("kernel B", tab, f)
    p, s = f.shape
    d = tab.shape[1]
    _check_tensor("tab", tab, torch.uint16, (p, d), tab.device)
    if tab.data_ptr() % 16:
        raise ValueError("tab is not 16-byte aligned")
    if _state["earlier"] and d != 128:
        raise ValueError("the earlier design of kernel B takes only "
                         "128-plane tables")
    _check_tensor("f", f, torch.float32, (p, s), tab.device)
    out = torch.empty((p, s), dtype=torch.float32, device=tab.device)
    for r0, r1 in row_chunks(p, s, d):
        _launch("volume_lookup", tab.device,
                tab.data_ptr() + r0 * d * tab.element_size(),
                f.data_ptr() + r0 * s * f.element_size(),
                out.data_ptr() + r0 * s * out.element_size(), r1 - r0, s, d)
    return out


def rect_build(rect_src: torch.Tensor, rb: torch.Tensor, cb: torch.Tensor,
               rowf: torch.Tensor, c0w: torch.Tensor, kp: torch.Tensor,
               p_pad: int) -> torch.Tensor:
    """Kernel A: u16 tables (V, p_pad, 128) from the rect images
    (V, H_r, W_r), per-tile bases rb/cb (V, T) and tile-major per-pixel
    fields (V, T * 1024)."""
    if rect_src.device.type != "cuda":
        raise ValueError("rect_build kernel needs CUDA tensors")
    v, h_r, w_r = rect_src.shape
    n_tiles = rb.shape[1]
    dev = rect_src.device
    _check_tensor("rect_src", rect_src, torch.float32, (v, h_r, w_r), dev)
    for name, t in (("rb", rb), ("cb", cb)):
        _check_tensor(name, t, torch.int32, (v, n_tiles), dev)
    for name, t in (("rowf", rowf), ("c0w", c0w), ("kp", kp)):
        _check_tensor(name, t, torch.float32, (v, n_tiles * 1024), dev)
    if p_pad < n_tiles * 1024:
        raise ValueError(f"p_pad {p_pad} < {n_tiles * 1024} pixels")
    tab = torch.empty((v, p_pad, 128), dtype=torch.uint16, device=dev)
    _launch("rect_build", dev,
            rect_src.data_ptr(), rb.data_ptr(), cb.data_ptr(),
            rowf.data_ptr(), c0w.data_ptr(), kp.data_ptr(), tab.data_ptr(),
            v, h_r, w_r, n_tiles, p_pad)
    return tab


def rect_lookup(maps: torch.Tensor, row_int: torch.Tensor,
                c0: torch.Tensor, k: torch.Tensor, rb: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
    """Kernel C: maps (V, C, H_r, W_r) read at every pixel's rect position
    for inverse depth sigma (H, W) -> (V, C, H, W), or for K candidates'
    (K, H, W) -> (K, V, C, H, W) in the same one launch."""
    if maps.device.type != "cuda":
        raise ValueError("rect_lookup kernel needs CUDA tensors")
    v, c, h_r, w_r = maps.shape
    if sigma.dim() not in (2, 3):
        raise ValueError(f"sigma has shape {tuple(sigma.shape)}, expected "
                         "(H, W) or (K, H, W)")
    lead = tuple(sigma.shape[:-2])
    n_cand = lead[0] if lead else 1
    h, w = sigma.shape[-2:]
    dev = maps.device
    _check_tensor("maps", maps, torch.float32, (v, c, h_r, w_r), dev)
    _check_tensor("row_int", row_int, torch.int32, (v, h, w), dev)
    _check_tensor("c0", c0, torch.float32, (v, h, w), dev)
    _check_tensor("k", k, torch.float32, (v, h, w), dev)
    _check_tensor("rb", rb, torch.int32, (v, -(-h // 8), -(-w // 128)), dev)
    _check_tensor("sigma", sigma, torch.float32, lead + (h, w), dev)
    out = torch.empty(lead + (v, c, h, w), dtype=torch.float32, device=dev)
    _launch("rect_lookup", dev,
            maps.data_ptr(), row_int.data_ptr(), c0.data_ptr(),
            k.data_ptr(), rb.data_ptr(), sigma.data_ptr(), out.data_ptr(),
            n_cand, v, c, h, w, h_r, w_r)
    return out


def volume_lookup_multi(tab: torch.Tensor, f: torch.Tensor,
                        bounds: torch.Tensor = None) -> torch.Tensor:
    """Kernel D: tab (P, D) u16, f (P, C) f32 -> (P, C) f32; or f (P, C)
    u16 (packed, f * 64) -> (P, C) u16, with the sentinel 0xFFFF outside
    the per-row interval of ``bounds`` (P, 128) u16 when given.  Any P, in
    launches of ``row_chunks``."""
    if tab.device.type != "cuda":
        raise ValueError("volume_lookup_multi kernel needs CUDA tensors")
    _check_depth("kernel D", tab, f)
    p, c = f.shape
    dev = tab.device
    _check_tensor("tab", tab, torch.uint16, (p, tab.shape[1]), dev)
    if tab.data_ptr() % 16:       # the earlier design stages 16 B words
        raise ValueError("tab is not 16-byte aligned")
    if f.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"f has dtype {f.dtype}, expected uint16 or float32")
    if f.dtype == torch.uint16:
        mode = 1 if bounds is None else 2
    elif bounds is not None:
        raise ValueError("bounds need a packed (u16) field")
    else:
        mode = 0
    _check_tensor("f", f, f.dtype, (p, c), dev)
    if bounds is not None:
        _check_tensor("bounds", bounds, torch.uint16, (p, 128), dev)
    out = torch.empty((p, c), dtype=f.dtype, device=dev)
    d = tab.shape[1]
    if _state["earlier"] and d > 512:
        raise ValueError("the earlier design of kernel D stages tables of "
                         "at most 512 planes")
    for r0, r1 in row_chunks(p, c, d):
        _launch("volume_lookup_multi", dev,
                tab.data_ptr() + r0 * d * tab.element_size(),
                f.data_ptr() + r0 * c * f.element_size(),
                None if bounds is None
                else bounds.data_ptr() + r0 * 128 * bounds.element_size(),
                out.data_ptr() + r0 * c * out.element_size(),
                r1 - r0, c, d, mode)
    return out


_offset_buffers: Dict[tuple, torch.Tensor] = {}


def _offset_buffer(offs: tuple, device: torch.device) -> torch.Tensor:
    """Kernel E's (dy, dx) int32 pairs on the card, one buffer per offset
    list and device (a config has a few lists; each is copied once)."""
    key = (offs, device)
    if key not in _offset_buffers:
        _offset_buffers[key] = torch.tensor(offs or (0,), dtype=torch.int32,
                                            device=device)
    return _offset_buffers[key]


def zncc_warped(ref_pad: torch.Tensor, tm: torch.Tensor, nsq0: torch.Tensor,
                warped_pad: torch.Tensor, valid_pad: torch.Tensor,
                hw: torch.Tensor, acc: torch.Tensor, scan_offsets,
                pad: int):
    """Kernel E: (score, var1), both (V, H, W), from the padded reference
    (H+2p, W+2p), tm/nsq0/hw (H, W), the padded warped sources and their
    validity (V, H+2p, W+2p) and the corner sums acc (V, 4, H, W); or for
    K candidates against the same reference (warped_pad, valid_pad (K, V,
    H+2p, W+2p), acc (K, V, 4, H, W)), both (K, V, H, W) from the same
    launches.  Each view's output depends on that view's inputs only, so
    more than ``ZNCC_MAX_VIEWS`` views go in launches of that many,
    exactly."""
    if tm.device.type != "cuda":
        raise ValueError("zncc_warped kernel needs CUDA tensors")
    if warped_pad.dim() not in (3, 4):
        raise ValueError(f"warped_pad has shape {tuple(warped_pad.shape)},"
                         " expected (V, H', W') or (K, V, H', W')")
    lead = tuple(warped_pad.shape[:-3])
    n_cand = lead[0] if lead else 1
    v = warped_pad.shape[-3]
    if v > ZNCC_MAX_VIEWS:
        def views(x, s):
            return x[..., s:s + ZNCC_MAX_VIEWS, :, :].contiguous()
        parts = [zncc_warped(ref_pad, tm, nsq0, views(warped_pad, s),
                             views(valid_pad, s), hw,
                             acc[..., s:s + ZNCC_MAX_VIEWS, :, :, :]
                             .contiguous(), scan_offsets, pad)
                 for s in range(0, v, ZNCC_MAX_VIEWS)]
        return (torch.cat([p[0] for p in parts], dim=-3),
                torch.cat([p[1] for p in parts], dim=-3))
    h, w = tm.shape
    dev = tm.device
    padded = (h + 2 * pad, w + 2 * pad)
    _check_tensor("ref_pad", ref_pad, torch.float32, padded, dev)
    for name, t in (("tm", tm), ("nsq0", nsq0), ("hw", hw)):
        _check_tensor(name, t, torch.float32, (h, w), dev)
    for name, t in (("warped_pad", warped_pad), ("valid_pad", valid_pad)):
        _check_tensor(name, t, torch.float32, lead + (v, *padded), dev)
    _check_tensor("acc", acc, torch.float32, lead + (v, 4, h, w), dev)
    if v < 1 or n_cand < 1:
        raise ValueError("kernel E takes at least one view and candidate")
    if n_cand > 65535:
        raise ValueError(f"kernel E takes at most 65535 candidates, got "
                         f"{n_cand}")
    offs = tuple(int(x) for o in scan_offsets for x in o)
    if any(abs(x) > pad for x in offs):
        raise ValueError(f"kernel E takes offsets within the pad {pad}, "
                         f"got {list(scan_offsets)}")
    offs_dev = _offset_buffer(offs, dev)
    score = torch.empty(lead + (v, h, w), dtype=torch.float32, device=dev)
    var1 = torch.empty(lead + (v, h, w), dtype=torch.float32, device=dev)
    _launch("zncc_warped", dev,
            ref_pad.data_ptr(), tm.data_ptr(), nsq0.data_ptr(),
            warped_pad.data_ptr(), valid_pad.data_ptr(), hw.data_ptr(),
            acc.data_ptr(), score.data_ptr(), var1.data_ptr(),
            offs_dev.data_ptr(), len(offs) // 2, n_cand, v, h, w, pad)
    return score, var1
