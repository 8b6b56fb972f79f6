"""Plane-sweep sigma tables: the exact-scoring lookup engine (PyTorch port
of ``hcmvs_tpu/ops/volume.py``, rect-frame build only).

Every warp position of a pixel's patch lies on its epipolar line,
parameterised by the scalar sigma (inverse depth along the plane).  Per
(ref, src) pair the source is resampled once along every pixel's line at
D = 128 uniform sigma steps into ``tab[q, j]``, stored as u16 fixed point,
and every score sample becomes a 1-D lerp lookup (``volume_lookup``).

The tables are built in each pair's rectified frame
(``build_volume_tables_rect``), where every pixel's sigma segment is a
strided run of one rect row.  Its pixel order is tile-major
(``to_volume_order``); the scoring consumer uses the same order.

Three kernels live here, each beside its plain PyTorch version:
- kernel A, ``rect_build_tab`` (``kernels/csrc/rect_build.cu``), replaces
  the Pallas ``_rect_build_kernel``;
- kernel B, ``volume_lookup`` (``kernels/csrc/volume_lookup.cu``),
  replaces the Pallas ``_lookup_kernel``;
- kernel D, ``volume_lookup_multi``
  (``kernels/csrc/volume_lookup_multi.cu``), replaces the Pallas
  ``_lookup_multi_kernel``: C index columns (all candidates' samples of a
  pixel) against one table row.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hcmvs_tpu_torch import kernels
from hcmvs_tpu_torch.dense.types import mat3_apply
from hcmvs_tpu_torch.ops.sampling import bicubic_sample_xy

D_PLANES = 128          # sigma planes per table
F_PACK_SCALE = 64       # packed index fields: u16 steps of 1/64 plane
_SIGMA_MARGIN = 1.35    # widening of the sigma range for patch obliquity
_CHUNK = 2048           # table rows are padded to a multiple of this

_RG_ROW_HALVES = 11     # build row band: 11 x 8 rows per (8, 128) tile
_RG_COL_HALVES = 2      # build column window: 2 x 512 columns
_RG_Y_SCALE = 2.0       # cross-epipolar oversampling of the build's frame
_WARP_ROW_STEP = 2      # rect rows warped exactly; the odd ones are rebuilt
_PLAIN_BUILD_TILES = 256  # tiles per pass of kernel A's plain version


class VolumeTables(NamedTuple):
    """Per-(ref, src-view) sweep tables; leading dim V (N, V at scene
    level)."""

    tab: torch.Tensor       # (V, P_pad, D) u16 fixed-point intensities
    sig0: torch.Tensor      # (V,) grid origin
    inv_dsig: torch.Tensor  # (V,) 1 / grid step
    sig_lo: torch.Tensor    # (V, H, W) valid-sigma interval (shrunk by
    sig_hi: torch.Tensor    # one grid step for the lerp neighbour)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _encode_tab(x: torch.Tensor) -> torch.Tensor:
    """f32 intensities in [0, 1] -> u16 fixed point (v * 65535)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 65535.0).to(torch.uint16)


def _decode_tab(x: torch.Tensor) -> torch.Tensor:
    """u16 fixed point -> f32 intensities."""
    return x.to(torch.float32) * (1.0 / 65535.0)


def sigma_grid(d_min, d_max):
    """(sigma0, dsigma): uniform D_PLANES-step grid over the realisable
    sigma range of hypotheses clamped to [0.8 d_min, 1.2 d_max], widened
    by ``_SIGMA_MARGIN`` for patch obliquity."""
    s_min = 1.0 / (1.2 * _SIGMA_MARGIN * d_max)
    s_max = _SIGMA_MARGIN / (0.8 * d_min)
    dsig = (s_max - s_min) / (D_PLANES - 1)
    return s_min, dsig


def _intersect_sigma(cons) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersect linear validity constraints a + b*sigma >= 0 (each a is
    an (H, W) plane, each b a plane or a scalar tensor)."""
    lo = torch.full_like(cons[0][0], -float("inf"))
    hi = torch.full_like(cons[0][0], float("inf"))
    eps = 1e-12
    for a, b in cons:
        root = -a / torch.where(b.abs() < eps, eps, b)
        lo = torch.where(b > eps, torch.maximum(lo, root), lo)
        hi = torch.where(b < -eps, torch.minimum(hi, root), hi)
        # b ~ 0: the constraint is constant; a < 0 -> never valid
        lo = torch.where((b.abs() <= eps) & (a < 0), float("inf"), lo)
    return lo, hi


def use_rect_volume_build(cfg, h: int, w: int) -> bool:
    """Whether stage tables are built in the rect frame: always, in the
    port (the per-plane build is not ported and raises)."""
    del h, w
    if cfg.volume_planes > D_PLANES:
        raise NotImplementedError(
            f"volume_planes={cfg.volume_planes} (> 128 needs the per-plane "
            "table build and multi-chunk lookups, not ported)")
    if cfg.volume_build not in ("auto", "rect"):
        raise NotImplementedError(
            f"volume_build={cfg.volume_build!r} (per-plane table build, "
            "not ported)")
    return True


def padded_hw(h: int, w: int) -> Tuple[int, int]:
    """Tile-aligned size the rect paths pad unaligned images to."""
    return _round_up(h, 8), _round_up(w, 128)


def to_volume_order(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., P) in the rect build's pixel order: (8, 128)
    image tiles in raster order; within a tile, column-major octets.
    Unaligned images are padded to the tile grid with zeros."""
    *lead, h, w = x.shape
    h8, w128 = padded_hw(h, w)
    if (h8, w128) != (h, w):
        x = torch.nn.functional.pad(x, (0, w128 - w, 0, h8 - h))
    x = x.reshape(*lead, h8 // 8, 8, w128 // 128, 128)
    x = x.movedim(-3, -2).transpose(-1, -2)     # (..., bh, bw, 128, 8)
    return x.reshape(*lead, h8 * w128)


def from_volume_order(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of to_volume_order (drops the alignment padding)."""
    *lead, _ = x.shape
    h8, w128 = padded_hw(h, w)
    x = x.reshape(*lead, h8 // 8, w128 // 128, 128, 8)
    x = x.transpose(-1, -2).movedim(-2, -3)     # (..., bh, 8, bw, 128)
    return x.reshape(*lead, h8, w128)[..., :h, :w]


def to_volume_order_multi(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (P, C): the rows of ``to_volume_order`` with the C
    channels minor, in one copy.  Unaligned images are zero-padded."""
    c, h, w = x.shape
    h8, w128 = padded_hw(h, w)
    if (h8, w128) != (h, w):
        x = torch.nn.functional.pad(x, (0, w128 - w, 0, h8 - h))
    x = x.reshape(c, h8 // 8, 8, w128 // 128, 128)
    return x.permute(1, 3, 4, 2, 0).reshape(h8 * w128, c)


def from_volume_order_multi(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of to_volume_order_multi: (P, C) -> (C, H, W)."""
    c = x.shape[1]
    h8, w128 = padded_hw(h, w)
    x = x.reshape(h8 // 8, w128 // 128, 128, 8, c).permute(4, 0, 3, 1, 2)
    return x.reshape(c, h8, w128)[:, :h, :w]


# --------------------------------------------------------------------------
# kernel B: table lookup
# --------------------------------------------------------------------------

def u16_as_int32(x: torch.Tensor) -> torch.Tensor:
    """u16 (or its int16 view) -> int32 values 0..65535 (PyTorch has few
    u16 kernels; conversions through an int16 view work everywhere)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def volume_lookup_plain(tab: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: tab (P, D) u16, f (P, S) f32 ->
    ``lerp(tab[q, i0], tab[q, i0 + 1], f - i0)`` with
    ``i0 = clip(floor f, 0, D - 2)``, decoded to f32."""
    i0 = torch.clamp(torch.floor(f), 0.0, tab.shape[1] - 2.0)
    t = f - i0
    i0i = i0.to(torch.int64)
    t16 = tab.view(torch.int16)       # gather has no u16 variant

    def dec(idx):
        raw = u16_as_int32(torch.gather(t16, 1, idx))
        return raw.to(torch.float32) * (1.0 / 65535.0)

    g0 = dec(i0i)
    g1 = dec(i0i + 1)
    return g0 + (g1 - g0) * t


def volume_lookup(tab: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Lerp-sample per-pixel tables: tab (P_pad, 128) u16, f (P_pad, S)
    contiguous f32 -> (P_pad, S).  Kernel B on CUDA, the plain version on
    the CPU."""
    if kernels.use_kernel(tab):
        return kernels.volume_lookup(tab, f)
    return volume_lookup_plain(tab, f)


# --------------------------------------------------------------------------
# kernel D: lookup of many index columns per table row
# --------------------------------------------------------------------------

def volume_lookup_multi_plain(tab: torch.Tensor, f: torch.Tensor,
                              bounds: torch.Tensor = None) -> torch.Tensor:
    """Plain version of kernel D.  tab (P, D) u16.

    - f (P, C) f32: ``volume_lookup_plain`` (decoded f32 values);
    - f (P, C) u16, packed (f * F_PACK_SCALE): ``i0 = min(f >> 6, D - 2)``,
      ``t = (f - 64 i0) / 64``, the lerp on the raw u16 scale, rounded half
      to even, low 16 bits kept -> (P, C) u16;
    - with ``bounds`` (P, 128) u16 (lo in lanes 0..63, hi in 64..127):
      ``min(value, 65534)`` where lo <= f <= hi, else the sentinel 0xFFFF.
    """
    if f.dtype == torch.float32:
        if bounds is not None:
            raise ValueError("bounds need a packed (u16) field")
        return volume_lookup_plain(tab, f)
    d = tab.shape[1]
    fi = u16_as_int32(f)
    i0 = torch.clamp_max(fi >> 6, d - 2)
    t = (fi - (i0 << 6)).to(torch.float32) * (1.0 / F_PACK_SCALE)
    t16 = tab.view(torch.int16)
    i0l = i0.to(torch.int64)
    g0 = u16_as_int32(torch.gather(t16, 1, i0l)).to(torch.float32)
    g1 = u16_as_int32(torch.gather(t16, 1, i0l + 1)).to(torch.float32)
    li = torch.round(g0 + (g1 - g0) * t).to(torch.int32)
    if bounds is not None:
        b = u16_as_int32(bounds)
        ok = (fi >= b[:, :1]) & (fi <= b[:, 64:65])
        li = torch.where(ok, torch.clamp_max(li, 65534), 65535)
    return (li & 0xFFFF).to(torch.int16).view(torch.uint16)


def volume_lookup_multi(tab: torch.Tensor, f: torch.Tensor,
                        bounds: torch.Tensor = None) -> torch.Tensor:
    """Lerp-sample per-pixel tables at C index columns per row (see
    ``volume_lookup_multi_plain``).  Kernel D on CUDA, the plain version
    on the CPU."""
    if kernels.use_kernel(tab):
        return kernels.volume_lookup_multi(tab, f, bounds)
    return volume_lookup_multi_plain(tab, f, bounds)


# --------------------------------------------------------------------------
# kernel A: rect-frame table build
# --------------------------------------------------------------------------

def _rect_build_plain(rect_src: torch.Tensor, rb: torch.Tensor,
                      cb: torch.Tensor, rowf: torch.Tensor,
                      c0w: torch.Tensor, kp: torch.Tensor,
                      p_pad: int) -> torch.Tensor:
    """Plain version of kernel A (the semantics of the JAX package's
    ``_rect_build_xla`` + ``_encode_tab`` + row padding).

    ``rect_src`` (V, H_r, W_r); ``rb``/``cb`` (V, T) per-tile band and
    window bases; ``rowf`` (band-relative row), ``c0w`` (window-relative
    column at sigma0) and ``kp`` (columns per plane) are (V, T * 1024) in
    tile-major pixel order.  Returns (V, p_pad, 128) u16.  Works through
    ``_PLAIN_BUILD_TILES`` tiles at a time to bound its temporaries."""
    v, h_r, w_r = rect_src.shape
    n_tiles = rb.shape[1]
    j = torch.arange(D_PLANES, dtype=torch.float32, device=rect_src.device)
    out = []
    for vi in range(v):
        flat = rect_src[vi].reshape(-1)
        parts = []
        for t0 in range(0, n_tiles, _PLAIN_BUILD_TILES):
            t1 = min(n_tiles, t0 + _PLAIN_BUILD_TILES)
            sl = slice(t0 * 1024, t1 * 1024)
            rf = rowf[vi, sl]
            r0 = torch.floor(rf)
            fr = (rf - r0)[:, None]
            r0b = r0.to(torch.int64)
            ok0 = ((r0b >= 0) & (r0b < 8 * _RG_ROW_HALVES)).float()[:, None]
            ok1 = ((r0b + 1 >= 0)
                   & (r0b + 1 < 8 * _RG_ROW_HALVES)).float()[:, None]
            band_lo = rb[vi, t0:t1].to(torch.int64).repeat_interleave(
                1024) * 8
            r0i = torch.clamp(r0b + band_lo, 0, h_r - 1)[:, None]
            r1i = torch.clamp(r0b + 1 + band_lo, 0, h_r - 1)[:, None]
            base = c0w[vi, sl, None] + kp[vi, sl, None] * j
            i0 = torch.clamp(torch.floor(base), 0.0, 1022.0)
            fc = torch.clamp(base - i0, 0.0, 1.0)
            col_lo = cb[vi, t0:t1].to(torch.int64).repeat_interleave(
                1024)[:, None] * 512
            ci = i0.to(torch.int64) + col_lo
            ci0 = torch.clamp(ci, 0, w_r - 1)
            ci1 = torch.clamp(ci + 1, 0, w_r - 1)
            v00 = flat[r0i * w_r + ci0] * ok0
            v01 = flat[r0i * w_r + ci1] * ok0
            v10 = flat[r1i * w_r + ci0] * ok1
            v11 = flat[r1i * w_r + ci1] * ok1
            top = v00 * (1 - fc) + v01 * fc
            bot = v10 * (1 - fc) + v11 * fc
            parts.append(_encode_tab(top * (1 - fr) + bot * fr))
        pad = torch.zeros((p_pad - n_tiles * 1024, D_PLANES),
                          dtype=torch.uint16, device=rect_src.device)
        out.append(torch.cat(parts + [pad]))
    return torch.stack(out)


def rect_build_tab(rect_src: torch.Tensor, rb: torch.Tensor,
                   cb: torch.Tensor, rowf: torch.Tensor, c0w: torch.Tensor,
                   kp: torch.Tensor, p_pad: int) -> torch.Tensor:
    """u16 tables (V, p_pad, 128) from the rect images and tile-major
    fields (see ``_rect_build_plain``).  Kernel A on CUDA, the plain
    version on the CPU."""
    if kernels.use_kernel(rect_src):
        return kernels.rect_build(rect_src, rb, cb, rowf, c0w, kp, p_pad)
    return _rect_build_plain(rect_src, rb, cb, rowf, c0w, kp, p_pad)


def _rect_frame_rounded(h: int, w: int) -> Tuple[int, int]:
    """rect_gather's frame at the build's vertical oversampling, rounded
    so its rows/cols block into 8-row / 512-col windows."""
    from hcmvs_tpu_torch.ops.rect_gather import rect_frame_shape
    h_r, w_r = rect_frame_shape(h, w, _RG_Y_SCALE)
    return _round_up(h_r, 8), _round_up(w_r, 512)


def _expand_tiles(x_t: torch.Tensor, n_bh: int, n_bw: int) -> torch.Tensor:
    """(T,) per-tile values -> (H8, W128) per-pixel broadcast."""
    x = x_t.reshape(n_bh, 1, n_bw, 1).expand(n_bh, 8, n_bw, 128)
    return x.reshape(n_bh * 8, n_bw * 128)


def _tile_blocks(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """(V, H, W) -> (V, n_bh, n_bw, 8, 128) tiles, padded with
    ``pad_value``."""
    v, h, w = x.shape
    h8, w128 = padded_hw(h, w)
    if (h8, w128) != (h, w):
        x = torch.nn.functional.pad(x, (0, w128 - w, 0, h8 - h),
                                    value=pad_value)
    return x.reshape(v, h8 // 8, 8, w128 // 128, 128).movedim(2, 3)


def _nanmin(x: torch.Tensor, dims) -> torch.Tensor:
    """``jnp.nanmin``: NaNs ignored; an all-NaN slice gives +inf here and
    -inf from ``_nanmax``, whose mean is NaN as in the JAX package."""
    return torch.where(torch.isnan(x), float("inf"), x).amin(dim=dims)


def _nanmax(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.where(torch.isnan(x), -float("inf"), x).amax(dim=dims)


class RectBuildSetup(NamedTuple):
    """Kernel A's arguments (see ``_rect_build_plain``) and the per-pixel
    fields the valid-sigma interval reads."""

    rect_src: torch.Tensor   # (V, H_r, W_r) source warped to the rect frame
    rb: torch.Tensor         # (V, T) int32 band base / 8 per tile
    cb: torch.Tensor         # (V, T) int32 window base / 512 per tile
    rowf_g: torch.Tensor     # (V, T * 1024) tile-major, band-relative
    c0w_g: torch.Tensor      # (V, T * 1024) tile-major, window-relative
    kp_g: torch.Tensor       # (V, T * 1024) tile-major columns per plane
    p_pad: int               # table rows, padded to _CHUNK
    rowf: torch.Tensor       # (V, H, W) rect row
    c0: torch.Tensor         # (V, H, W) rect column at sigma = 0
    k: torch.Tensor          # (V, H, W) rect columns per unit sigma
    az_ok: torch.Tensor      # (V, H, W) in front of the rect camera
    sig0: torch.Tensor       # sigma grid origin
    dsig: torch.Tensor       # sigma grid step
    h_r0: int                # rect frame rows


def rect_build_setup(geom, src_grays: torch.Tensor, d_min,
                     d_max) -> RectBuildSetup:
    """Everything of the rect-frame build up to kernel A: the source warped
    into each pair's rect frame once (Catmull-Rom; every other
    cross-epipolar row warped exactly and the rows between rebuilt by
    vertical Catmull-Rom), the per-tile band/window bases and the
    per-pixel fields."""
    from hcmvs_tpu_torch.ops.rect_gather import make_rect_geometry

    v, h, w = src_grays.shape
    dev = src_grays.device
    h8, w128 = padded_hw(h, w)
    sig0, dsig = sigma_grid(d_min, d_max)
    rg = make_rect_geometry(geom, h, w, y_scale=_RG_Y_SCALE)
    h_r0, w_r0 = _rect_frame_rounded(h, w)
    n_bh, n_bw = h8 // 8, w128 // 128
    n_tiles = n_bh * n_bw
    f32 = torch.float32

    # one-time Catmull-Rom warp into the rect frame (edge-clamped: values
    # outside the source footprint are never consumed, validity is
    # governed by the sigma intervals)
    n_rows = h_r0 // _WARP_ROW_STEP
    rv, ru = torch.meshgrid(
        torch.arange(n_rows, dtype=f32, device=dev) * _WARP_ROW_STEP,
        torch.arange(w_r0, dtype=f32, device=dev), indexing="ij")
    warped = []
    for vi in range(v):
        px, py, pz = mat3_apply(rg.H_sr[vi], (ru, rv, torch.ones_like(ru)))
        inv = 1.0 / torch.where(pz.abs() < 1e-9, 1e-9, pz)
        x = torch.clamp(px * inv, 0.0, w - 1.0)
        y = torch.clamp(py * inv, 0.0, h - 1.0)
        front = pz > 1e-9
        out, _ = bicubic_sample_xy(src_grays[vi], torch.where(front, x, 0.0),
                                   torch.where(front, y, 0.0))
        warped.append(out)
    rect_src = torch.stack(warped)                     # (V, H_r/2, W_r)
    # each skipped row lies halfway between two warped rows: Catmull-Rom
    # at t = 1/2 has the weights (-1/16, 9/16, 9/16, -1/16)
    cm1 = torch.cat([rect_src[:, :1], rect_src[:, :-1]], dim=1)
    cp1 = torch.cat([rect_src[:, 1:], rect_src[:, -1:]], dim=1)
    cp2 = torch.cat([rect_src[:, 2:], rect_src[:, -1:], rect_src[:, -1:]],
                    dim=1)
    mid = (-0.0625 * cm1 + 0.5625 * rect_src + 0.5625 * cp1
           - 0.0625 * cp2)
    rect_src = torch.stack([rect_src, mid], dim=2).reshape(v, h_r0, w_r0)
    rect_src = rect_src.contiguous()

    # per-pixel fields: rect row, column at sigma = 0, columns per sigma
    pv, pu = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    rowf, c0, k, az_ok = [], [], [], []
    for vi in range(v):
        ax, ay, az = mat3_apply(rg.M[vi], (pu, pv, torch.ones_like(pu)))
        ok = az > 1e-9
        inv = 1.0 / torch.where(ok, az, 1.0)
        rowf.append(torch.where(ok, ay * inv, -1e9))
        c0.append(torch.where(ok, ax * inv, 1e9))
        k.append(torch.where(ok, rg.bx[vi] * inv, 0.0))
        az_ok.append(ok)
    rowf, c0, k, az_ok = (torch.stack(x) for x in (rowf, c0, k, az_ok))

    # per-tile bases: centred 88-row band / 1024-col window.  Alignment
    # padding enters as NaN so it never moves a tile's window.
    nan = float("nan")
    rows_b = _tile_blocks(torch.where(az_ok, rowf, nan), nan)
    center = torch.nan_to_num(
        0.5 * (_nanmin(rows_b, (-1, -2)) + _nanmax(rows_b, (-1, -2))),
        nan=0.0)
    rb = torch.clamp(torch.floor(center / 8.0).to(torch.int32)
                     - _RG_ROW_HALVES // 2,
                     0, h_r0 // 8 - _RG_ROW_HALVES).reshape(v, n_tiles)
    c_a = _tile_blocks(torch.where(az_ok, c0 + k * sig0, nan), nan)
    c_b = _tile_blocks(torch.where(
        az_ok, c0 + k * (sig0 + dsig * (D_PLANES - 1)), nan), nan)
    cmin = torch.minimum(_nanmin(c_a, (-1, -2)), _nanmin(c_b, (-1, -2)))
    cmax = torch.maximum(_nanmax(c_a, (-1, -2)), _nanmax(c_b, (-1, -2)))
    ccen = torch.nan_to_num(0.5 * (cmin + cmax), nan=0.0)
    cb = torch.clamp(torch.floor(ccen / 512.0).to(torch.int32) - 1,
                     0, w_r0 // 512 - _RG_COL_HALVES).reshape(v, n_tiles)

    # tile-major fields relative to the band / window; padded pixels carry
    # the invalid-row sentinel so their rows read 0
    def tile_major(x, pad_value):
        xb = _tile_blocks(x, pad_value)               # (V, bh, bw, 8, 128)
        return xb.transpose(-1, -2).reshape(v, n_tiles, 1024)

    rb_px = rb.to(f32)[..., None]
    cb_px = cb.to(f32)[..., None]
    rowf_g = (tile_major(rowf, -1e9) - 8.0 * rb_px).reshape(v, -1)
    c0w_g = (tile_major(c0 + k * sig0, 0.0) - 512.0 * cb_px).reshape(v, -1)
    kp_g = tile_major(k * dsig, 0.0).reshape(v, -1)

    return RectBuildSetup(
        rect_src=rect_src, rb=rb.contiguous(), cb=cb.contiguous(),
        rowf_g=rowf_g.contiguous(), c0w_g=c0w_g.contiguous(),
        kp_g=kp_g.contiguous(), p_pad=_round_up(n_tiles * 1024, _CHUNK),
        rowf=rowf, c0=c0, k=k, az_ok=az_ok, sig0=sig0, dsig=dsig, h_r0=h_r0)


def build_volume_tables_rect(geom, src_grays: torch.Tensor, d_min,
                             d_max) -> VolumeTables:
    """Rect-frame table build for one reference view (all V pairs).

    ``tab[p, j]`` is the bilerp of the rect-warped source at row(p) and
    column c0(p) + k(p) * sigma_j (``rect_build_setup``, then kernel A).
    The valid-sigma interval also intersects the rect band/window
    coverage, so banding misses are exact invalidity, never silent zeros.
    """
    v, h, w = src_grays.shape
    s = rect_build_setup(geom, src_grays, d_min, d_max)
    tab = rect_build_tab(s.rect_src, s.rb, s.cb, s.rowf_g, s.c0w_g, s.kp_g,
                         s.p_pad)

    # exact valid-sigma interval: src-frame constraints plus the rect
    # frame / band / window coverage
    f32 = torch.float32
    h8, w128 = padded_hw(h, w)
    n_bh, n_bw = h8 // 8, w128 // 128
    pv, pu = torch.meshgrid(torch.arange(h, dtype=f32, device=tab.device),
                            torch.arange(w, dtype=f32, device=tab.device),
                            indexing="ij")
    rb, cb, rowf, c0, k, az_ok = s.rb, s.cb, s.rowf, s.c0, s.k, s.az_ok
    lo_all, hi_all = [], []
    for vi in range(v):
        A, wv = geom.A[vi], geom.wv[vi]
        p0x = A[0, 0] * pu + A[0, 1] * pv + A[0, 2]
        p0y = A[1, 0] * pu + A[1, 1] * pv + A[1, 2]
        p0z = A[2, 0] * pu + A[2, 1] * pv + A[2, 2]
        rbf = _expand_tiles(rb[vi], n_bh, n_bw)[:h, :w].to(f32) * 8.0
        cbf = _expand_tiles(cb[vi], n_bh, n_bw)[:h, :w].to(f32) * 512.0
        c0_v, k_v = c0[vi], k[vi]
        cons = (
            (p0z, wv[2]),
            (p0x, wv[0]),
            ((w - 1) * p0z - p0x, (w - 1) * wv[2] - wv[0]),
            (p0y, wv[1]),
            ((h - 1) * p0z - p0y, (h - 1) * wv[2] - wv[1]),
            # rect col window: 512*cb <= c0 + k*sigma <= 512*cb + 1022
            (c0_v - cbf, k_v),
            (cbf + 1022.0 - c0_v, -k_v),
        )
        lo, hi = _intersect_sigma(cons)
        rowf_v = rowf[vi]
        row_ok = (az_ok[vi] & (rowf_v >= rbf)
                  & (rowf_v <= rbf + 8.0 * _RG_ROW_HALVES - 1.0)
                  & (rowf_v <= s.h_r0 - 1))
        lo = torch.where(row_ok, lo, float("inf"))
        lo_all.append(lo + s.dsig)
        hi_all.append(hi - s.dsig)
    ones = torch.ones(v, dtype=f32, device=tab.device)
    return VolumeTables(tab=tab, sig0=s.sig0 * ones,
                        inv_dsig=(1.0 / s.dsig) * ones,
                        sig_lo=torch.stack(lo_all),
                        sig_hi=torch.stack(hi_all))
