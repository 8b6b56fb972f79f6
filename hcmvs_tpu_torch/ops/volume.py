"""Plane-sweep sigma tables: the exact-scoring lookup engine (PyTorch port
of ``hcmvs_tpu/ops/volume.py``).

Every warp position of a pixel's patch lies on its epipolar line,
parameterised by the scalar sigma (inverse depth along the plane).  Per
(ref, src) pair the source is resampled once along every pixel's line at
D uniform sigma steps into ``tab[q, j]``, stored as u16 fixed point, and
every score sample becomes a 1-D lerp lookup (``volume_lookup``).

Two builds, chosen by ``use_rect_volume_build``:
- the rect-frame build (``build_volume_tables_rect``, D = 128), where
  every pixel's sigma segment is a strided run of one rect row; its pixel
  order is tile-major (``to_volume_order``);
- the per-plane build (``build_volume_tables``, D = 128 n:
  ``table_chunks``), one bilinear warp of the source per coarse
  plane and Catmull-Rom along sigma between them; its pixel order is the
  image's (row-major).
Every consumer of the tables (kernel B's and D's index fields, D's bounds
panels) keys its row order on the same gate (``dense/score.py``).

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

from typing import NamedTuple, Optional, Tuple

import torch

from hcmvs_tpu_torch import kernels
from hcmvs_tpu_torch.dense.types import mat3_apply
from hcmvs_tpu_torch.ops.sampling import bicubic_sample_xy

D_PLANES = 128          # sigma planes per table chunk (the rect build's D)
F_PACK_SCALE = 64       # packed index fields: u16 steps of 1/64 plane
# the deepest table packed fields address: the last plane's index,
# (D - 1) * 64, must stay below the 0xFFFF sentinel
MAX_PACKED_PLANES = 65534 // F_PACK_SCALE + 1
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


def sigma_grid(d_min, d_max, margin: float = _SIGMA_MARGIN,
               n_planes: int = D_PLANES):
    """(sigma0, dsigma): uniform ``n_planes``-step grid over the realisable
    sigma range of hypotheses clamped to [0.8 d_min, 1.2 d_max], widened
    by ``margin`` for patch obliquity."""
    s_min = 1.0 / (1.2 * margin * d_max)
    s_max = margin / (0.8 * d_min)
    dsig = (s_max - s_min) / (n_planes - 1)
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


def table_chunks(cfg) -> int:
    """The per-plane build's ``n_chunks`` for ``cfg.volume_planes``, as the
    JAX package takes it (scene_driver.py): max(volume_planes // 128, 1),
    so 200 builds 128 planes and 1024 builds 8 chunks."""
    return max(cfg.volume_planes // D_PLANES, 1)


def use_rect_volume_build(cfg, h: int, w: int) -> bool:
    """Whether stage tables are built in the rect frame (tile-major rows)
    rather than plane by plane (image-order rows), as the JAX package
    routes them: ``volume_planes > 128`` or ``volume_build="planes"`` take
    the per-plane build; "rect" and, in the port, "auto" the rect build on
    every device ("auto" with ``use_pallas=False`` the per-plane one)."""
    del h, w
    if cfg.volume_planes > D_PLANES:
        return False
    if cfg.volume_build == "rect":
        return True
    if cfg.volume_build == "planes":
        return False
    if cfg.volume_build != "auto":
        raise ValueError(f"unknown volume_build {cfg.volume_build!r}")
    return bool(cfg.use_pallas)


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
    """Plain version of kernel B (``volume_lookup_xla``'s lerp, which the
    Pallas kernel's per-chunk select-merge computes at every D): tab (P, D)
    u16, f (P, S) f32 ->
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
    """Lerp-sample per-pixel tables: tab (P_pad, D) u16, D a multiple of
    128, f (P_pad, S) contiguous f32 -> (P_pad, S).  Kernel B on
    CUDA, the plain version on the CPU."""
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
# the per-plane build (image-order rows, any plane count)
# --------------------------------------------------------------------------

_PLANE_BATCH = 16       # coarse planes warped per pass of the planes build


def build_view_volume(A: torch.Tensor, wv: torch.Tensor,
                      src_gray: torch.Tensor, sig0, dsig, h: int, w: int,
                      build_step: int = 2, n_planes: int = D_PLANES,
                      row_range: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (ref, src) pair's table, (P_pad, n_planes) u16 in image order
    (rows past h * w zero), and its valid-sigma interval (H, W) x 2.
    ``row_range`` (lo, hi): the image rows [lo, hi) alone (a row band's
    table; every pixel's entries are those of the whole image's).

    Every ``build_step``-th plane (and the last coarse one) is a bilinear
    warp of the source through the plane's homography; the planes between
    are Catmull-Rom along sigma, the coarse stack padded with its end
    planes at both ends and cut to ``n_planes``, as the JAX package builds
    them.  The warps go ``_PLANE_BATCH`` planes a pass; each plane's
    values are the same elementwise arithmetic whatever the batch."""
    from hcmvs_tpu_torch.ops.sampling import bilinear_sample_xy
    dev = src_gray.device
    f32 = torch.float32
    r0, r1 = (0, h) if row_range is None else row_range
    h = r1 - r0
    v_, u_ = torch.meshgrid(torch.arange(r0, r1, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    p0x = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]
    p0y = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]
    p0z = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]
    hs, ws = src_gray.shape

    def planes(js: torch.Tensor) -> torch.Tensor:
        sig = (sig0 + dsig * js)[:, None, None]            # (B, 1, 1)
        phx = p0x + wv[0] * sig
        phy = p0y + wv[1] * sig
        phz = p0z + wv[2] * sig
        inv_z = 1.0 / torch.where(phz.abs() < 1e-9, 1e-9, phz)
        val, _ = bilinear_sample_xy(src_gray, phx * inv_z, phy * inv_z)
        return val.reshape(js.shape[0], h * w)

    step = 1 if build_step == 1 else build_step
    n_coarse = (n_planes - 1) // step + 1
    js = torch.arange(n_coarse, dtype=f32, device=dev) * step
    coarse = torch.cat([planes(js[i:i + _PLANE_BATCH])
                        for i in range(0, n_coarse, _PLANE_BATCH)])
    rows = [_encode_tab(coarse)]
    if step > 1:
        idx = torch.arange(n_coarse, device=dev)
        cm1 = coarse[torch.clamp_min(idx - 1, 0)]
        cp1 = coarse[torch.clamp_max(idx + 1, n_coarse - 1)]
        cp2 = coarse[torch.clamp_max(idx + 2, n_coarse - 1)]
        for r in range(1, step):
            t = r / step
            # Catmull-Rom weights at fraction t
            w0 = -0.5 * t + t * t - 0.5 * t ** 3
            w1 = 1.0 - 2.5 * t * t + 1.5 * t ** 3
            w2 = 0.5 * t + 2.0 * t * t - 1.5 * t ** 3
            w3 = -0.5 * t * t + 0.5 * t ** 3
            rows.append(_encode_tab(w0 * cm1 + w1 * coarse + w2 * cp1
                                    + w3 * cp2))
        del cm1, cp1, cp2
    del coarse
    # (n_coarse, step, P) -> plane-major (D, P), then pixel-major rows
    tab = torch.stack(rows, dim=1).reshape(n_coarse * step, h * w)
    tab = tab[:n_planes].T
    p_pad = _round_up(h * w, _CHUNK)
    out = torch.zeros((p_pad, n_planes), dtype=torch.uint16, device=dev)
    out[:h * w] = tab
    del tab, rows

    # valid-sigma interval: each border is one linear constraint
    # a + b*sigma >= 0 (z > 0 folded in), intersected analytically
    cons = (
        (p0z, wv[2]),                                          # z > 0
        (p0x, wv[0]),                                          # u >= 0
        ((ws - 1) * p0z - p0x, (ws - 1) * wv[2] - wv[0]),      # u <= W-1
        (p0y, wv[1]),                                          # v >= 0
        ((hs - 1) * p0z - p0y, (hs - 1) * wv[2] - wv[1]),      # v <= H-1
    )
    lo, hi = _intersect_sigma(cons)
    # shrink by one step: the lerp also reads plane floor(f) + 1
    return out, lo + dsig, hi - dsig


def build_volume_tables(geom, src_grays: torch.Tensor, d_min, d_max,
                        n_chunks: int = 1,
                        row_range: Optional[Tuple[int, int]] = None
                        ) -> VolumeTables:
    """All neighbour views' per-plane tables for one reference view:
    ``n_chunks * 128`` sigma planes, (V, P_pad, D) u16 in image order.
    The neighbours are built one after another (the JAX package
    serialises them above 640x480; each pair's f32 plane stack is the
    largest temporary).  ``row_range``: a row band's rows alone."""
    v, h, w = src_grays.shape
    n_planes = n_chunks * D_PLANES
    sig0, dsig = sigma_grid(d_min, d_max, n_planes=n_planes)
    tabs, los, his = [], [], []
    for vi in range(v):
        tab, lo, hi = build_view_volume(geom.A[vi], geom.wv[vi],
                                        src_grays[vi], sig0, dsig, h, w,
                                        n_planes=n_planes,
                                        row_range=row_range)
        tabs.append(tab)
        los.append(lo)
        his.append(hi)
    ones = torch.ones(v, dtype=torch.float32, device=src_grays.device)
    return VolumeTables(tab=torch.stack(tabs), sig0=sig0 * ones,
                        inv_dsig=(1.0 / dsig) * ones,
                        sig_lo=torch.stack(los), sig_hi=torch.stack(his))


def build_tables(geom, src_grays: torch.Tensor, d_min, d_max, cfg,
                 row_range: Optional[Tuple[int, int]] = None
                 ) -> VolumeTables:
    """One reference view's tables by the build ``cfg`` routes to
    (``use_rect_volume_build``); ``row_range`` (lo, hi): the rows of
    image rows [lo, hi) alone, lo a multiple of 8 and hi too or the
    image's height (a row band's tables: the whole image's rows
    [lo, hi), in the build's row order)."""
    h, w = src_grays.shape[1:]
    if row_range is not None:
        lo, hi = row_range
        if not (0 <= lo < hi <= h and lo % 8 == 0
                and (hi % 8 == 0 or hi == h)):
            raise ValueError(f"rows [{lo}, {hi}) of a {h}-row image are "
                             f"not whole 8-row tile rows")
    if use_rect_volume_build(cfg, h, w):
        return build_volume_tables_rect(geom, src_grays, d_min, d_max,
                                        row_range)
    return build_volume_tables(geom, src_grays, d_min, d_max,
                               n_chunks=table_chunks(cfg),
                               row_range=row_range)


def table_rows(vol: VolumeTables, span: Tuple[int, int],
               rows: Tuple[int, int], w: int, rect: bool) -> VolumeTables:
    """The tables of image rows ``rows`` (lo, hi) cut from ``vol``, one
    view's tables of the image rows ``span`` around them (both whole
    8-row tile rows, or ending at the image's last row): what
    ``build_tables`` builds for ``rows``.  ``rect``: ``vol`` is in the
    rect build's tile order, else in image order."""
    if tuple(rows) == tuple(span):
        return vol
    r0, r1 = rows[0] - span[0], rows[1] - span[0]
    if rect:
        per = padded_hw(8, w)[1] * 8      # the table rows of a tile row
        a, z = r0 // 8 * per, -(-r1 // 8) * per
    else:
        a, z = r0 * w, r1 * w
    v, _, d = vol.tab.shape
    tab = vol.tab.new_zeros((v, _round_up(z - a, _CHUNK), d))
    tab[:, :z - a] = vol.tab[:, a:z]
    return vol._replace(tab=tab,
                        sig_lo=vol.sig_lo[:, r0:r1].contiguous(),
                        sig_hi=vol.sig_hi[:, r0:r1].contiguous())


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


def rect_build_args(s: RectBuildSetup,
                    row_range: Optional[Tuple[int, int]] = None) -> tuple:
    """Kernel A's arguments after the rect images, (rb, cb, rowf, c0w, kp,
    p_pad): the whole view's, or those of the tiles of image rows
    ``row_range`` (lo, hi), whole tile rows (a row band's window)."""
    args = (s.rb, s.cb, s.rowf_g, s.c0w_g, s.kp_g)
    if row_range is None:
        return args + (s.p_pad,)
    h, w = s.rowf.shape[1:]
    n_bw = padded_hw(h, w)[1] // 128
    t0, t1 = row_range[0] // 8 * n_bw, -(-row_range[1] // 8) * n_bw
    return (s.rb[:, t0:t1].contiguous(), s.cb[:, t0:t1].contiguous(),
            *(x[:, t0 * 1024:t1 * 1024].contiguous()
              for x in args[2:]), _round_up((t1 - t0) * 1024, _CHUNK))


def build_volume_tables_rect(geom, src_grays: torch.Tensor, d_min,
                             d_max,
                             row_range: Optional[Tuple[int, int]] = None
                             ) -> VolumeTables:
    """Rect-frame table build for one reference view (all V pairs).

    ``tab[p, j]`` is the bilerp of the rect-warped source at row(p) and
    column c0(p) + k(p) * sigma_j (``rect_build_setup``, then kernel A).
    The valid-sigma interval also intersects the rect band/window
    coverage, so banding misses are exact invalidity, never silent zeros.
    ``row_range`` (lo, hi), whole tile rows: the setup (frame fit, rect
    images, per-tile bases) is the whole view's, and kernel A runs on
    the tiles of rows [lo, hi) alone.
    """
    v, h, w = src_grays.shape
    s = rect_build_setup(geom, src_grays, d_min, d_max)
    n_bw = padded_hw(h, w)[1] // 128
    r0, r1 = (0, h) if row_range is None else row_range
    args = rect_build_args(s, row_range)
    rb, cb = args[:2]
    tab = rect_build_tab(s.rect_src, *args)

    # exact valid-sigma interval: src-frame constraints plus the rect
    # frame / band / window coverage
    f32 = torch.float32
    hb = r1 - r0
    n_bh = -(-hb // 8)
    pv, pu = torch.meshgrid(torch.arange(r0, r1, dtype=f32,
                                         device=tab.device),
                            torch.arange(w, dtype=f32, device=tab.device),
                            indexing="ij")
    rowf, c0, k, az_ok = (x[:, r0:r1] for x in (s.rowf, s.c0, s.k, s.az_ok))
    lo_all, hi_all = [], []
    for vi in range(v):
        A, wv = geom.A[vi], geom.wv[vi]
        p0x = A[0, 0] * pu + A[0, 1] * pv + A[0, 2]
        p0y = A[1, 0] * pu + A[1, 1] * pv + A[1, 2]
        p0z = A[2, 0] * pu + A[2, 1] * pv + A[2, 2]
        rbf = _expand_tiles(rb[vi], n_bh, n_bw)[:hb, :w].to(f32) * 8.0
        cbf = _expand_tiles(cb[vi], n_bh, n_bw)[:hb, :w].to(f32) * 512.0
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
