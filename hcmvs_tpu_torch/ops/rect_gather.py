"""Rectified epipolar gather: the geo-consistency lookup engine (PyTorch
port of ``hcmvs_tpu/ops/rect_gather.py``).

Each (ref, src) pair is rectified: the source camera is rotated by Q so
that Q t_rel = (|t|, 0, 0).  In that frame the projection of ref pixel p
at inverse depth sigma is

    col(p) = c0(p) + k(p) * sigma        row(p) = r(p)

so the row is fixed for a whole stage and the column is affine in sigma.
The neighbour maps are warped into the rect frames once per external
iteration (``build_rect_context``), and every per-candidate read is
``rect_lookup``.

Each (8, 128) pixel tile reads through one 40-row band (``rb``) and one
512-column window (``_col_bases``); reads that miss them return 0, i.e.
"neighbour invalid".  That banding was a Mosaic constraint of the TPU
kernel, but its misses are part of the reference semantics and the port
keeps them.  The rect maps are stored (V, C, H_r, W_r); the TPU blocking
into (8, 256) quarters is not carried over.

Kernel C, ``rect_lookup`` (``kernels/csrc/rect_lookup.cu``), replaces the
Pallas ``_lookup_kernel``; ``rect_lookup_plain`` is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hcmvs_tpu_torch import kernels
from hcmvs_tpu_torch.dense.types import mat3_apply

R_HALVES = 5          # row band = R_HALVES x 8 rows, 8-row-aligned base
ROWS_HALF = 8
COLS_HALF = 256       # window = 2 halves of 256 cols, 256-col-aligned
BAND_ROWS = R_HALVES * ROWS_HALF
WIN_COLS = 2 * COLS_HALF
_INVALID = 1 << 20    # sentinel pushing misses out of every window


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rect_frame_shape(h: int, w: int,
                     y_scale: float = 1.0) -> Tuple[int, int]:
    """Static rect-frame size for an (h, w) image; ``y_scale`` > 1
    oversamples the cross-epipolar axis (the table build uses 2)."""
    return (_ceil_to(max(int(1.25 * h * y_scale), BAND_ROWS), ROWS_HALF),
            _ceil_to(max(int(1.6 * w), WIN_COLS), WIN_COLS))


class RectGeometry(NamedTuple):
    """Per-(ref, src-view) rectification constants; leading dim V."""

    M: torch.Tensor      # (V, 3, 3)  K_rect Q R_rel K_inv_ref
    bx: torch.Tensor     # (V,)       (K_rect Q t_rel)_x
    H_sr: torch.Tensor   # (V, 3, 3)  rect px -> src px homography
    scale: torch.Tensor  # (V,)       rect px per src px


def make_rect_geometry(geom, h: int, w: int,
                       y_scale: float = 1.0) -> RectGeometry:
    """Rectifying rotation + frame fit for every neighbour view.

    Q rows: q1 = t_hat; q2 is the ref image's y axis carried into the src
    camera and orthogonalised (so rect rows run along ref rows and a
    tile's row spread stays small), or a helper axis when that
    degenerates; q3 = q1 x q2, flipped with q2 to look forward.  All
    products are full float32 (see core/camera.py).
    """
    h_r, w_r = rect_frame_shape(h, w, y_scale)
    dev = geom.R_rel.device
    f32 = torch.float32
    corners = torch.tensor([[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
                            [0.0, h - 1.0, 1.0], [w - 1.0, h - 1.0, 1.0]],
                           dtype=f32, device=dev).T
    KQs, bxs, H_srs, scales = [], [], [], []
    for vi in range(geom.R_rel.shape[0]):
        R_rel, t_rel, K_inv_src = (geom.R_rel[vi], geom.t_rel[vi],
                                   geom.K_inv_src[vi])
        tn = torch.linalg.norm(t_rel) + 1e-12
        q1 = t_rel / tn
        y_ref = R_rel[:, 1]
        q2 = y_ref - torch.dot(y_ref, q1) * q1
        n2 = torch.linalg.norm(q2)
        helper = torch.where(q1[2].abs() < 0.9,
                             torch.tensor([0.0, 0.0, 1.0], device=dev),
                             torch.tensor([0.0, 1.0, 0.0], device=dev))
        alt = torch.linalg.cross(helper, q1)
        q2 = torch.where(n2 > 1e-6, q2 / (n2 + 1e-12),
                         alt / (torch.linalg.norm(alt) + 1e-12))
        q3 = torch.linalg.cross(q1, q2)
        flip = torch.where(q3[2] < 0.0, -1.0, 1.0)
        q2 = q2 * flip
        q3 = q3 * flip
        Q = torch.stack([q1, q2, q3])                  # src-cam -> rect

        # fit the src corners (ray units) into the static frame; rect px
        # per src px is capped at 1.5
        pr = Q @ (K_inv_src @ corners)                 # (3, 4)
        z = torch.clamp_min(pr[2], 1e-6)
        cx = pr[0] / z
        cy = pr[1] / z
        f_src = 2.0 / torch.clamp_min(
            K_inv_src[0, 0].abs() + K_inv_src[1, 1].abs(), 1e-12)
        s = torch.minimum(torch.minimum(
            (w_r - 1.0) / torch.clamp_min(cx.max() - cx.min(), 1e-6),
            (h_r - 1.0) / (y_scale
                           * torch.clamp_min(cy.max() - cy.min(), 1e-6))),
            1.5 * f_src)
        sy = s * y_scale
        zero = torch.zeros((), dtype=f32, device=dev)
        one = torch.ones((), dtype=f32, device=dev)
        K_rect = torch.stack([
            torch.stack([s, zero, -s * cx.min()]),
            torch.stack([zero, sy, -sy * cy.min()]),
            torch.stack([zero, zero, one])])
        KQ = K_rect @ Q
        bxs.append((KQ @ t_rel)[0])
        H_srs.append(torch.linalg.inv_ex(KQ @ K_inv_src)[0])
        KQs.append(KQ)
        scales.append(s)
    KQ = torch.stack(KQs)
    M = torch.einsum("vij,vjk,kl->vil", KQ, geom.R_rel, geom.K_inv_ref)
    return RectGeometry(M=M, bx=torch.stack(bxs), H_sr=torch.stack(H_srs),
                        scale=torch.stack(scales))


class RectContext(NamedTuple):
    """Everything the rect lookup needs; rebuilt once per external
    iteration (the neighbour-map snapshot changes)."""

    maps: torch.Tensor     # (V, C, H_r, W_r) rect channels
    row_int: torch.Tensor  # (V, H, W) int32 rect row (_INVALID marks bad)
    c0: torch.Tensor       # (V, H, W) col at sigma=0 (_INVALID when bad)
    k: torch.Tensor        # (V, H, W) d(col)/d(sigma)
    rb: torch.Tensor       # (V, n_bh, n_bw) int32 row base / ROWS_HALF

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return tuple(self.maps.shape[2:])


def _to_blocks(x: torch.Tensor, pad_value) -> torch.Tensor:
    """(V, H, W) -> (V, H8/8, W128/128, 8, 128) tiles, padded with
    ``pad_value``."""
    v, h, w = x.shape
    h8, w128 = _ceil_to(h, 8), _ceil_to(w, 128)
    if (h8, w128) != (h, w):
        x = torch.nn.functional.pad(x, (0, w128 - w, 0, h8 - h),
                                    value=pad_value)
    return x.reshape(v, h8 // 8, 8, w128 // 128, 128).movedim(2, 3)


def _from_tiles(x_t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(V, n_bh, n_bw) per-tile values -> (V, H, W) per-pixel."""
    v, n_bh, n_bw = x_t.shape
    x = x_t[:, :, None, :, None].expand(v, n_bh, 8, n_bw, 128)
    return x.reshape(v, n_bh * 8, n_bw * 128)[:, :h, :w]


def build_rect_context(geom, nbr_maps: torch.Tensor) -> RectContext:
    """Warp neighbour channels ``nbr_maps`` (V, C, H, W) into the rect
    frames (one nearest gather) and compute the per-pixel fields."""
    from hcmvs_tpu_torch.ops.sampling import nearest_sample_planes_batched
    v, c, h, w = nbr_maps.shape
    dev = nbr_maps.device
    f32 = torch.float32
    h_r, w_r = rect_frame_shape(h, w)
    rg = make_rect_geometry(geom, h, w)

    rv, ru = torch.meshgrid(torch.arange(h_r, dtype=f32, device=dev),
                            torch.arange(w_r, dtype=f32, device=dev),
                            indexing="ij")
    xs, ys = [], []
    for vi in range(v):
        px, py, pz = mat3_apply(rg.H_sr[vi], (ru, rv, torch.ones_like(ru)))
        inv = 1.0 / torch.where(pz.abs() < 1e-9, 1e-9, pz)
        xs.append(torch.round(torch.where(pz > 1e-9, px * inv, -1.0)))
        ys.append(torch.round(torch.where(pz > 1e-9, py * inv, -1.0)))
    maps, _ = nearest_sample_planes_batched(nbr_maps, torch.stack(xs),
                                            torch.stack(ys))

    # per-pixel fields: a = M p~; row = a_y/a_z, c0 = a_x/a_z, k = bx/a_z
    pv, pu = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    rows, c0s, ks = [], [], []
    for vi in range(v):
        ax, ay, az = mat3_apply(rg.M[vi], (pu, pv, torch.ones_like(pu)))
        ok = az > 1e-9
        inv = 1.0 / torch.where(ok, az, 1.0)
        row = torch.round(ay * inv)
        row_ok = ok & (row >= 0) & (row <= h_r - 1)
        rows.append(torch.where(row_ok, row, float(_INVALID)).to(
            torch.int32))
        c0s.append(torch.where(ok, ax * inv, float(_INVALID)))
        ks.append(torch.where(ok, rg.bx[vi] * inv, 0.0))
    row_int = torch.stack(rows)

    # 8-row-aligned band base per (8, 128) tile, centred between the
    # tile's valid row extremes; padding enters as _INVALID
    rows_b = _to_blocks(row_int, _INVALID)
    valid_b = rows_b < _INVALID
    rmin = torch.where(valid_b, rows_b, _INVALID).amin(dim=(-1, -2))
    rmax = torch.where(valid_b, rows_b, 0).amax(dim=(-1, -2))
    center = torch.div(torch.minimum(rmin, rmax) + rmax, 2,
                       rounding_mode="floor")
    rb = torch.clamp(torch.div(center, ROWS_HALF, rounding_mode="floor")
                     - R_HALVES // 2, 0, h_r // ROWS_HALF - R_HALVES)
    return RectContext(maps=maps.contiguous(), row_int=row_int,
                       c0=torch.stack(c0s), k=torch.stack(ks),
                       rb=rb.to(torch.int32).contiguous())


def rect_rows(ctx: RectContext, r0: int, r1: int) -> RectContext:
    """The context of image rows [r0, r1) (r0 a multiple of 8, r1 too
    or the image's height): the per-pixel fields and the per-tile bases
    of those rows, the rect maps whole (the context itself for all
    rows).  A row band's lookups through it equal the whole context's at
    those rows."""
    if (r0, r1) == (0, ctx.row_int.shape[1]):
        return ctx
    return RectContext(
        maps=ctx.maps, row_int=ctx.row_int[:, r0:r1].contiguous(),
        c0=ctx.c0[:, r0:r1].contiguous(), k=ctx.k[:, r0:r1].contiguous(),
        rb=ctx.rb[:, r0 // ROWS_HALF:-(-r1 // ROWS_HALF)].contiguous())


def pack_depth_normals(nbr_depth: torch.Tensor,
                       nbr_normal: torch.Tensor) -> torch.Tensor:
    """(V, H, W) depth + (V, 3, H, W) normals -> (V, 2, H, W) words.

    Word 0 is the depth with n_z's sign folded into the float sign bit;
    word 1 holds (n_x, n_y) as a bf16 pair, n_x in the high half.  The
    pair is assembled by viewing two bf16 as one float32, which puts the
    second element in the high half on a little-endian machine (x86 and
    every CUDA device)."""
    w0 = torch.where(nbr_normal[:, 2] >= 0, -nbr_depth, nbr_depth)
    pair = torch.stack([nbr_normal[:, 1].to(torch.bfloat16),
                        nbr_normal[:, 0].to(torch.bfloat16)], dim=-1)
    w1 = pair.view(torch.float32)[..., 0]
    return torch.stack([w0, w1], dim=1)


def unpack_taps(taps: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_depth_normals on gathered taps (V, 2, ...):
    returns ((V, 4, ...) [depth, nx, ny, nz], valid (V, ...))."""
    w0 = taps[:, 0]
    w1 = taps[:, 1].contiguous()
    d1 = w0.abs()
    pair = w1[..., None].view(torch.bfloat16).to(torch.float32)
    nx = pair[..., 1]
    ny = pair[..., 0]
    nz_mag = torch.sqrt(torch.clamp_min(1.0 - nx * nx - ny * ny, 0.0))
    nz = torch.where(w0 >= 0, -nz_mag, nz_mag)
    return torch.stack([d1, nx, ny, nz], dim=1), d1 > 0.0


def _icol(ctx: RectContext, sigma: torch.Tensor) -> torch.Tensor:
    col = ctx.c0 + ctx.k * sigma.unsqueeze(-3)
    return torch.round(torch.clamp(col, -2.0 * _INVALID, 2.0 * _INVALID)
                       ).to(torch.int32)


def _col_bases(ctx: RectContext, icol: torch.Tensor) -> torch.Tensor:
    """256-col-aligned window base per (8, 128) tile: the tile's minimum
    in-frame column (out-of-frame columns and padding excluded)."""
    _, w_r = ctx.frame_shape
    icol_b = _to_blocks(icol, -_INVALID)
    cmin = torch.where((icol_b < 0) | (icol_b > w_r - 1), _INVALID,
                       icol_b).amin(dim=(-1, -2))
    return torch.clamp(torch.div(cmin, COLS_HALF, rounding_mode="floor"),
                       0, w_r // COLS_HALF - 2)


def rect_lookup_plain(ctx: RectContext, sigma: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C (the JAX package's rect_lookup_xla): every
    rect channel at (row(p), round(c0(p) + k(p) * sigma(p))) for all V
    views, 0 where the read misses its tile's band/window or the frame.
    ``sigma`` (H, W) -> (V, C, H, W), or K candidates' (K, H, W) -> (K, V,
    C, H, W), each candidate with its own column bases."""
    v, c, h_r, w_r = ctx.maps.shape
    _, h, w = ctx.row_int.shape
    lead = sigma.shape[:-2]
    icol = _icol(ctx, sigma)                             # ([K,] V, H, W)
    flat = icol.reshape(-1, h, w)          # candidates x views as "views"
    cb_full = _from_tiles(_col_bases(ctx, flat), h, w).reshape(icol.shape)
    rb_full = _from_tiles(ctx.rb, h, w)
    iwin = icol - cb_full * COLS_HALF
    roff = ctx.row_int - rb_full * ROWS_HALF
    ok = ((roff >= 0) & (roff < BAND_ROWS) & (iwin >= 0)
          & (iwin < WIN_COLS) & (icol >= 0) & (icol <= w_r - 1)
          & (ctx.row_int <= h_r - 1))
    rc = torch.clamp(ctx.row_int, 0, h_r - 1).to(torch.int64)
    cc = torch.clamp(icol, 0, w_r - 1).to(torch.int64)
    idx = (rc * w_r + cc).reshape(*lead, v, 1, h * w).expand(
        *lead, v, c, h * w)
    maps = ctx.maps.reshape(v, c, h_r * w_r).expand(*lead, v, c, h_r * w_r)
    taps = torch.gather(maps, -1, idx)
    return torch.where(ok.unsqueeze(-3), taps.reshape(*lead, v, c, h, w),
                       0.0)


def rect_lookup(ctx: RectContext, sigma: torch.Tensor) -> torch.Tensor:
    """Per-candidate lookup for inverse depth ``sigma`` (H, W) ->
    (V, C, H, W), or for K candidates at once, (K, H, W) -> (K, V, C, H,
    W).  Kernel C on CUDA (one launch either way), the plain version on
    the CPU."""
    if kernels.use_kernel(sigma):
        return kernels.rect_lookup(ctx.maps, ctx.row_int, ctx.c0, ctx.k,
                                   ctx.rb, sigma.contiguous())
    return rect_lookup_plain(ctx, sigma)


def rect_coverage(ctx: RectContext, sigma: torch.Tensor) -> torch.Tensor:
    """Share of in-frame lookups that land inside their tile's band and
    window (a diagnostic: near 1.0 for usual MVS pair geometry), as a 0-d
    float32 tensor."""
    _, h, w = ctx.row_int.shape
    h_r, w_r = ctx.frame_shape
    icol = _icol(ctx, sigma)
    cb_full = _from_tiles(_col_bases(ctx, icol), h, w)
    rb_full = _from_tiles(ctx.rb, h, w)
    in_frame = (ctx.row_int <= h_r - 1) & (icol >= 0) & (icol <= w_r - 1)
    iwin = icol - cb_full * COLS_HALF
    roff = ctx.row_int - rb_full * ROWS_HALF
    hit = ((roff >= 0) & (roff < BAND_ROWS) & (iwin >= 0)
           & (iwin < WIN_COLS))
    return ((hit & in_frame).sum() / torch.clamp_min(in_frame.sum(), 1)
            ).to(torch.float32)
