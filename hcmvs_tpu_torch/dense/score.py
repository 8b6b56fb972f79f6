"""PatchMatch cost terms, evaluated for every pixel at once (PyTorch port
of the main-path terms of ``hcmvs_tpu/dense/score.py``).

photometric phase:  score = score_ncc
geometric phase:    s = (1-para_tapa) * score_ncc + para_tapa * score_geo
                    s = (1-para_part) * s + para_part * score_gra
with para_tapa / para_part chosen per pixel from the texture-gradient
thresholds (ref: DepthMap.cpp:900-930), then min-mean aggregation over
views and, in the geometric phase where a prior map is attached, the
prior term (``prior_blend``).

Exact ZNCC is scored through the sigma tables (``ops/volume.py``), one
candidate at a time (kernel B) or, with ``candidate_kernel="on"``, all
propagation candidates in one multi-column lookup per view (kernel D);
with ``exact_backend="bilinear"`` it is scored directly, one bilinear
sample of each source per patch offset (``photometric_scores``).  The
warped mode scores against centre-warped sources (kernel E,
``ops/zncc_warped.py``), and "hybrid" takes it in the photometric phase
and exact scoring after.  The geo term and the view-spread candidates
read the neighbour maps through the rect engine (``ops/rect_gather.py``,
kernel C) or, with ``geo_backend="direct"``, by nearest gathers.  In the
port, "auto" resolves to the tables and the rect engine on every device
(with ``use_pallas=False``, to the direct paths, as the JAX package off
the TPU); the direct paths are plain PyTorch on every device.  The
tables' row order follows their build (``ops/volume.
use_rect_volume_build``: tile-major for the rect build, image order for
the per-plane one), and every consumer keys on the same gate.  Per-offset
sums are accumulated in the JAX package's order, so CPU results agree with
it to rounding.

Candidate axis (``batch_candidates``, the JAX package's ``vmap`` of the
cost): the terms that score a hypothesis take a depth field (..., H, W)
and normals (..., 3, H, W) with an optional leading axis of K candidates,
and return (..., V, H, W) per-view terms or (..., H, W) costs.  The axis
is written out, not mapped (kernels B, C and E sit behind ctypes): B
reads the K index fields as K * S columns of one table row, C and E take
the candidates as a grid axis, so a call for the whole stack launches
each kernel as often as a call for one hypothesis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense.types import (Rows, ViewGeometry, mat3_apply,
                                         mat3_apply_t, normalize3,
                                         pixel_grid)
from hcmvs_tpu_torch.ops.sampling import (bilinear_sample_xy,
                                          nearest_sample_planes_batched,
                                          pad_edge)

_SIGMA_COLOR = 0.2          # ref: DepthMap.h:538 GetWeight sigmaColor
_GRA_STRONG = 100.0         # ref: DepthMap.cpp:457 hardcoded texture split
_STRONG_HALFWIN = 5         # ref: DepthMap.cpp:458


def patch_offsets(cfg: DenseConfig) -> Tuple[Tuple[int, int], ...]:
    """Static (dy, dx) patch sample offsets covering the largest
    half-window; samples outside a pixel's adaptive window are masked."""
    hw = max(cfg.adapt_half_window, cfg.patch_half_window)
    r = range(-hw, hw + 1, cfg.patch_step)
    return tuple((dy, dx) for dy in r for dx in r)


def halfwin_map(gra: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """Per-pixel adaptive half-window: small for strong texture."""
    return torch.where(gra > _GRA_STRONG, float(_STRONG_HALFWIN),
                       float(cfg.adapt_half_window))


class RefPatchStats(NamedTuple):
    """Per-pixel weighted patch statistics of the reference image."""

    tm: torch.Tensor        # (H, W) weighted patch mean
    norm_sq0: torch.Tensor  # (H, W) weighted centred sum of squares
    sum_w: torch.Tensor     # (H, W) sum of bilateral weights
    ref_pad: torch.Tensor   # (H+2P, W+2P) edge-padded gray image
    wts: torch.Tensor       # (S, H, W) bilateral weights per offset


def _pad_of(offsets) -> int:
    return int(max(max(abs(dy), abs(dx)) for dy, dx in offsets))


def _shifted(x_pad: torch.Tensor, pad: int, dy: int, dx: int,
             h: int, w: int) -> torch.Tensor:
    """Static-offset window of a padded (..., H+2P, W+2P) array."""
    return x_pad[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _stacked_shifts(ref_pad: torch.Tensor, pad: int, offsets, h: int,
                    w: int) -> torch.Tensor:
    """(S, H, W) stack of the statically-shifted reference values."""
    return torch.stack([_shifted(ref_pad, pad, dy, dx, h, w)
                        for dy, dx in offsets])


def _weights_traced(v_c: torch.Tensor, v_d: torch.Tensor, dyf: float,
                    dxf: float, hw: torch.Tensor) -> torch.Tensor:
    """Bilateral patch weight (ref: DepthMap.h:536-549 GetWeight) with the
    adaptive-window mask folded in."""
    w_color = (v_d - v_c) ** 2 * (-1.0 / (2.0 * _SIGMA_COLOR ** 2))
    w_spatial = (dyf * dyf + dxf * dxf) / (-2.0 * hw * hw)
    in_win = max(abs(dyf), abs(dxf)) <= hw
    return torch.exp(w_color + w_spatial) * in_win


def ref_patch_stats(ref_gray: torch.Tensor, hw: torch.Tensor,
                    offsets) -> RefPatchStats:
    h, w = ref_gray.shape
    pad = _pad_of(offsets)
    ref_pad = pad_edge(ref_gray, pad)
    v_ds = _stacked_shifts(ref_pad, pad, offsets, h, w)
    wts = torch.stack([_weights_traced(ref_gray, v_ds[i], float(dy),
                                       float(dx), hw)
                       for i, (dy, dx) in enumerate(offsets)])
    sum_w = wts.sum(dim=0)
    tm = (wts * v_ds).sum(dim=0) / torch.clamp_min(sum_w, 1e-12)
    norm_sq0 = (wts * (v_ds - tm) ** 2).sum(dim=0)
    return RefPatchStats(tm=tm, norm_sq0=norm_sq0, sum_w=sum_w,
                         ref_pad=ref_pad, wts=wts)


def _bilinear_views(srcs: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bilinear_sample_xy`` of V images (V, H, W) at per-view coordinates
    (..., V, H', W') in one pass: each view's taps index its own image,
    with the same clamps and arithmetic."""
    v, h, w = srcs.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0c = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0c = torch.clamp(y0.to(torch.int64), 0, h - 2)
    voff = (torch.arange(v, device=srcs.device) * (h * w)).reshape(v, 1, 1)
    flat = srcs.reshape(-1)
    base = voff + y0c * w + x0c
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(valid, out, 0.0), valid


def _col(x: torch.Tensor) -> torch.Tensor:
    """(V,) -> (V, 1, 1), to broadcast a per-view scalar over planes."""
    return x[:, None, None]


def photometric_scores(geom: ViewGeometry, src_grays: torch.Tensor,
                       stats: RefPatchStats, hw: torch.Tensor,
                       depth: torch.Tensor, normal: torch.Tensor,
                       rays: torch.Tensor, offsets, cfg: DenseConfig,
                       rows: Optional[Rows] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct weighted ZNCC (``exact_backend="bilinear"``; ref:
    ScorePixelImage, DepthMap.cpp:522-595): every patch sample warped
    through the pixel's plane homography and sampled bilinearly, one
    sample of every view per offset.  Returns ``(scores, bad)``, both
    (V, H, W): ``1 - zncc`` in [0, 2], and the flat thRobust cost where
    the centre warp leaves the source or lies behind it, or the patch is
    textureless.  ``rows``: the fields are a row band of the image.  With
    a candidate axis (depth (K, H, W)) both are (K, V, H, W)."""
    h, w = depth.shape[-2:]
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    dev = depth.device
    # the plane terms broadcast over the view axis
    n_ray0, inv_dp, nk_x, nk_y = (t.unsqueeze(-3) for t in _plane_terms(
        geom, depth, normal, rays))
    v_, u_ = pixel_grid(h, w, dev, rows)
    ref_center = _shifted(stats.ref_pad, pad, 0, 0, h, w)
    A, wv = geom.A, geom.wv                           # (V, 3, 3), (V, 3)
    # the homogeneous warp of the pixel grid, each view's as a plane
    p0x = _col(A[:, 0, 0]) * u_ + _col(A[:, 0, 1]) * v_ + _col(A[:, 0, 2])
    p0y = _col(A[:, 1, 0]) * u_ + _col(A[:, 1, 1]) * v_ + _col(A[:, 1, 2])
    p0z = _col(A[:, 2, 0]) * u_ + _col(A[:, 2, 1]) * v_ + _col(A[:, 2, 2])
    zeros = torch.zeros(depth.shape[:-2] + (A.shape[0], h, w),
                        dtype=torch.float32, device=dev)
    num, s1, sq1, sw = zeros, zeros, zeros, zeros
    for dy, dx in offsets:
        dyf, dxf = float(dy), float(dx)
        v_d = _shifted(stats.ref_pad, pad, dy, dx, h, w)
        wt = _weights_traced(ref_center, v_d, dyf, dxf, hw)
        s = (n_ray0 + nk_x * dxf + nk_y * dyf) * inv_dp
        phx = p0x + _col(A[:, 0, 0]) * dxf + _col(A[:, 0, 1]) * dyf \
            + _col(wv[:, 0]) * s
        phy = p0y + _col(A[:, 1, 0]) * dxf + _col(A[:, 1, 1]) * dyf \
            + _col(wv[:, 1]) * s
        phz = p0z + _col(A[:, 2, 0]) * dxf + _col(A[:, 2, 1]) * dyf \
            + _col(wv[:, 2]) * s
        inv_z = 1.0 / torch.where(phz.abs() < 1e-9, 1e-9, phz)
        v1, valid = _bilinear_views(src_grays, phx * inv_z, phy * inv_z)
        wt = wt * valid
        num = num + wt * (v_d - stats.tm) * v1
        s1 = s1 + wt * v1
        sq1 = sq1 + wt * v1 * v1
        sw = sw + wt
    var1 = sq1 - s1 * s1 / torch.clamp_min(sw, 1e-12)
    denom = torch.sqrt(torch.clamp_min(stats.norm_sq0 * var1, 1e-16))
    score = 1.0 - torch.clamp(num / denom, -1.0, 1.0)
    # centre visibility: the centre warp must land in the source, in front
    s_c = n_ray0 * inv_dp
    cx = p0x + _col(wv[:, 0]) * s_c
    cy = p0y + _col(wv[:, 1]) * s_c
    cz = p0z + _col(wv[:, 2]) * s_c
    inv_cz = 1.0 / torch.where(cz.abs() < 1e-9, 1e-9, cz)
    ucx = cx * inv_cz
    ucy = cy * inv_cz
    hs, ws = src_grays.shape[1:]
    oob = ((ucx < 0) | (ucx > ws - 1) | (ucy < 0) | (ucy > hs - 1)
           | (cz <= 0))
    bad = (oob | (var1 <= 1e-12)
           | (stats.norm_sq0 <= cfg.min_patch_variance ** 2))
    return torch.where(bad, th_robust, score), bad


class WarpedInputs(NamedTuple):
    """Kernel E's arguments (``ops/zncc_warped.zncc_warped``) for one
    hypothesis field, or a stack of K (each per-view field then has the
    leading K axis), and the centre warp's out-of-bounds mask."""

    ref_pad: torch.Tensor     # (H+2P, W+2P) edge-padded reference
    tm: torch.Tensor          # (H, W)
    nsq0: torch.Tensor        # (H, W)
    warped_pad: torch.Tensor  # ([K,] V, H+2P, W+2P) edge-padded warped
                              # sources
    valid_pad: torch.Tensor   # ([K,] V, H+2P, W+2P) centre-warp validity,
                              # 0-padded
    hw: torch.Tensor          # (H, W)
    acc: torch.Tensor         # ([K,] V, 4, H, W) exactly warped corner sums
    scan_offsets: tuple       # the offsets read from the warped images
    pad: int
    oob: torch.Tensor         # ([K,] V, H, W) centre warp off-image or
                              # behind


def warped_inputs(geom: ViewGeometry, src_grays: torch.Tensor,
                  stats: RefPatchStats, hw: torch.Tensor,
                  depth: torch.Tensor, normal: torch.Tensor,
                  rays: torch.Tensor, offsets,
                  rows: Optional[Rows] = None) -> WarpedInputs:
    """Everything of warped scoring up to kernel E: each source sampled
    once per pixel at the hypothesis' warp centre, and the window corners
    (|dy| = |dx| = pad) warped exactly through the pixel's own plane (the
    centre warp alone is normal-independent) into the starting sums.
    ``rows``: the fields are a row band of the image (the warped sources
    are then padded at the band's edges, which only the band's outer
    ``pad`` rows read).  With a candidate axis (depth (K, H, W)) every
    per-view field has it too."""
    h, w = depth.shape[-2:]
    pad = _pad_of(offsets)
    dev = depth.device
    n_ray0, inv_dp, nk_x, nk_y = _plane_terms(geom, depth, normal, rays)
    v_, u_ = pixel_grid(h, w, dev, rows)
    ref_center = _shifted(stats.ref_pad, pad, 0, 0, h, w)
    corner_offsets = tuple((dy, dx) for dy, dx in offsets
                           if abs(dy) == pad and abs(dx) == pad)
    scan_offsets = tuple(o for o in offsets if o not in corner_offsets)
    s_c = n_ray0 * inv_dp

    warped, valid, oob, acc = [], [], [], []
    for vi in range(src_grays.shape[0]):
        A, wvec, src = geom.A[vi], geom.wv[vi], src_grays[vi]
        # centre warp: one bilinear sample per pixel
        phx = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2] + wvec[0] * s_c
        phy = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2] + wvec[1] * s_c
        phz = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2] + wvec[2] * s_c
        inv_z = 1.0 / torch.where(phz.abs() < 1e-9, 1e-9, phz)
        wv_c, ok_c = bilinear_sample_xy(src, phx * inv_z, phy * inv_z)
        warped.append(wv_c)
        valid.append(ok_c)
        oob.append(~ok_c | (phz <= 0))
        # corners warped exactly
        zeros = torch.zeros_like(depth)
        num, s1, sq1, sw = zeros, zeros, zeros, zeros
        for dy, dx in corner_offsets:
            v_d = _shifted(stats.ref_pad, pad, dy, dx, h, w)
            wt = _weights_traced(ref_center, v_d, float(dy), float(dx), hw)
            s = (n_ray0 + nk_x * dx + nk_y * dy) * inv_dp
            qx = A[0, 0] * (u_ + dx) + A[0, 1] * (v_ + dy) + A[0, 2] \
                + wvec[0] * s
            qy = A[1, 0] * (u_ + dx) + A[1, 1] * (v_ + dy) + A[1, 2] \
                + wvec[1] * s
            qz = A[2, 0] * (u_ + dx) + A[2, 1] * (v_ + dy) + A[2, 2] \
                + wvec[2] * s
            inv_qz = 1.0 / torch.where(qz.abs() < 1e-9, 1e-9, qz)
            v1, ok = bilinear_sample_xy(src, qx * inv_qz, qy * inv_qz)
            wt = wt * ok
            num = num + wt * (v_d - stats.tm) * v1
            s1 = s1 + wt * v1
            sq1 = sq1 + wt * v1 * v1
            sw = sw + wt
        acc.append(torch.stack([num, s1, sq1, sw], dim=-3))
    warped_pad = pad_edge(torch.stack(warped, dim=-3), pad)
    valid_pad = torch.nn.functional.pad(
        torch.stack(valid, dim=-3).to(torch.float32), (pad, pad, pad, pad))
    return WarpedInputs(
        ref_pad=stats.ref_pad.contiguous(), tm=stats.tm.contiguous(),
        nsq0=stats.norm_sq0.contiguous(), warped_pad=warped_pad,
        valid_pad=valid_pad, hw=hw.contiguous(),
        acc=torch.stack(acc, dim=-4), scan_offsets=scan_offsets, pad=pad,
        oob=torch.stack(oob, dim=-3))


def photometric_scores_warped(geom: ViewGeometry, src_grays: torch.Tensor,
                              stats: RefPatchStats, hw: torch.Tensor,
                              depth: torch.Tensor, normal: torch.Tensor,
                              rays: torch.Tensor, offsets, cfg: DenseConfig,
                              rows: Optional[Rows] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warped-image weighted ZNCC: each source is sampled once per pixel
    at the warp centre and the patch read from that image at static
    offsets (exact only where neighbouring pixels carry the same plane;
    the window corners are warped exactly).  Returns ``(scores, bad)``,
    both ([K,] V, H, W), as ``photometric_scores_volume``; one launch of
    kernel E (per ten views) for any K."""
    from hcmvs_tpu_torch.ops.zncc_warped import zncc_warped
    x = warped_inputs(geom, src_grays, stats, hw, depth, normal, rays,
                      offsets, rows)
    score, var1 = zncc_warped(x.ref_pad, x.tm, x.nsq0, x.warped_pad,
                              x.valid_pad, x.hw, x.acc, x.scan_offsets,
                              x.pad)
    bad = (x.oob | (var1 <= 1e-12)
           | (stats.norm_sq0 <= cfg.min_patch_variance ** 2)[None])
    return torch.where(bad, cfg.ncc_threshold_keep * 1.2, score), bad


def _table_rows(x: torch.Tensor, blocked: bool) -> torch.Tensor:
    """(..., H, W) -> (..., P_used): a field in the tables' row order,
    tile-major for the rect build (``blocked``), the image's for the
    per-plane build."""
    from hcmvs_tpu_torch.ops.volume import to_volume_order
    if blocked:
        return to_volume_order(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _table_rows_multi(x: torch.Tensor, blocked: bool) -> torch.Tensor:
    """(C, H, W) -> (P_used, C) in the tables' row order."""
    from hcmvs_tpu_torch.ops.volume import to_volume_order_multi
    if blocked:
        return to_volume_order_multi(x)
    return x.reshape(x.shape[0], -1).T.contiguous()


def _image_of_rows(x: torch.Tensor, h: int, w: int,
                   blocked: bool) -> torch.Tensor:
    """(P_pad, C) lookup output in the tables' row order -> (C, H, W)."""
    from hcmvs_tpu_torch.ops.volume import (from_volume_order_multi,
                                            padded_hw)
    if blocked:
        h8, w128 = padded_hw(h, w)
        return from_volume_order_multi(x[:h8 * w128], h, w)
    return x[:h * w].T.reshape(x.shape[1], h, w)


def packed_lookup(vol) -> bool:
    """Whether kernel D reads ``vol``'s tables through packed u16 index
    fields and bounds panels (the JAX package's TPU route): their 1/64
    steps address at most ``MAX_PACKED_PLANES`` (1024) planes.  Deeper
    tables take f32 fields, as the JAX package off the TPU."""
    from hcmvs_tpu_torch.ops.volume import MAX_PACKED_PLANES
    return vol.tab.shape[-1] <= MAX_PACKED_PLANES


def _check_packed(vol) -> None:
    if not packed_lookup(vol):
        raise ValueError(f"{vol.tab.shape[-1]} sigma planes: packed u16 "
                         "index fields address at most 1024")


def volume_bounds(vol, blocked: bool = True) -> torch.Tensor:
    """Per-view bounds panels (V, P_pad, 128) u16 of kernel D's bounded
    mode: each table row's valid-sigma interval on the packed index scale
    (lo replicated in lanes 0..63, hi in 64..127), rows in the tables'
    order (tile-major when ``blocked``, the image's otherwise).  Depends
    only on the stage's tables, so it is built once per sweep call.
    Raises past ``packed_lookup``'s depth."""
    from hcmvs_tpu_torch.ops.volume import F_PACK_SCALE
    _check_packed(vol)
    p_pad, d_planes = vol.tab.shape[-2], vol.tab.shape[-1]
    out = []
    for vi in range(vol.tab.shape[0]):
        lo_idx = (vol.sig_lo[vi] - vol.sig0[vi]) * vol.inv_dsig[vi]
        hi_idx = (vol.sig_hi[vi] - vol.sig0[vi]) * vol.inv_dsig[vi]
        lo_e = torch.ceil(torch.clamp(lo_idx * F_PACK_SCALE, 0.0, 65535.0))
        hi_e = torch.floor(torch.clamp(
            torch.clamp_max(hi_idx, d_planes - 1.0) * F_PACK_SCALE,
            0.0, 65534.0))
        # intervals entirely outside the grid stay empty after the clips
        lo_e = torch.where((hi_idx < 0.0) | (lo_idx > 1023.0), 65535.0,
                           lo_e)
        lo_hi = torch.stack([_table_rows(lo_e, blocked),
                             _table_rows(hi_e, blocked)], dim=1)  # (P_used, 2)
        lo_hi = torch.nn.functional.pad(
            lo_hi, (0, 0, 0, p_pad - lo_hi.shape[0]))
        out.append(lo_hi[:, :, None].expand(p_pad, 2, 64)
                   .reshape(p_pad, 128).to(torch.uint16))
    return torch.stack(out)


def packed_fields(geom: ViewGeometry, vol, depths: torch.Tensor,
                  normals: torch.Tensor, rays: torch.Tensor, offsets,
                  blocked: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's index field for K hypotheses: (P_pad, K * S) u16 in the
    tables' row order (``blocked``: tile-major), column k * S + j holding
    the packed sigma index (``F_PACK_SCALE`` steps) of candidate k's sample
    j, and the sentinel 0xFFFF beyond the table's D planes; plus the
    (K, H, W) centre sigmas.  Raises past ``packed_lookup``'s depth."""
    from hcmvs_tpu_torch.ops.volume import F_PACK_SCALE
    _check_packed(vol)
    sig0, inv_dsig = vol.sig0[0], vol.inv_dsig[0]
    d_planes = vol.tab.shape[-1]
    enc, s_cs = [], []
    for k in range(depths.shape[0]):
        s_c, fwd = _sample_sigmas(geom, depths[k], normals[k], rays, offsets)
        f = (fwd - sig0) * inv_dsig
        in_grid = (f >= 0.0) & (f <= d_planes - 1.0)
        enc.append(torch.where(in_grid, torch.round(f * F_PACK_SCALE),
                               65535.0).to(torch.int32).to(torch.int16))
        s_cs.append(s_c)
    f2 = _table_rows_multi(torch.cat(enc), blocked)      # (P_used, C)
    f2 = torch.nn.functional.pad(f2, (0, 0, 0, vol.tab.shape[1]
                                      - f2.shape[0]))
    return f2.view(torch.uint16), torch.stack(s_cs)


def photometric_scores_volume_batched(geom: ViewGeometry, vol,
                                      stats: RefPatchStats, hw: torch.Tensor,
                                      depths: torch.Tensor,
                                      normals: torch.Tensor,
                                      rays: torch.Tensor, offsets,
                                      cfg: DenseConfig, bounds_all=None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact table scoring of K hypotheses at once: all K x S index
    columns of a pixel ride one multi-column lookup per view (kernel D),
    so each table row is read once per view instead of once per candidate.

    This is the JAX package's packed TPU route, taken on every device:
    u16 index fields, bounded lookups whose 0xFFFF sentinel doubles as the
    validity mask, bf16-rounded bilateral weights, and a per-candidate
    accumulation straight off the sentinel panel.  Tables deeper than the
    packed fields address (``packed_lookup``) take the JAX package's route
    off the TPU instead (``_scores_batched_f32``).  ``depths`` (K, H, W),
    ``normals`` (K, 3, H, W); ``bounds_all`` from ``volume_bounds`` (built
    here when None).  The tables' row order follows ``cfg``'s build gate
    (any D the table has).  Returns (scores, bad), both (K, V, H, W).
    """
    from hcmvs_tpu_torch.ops.volume import (u16_as_int32,
                                            use_rect_volume_build,
                                            volume_lookup_multi)
    k_n, h, w = depths.shape
    blocked = use_rect_volume_build(cfg, h, w)
    if not packed_lookup(vol):
        return _scores_batched_f32(geom, vol, stats, depths, normals, rays,
                                   offsets, cfg, blocked)
    pad = _pad_of(offsets)
    s_count = len(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    f2, s_c_all = packed_fields(geom, vol, depths, normals, rays, offsets,
                                blocked)
    if bounds_all is None:
        bounds_all = volume_bounds(vol, blocked)
    v_ds = _stacked_shifts(stats.ref_pad, pad, offsets, h, w)
    # the weight panels are rounded to bf16 as on the TPU route (ZNCC is
    # scale-invariant and the weights are smooth Gaussian factors)
    wts_r = stats.wts.to(torch.bfloat16).to(torch.float32)
    coef_r = (stats.wts * (v_ds - stats.tm[None])).to(
        torch.bfloat16).to(torch.float32)
    min_var_bad = stats.norm_sq0 <= cfg.min_patch_variance ** 2

    # one view's (P, C) panel is live at a time, one candidate's samples
    # are decoded at a time
    scores, bads = [], []
    for vi in range(vol.tab.shape[0]):
        lo_v, hi_v = vol.sig_lo[vi], vol.sig_hi[vi]
        out2 = volume_lookup_multi(vol.tab[vi], f2, bounds_all[vi])
        v3 = _image_of_rows(out2.view(torch.int16), h, w,
                            blocked)                     # (C, H, W)
        s_v, b_v = [], []
        for k in range(k_n):
            vp = torch.nn.functional.pad(
                u16_as_int32(v3[k * s_count:(k + 1) * s_count]),
                (pad, pad, pad, pad), value=65535)
            zeros = torch.zeros_like(hw)
            num, s1, sq1, sw = zeros, zeros, zeros, zeros
            for j, (dy, dx) in enumerate(offsets):
                vs = _shifted(vp[j], pad, dy, dx, h, w)
                ok = (vs < 65535).to(torch.float32)
                v1 = vs.to(torch.float32) * (1.0 / 65535.0)
                w_ok = wts_r[j] * ok
                num = num + coef_r[j] * ok * v1
                s1 = s1 + w_ok * v1
                sq1 = sq1 + w_ok * v1 * v1
                sw = sw + w_ok
            var1 = sq1 - s1 * s1 / torch.clamp_min(sw, 1e-12)
            denom = torch.sqrt(torch.clamp_min(stats.norm_sq0 * var1,
                                               1e-16))
            score = 1.0 - torch.clamp(num / denom, -1.0, 1.0)
            oob = (s_c_all[k] < lo_v) | (s_c_all[k] > hi_v)
            bad = oob | (var1 <= 1e-12) | min_var_bad
            s_v.append(torch.where(bad, th_robust, score))
            b_v.append(bad)
        scores.append(torch.stack(s_v))
        bads.append(torch.stack(b_v))
    return torch.stack(scores, dim=1), torch.stack(bads, dim=1)


def _scores_batched_f32(geom: ViewGeometry, vol, stats: RefPatchStats,
                        depths: torch.Tensor, normals: torch.Tensor,
                        rays: torch.Tensor, offsets, cfg: DenseConfig,
                        blocked: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``photometric_scores_volume_batched`` on f32 index fields (kernel
    D's f32 mode) with validity from the sigma intervals and full-precision
    weights: the JAX package's route off the TPU, which takes any D."""
    from hcmvs_tpu_torch.ops.volume import volume_lookup_multi
    k_n, h, w = depths.shape
    s_count = len(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    sig0 = vol.sig0[0]
    sig_hi_grid = sig0 + (vol.tab.shape[-1] - 1) / vol.inv_dsig[0]
    s_cs, fwds = zip(*(_sample_sigmas(geom, depths[k], normals[k], rays,
                                      offsets) for k in range(k_n)))
    s_c_all, fwd = torch.stack(s_cs), torch.stack(fwds)  # (K, S, H, W)
    f2 = _table_rows_multi(((fwd - sig0) * vol.inv_dsig[0]).reshape(
        k_n * s_count, h, w), blocked)
    f2 = torch.nn.functional.pad(f2, (0, 0, 0, vol.tab.shape[1]
                                      - f2.shape[0]))
    in_grid = (fwd >= sig0) & (fwd <= sig_hi_grid)
    v_ds = _stacked_shifts(stats.ref_pad, _pad_of(offsets), offsets, h, w)
    coef = stats.wts * (v_ds - stats.tm[None])
    min_var_bad = stats.norm_sq0 <= cfg.min_patch_variance ** 2

    scores, bads = [], []
    for vi in range(vol.tab.shape[0]):
        lo_v, hi_v = vol.sig_lo[vi], vol.sig_hi[vi]
        v3 = _image_of_rows(volume_lookup_multi(vol.tab[vi], f2), h, w,
                            blocked).reshape(k_n, s_count, h, w)
        ok3 = (fwd >= lo_v) & (fwd <= hi_v) & in_grid
        s_v, b_v = zip(*(_zncc_of_samples(v3[k], ok3[k], s_c_all[k], lo_v,
                                          hi_v, stats, coef, offsets,
                                          th_robust, min_var_bad)
                         for k in range(k_n)))
        scores.append(torch.stack(s_v))
        bads.append(torch.stack(b_v))
    return torch.stack(scores, dim=1), torch.stack(bads, dim=1)


def use_volume_tables(cfg: DenseConfig) -> bool:
    """Whether exact scoring reads the sigma tables ("exact" in every
    phase, "hybrid" in the geometric ones; "warped" never, and no tables
    are built for it): ``exact_backend`` "volume", or "auto" (tables on
    every device in the port, unless ``use_pallas=False``); "bilinear"
    scores directly."""
    if cfg.score_mode not in ("exact", "hybrid", "warped"):
        raise ValueError(f"unknown score_mode {cfg.score_mode!r}")
    if cfg.exact_backend not in ("auto", "volume", "bilinear"):
        raise ValueError(f"unknown exact_backend {cfg.exact_backend!r}")
    if cfg.score_mode == "warped" or cfg.exact_backend == "bilinear":
        return False
    return cfg.exact_backend == "volume" or bool(cfg.use_pallas)


def exact_scoring(cfg: DenseConfig, phase: int) -> bool:
    """Whether ``phase`` scores exactly through the tables ("exact", and
    "hybrid" from the geometric phase on) rather than warped."""
    return cfg.score_mode == "exact" or (cfg.score_mode == "hybrid"
                                         and phase >= 1)


def use_candidate_batch(cfg: DenseConfig) -> bool:
    """Whether propagation candidates are scored together through kernel
    D (``photometric_scores_volume_batched``); "auto" resolves off, as in
    the JAX package."""
    return cfg.candidate_kernel == "on"


def use_rect_backend(cfg: DenseConfig, h: int, w: int) -> bool:
    """Whether neighbour-map lookups (the geo term, view spread) use the
    rect engine: ``geo_backend`` "rect", or "auto" (every device in the
    port, unless ``use_pallas=False``); "direct" gathers nearest samples
    of the neighbour maps."""
    del h, w
    if cfg.geo_backend not in ("auto", "rect", "direct"):
        raise ValueError(f"unknown geo_backend {cfg.geo_backend!r}")
    if cfg.geo_backend == "direct":
        return False
    return cfg.geo_backend == "rect" or bool(cfg.use_pallas)


def _plane_terms(geom: ViewGeometry, depth: torch.Tensor,
                 normal: torch.Tensor, rays: torch.Tensor):
    """(n_ray0, inv_dp, nk_x, nk_y) of the per-pixel plane hypotheses:
    a sample at offset (dy, dx) lies at the epipolar parameter
    ``s = (n_ray0 + nk_x*dx + nk_y*dy) * inv_dp``, the same for every
    view.  Any leading candidate axis is kept."""
    nx, ny, nz = normal.unbind(-3)
    n_ray0 = nx * rays[0] + ny * rays[1] + nz * rays[2]
    d_plane = n_ray0 * depth
    inv_dp = 1.0 / torch.where(d_plane.abs() < 1e-12, 1e-12, d_plane)
    Ki = geom.K_inv_ref
    nk_x = nx * Ki[0, 0] + ny * Ki[1, 0] + nz * Ki[2, 0]
    nk_y = nx * Ki[0, 1] + ny * Ki[1, 1] + nz * Ki[2, 1]
    return n_ray0, inv_dp, nk_x, nk_y


def _sample_sigmas(geom: ViewGeometry, depth: torch.Tensor,
                   normal: torch.Tensor, rays: torch.Tensor, offsets
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hypothesis' epipolar parameter at the centre, s_c ([K,] H, W),
    and its forward-shifted sample fields ([K,] S, H, W): row q of field k
    holds s(q - delta_k), so a table lookup lands on the row of the SAMPLE
    pixel q = p + delta."""
    h, w = depth.shape[-2:]
    pad = _pad_of(offsets)
    n_ray0, inv_dp, nk_x, nk_y = _plane_terms(geom, depth, normal, rays)
    s_c = n_ray0 * inv_dp
    s_cp = pad_edge(s_c, pad)
    gxp = pad_edge(nk_x * inv_dp, pad)
    gyp = pad_edge(nk_y * inv_dp, pad)
    fwd = torch.stack([
        _shifted(s_cp, pad, -dy, -dx, h, w)
        + _shifted(gxp, pad, -dy, -dx, h, w) * dx
        + _shifted(gyp, pad, -dy, -dx, h, w) * dy
        for dy, dx in offsets], dim=-3)
    return s_c, fwd


def volume_fields(geom: ViewGeometry, vol, depth: torch.Tensor,
                  normal: torch.Tensor, rays: torch.Tensor, offsets,
                  blocked: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s_c, fwd, f2): ``_sample_sigmas``'s centre parameter ([K,] H, W)
    and sample fields ([K,] S, H, W), and kernel B's index field (P_pad,
    S), or (P_pad, K * S) with column k * S + j candidate k's sample j:
    the sample fields as fractional indices of the sigma grid (shared
    across views), in the tables' row order (``blocked``: the rect build's
    tile-major order; else the image's), zero rows past the image."""
    s_c, fwd = _sample_sigmas(geom, depth, normal, rays, offsets)
    f_flat = _table_rows((fwd - vol.sig0[0]) * vol.inv_dsig[0], blocked)
    f_flat = f_flat.reshape(-1, f_flat.shape[-1])
    f2 = torch.nn.functional.pad(
        f_flat.T, (0, 0, 0, vol.tab.shape[1] - f_flat.shape[1]))
    return s_c, fwd, f2.contiguous()


def photometric_scores_volume(geom: ViewGeometry, vol, stats: RefPatchStats,
                              hw: torch.Tensor, depth: torch.Tensor,
                              normal: torch.Tensor, rays: torch.Tensor,
                              offsets, cfg: DenseConfig
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact plane-homography weighted ZNCC per source view through the
    sigma tables (ref: ScorePixelImage, DepthMap.cpp:522-595).

    The epipolar parameter of sample p + delta,
    ``s = (n_ray0 + nk_x*dx + nk_y*dy) * inv_dp``, is view-independent, so
    one (S, H, W) index field feeds every view's table lookup; validity is
    the analytic valid-sigma interval.  Returns ``(scores, bad)``, both
    (V, H, W): ``1 - zncc`` in [0, 2], with the flat thRobust cost where
    ``bad``.  The tables' row order (and D, read from the table) follow
    ``cfg``'s build gate.  K candidates (depth (K, H, W)) give (K, V, H,
    W), their K * S index columns read in one lookup per view.
    """
    from hcmvs_tpu_torch.ops.volume import (use_rect_volume_build,
                                            volume_lookup)
    h, w = depth.shape[-2:]
    blocked = use_rect_volume_build(cfg, h, w)
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    s_c, fwd, f2 = volume_fields(geom, vol, depth, normal, rays, offsets,
                                 blocked)
    sig0 = vol.sig0[0]
    sig_hi_grid = sig0 + (vol.tab.shape[2] - 1) / vol.inv_dsig[0]

    # candidate-independent numerator weights; ok in {0, 1} multiplies
    # them exactly, so this is the JAX package's per-offset product
    v_ds = _stacked_shifts(stats.ref_pad, pad, offsets, h, w)
    coef = stats.wts * (v_ds - stats.tm)
    in_grid = (fwd >= sig0) & (fwd <= sig_hi_grid)
    min_var_bad = stats.norm_sq0 <= cfg.min_patch_variance ** 2

    scores, bads = [], []
    for vi in range(vol.tab.shape[0]):
        lo_v, hi_v = vol.sig_lo[vi], vol.sig_hi[vi]
        out2 = volume_lookup(vol.tab[vi], f2)
        v3 = _image_of_rows(out2, h, w, blocked).reshape(
            fwd.shape)                                   # ([K,] S, H, W)
        # validity: the in-image sigma interval AND the grid's own range
        ok3 = (fwd >= lo_v) & (fwd <= hi_v) & in_grid
        score, bad = _zncc_of_samples(v3, ok3, s_c, lo_v, hi_v, stats, coef,
                                      offsets, th_robust, min_var_bad)
        scores.append(score)
        bads.append(bad)
    return torch.stack(scores, dim=-3), torch.stack(bads, dim=-3)


def _zncc_of_samples(v3: torch.Tensor, ok3: torch.Tensor, s_c: torch.Tensor,
                     lo_v: torch.Tensor, hi_v: torch.Tensor,
                     stats: RefPatchStats, coef: torch.Tensor, offsets,
                     th_robust: float, min_var_bad: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hypothesis' (score, bad) in one view, both (H, W), from its
    looked-up samples ``v3`` (S, H, W) f32 and their validity ``ok3``
    (S, H, W) bool in the fields' forward-shifted rows; ``coef`` the
    numerator weights wts * (v_d - tm).  K hypotheses: ``v3``, ``ok3``
    (K, S, H, W), ``s_c`` (K, H, W) -> (K, H, W)."""
    h, w = s_c.shape[-2:]
    pad = _pad_of(offsets)
    # consumption shift: centre p reads sample row p + delta (zero
    # validity where the sample pixel falls off the image)
    v3p = torch.nn.functional.pad(v3, (pad, pad, pad, pad))
    ok3p = torch.nn.functional.pad(ok3.to(torch.float32),
                                   (pad, pad, pad, pad))
    zeros = torch.zeros_like(s_c)
    num, s1, sq1, sw = zeros, zeros, zeros, zeros
    for k, (dy, dx) in enumerate(offsets):
        v1 = _shifted(v3p[..., k, :, :], pad, dy, dx, h, w)
        ok = _shifted(ok3p[..., k, :, :], pad, dy, dx, h, w)
        wt = stats.wts[k] * ok
        num = num + coef[k] * ok * v1
        s1 = s1 + wt * v1
        sq1 = sq1 + wt * v1 * v1
        sw = sw + wt
    var1 = sq1 - s1 * s1 / torch.clamp_min(sw, 1e-12)
    denom = torch.sqrt(torch.clamp_min(stats.norm_sq0 * var1, 1e-16))
    ncc = torch.clamp(num / denom, -1.0, 1.0)
    score = 1.0 - ncc
    # centre visibility: the hypothesis must lie in the interval at p
    oob = (s_c < lo_v) | (s_c > hi_v)
    bad = oob | (var1 <= 1e-12) | min_var_bad
    return torch.where(bad, th_robust, score), bad


def score_photometric(geom: ViewGeometry, src_grays: torch.Tensor,
                      stats: RefPatchStats, hw: torch.Tensor,
                      depth: torch.Tensor, normal: torch.Tensor,
                      rays: torch.Tensor, offsets, cfg: DenseConfig,
                      phase: int = 1, vol=None,
                      rows: Optional[Rows] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on cfg.score_mode, as the JAX package: exact scoring
    through the sigma tables where they are attached, direct bilinear
    scoring where the config routes exact scoring there, or the warped
    approximation ("warped", and "hybrid" in the photometric phase).
    Tables the config asks for but the caller did not attach raise.
    ``rows``: the fields (and ``vol``'s rows) are a row band of the
    image."""
    tables = use_volume_tables(cfg)
    if not exact_scoring(cfg, phase):
        return photometric_scores_warped(geom, src_grays, stats, hw, depth,
                                         normal, rays, offsets, cfg, rows)
    if vol is not None:
        return photometric_scores_volume(geom, vol, stats, hw, depth,
                                         normal, rays, offsets, cfg)
    if tables:
        raise ValueError("exact scoring needs the sigma tables "
                         "(scene_driver.attach_volumes)")
    return photometric_scores(geom, src_grays, stats, hw, depth, normal,
                              rays, offsets, cfg, rows)


def aggregate_scores(scores: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """Min-mean aggregation over views (ref: ScorePixel
    DENSE_AGGNCC_MINMEAN, DepthMap.cpp:1015-1032): mean of the best two
    view scores, dropping the second if beyond thRobust.  ``scores``
    ([K,] V, H, W) -> ([K,] H, W)."""
    th_robust = cfg.ncc_threshold_keep * 1.2
    if scores.shape[-3] <= 2:
        return scores.amin(dim=-3)
    # the two smallest values over views (what top-k of the negated scores
    # gives); torch.topk along the short leading axis measured 2.8 ms per
    # call at 1280x960 on the H100, this form a few elementwise passes
    best0, k0 = scores.min(dim=-3)
    views = torch.arange(scores.shape[-3], device=scores.device)
    best1 = torch.where(views[:, None, None] == k0.unsqueeze(-3),
                        float("inf"), scores).amin(dim=-3)
    use1 = best1 < th_robust
    total = best0 + torch.where(use1, best1, 0.0)
    return total / (1.0 + use1.to(torch.float32))


def flow_score(geom: ViewGeometry, depth: torch.Tensor, rays: torch.Tensor,
               flow: torch.Tensor, view_idx: int = 0,
               rows: Optional[Rows] = None) -> torch.Tensor:
    """Optical-flow cross-consistency against the best neighbour: (H, W)
    in [0, 2] (ref: DepthMap.cpp:741-792; applied to idxView==1 only).

    Compares the hypothesis' motion vector (its projection into the
    neighbour minus the pixel) with the dense flow ``flow`` (2, H, W),
    scoring direction and length agreement.  ``rows``: the fields are a
    row band of the image.  A depth stack (K, H, W) gives (K, H, W)."""
    w = depth.shape[-1]
    h = depth.shape[-2] if rows is None else rows.height
    v_, u_ = pixel_grid(depth.shape[-2], w, depth.device, rows)
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)
    X1 = mat3_apply(geom.R_rel[view_idx], X0)
    t = geom.t_rel[view_idx]
    X1 = (X1[0] + t[0], X1[1] + t[1], X1[2] + t[2])
    p1 = mat3_apply(geom.K_src[view_idx], X1)
    z1 = p1[2]
    inv_z1 = 1.0 / torch.where(z1.abs() < 1e-9, 1e-9, z1)
    u1 = p1[0] * inv_z1
    v1c = p1[1] * inv_z1
    mvx = u1 - u_
    mvy = v1c - v_
    fvx, fvy = flow[0], flow[1]
    n_mv = torch.hypot(mvx, mvy)
    n_fv = torch.hypot(fvx, fvy)
    max_dist = math.hypot(w / 2, h / 2)
    cos = (mvx * fvx + mvy * fvy) / torch.clamp_min(n_mv * n_fv, 1e-9)
    ratio = torch.minimum(n_mv, n_fv) / torch.clamp_min(
        torch.maximum(n_mv, n_fv), 1e-9)
    score = (1.0 - cos.abs()) + (1.0 - ratio)
    score = torch.where(n_mv >= max_dist, 2.0, score)
    score = torch.where((n_mv < 1e-6) & (n_fv >= 1e-6), 1.0, score)
    score = torch.where((n_mv >= 1e-6) & (n_fv < 1e-6), 0.0, score)
    score = torch.where((n_mv < 1e-6) & (n_fv < 1e-6), 0.0, score)
    oob = (u1 < 0) | (u1 > w - 1) | (v1c < 0) | (v1c > h - 1) | (z1 <= 0)
    return torch.where(oob, 1.0, torch.clamp(score, 0.0, 2.0))


def _rect_taps(rect, depth: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([K,] V, 4, H, W) neighbour (depth, normal) samples at each pixel's
    forward projection, via the rect engine (one lookup for all K
    candidates); valid = depth tap > 0."""
    from hcmvs_tpu_torch.ops.rect_gather import rect_lookup, unpack_taps
    sigma = 1.0 / torch.clamp_min(depth, 1e-9)
    taps = rect_lookup(rect, sigma)                      # ([K,] V, 2, H, W)
    lead = taps.shape[:-3]
    out, ok = unpack_taps(taps.reshape(-1, *taps.shape[-3:]))
    return (out.reshape(*lead, *out.shape[1:]),
            ok.reshape(*lead, *ok.shape[1:]))


def _forward_projections(geom: ViewGeometry, depth: torch.Tensor,
                         rays: torch.Tensor):
    """Each pixel projected into every neighbour with the hypothesis
    depth: [(u1, v1, z1)] per view, ([K,] H, W) each."""
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)
    out = []
    for vi in range(geom.R_rel.shape[0]):
        t_rel = geom.t_rel[vi]
        X1 = mat3_apply(geom.R_rel[vi], X0)
        X1 = (X1[0] + t_rel[0], X1[1] + t_rel[1], X1[2] + t_rel[2])
        p1 = mat3_apply(geom.K_src[vi], X1)
        z1 = p1[2]
        inv_z1 = 1.0 / torch.where(z1.abs() < 1e-9, 1e-9, z1)
        out.append((p1[0] * inv_z1, p1[1] * inv_z1, z1))
    return out


def _direct_taps(nbr_depth: torch.Tensor, nbr_normal: torch.Tensor,
                 u1_all: torch.Tensor, v1_all: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([K,] V, 4, H, W) neighbour (depth, normal) samples at rounded
    positions ``u1_all``, ``v1_all`` ([K,] V, H, W) by nearest gathers (the
    reference's integer-pixel reads, DepthMap.cpp:652-655), and their
    in-image mask ([K,] V, H, W)."""
    # the sampler takes the view axis first
    taps, ok = nearest_sample_planes_batched(
        torch.cat([nbr_depth[:, None], nbr_normal], dim=1),
        u1_all.movedim(-3, 0), v1_all.movedim(-3, 0))
    return taps.movedim((0, 1), (-4, -3)), ok.movedim(0, -3)


def geometric_scores(geom: ViewGeometry, depth: torch.Tensor,
                     normal: torch.Tensor, rays: torch.Tensor,
                     nbr_depth: torch.Tensor, nbr_normal: torch.Tensor,
                     cfg: DenseConfig, rect=None,
                     rows: Optional[Rows] = None) -> torch.Tensor:
    """Forward-backward reprojection consistency per view: (V, H, W) in
    [0, 2] (ref: DepthMap.cpp:625-732).  Projects each pixel into every
    neighbour with the hypothesis depth, reads the neighbour's (depth,
    normal) there (through the rect engine ``rect``, or, with
    ``geo_backend="direct"``, by nearest gathers of ``nbr_depth`` /
    ``nbr_normal``), back-projects, and scores the reprojection error
    against the epipolar-distance normaliser plus normal agreement.
    ``rows``: the fields (and ``rect``'s) are a row band of the image.
    A candidate stack (depth (K, H, W)) gives (K, V, H, W), its
    neighbour reads in one lookup."""
    w = depth.shape[-1]
    h = depth.shape[-2] if rows is None else rows.height
    if rect is None and use_rect_backend(cfg, h, w):
        raise ValueError("geometric scoring needs a rect context "
                         "(ops/rect_gather.build_rect_context)")
    v_, u_ = pixel_grid(depth.shape[-2], w, depth.device, rows)
    max_dist = float(math.hypot(w / 2, h / 2))
    fwd = _forward_projections(geom, depth, rays)
    if rect is not None:
        taps_all, vd_all = _rect_taps(rect, depth)
    else:
        taps_all, vd_all = _direct_taps(
            nbr_depth, nbr_normal,
            torch.round(torch.stack([f[0] for f in fwd], dim=-3)),
            torch.round(torch.stack([f[1] for f in fwd], dim=-3)))
    nx, ny, nz = normal.unbind(-3)

    out = []
    for vi in range(geom.R_rel.shape[0]):
        R_rel, t_rel = geom.R_rel[vi], geom.t_rel[vi]
        u1, v1c, z1 = fwd[vi]
        in1 = ((u1 >= 0) & (u1 <= w - 1) & (v1c >= 0) & (v1c <= h - 1)
               & (z1 > 0))

        taps, vd = taps_all[..., vi, :, :, :], vd_all[..., vi, :, :]
        d1 = taps[..., 0, :, :]
        n1 = normalize3(tuple(taps[..., i, :, :] for i in (1, 2, 3)))
        # back-project via the neighbour's depth
        ray1 = mat3_apply(geom.K_inv_src[vi], (u1, v1c, torch.ones_like(u1)))
        X1b = (ray1[0] * d1, ray1[1] * d1, ray1[2] * d1)
        X0b = mat3_apply_t(R_rel, (X1b[0] - t_rel[0], X1b[1] - t_rel[1],
                                   X1b[2] - t_rel[2]))
        p0b = mat3_apply(geom.K_ref, X0b)
        z0b = p0b[2]
        inv_z0b = 1.0 / torch.where(z0b.abs() < 1e-9, 1e-9, z0b)
        u0b = p0b[0] * inv_z0b
        v0b = p0b[1] * inv_z0b
        in0 = ((u0b >= 0) & (u0b <= w - 1) & (v0b >= 0) & (v0b <= h - 1)
               & (z0b > 0))
        err = torch.hypot(u0b - u_, v0b - v_)
        # epipolar distance of x0 to the epiline of x1: line = F^T x1
        lin = mat3_apply_t(geom.F[vi], (u1, v1c, torch.ones_like(u1)))
        dis = ((lin[0] * u_ + lin[1] * v_ + lin[2]).abs()
               / torch.clamp_min(torch.hypot(lin[0], lin[1]), 1e-9))
        dis = torch.clamp_min(dis, 0.5)
        # normal agreement in the ref frame
        n1_ref = mat3_apply_t(R_rel, n1)
        cos_n = (nx * n1_ref[0] + ny * n1_ref[1] + nz * n1_ref[2]).abs()
        score = torch.where(err < dis * cfg.maxgeo_proportion,
                            err / dis + (1.0 - cos_n), 2.0)
        bad = (~in1) | (~in0) | (d1 <= 0) | (~vd) | (err > max_dist)
        out.append(torch.where(bad, 1.0, torch.clamp_max(score, 2.0)))
    return torch.stack(out, dim=-3)


def view_spread_candidates(geom: ViewGeometry, depth: torch.Tensor,
                           rays: torch.Tensor, nbr_depth: torch.Tensor,
                           nbr_normal: torch.Tensor, rect=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Cross-view hypothesis harvesting (ref: OPTDENSE::viewspread,
    DepthMap.cpp:1504-1608): map each pixel into every neighbour with its
    current depth, read that view's (depth, normal) there (rect engine, or
    nearest gathers when ``rect`` is None) and reproject them into the
    reference frame.  Returns (cand_depth (V, H, W), cand_normal
    (V, 3, H, W) in the reference frame, valid (V, H, W))."""
    fwd = [(torch.round(u1), torch.round(v1), z1)
           for u1, v1, z1 in _forward_projections(geom, depth, rays)]
    if rect is not None:
        taps_all, ok_all = _rect_taps(rect, depth)
    else:
        taps_all, ok_all = _direct_taps(
            nbr_depth, nbr_normal, torch.stack([f[0] for f in fwd]),
            torch.stack([f[1] for f in fwd]))
    cds, cns, oks = [], [], []
    for vi in range(geom.R_rel.shape[0]):
        R_rel, t_rel = geom.R_rel[vi], geom.t_rel[vi]
        u1, v1, z1 = fwd[vi]
        taps = taps_all[vi]
        d1 = taps[0]
        # back-project the neighbour's hypothesis into the ref frame
        ray1 = mat3_apply(geom.K_inv_src[vi], (u1, v1, torch.ones_like(u1)))
        X1b = (ray1[0] * d1, ray1[1] * d1, ray1[2] * d1)
        X0b = mat3_apply_t(R_rel, (X1b[0] - t_rel[0], X1b[1] - t_rel[1],
                                   X1b[2] - t_rel[2]))
        cand_d = X0b[2]
        n_ref = normalize3(mat3_apply_t(R_rel, (taps[1], taps[2], taps[3])))
        cds.append(cand_d)
        cns.append(torch.stack(n_ref))
        oks.append(ok_all[vi] & (d1 > 0) & (z1 > 0) & (cand_d > 0))
    return torch.stack(cds), torch.stack(cns), torch.stack(oks)


def local_smoothness_score(depth_map: torch.Tensor, normal_map: torch.Tensor,
                           rays: torch.Tensor, depth: torch.Tensor,
                           normal: torch.Tensor, d_max: torch.Tensor,
                           delta_c2pmax: torch.Tensor) -> torch.Tensor:
    """Local depth / normal / plane-distance consistency over a 4x4
    neighbourhood: ([K,] H, W) in [0, 2] for hypotheses ([K,] H, W) (ref:
    DepthMap.cpp:798-887)."""
    h, w = depth.shape[-2:]
    nx, ny, nz = normal.unbind(-3)
    c2p_cur = (nx * rays[0] + ny * rays[1] + nz * rays[2]) * depth
    pad = 2
    dm_pad = pad_edge(depth_map, pad)
    nm_pad = pad_edge(normal_map, pad)
    rays_pad = pad_edge(rays, pad)
    zeros = torch.zeros_like(depth)
    diff, ndiff, c2pdiff, cnt = zeros, zeros, zeros, zeros
    for dy in range(-2, 2):
        for dx in range(-2, 2):
            d_n = _shifted(dm_pad, pad, dy, dx, h, w)
            n_n = _shifted(nm_pad, pad, dy, dx, h, w)
            r_n = _shifted(rays_pad, pad, dy, dx, h, w)
            ok = (d_n > 0).to(torch.float32)
            diff = diff + ok * (depth - d_n).abs()
            nd = ((nx - n_n[0]).abs() + (ny - n_n[1]).abs()
                  + (nz - n_n[2]).abs())
            ndiff = ndiff + ok * nd
            c2p_n = (nx * r_n[0] + ny * r_n[1] + nz * r_n[2]) * d_n
            c2pdiff = c2pdiff + ok * (c2p_cur - c2p_n).abs()
            cnt = cnt + ok
    cnt = torch.clamp_min(cnt, 1.0)
    diff = diff / cnt
    ndiff = (ndiff / cnt / 3.0) * 2.0
    c2pdiff = c2pdiff / cnt
    diff_max = d_max * 0.5
    c2p_max = torch.clamp_min(delta_c2pmax * 0.5, 1e-9)
    diff = torch.where(diff > diff_max, 2.0, 2.0 * diff / diff_max)
    c2pdiff = torch.where(c2pdiff > c2p_max, 2.0, 2.0 * c2pdiff / c2p_max)
    return (diff + ndiff + c2pdiff) / 3.0


def smoothness_bonus(depth_map: torch.Tensor, normal_map: torch.Tensor,
                     rays: torch.Tensor, depth: torch.Tensor,
                     normal: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """Multiplicative smoothness bonus from the 4-adjacent neighbours
    (ref: DepthMap.cpp:605-617), ([K,] H, W) for hypotheses ([K,] H,
    W)."""
    h, w = depth.shape[-2:]
    bonus_d = 1.0 - cfg.random_smooth_bonus
    bonus_n = (1.0 - cfg.random_smooth_bonus) * 0.96
    sigma_d = -1.0 / (2.0 * cfg.random_smooth_depth ** 2)
    sigma_n = -1.0 / (2.0 * math.radians(cfg.random_smooth_normal) ** 2)
    dm_pad = pad_edge(depth_map, 1)
    nm_pad = pad_edge(normal_map, 1)
    rays_pad = pad_edge(rays, 1)
    factor = torch.ones_like(depth)
    nx, ny, nz = normal.unbind(-3)
    n_dot_ray = nx * rays[0] + ny * rays[1] + nz * rays[2]
    plane_d = n_dot_ray * depth
    inv_depth = 1.0 / torch.clamp_min(depth, 1e-9)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        d_n = _shifted(dm_pad, 1, dy, dx, h, w)
        n_n = _shifted(nm_pad, 1, dy, dx, h, w)
        r_n = _shifted(rays_pad, 1, dy, dx, h, w)
        # distance of the neighbour's point to the hypothesis plane, / depth
        nX = (nx * r_n[0] + ny * r_n[1] + nz * r_n[2]) * d_n
        dist = (nX - plane_d) * inv_depth
        f_d = torch.exp(dist ** 2 * sigma_d)
        cos = torch.clamp(nx * n_n[0] + ny * n_n[1] + nz * n_n[2], -1.0,
                          1.0)
        f_n = torch.exp(torch.arccos(cos) ** 2 * sigma_n)
        ok = (d_n > 0).to(torch.float32)
        factor = factor * (1.0 - bonus_d * f_d * ok) \
            * (1.0 - bonus_n * f_n * ok)
    return factor


def prior_blend(score: torch.Tensor, depth: torch.Tensor,
                prior_depth: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    """Prior term (ref: DepthMap.cpp:940-955): pull the score toward
    agreement with the prior depth where a prior exists (> 0)."""
    dd = (prior_depth - depth) / torch.clamp_min(prior_depth.abs(), 1e-9)
    w_prior = torch.exp(-(dd ** 2) / (2.0 * cfg.sigma_prior ** 2))
    blended = (score * (1.0 - cfg.para_prior)
               + 2.0 * (1.0 - w_prior) * cfg.para_prior)
    return torch.where(prior_depth > 0, blended, score)


def texture_weights(gra: torch.Tensor, cfg: DenseConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (para_tapa, para_part) from the gradient thresholds
    (ref: DepthMap.cpp:906-928)."""
    para_tapa = torch.where(
        gra < cfg.tx_threshold, cfg.para_tapa,
        torch.where(gra < cfg.tx_threshold2, cfg.para_tapa2, 0.0))
    para_part = torch.where(
        gra < cfg.tx_threshold, cfg.para_part,
        torch.where(gra < cfg.tx_threshold2, cfg.para_part2, 0.0))
    if not cfg.use_geo_consistency:
        para_tapa = torch.zeros_like(para_tapa)
    if not cfg.use_part_consistency:
        para_part = torch.zeros_like(para_part)
    return para_tapa, para_part
