"""Cross-view depth filtering, gap interpolation and point-cloud fusion
(PyTorch port of ``hcmvs_tpu/dense/fusion.py``).

- ``cross_view_filter``: the consistency vote and fused depth of the
  reference's RemoveSmallSegments / FilterDepthMap
  (ref: frame_main/libs/MVS/SceneDensify.cpp:1953-2276, :3006-3259);
- ``gap_interpolate`` / ``gap_repropagate``: the two GapInterpolation
  phases (ref: SceneDensify.cpp:2280-3001);
- ``fuse_point_cloud`` + ``compact_point_cloud``: depth maps to a world
  point cloud with per-point view lists (ref: SceneDensify.cpp:3265-3495
  FuseDepthMaps, Conf2Weight :154-156).

Every view is processed at once from the same maps; a pixel emits its
point only if no higher-priority view agrees with it (the JAX package's
deterministic replacement of the reference's first-come index map).

The row/column gap fill finds each pixel's nearest valid neighbour on
either side with ``torch.cummax`` over the valid positions' indices (and
over the flipped line for the right side) and gathers depth, confidence,
gradient and normal there, instead of the JAX package's ``lax.scan``
along every line.  Where a side has no valid pixel the values are the
scan's initial carry (index -1e9 / 1e9, zeros), so spans, weights and
gates come out the same.

Layout: per-pixel 3-vectors are planes-first (3, H, W); normals come in
as (N, 3, H, W); colours as (N, H, W, 3).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense.types import (dot3, mat3_apply, mat3_apply_t,
                                         normalize3, pixel_rays)
from hcmvs_tpu_torch.ops.sampling import bilinear_sample_xy, pad_edge


def conf_to_weight(conf: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """ref: SceneDensify.cpp:154-156."""
    return 1.0 / (torch.clamp_min(1.0 - conf, 0.03)
                  * torch.clamp_min(depth, 1e-6) ** 2)


def _cam_to_world(cam: Camera, Xc):
    Xw = mat3_apply_t(cam.R, Xc)
    return (Xw[0] + cam.C[0], Xw[1] + cam.C[1], Xw[2] + cam.C[2])


def _world_to_cam(cam: Camera, Xw):
    return mat3_apply(cam.R, (Xw[0] - cam.C[0], Xw[1] - cam.C[1],
                              Xw[2] - cam.C[2]))


def _project(cam: Camera, Xw):
    """World planes -> (u, v, z) planes in the camera."""
    p = mat3_apply(cam.K, _world_to_cam(cam, Xw))
    z = p[2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    return p[0] * inv_z, p[1] * inv_z, z


def _backproject(cam: Camera, depth: torch.Tensor):
    """World planes of every pixel of ``depth`` (H, W) in ``cam``."""
    h, w = depth.shape
    r = pixel_rays(cam.K_inv, h, w)
    return _cam_to_world(cam, (r[0] * depth, r[1] * depth, r[2] * depth))


def cross_view_filter(depths: torch.Tensor, normals: torch.Tensor,
                      confs: torch.Tensor, cams: Camera,
                      nbr_idx: torch.Tensor, nbr_valid: torch.Tensor,
                      cfg: DenseConfig, views: Optional[range] = None):
    """Consistency filter and fused depth across views.

    Args: depths (N, H, W); normals (N, 3, H, W); confs (N, H, W); cams
    batched Camera (N); nbr_idx / nbr_valid (N, V); ``views``: the views
    to filter (all by default; a process's block under the view axis),
    each against all views' maps.

    Returns (filtered_depth, fused_depth, support), one row a filtered
    view: depths with too little cross-view support zeroed; the
    support-weighted mean depth (the reference's depthMap_fuse); the
    supporting-view count (int32).
    """
    del normals
    n, h, w = depths.shape
    nbr = nbr_idx.tolist()
    thr = cfg.depth_diff_threshold * cfg.depth_weight
    filt, fused, support = [], [], []
    for i in (range(n) if views is None else views):
        depth_i = depths[i]
        X_w = _backproject(cams[i], depth_i)
        w0 = conf_to_weight(confs[i], depth_i)
        acc_d = depth_i * w0
        acc_w = w0
        sup = torch.zeros((h, w), dtype=torch.int32, device=depths.device)
        for k, j in enumerate(nbr[i]):
            u_j, v_j, z_j = _project(cams[j], X_w)
            d_j, ok = bilinear_sample_xy(depths[j], u_j, v_j)
            c_j, _ = bilinear_sample_xy(confs[j], u_j, v_j)
            agree = (ok & (d_j > 0) & (z_j > 0)
                     & ((z_j - d_j).abs() < thr * d_j) & nbr_valid[i, k])
            # the neighbour's own depth re-expressed in view i
            scale = d_j / torch.where(z_j <= 0, 1e9, z_j)
            w_j = conf_to_weight(c_j, d_j) * agree
            acc_d = acc_d + depth_i * scale * w_j
            acc_w = acc_w + w_j
            sup = sup + agree.to(torch.int32)
        fused.append(torch.where(depth_i > 0,
                                 acc_d / torch.clamp_min(acc_w, 1e-12), 0.0))
        keep = (sup + 1 >= cfg.min_views_filter) & (depth_i > 0)
        filt.append(torch.where(keep, depth_i, 0.0))
        support.append(sup)
    return torch.stack(filt), torch.stack(fused), torch.stack(support)


def _nearest_valid(valid: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Per position of each line (last axis): the index of the nearest
    valid position at or before it (``reverse``: at or after it), -1 where
    there is none."""
    w = valid.shape[-1]
    idx = torch.arange(w, device=valid.device).expand(valid.shape)
    if not reverse:
        return torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    last = torch.cummax(torch.where(valid.flip(-1), idx, -1),
                        dim=-1).values.flip(-1)
    return torch.where(last >= 0, w - 1 - last, -1)


def _gather_side(pos: torch.Tensor, fields, missing_idx: float):
    """Index (float), depth, conf, gradient and normal at ``pos`` of each
    line, or the scan's initial carry where ``pos`` is -1."""
    has = pos >= 0
    p = pos.clamp_min(0)
    d, c, g, nrm = fields
    out = [torch.where(has, pos.to(torch.float32), missing_idx)]
    out += [torch.where(has, torch.gather(x, -1, p), 0.0) for x in (d, c, g)]
    out.append(torch.where(has[None], torch.gather(
        nrm, -1, p[None].expand(3, *p.shape)), 0.0))
    return out


def _gap_fill_lines(depth: torch.Tensor, conf: torch.Tensor, gap: int,
                    thr: float, gra: Optional[torch.Tensor] = None,
                    normal: Optional[torch.Tensor] = None,
                    tx_gate: float = 0.1):
    """Fill invalid runs between valid depths along the last axis of
    (L, W) maps by linear interpolation (ref: GapInterpolation,
    SceneDensify.cpp:2295-2460).

    Runs up to ``gap`` pixels fill when the endpoint depths are similar;
    longer runs fill only when the texture-gradient ratio across the gap
    is below ``tx_gate`` (when ``gra`` is given).  Normals (3, L, W), when
    given, are interpolated and renormalised."""
    idx = torch.arange(depth.shape[-1], dtype=torch.float32,
                       device=depth.device).expand(depth.shape)
    valid = depth > 0
    has_tx = gra is not None
    g = gra if has_tx else torch.zeros_like(depth)
    has_n = normal is not None
    nr = normal if has_n else torch.zeros((3,) + depth.shape,
                                          device=depth.device)
    fields = (depth, conf, g, nr)
    li, ld, lc, lg, ln = _gather_side(_nearest_valid(valid, False), fields,
                                      -1e9)
    ri, rd, rc, rg, rn = _gather_side(_nearest_valid(valid, True), fields,
                                      1e9)
    span = ri - li
    similar = (ld - rd).abs() < thr * torch.maximum(ld, rd)
    ends = (ld > 0) & (rd > 0)
    small = (~valid) & (span <= gap + 1) & ends & similar
    if has_tx:
        tx_ok = ((rg - lg).abs() / torch.clamp_min(lg, 1e-6)) <= tx_gate
        large = (~valid) & (span > gap + 1) & ends & (tx_ok | similar)
        fill = small | large
    else:
        fill = small
    t = (idx - li) / torch.where(span == 0, 1.0, span)
    d_interp = ld * (1 - t) + rd * t
    c_interp = torch.minimum(lc, rc)
    depth_out = torch.where(fill, d_interp, depth)
    conf_out = torch.where(fill, c_interp, conf)
    if has_n:
        n_interp = ln * (1 - t)[None] + rn * t[None]
        n_interp = n_interp / torch.clamp_min(
            torch.sqrt((n_interp * n_interp).sum(0, keepdim=True)), 1e-9)
        return depth_out, conf_out, torch.where(fill[None], n_interp, nr)
    return depth_out, conf_out


def gap_interpolate(depth: torch.Tensor, conf: torch.Tensor,
                    cfg: DenseConfig, gra: Optional[torch.Tensor] = None,
                    normal: Optional[torch.Tensor] = None):
    """Row then column gap interpolation of one (H, W) depth map (ref:
    GapInterpolation phase 1, SceneDensify.cpp:2295-2785): similar-depth
    fills for small gaps, texture-ratio-gated fills for large ones (with
    ``gra``), normal interpolation (with ``normal`` (3, H, W); the gate
    then runs on ``gra`` or zeros).  Returns (depth, conf) or (depth,
    conf, normal)."""
    gap = cfg.ipol_gap_size
    thr = cfg.depth_diff_threshold * 2.5    # ref: fDepthDiffThreshold*2.5
    if normal is not None:
        g = gra if gra is not None else torch.zeros_like(depth)
        d, c, n = _gap_fill_lines(depth, conf, gap, thr, g, normal)
        d, c, n = _gap_fill_lines(d.T, c.T, gap, thr, g.T,
                                  n.transpose(1, 2))
        return d.T, c.T, n.transpose(1, 2)
    d, c = _gap_fill_lines(depth, conf, gap, thr, gra)
    d, c = _gap_fill_lines(d.T, c.T, gap, thr,
                           None if gra is None else gra.T)
    return d.T, c.T


def gap_repropagate(depth_fuse: torch.Tensor, normal_fuse: torch.Tensor,
                    depth: torch.Tensor, normal: torch.Tensor,
                    conf: torch.Tensor, gra: torch.Tensor,
                    rays: torch.Tensor, cfg: DenseConfig):
    """Gradient-guided re-propagation over the remaining fusion holes
    (ref: GapInterpolation phase 2, SceneDensify.cpp:2791-2983).

    Every invalid fused pixel harvests the HC cross-pattern candidates
    (radius 5 where gra > 150, else propagate_step) from the current depth
    map; where the local texture and depth are smooth (mean ratios below
    1%) it takes the plane-propagated depth of the candidate closest to
    the local depth mean, with that candidate's normal and confidence."""
    h, w = depth_fuse.shape
    step = max(cfg.propagate_step, 1)
    radius = max(cfg.propagate_half_window, step)
    dists = list(range(1, radius + 1, step))
    offs = ([(0, d) for d in dists] + [(0, -d) for d in dists]
            + [(d, 0) for d in dists] + [(-d, 0) for d in dists])
    pad = radius
    dp = F.pad(depth, (pad,) * 4)
    np_ = F.pad(normal, (pad,) * 4)
    gp = pad_edge(gra, pad)
    cp = F.pad(conf, (pad,) * 4)
    rp = pad_edge(rays, pad)
    # texture-adaptive radius per candidate (ref: :2803-2809)
    r_eff = torch.where(gra > 150.0, float(min(5, radius)),
                        float(min(step, radius)))

    def sl(a, dy, dx):
        return a[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    dev = depth.device
    cnt = torch.zeros((h, w), device=dev)
    d_sum = torch.zeros((h, w), device=dev)
    tx_sum = torch.zeros((h, w), device=dev)
    d_min = torch.full((h, w), math.inf, device=dev)
    d_max = torch.full((h, w), -math.inf, device=dev)
    for dy, dx in offs:
        d_c = sl(dp, dy, dx)
        ok = (d_c > 0) & (max(abs(dy), abs(dx)) <= r_eff)
        okf = ok.to(torch.float32)
        cnt = cnt + okf
        d_sum = d_sum + okf * d_c
        tx_sum = tx_sum + okf * (sl(gp, dy, dx) - gra)
        d_min = torch.where(ok, torch.minimum(d_min, d_c), d_min)
        d_max = torch.where(ok, torch.maximum(d_max, d_c), d_max)
    cnt_s = torch.clamp_min(cnt, 1.0)
    d_mean = d_sum / cnt_s
    texture_ratio = (tx_sum / cnt_s).abs() / torch.clamp_min(gra, 1e-6)
    depth_ratio = (d_max - d_min) / torch.clamp_min(d_mean, 1e-9)
    smooth = (texture_ratio < 0.01) & (depth_ratio < 0.01) & (cnt >= 2)

    # the candidate closest to the local depth mean; fill = its plane
    # propagated to this pixel
    best_dev = torch.full((h, w), math.inf, device=dev)
    best_d = torch.zeros((h, w), device=dev)
    best_n = torch.zeros((3, h, w), device=dev)
    best_c = torch.zeros((h, w), device=dev)
    for dy, dx in offs:
        d_c = sl(dp, dy, dx)
        ok = (d_c > 0) & (max(abs(dy), abs(dx)) <= r_eff)
        n_c = sl(np_, dy, dx)
        r_c = sl(rp, dy, dx)
        num = (n_c[0] * r_c[0] + n_c[1] * r_c[1] + n_c[2] * r_c[2]) * d_c
        den = n_c[0] * rays[0] + n_c[1] * rays[1] + n_c[2] * rays[2]
        d_prop = num / torch.where(den.abs() < 1e-9, 1e-9, den)
        dev_c = torch.where(ok, (d_c - d_mean).abs(), math.inf)
        better = dev_c < best_dev
        best_dev = torch.where(better, dev_c, best_dev)
        best_d = torch.where(better, d_prop, best_d)
        best_n = torch.where(better[None], n_c, best_n)
        best_c = torch.where(better, sl(cp, dy, dx), best_c)

    fill = ((depth_fuse <= 0) & smooth & (best_d > 0)
            & torch.isfinite(best_dev))
    return (torch.where(fill, best_d, depth_fuse),
            torch.where(fill[None], best_n, normal_fuse),
            torch.where(fill, best_c, conf))


def fuse_point_cloud(depths: torch.Tensor, normals: torch.Tensor,
                     confs: torch.Tensor, cams: Camera,
                     nbr_idx: torch.Tensor, nbr_valid: torch.Tensor,
                     priority, cfg: DenseConfig,
                     colors: Optional[torch.Tensor] = None,
                     with_colors: bool = False,
                     views: Optional[range] = None) -> dict:
    """Fuse per-view depth maps into a world point cloud.

    Args:
      depths (N, H, W); normals (N, 3, H, W) camera space; confs
        (N, H, W); colors (N, H, W, 3) when ``with_colors``.
      priority: (N,) smaller = higher priority (the reference processes
        the best-connected images first, SceneDensify.cpp:3290-3302).
      views: the views whose pixels to fuse (all by default; a process's
        block under the view axis), each against all views' maps.

    Returns a dict of per-pixel tensors, one row a fused view, and the
    ``keep`` mask; compact it with ``compact_point_cloud``.  Points are
    (N, 3, H, W) planes.  Neighbours are sampled bilinearly at the rounded projection (round
    half to even, as ``jnp.round``)."""
    n, h, w = depths.shape
    dev = depths.device
    nrm_err = float(np.cos(np.radians(cfg.normal_diff_threshold
                                      * cfg.normal_weight)))
    thr = cfg.depth_diff_threshold * cfg.depth_weight
    nbr = nbr_idx.tolist()
    prio = (priority.tolist() if torch.is_tensor(priority)
            else [float(p) for p in priority])
    outs = []
    for i in (range(n) if views is None else views):
        cam_i = cams[i]
        depth_i = depths[i]
        X_w = _backproject(cam_i, depth_i)
        n_i = normals[i]
        n_w = mat3_apply_t(cam_i.R, (n_i[0], n_i[1], n_i[2]))
        w_i = conf_to_weight(confs[i], depth_i)
        accX = [X_w[c] * w_i for c in range(3)]
        accN = [n_w[c] * w_i for c in range(3)]
        accC = ([colors[i][..., c] * w_i for c in range(3)] if with_colors
                else [torch.zeros((h, w), device=dev)] * 3)
        accW = w_i
        count = torch.ones((h, w), dtype=torch.int32, device=dev)
        owned = torch.zeros((h, w), dtype=torch.bool, device=dev)
        agree_k, conf_k = [], []
        for k, j in enumerate(nbr[i]):
            cam_j = cams[j]
            u_j, v_j, z_j = _project(cam_j, X_w)
            ur, vr = torch.round(u_j), torch.round(v_j)
            d_j, ok = bilinear_sample_xy(depths[j], ur, vr)
            c_j, _ = bilinear_sample_xy(confs[j], ur, vr)
            n_j = tuple(bilinear_sample_xy(normals[j][c], ur, vr)[0]
                        for c in range(3))
            n_jw = mat3_apply_t(cam_j.R, n_j)
            agree = (ok & (d_j > 0) & (z_j > 0) & nbr_valid[i, k]
                     & ((z_j - d_j).abs() < thr * d_j)
                     & (dot3(n_w, n_jw) > nrm_err))
            ray_j = mat3_apply(cam_j.K_inv, (u_j, v_j, torch.ones_like(u_j)))
            X_j = _cam_to_world(cam_j, (ray_j[0] * d_j, ray_j[1] * d_j,
                                        ray_j[2] * d_j))
            w_j = conf_to_weight(c_j, d_j) * agree
            accX = [accX[c] + X_j[c] * w_j for c in range(3)]
            accN = [accN[c] + n_jw[c] * w_j for c in range(3)]
            if with_colors:
                accC = [accC[c] + bilinear_sample_xy(
                    colors[j][..., c], ur, vr)[0] * w_j for c in range(3)]
            accW = accW + w_j
            count = count + agree.to(torch.int32)
            if prio[j] < prio[i]:
                owned = owned | agree
            agree_k.append(agree)
            conf_k.append(torch.where(agree, c_j, 0.0))
        keep = (depth_i > 0) & (~owned) & (count >= cfg.min_views_fuse)
        inv_w = 1.0 / torch.clamp_min(accW, 1e-12)
        outs.append(dict(
            points=torch.stack([accX[c] * inv_w for c in range(3)]),
            normals=torch.stack(normalize3(tuple(accN[c] * inv_w
                                                 for c in range(3)))),
            colors=torch.stack([accC[c] * inv_w for c in range(3)]),
            weights=accW, support=count, keep=keep,
            nbr_agree=torch.stack(agree_k), nbr_conf=torch.stack(conf_k)))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def compact_point_cloud(fused: dict, nbr_idx=None, confs=None) -> dict:
    """Compaction of the fused per-pixel tensors into (M, ...) numpy
    arrays, kept pixels in row-major (N, H, W) order.  The selection runs
    on the tensors' device, so only the kept points are copied to the
    host.

    When ``nbr_idx`` (N, V) is given, also emits the ragged per-point view
    lists of the reference's FuseDepthMaps (SceneDensify.cpp:3265-3495):
    ``view_counts`` (M,), ``view_ids`` (sum,) with the owner view first and
    then each agreeing neighbour, and ``view_confs`` (sum,): the owner's
    confidence (from ``confs`` (N, H, W)) and then the neighbours' sampled
    ones."""
    keep_nhw = fused["keep"]
    keep = keep_nhw.reshape(-1)
    out = {}
    for name in ("points", "normals", "colors"):
        out[name] = _host(fused[name].movedim(1, -1).reshape(-1, 3)[keep])
    for name in ("weights", "support"):
        out[name] = _host(fused[name].reshape(-1)[keep])
    n = keep_nhw.shape[0]
    hw = keep.numel() // n
    owner = _host(torch.nonzero(keep).reshape(-1) // hw).astype(np.uint32)
    out["owner_view"] = owner
    if nbr_idx is not None:
        v = fused["nbr_agree"].shape[1]
        agree = _host(fused["nbr_agree"].movedim(1, -1).reshape(-1, v)[keep])
        nconf = _host(fused["nbr_conf"].movedim(1, -1).reshape(-1, v)[keep])
        nbr_of = _host(nbr_idx).astype(np.uint32)[owner]          # (M, V)
        oconf = (np.ones(len(owner), np.float32) if confs is None
                 else _host(confs.reshape(-1)[keep]))
        counts = 1 + agree.sum(1).astype(np.int32)               # (M,)
        total = int(counts.sum())
        ids = np.empty(total, np.uint32)
        cfs = np.empty(total, np.float32)
        offs = np.concatenate([[0], np.cumsum(counts)])
        # owner first, then the agreeing neighbours in nbr_idx order: the
        # per-row running rank of the agreement flags gives the positions
        ids[offs[:-1]] = owner
        cfs[offs[:-1]] = oconf
        rank = np.cumsum(agree, axis=1)                          # 1-based
        rows, cols = np.nonzero(agree)
        pos = offs[rows] + rank[rows, cols]
        ids[pos] = nbr_of[rows, cols]
        cfs[pos] = nconf[rows, cols]
        out["view_counts"] = counts
        out["view_ids"] = ids
        out["view_confs"] = cfs
    return out


def estimate_point_labels(points: np.ndarray, owner_view: np.ndarray,
                          semantic: torch.Tensor, cams: Camera
                          ) -> np.ndarray:
    """Per-point semantic labels: each fused point projected into its
    owner view's label map (ref: EstimatePointLabels,
    frame_main/libs/MVS/DepthMap.cpp:2165), on the label maps' device.

    Args:
      points: (P, 3) world points (a compacted cloud's ``points``).
      owner_view: (P,) index of the view that fused each point.
      semantic: (N, H, W) integer label maps.
      cams: batched Camera of the N views.
    Returns (P,) int32 labels (-1 where the projection misses).
    """
    dev = semantic.device
    n, h, w = semantic.shape
    pts = torch.as_tensor(np.asarray(points), device=dev)
    view = torch.as_tensor(np.asarray(owner_view).astype(np.int64),
                           device=dev)
    Xc = ((pts - cams.C.to(pts.dtype)[view])[:, None, :]
          * cams.R.to(pts.dtype)[view]).sum(-1)               # R (X - C)
    uv = (Xc[:, None, :] * cams.K.to(pts.dtype)[view]).sum(-1)
    x = torch.round(uv[:, 0] / uv[:, 2])
    y = torch.round(uv[:, 1] / uv[:, 2])
    ok = ((Xc[:, 2] > 0) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
          & (view >= 0) & (view < n))
    xi = torch.where(ok, x, 0).long()
    yi = torch.where(ok, y, 0).long()
    lab = semantic[torch.clamp(view, 0, n - 1), yi, xi].to(torch.int32)
    return torch.where(ok, lab, -1).cpu().numpy()
