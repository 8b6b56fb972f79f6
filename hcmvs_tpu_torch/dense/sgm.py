"""Semi-global matching: the alternative stereo path (fusion modes -1/-2).

PyTorch port of ``hcmvs_tpu/dense/sgm.py`` (ref:
frame_main/libs/MVS/SemiGlobalMatcher.{h,cpp} — census transform, WTA over
an 8-path aggregated cost volume, left-right consistency check, sub-pixel
refinement; invoked via DensifyPointCloud --fusion-mode -1/-2,
SceneDensify.cpp:3899-3911).

- The census transform is shifted-array comparisons packed into int32
  bits (24 at radius 2); the popcount of a XOR is the SWAR bit count,
  done in int64 so that its uint32 wrap-around is exact.
- The cost volume plane-sweeps D fronto-parallel depth hypotheses through
  the full homography (general two-view poses, no rectification).
- Path aggregation is the classic dynamic program along rows and
  columns.  The JAX package scans each of the 8 paths on its own; here
  the six row-scanning paths (down, up and the four diagonals) advance
  together as one (2, 3, D, W) carry, and the two column-scanning paths
  as one (2, D, H): each path's values are the reference's recurrence op
  for op, and the paths are summed in the reference's order, so the
  result is the same with a third of the steps.  Reverse paths run on
  the flipped volume.

The JAX package ``vmap``s the views; ``sgm_scene`` loops over views and
pairs, so one pair's volumes are live at a time.  No kernel of the port
is on this path: it is XLA in the JAX package, plain PyTorch here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hcmvs_tpu_torch.dense.types import ViewGeometry

_INF = float("inf")


def census_transform(gray: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """(H, W) -> (H, W) int32 census bitstring over a (2r+1)^2-1 window
    (bit k set where the k-th neighbour, row-major, is below the centre;
    edges replicated)."""
    n_bits = (2 * radius + 1) ** 2 - 1
    if n_bits > 31:
        raise ValueError(f"census radius {radius}: {n_bits} bits do not "
                         f"fit an int32")
    h, w = gray.shape
    pad = torch.nn.functional.pad(gray[None, None], (radius,) * 4,
                                  mode="replicate")[0, 0]
    bits = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[radius + dy:radius + dy + h,
                     radius + dx:radius + dx + w]
            bits = bits | ((nb < gray).to(torch.int32) << k)
            k += 1
    return bits


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount of a XOR b for int32 census codes, as float32: the JAX
    package's uint32 SWAR count, in int64 with the product cut to 32 bits
    (int32 would overflow, and its >> is arithmetic)."""
    v = (a ^ b).to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.float32)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int
              ) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` as the JAX package's compiled
    ``cost_volume`` computes it on the CPU: XLA turns jnp's
    start * (1 - i / (num - 1)) + stop * (i / (num - 1)) into
    fma(i, stop * c, start * (1 - i * c)) with c = f32(1 / (num - 1)) (the
    fused multiply-add done here in float64, where the product is exact),
    the last point ``stop`` itself; torch.linspace rounds differently."""
    div = num - 1
    c = float(torch.tensor(1.0 / div, dtype=torch.float32))
    i = torch.arange(div, dtype=torch.float32, device=start.device)
    head = start * (1 - i * c)
    out = (i.double() * (stop * c).double() + head.double()).float()
    return torch.cat([out, stop.reshape(1)])


def cost_volume(geom: ViewGeometry, ref_gray: torch.Tensor,
                src_gray: torch.Tensor, d_min: torch.Tensor,
                d_max: torch.Tensor, n_depths: int = 64, view: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) census cost volume by plane-sweeping fronto-parallel
    depths against neighbour ``view`` of ``geom``, plus the (D,) swept
    inverse-depth values."""
    h, w = ref_gray.shape
    dev = ref_gray.device
    f32 = torch.float32
    cr = census_transform(ref_gray)
    v_, u_ = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    A = geom.A[view]
    wv = geom.wv[view]
    p0x = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]
    p0y = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]
    p0z = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]
    inv_depths = _linspace(1.0 / d_max, 1.0 / d_min, n_depths)
    cs = census_transform(src_gray).reshape(-1)
    vol = torch.empty((n_depths, h, w), dtype=f32, device=dev)
    for k in range(n_depths):
        inv_d = inv_depths[k]
        # fronto-parallel plane at depth 1/inv_d: warp = A p + wv * inv_d
        phx = p0x + wv[0] * inv_d
        phy = p0y + wv[1] * inv_d
        phz = p0z + wv[2] * inv_d
        inv_z = 1.0 / torch.where(phz.abs() < 1e-9, 1e-9, phz)
        # census of the warped source: nearest neighbour (round half to
        # even, as jnp.round)
        xs = torch.round(phx * inv_z)
        ys = torch.round(phy * inv_z)
        xi = torch.clamp(xs.to(torch.int32), 0, w - 1)
        yi = torch.clamp(ys.to(torch.int32), 0, h - 1)
        oob = (xs < 0) | (xs > w - 1) | (ys < 0) | (ys > h - 1) | (phz <= 0)
        c = hamming_distance(cr, cs[(yi * w + xi).to(torch.int64)])
        vol[k] = torch.where(oob, 24.0, c)
    return vol, inv_depths


def _recurrence(prev: torch.Tensor, cur: torch.Tensor, p1: float,
                p2: float) -> torch.Tensor:
    """One step of the min-penalty recurrence, D on axis -2:
    cur + min(prev, up + p1, down + p1, min(prev) + p2) - min(prev), with
    ``up`` / ``down`` the neighbouring depth (inf past the ends)."""
    d = prev.shape[-2]
    prev_min = torch.amin(prev, dim=-2, keepdim=True)
    padded = torch.nn.functional.pad(prev, (0, 0, 1, 1), value=_INF)
    up = padded[..., 0:d, :]
    down = padded[..., 2:d + 2, :]
    best = torch.minimum(torch.minimum(prev, up + p1),
                         torch.minimum(down + p1, prev_min + p2))
    return cur + best - prev_min


def _row_paths(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The six row-scanning paths at once: (2, 3, D, H, W) for direction
    (down, up) x column shift (+1, 0, -1), the up paths' rows in scan
    order (``_path`` flips them back).  A shift makes the path
    diagonal: each step's predecessor row moves one column sideways, the
    entering column restarting at 0 (the JAX package's roll and zero).
    The carries are stored with a zero column at both sides, so the three
    shifts are three windows of one buffer (strides, not copies)."""
    d, h, w = cost.shape
    by_row = cost.permute(1, 0, 2)                       # (H, D, W)
    cur_all = torch.stack([by_row, by_row.flip(0)], 1)   # (H, 2, D, W)
    agg = torch.zeros((h, 2, 3, d, w + 2), dtype=cost.dtype,
                      device=cost.device)
    agg[0, :, :, :, 1:w + 1] = cur_all[0][:, None]
    sd, sg = 3 * d * (w + 2), d * (w + 2)
    for y in range(1, h):
        prev = agg[y - 1].as_strided(
            (2, 3, d, w), (sd, sg + 1, w + 2, 1),
            agg[y - 1].storage_offset())
        agg[y, :, :, :, 1:w + 1] = _recurrence(prev, cur_all[y][:, None],
                                               p1, p2)
    return agg[..., 1:w + 1].permute(1, 2, 3, 0, 4)     # (2, 3, D, H, W)


def _column_paths(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The two column-scanning paths at once: (2, D, H, W) for direction
    (right, left), the left path's columns in scan order."""
    d, h, w = cost.shape
    by_col = cost.permute(2, 0, 1)                       # (W, D, H)
    cur_all = torch.stack([by_col, by_col.flip(0)], 1)   # (W, 2, D, H)
    agg = torch.empty((w, 2, d, h), dtype=cost.dtype, device=cost.device)
    agg[0] = cur_all[0]
    for x in range(1, w):
        agg[x] = _recurrence(agg[x - 1], cur_all[x], p1, p2)
    return agg.permute(1, 2, 3, 0)                       # (2, D, H, W)


def _path(rows: torch.Tensor, cols: torch.Tensor, axis: int,
          reverse: bool, col_shift: int = 0) -> torch.Tensor:
    """One path's (D, H, W) volume in image order, from the outputs of
    ``_row_paths`` (axis 1) or ``_column_paths`` (axis 2)."""
    if axis == 2:
        return cols[1].flip(-1) if reverse else cols[0]
    out = rows[int(reverse), 1 - col_shift]
    return out.flip(-2) if reverse else out


def _aggregate_dir(cost: torch.Tensor, p1: float, p2: float, axis: int,
                   reverse: bool, col_shift: int = 0) -> torch.Tensor:
    """One SGM path of the (D, H, W) volume, as the JAX package's
    ``_aggregate_dir``: scan along ``axis`` (1 rows, 2 columns), backwards
    with ``reverse``, diagonal with ``col_shift`` +/-1 (rows only); the
    first line of the scan is copied.  (``sgm_aggregate`` runs the paths
    together; this one path is for the tests.)"""
    if axis == 2:
        if col_shift:
            raise ValueError("diagonal paths scan rows (axis 1)")
        return _path(None, _column_paths(cost, p1, p2), 2, reverse)
    return _path(_row_paths(cost, p1, p2), None, 1, reverse, col_shift)


def sgm_aggregate(cost: torch.Tensor, p1: float = 3.0, p2: float = 20.0,
                  n_paths: int = 8) -> torch.Tensor:
    """4- or 8-path SGM aggregation of a (D, H, W) volume (ref:
    SemiGlobalMatcher 4/8-path option): down / up / right / left plus,
    for 8 paths, the four diagonals as shifted row scans, summed in the
    JAX package's order."""
    rows = _row_paths(cost, p1, p2)
    cols = _column_paths(cost, p1, p2)
    order = [(1, False, 0), (1, True, 0), (2, False, 0), (2, True, 0)]
    if n_paths >= 8:
        order += [(1, False, 1), (1, False, -1), (1, True, 1),
                  (1, True, -1)]
    total = torch.zeros_like(cost)
    for axis, reverse, col_shift in order:
        total = total + _path(rows, cols, axis, reverse, col_shift)
    return total


def sgm_match(geom: ViewGeometry, ref_gray: torch.Tensor,
              src_gray: torch.Tensor, d_min: torch.Tensor,
              d_max: torch.Tensor, n_depths: int = 64, p1: float = 3.0,
              p2: float = 20.0, max_cost: float = 18.0, n_paths: int = 8,
              view: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SGM depth for a view pair (neighbour ``view`` of ``geom``):
    (depth (H, W), cost (H, W)).  WTA over the aggregated volume,
    parabola sub-pixel refinement in inverse depth, winner-cost
    thresholding (SemiGlobalMatcher.cpp:739)."""
    vol, inv_depths = cost_volume(geom, ref_gray, src_gray, d_min, d_max,
                                  n_depths, view)
    agg = sgm_aggregate(vol, p1, p2, n_paths)
    del vol
    best = torch.argmin(agg, dim=0)                      # (H, W)
    d_idx = torch.clamp(best, 1, n_depths - 2)
    c0 = torch.gather(agg, 0, (d_idx - 1)[None])[0]
    c1 = torch.gather(agg, 0, d_idx[None])[0]
    c2 = torch.gather(agg, 0, (d_idx + 1)[None])[0]
    denom = c0 + c2 - 2 * c1
    offset = torch.where(denom.abs() > 1e-6,
                         0.5 * (c0 - c2) / torch.clamp_min(denom, 1e-6),
                         0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    step = inv_depths[1] - inv_depths[0]
    inv_d = inv_depths[d_idx] + offset * step
    depth = 1.0 / torch.clamp_min(inv_d, 1e-9)
    win_cost = c1 / float(n_paths)                       # per-path average
    depth = torch.where(win_cost < max_cost, depth, 0.0)
    return depth, win_cost


def lr_consistency(geom: ViewGeometry, depth_ref: torch.Tensor,
                   depth_src: torch.Tensor, rel_thr: float = 0.02,
                   dsig: Optional[torch.Tensor] = None,
                   view: int = 0) -> torch.Tensor:
    """Left-right cross-check mask for one pair (ref: the rectified LR
    check of SemiGlobalMatcher::Match, SemiGlobalMatcher.cpp:530, in depth
    space): forward-project each reference pixel's depth into source
    ``view`` and keep it only where the source's own SGM depth there
    agrees.  Pixels projecting outside the source, onto invalid source
    pixels or onto a disagreeing depth (occlusions) are rejected."""
    h, w = depth_ref.shape
    dev = depth_ref.device
    f32 = torch.float32
    v_, u_ = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    A = geom.A[view]
    wv = geom.wv[view]
    px = (A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]) * depth_ref + wv[0]
    py = (A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]) * depth_ref + wv[1]
    pz = (A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]) * depth_ref + wv[2]
    inv_z = 1.0 / torch.where(pz.abs() < 1e-9, 1e-9, pz)
    xs = px * inv_z
    ys = py * inv_z
    # depth of the same point in the source camera: z of R_rel X + t_rel
    R = geom.R_rel[view]
    t = geom.t_rel[view]
    Ki = geom.K_inv_ref
    rz = ((R[2, 0] * Ki[0, 0] + R[2, 1] * Ki[1, 0]) * u_
          + (R[2, 0] * Ki[0, 1] + R[2, 1] * Ki[1, 1]) * v_
          + (R[2, 0] * Ki[0, 2] + R[2, 1] * Ki[1, 2] + R[2, 2]))
    d_in_src = rz * depth_ref + t[2]
    xi = torch.clamp(torch.round(xs).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(ys).to(torch.int64), 0, h - 1)
    d_src = depth_src.reshape(-1)[yi * w + xi]
    inside = ((xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
              & (pz > 0))
    thr = rel_thr * torch.clamp_min(d_in_src, 1e-9)
    if dsig is not None:
        # floor at ~2 sweep-quantization steps (the JAX package's choice,
        # measured there on the box occlusion scene)
        thr = torch.maximum(thr, 2.0 * d_in_src * d_in_src * dsig)
    agree = (d_src > 0) & ((d_src - d_in_src).abs() < thr)
    return inside & agree


def sgm_fuse_pairs(depths: torch.Tensor, costs: torch.Tensor,
                   max_cost: float = 18.0, depth_thr: float = 0.02,
                   dsig: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one view's per-neighbour SGM maps (K, H, W) into one map (ref:
    SemiGlobalMatcher::Fuse, SemiGlobalMatcher.cpp:739): per pixel, the
    estimate most other pairs agree with wins, and every agreeing pair is
    cost-weight-averaged around it; a winner with no support is dropped
    where a cross-check exists.  ``dsig``: the swept inverse-depth step;
    the agreement threshold floors at 4 quantization steps.  Returns
    (depth (H, W), fused per-path-average cost (H, W))."""
    k = depths.shape[0]
    valid = (depths > 0) & (costs < max_cost)
    wts = torch.where(valid, 1.0 / torch.clamp_min(costs, 0.5), 0.0)
    if k == 1:
        return torch.where(valid[0], depths[0], 0.0), costs[0]

    def thr(d):
        t = depth_thr * d
        if dsig is not None:
            t = torch.maximum(t, 4.0 * d * d * dsig)
        return t

    # support: for each pair's estimate, how many other pairs agree
    agree = torch.zeros_like(depths)
    for a in range(k):
        for b in range(k):
            if a == b:
                continue
            ok = (valid[a] & valid[b]
                  & ((depths[a] - depths[b]).abs() < thr(depths[a])))
            agree[a] = agree[a] + ok.to(torch.float32)
    best = torch.argmax(torch.where(valid, agree, -1.0) - costs * 1e-3,
                        dim=0)                           # (H, W)
    d_best = torch.gather(depths, 0, best[None])[0]
    v_best = torch.gather(valid, 0, best[None])[0]
    sup_best = torch.gather(agree, 0, best[None])[0]
    # average every agreeing pair around the winner
    close = valid & ((depths - d_best[None]).abs()
                     < thr(torch.clamp_min(d_best, 1e-9))[None])
    w_c = torch.where(close, wts, 0.0)
    norm = torch.clamp_min(torch.sum(w_c, 0), 1e-12)
    d_fused = torch.sum(w_c * depths, 0) / norm
    c_fused = torch.sum(w_c * costs, 0) / norm
    # at least one cross-pair agreement wherever a cross-check exists;
    # a pixel with a single valid pair keeps its lone estimate (the
    # cross-view filter still checks it)
    n_valid = valid.sum(0)
    keep = v_best & ((sup_best >= 1.0) | (n_valid <= 1))
    return (torch.where(keep, d_fused, 0.0),
            torch.where(keep, c_fused, 2.0 * max_cost))


def sgm_scene(scene, cfg=None, n_depths: int = 64, n_pairs: int = 0,
              lr_check: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SGM depth maps for every view, each matched against its top
    neighbours and fused: the DensifyPointCloud --fusion-mode -1/-2 path
    (ref: SceneDensify.cpp:3899-3911, SemiGlobalMatcher.cpp:530 / :739).
    Each pair runs the left-right cross-check (the reverse match, source
    as reference, over the union of both views' depth ranges); the pairs
    are fused with ``sgm_fuse_pairs``; the caller applies the cross-view
    filter as for PatchMatch maps.

    ``scene`` is a ``dense.scene_driver.SceneTensors``; ``n_pairs`` limits
    the neighbours matched per view (0 = all of ``nbr_idx``).  Returns
    (depth (N, H, W), normal (N, 3, H, W), conf (N, H, W)).  Views and
    pairs go one at a time (the JAX package vmaps the views)."""
    from hcmvs_tpu_torch.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu_torch.ops.gradients import normals_from_depth
    n, h, w = scene.gray.shape
    v_all = scene.nbr_idx.shape[1]
    k = v_all if n_pairs <= 0 else min(n_pairs, v_all)
    nbr_idx = scene.nbr_idx.tolist()
    nbr_valid = scene.nbr_valid.tolist()
    depths, normals, confs = [], [], []
    for i in range(n):
        cam_i = scene.cams[i]
        geom = make_view_geometry(cam_i, scene.cams[scene.nbr_idx[i]])
        dsig_i = (1.0 / scene.d_min[i] - 1.0 / scene.d_max[i]) / n_depths
        pair_d, pair_c = [], []
        for j in range(k):
            if not nbr_valid[i][j]:       # as the JAX package masks it
                pair_d.append(torch.zeros_like(scene.gray[i]))
                pair_c.append(torch.full_like(scene.gray[i], 1e9))
                continue
            nbr = nbr_idx[i][j]
            src_gray = scene.gray[nbr]
            d, c = sgm_match(geom, scene.gray[i], src_gray, scene.d_min[i],
                             scene.d_max[i], n_depths, view=j)
            if lr_check:
                geom_rev = make_view_geometry(scene.cams[nbr],
                                              scene.cams[i:i + 1])
                d_rev, _ = sgm_match(
                    geom_rev, src_gray, scene.gray[i],
                    torch.minimum(scene.d_min[i], scene.d_min[nbr]),
                    torch.maximum(scene.d_max[i], scene.d_max[nbr]),
                    n_depths)
                ok = lr_consistency(geom, d, d_rev, dsig=dsig_i, view=j)
                d = torch.where(ok, d, 0.0)
            pair_d.append(d)
            pair_c.append(c)
        depth, cost = sgm_fuse_pairs(torch.stack(pair_d),
                                     torch.stack(pair_c), dsig=dsig_i)
        rays = pixel_rays(geom.K_inv_ref, h, w)
        depths.append(depth)
        normals.append(normals_from_depth(depth, rays))
        confs.append(torch.where(
            depth > 0, torch.clamp_min(1.0 - cost / 18.0, 0.01), 0.0))
    return torch.stack(depths), torch.stack(normals), torch.stack(confs)
