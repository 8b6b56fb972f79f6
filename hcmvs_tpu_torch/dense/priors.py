"""Planar priors: superpixels, robust per-segment plane fits, RANSAC planes
per semantic region and the a-contrario gate (PyTorch port of
``hcmvs_tpu/dense/priors.py``; ref: frame_main/libs/MVS/SceneDensify.cpp:
4010-4090 LSC_superpixel, :1171-1545 GenerateSuperDepthPrior, :1550-1950
GenerateDepthPrior, :1079-1161 GenerateFinalPrior).

- Superpixels: SLIC-style local k-means; each pixel competes only among
  the 3x3 grid centres around its home cell.
- Plane fits: every segment at once by IRLS (Tukey weights) over
  per-segment 3x3 moment sums, planes in the inverse-depth-affine form
  1/depth = a*u + b*v + c of pixel (u, v).
- RANSAC per semantic region: a fixed number of hypotheses, each an
  anchor pixel plus two pixels within ``radius``; the draws come from
  ``ransac_draws`` and are applied by ``ransac_segment_planes``, so a
  caller (or a test) may feed draws of its own.
- The gate: a plane feeds the prior only if it is significant against an
  empirical null (``segment_plane_nfa``) or fits its segment finely.

Every function takes tensors on one device and returns tensors there.
Per-segment sums (``_Segments``) are ``index_add_`` on the CPU, in pixel
order as the JAX package's ``segment_sum`` adds them.  On CUDA
``index_add_`` adds through atomics in an order that changes from run to
run, and a superpixel whose plane sits at a gate's threshold then passes
in one run and not the next (1.06% of a 1280x960 view's prior pixels
between two runs on an H100); there the pixels are sorted by segment
once per segment map and each segment summed by a fixed reduction of a
padded (segments, longest segment) array, so a run repeats exactly.  The
solves stay in float32, as in the JAX package: pixel coordinates up to
1280 make the moment matrices ill-conditioned, and a float64 solve would
give other planes than the reference's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class _Segments:
    """Sums of per-pixel rows over a fixed map of ``n`` segment ids
    ``ids`` (P,): ``index_add_`` on the CPU; on CUDA the same order-fixed
    sum whatever the run (pixels sorted by segment, stable, into a
    zero-padded (n, longest, ...) array summed along its rows).
    ``fixed_order`` forces one or the other."""

    def __init__(self, ids: torch.Tensor, n: int,
                 fixed_order: Optional[bool] = None):
        self.ids, self.n = ids, n
        self.fixed_order = (ids.is_cuda if fixed_order is None
                            else fixed_order)
        if self.fixed_order:
            counts = torch.bincount(ids, minlength=n)
            self.width = max(int(counts.max()), 1)
            self.order = torch.argsort(ids, stable=True)
            sid = ids[self.order]
            start = torch.cumsum(counts, 0) - counts
            pos = torch.arange(ids.numel(), device=ids.device) - start[sid]
            self.slot = sid * self.width + pos

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) sums of the rows of ``x`` (P, ...)."""
        rest = tuple(x.shape[1:])
        if not self.fixed_order:
            out = torch.zeros((self.n,) + rest, dtype=x.dtype,
                              device=x.device)
            return out.index_add_(0, self.ids, x)
        pad = torch.zeros((self.n * self.width,) + rest, dtype=x.dtype,
                          device=x.device)
        pad[self.slot] = x[self.order]
        return pad.view((self.n, self.width) + rest).sum(dim=1)


def _segment_extreme(x: torch.Tensor, seg: torch.Tensor, n: int,
                     reduce: str) -> torch.Tensor:
    """Per-segment max ("amax") or min ("amin") of integer ``x``; an empty
    segment holds the reduction's identity (the dtype's min or max), as
    ``jax.ops.segment_max`` / ``segment_min`` leave it."""
    info = torch.iinfo(x.dtype)
    out = torch.full((n,), info.min if reduce == "amax" else info.max,
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce, include_self=False)


def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) float32 (H, W) pixel coordinates."""
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's nanmedian of a float tensor: the middle value, or the mean
    of the two middle values of an even count (``torch.nanmedian`` takes
    the lower one); NaN when every value is NaN."""
    vals = torch.sort(x.reshape(-1)).values         # NaN sorts last
    n = (~torch.isnan(vals)).sum()
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = torch.clamp_min(n // 2, 0)
    med = (vals[lo] + vals[hi]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def slic_superpixels(gray: torch.Tensor, grid_step: int = 16,
                     n_iters: int = 5, m: float = 0.1) -> torch.Tensor:
    """(H, W) -> (H, W) int64 labels, about one superpixel per grid cell.

    ``m`` balances intensity against spatial distance (SLIC compactness).
    """
    h, w = gray.shape
    dev = gray.device
    gh = max(h // grid_step, 1)
    gw = max(w // grid_step, 1)
    sy = h / gh
    sx = w / gw
    yy, xx = _pixel_grid(h, w, dev)
    # centres start at the grid cells' centres, with the image's value
    cy = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * sy
    cx = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * sx
    cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
    ci = gray[torch.clamp(cyy.long(), 0, h - 1),
              torch.clamp(cxx.long(), 0, w - 1)]
    centers = torch.stack([cyy, cxx, ci])                 # (3, gh, gw)
    # each pixel's home cell
    py = torch.clamp(torch.div(yy, torch.full_like(yy, sy)).long(), 0,
                     gh - 1)
    px = torch.clamp(torch.div(xx, torch.full_like(xx, sx)).long(), 0,
                     gw - 1)
    inv_s2 = 1.0 / (sy * sx)
    inv_m2 = 1.0 / (m * m)
    n_seg = gh * gw
    # (P, 4): count, y, x and intensity, summed per segment at once
    feats = torch.stack([torch.ones_like(yy), yy, xx, gray], -1).reshape(-1, 4)
    labels = None
    for _ in range(n_iters):
        best_d = torch.full((h, w), float("inf"), device=dev)
        best_l = torch.zeros((h, w), dtype=torch.int64, device=dev)
        cpad = F.pad(centers, (1, 1, 1, 1), mode="replicate")
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                gy = torch.clamp(py + dy, -1, gh)
                gx = torch.clamp(px + dx, -1, gw)
                c = cpad[:, gy + 1, gx + 1]               # (3, H, W)
                d = (((yy - c[0]) ** 2 + (xx - c[1]) ** 2) * inv_s2
                     + (gray - c[2]) ** 2 * inv_m2)
                lbl = (torch.clamp(gy, 0, gh - 1) * gw
                       + torch.clamp(gx, 0, gw - 1))
                better = d < best_d
                best_d = torch.where(better, d, best_d)
                best_l = torch.where(better, lbl, best_l)
        # centres move to their segments' means
        sums = _Segments(best_l.reshape(-1), n_seg).sum(feats)
        cnt = sums[:, 0]
        denom = torch.clamp_min(cnt, 1.0)
        new_centers = (sums[:, 1:] / denom[:, None]).T.reshape(3, gh, gw)
        keep = (cnt > 0).reshape(gh, gw)
        centers = torch.where(keep[None], new_centers, centers)
        labels = best_l
    return labels


def _plane_pred(planes: torch.Tensor, flat: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """a*u + b*v + c of each pixel's segment plane."""
    p = planes[flat]
    return p[:, 0] * u + p[:, 1] * v + p[:, 2]


def fit_segment_planes(labels: torch.Tensor, depth: torch.Tensor,
                       n_labels: int, n_irls: int = 3, tukey_c=0.02
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Robust plane fit per segment on the pixels with depth: weighted
    least squares of 1/depth ~ a*u + b*v + c, then ``n_irls`` Tukey
    reweightings (residual scale ``tukey_c``, a float or a 0-dim tensor).

    Returns (planes (L, 3), inlier_frac (L,), count (L,)).
    """
    h, w = depth.shape
    yy, xx = _pixel_grid(h, w, depth.device)
    valid = (depth > 0).reshape(-1)
    flat = labels.reshape(-1)
    segs = _Segments(flat, n_labels)
    u = xx.reshape(-1)
    v = yy.reshape(-1)
    z = 1.0 / torch.clamp_min(depth.reshape(-1), 1e-9)    # inverse depth
    wgt = valid.float()
    A = torch.stack([u, v, torch.ones_like(u)], dim=-1)   # (P, 3)
    eye = 1e-8 * torch.eye(3, device=depth.device)

    def solve(wgt):
        AtA = (A[:, :, None] * A[:, None, :]) * wgt[:, None, None]
        Atz = A * (z * wgt)[:, None]
        # the 3x3 moments and the right-hand side in one sum
        Mb = segs.sum(torch.cat([AtA.reshape(-1, 9), Atz], dim=1))
        M = Mb[:, :9].reshape(n_labels, 3, 3) + eye[None]
        b = Mb[:, 9:]
        return torch.linalg.solve_ex(M, b[..., None])[0][..., 0]  # (L, 3)

    planes = solve(wgt)
    for _ in range(n_irls):
        r = (z - _plane_pred(planes, flat, u, v)) / tukey_c
        tw = torch.where(torch.abs(r) < 1.0, (1 - r ** 2) ** 2, 0.0)
        planes = solve(wgt * tw)
    # inlier statistics of the final fit
    inl = (torch.abs(z - _plane_pred(planes, flat, u, v)) < tukey_c) & valid
    cnt, icnt = segs.sum(torch.stack([wgt, inl.float()], 1)).unbind(1)
    return planes, icnt / torch.clamp_min(cnt, 1.0), cnt


def prior_depth_map(labels: torch.Tensor, planes: torch.Tensor,
                    inlier_frac: torch.Tensor, count: torch.Tensor,
                    min_support: int = 30,
                    min_inlier_frac: float = 0.6) -> torch.Tensor:
    """Each pixel's segment plane evaluated at the pixel: (H, W) prior
    depth, 0 where the segment has no trustworthy plane (the
    depthMapPrior of the reference)."""
    h, w = labels.shape
    yy, xx = _pixel_grid(h, w, labels.device)
    p = planes[labels]                                    # (H, W, 3)
    inv_z = p[..., 0] * xx + p[..., 1] * yy + p[..., 2]
    depth = 1.0 / torch.clamp_min(inv_z, 1e-6)
    ok = ((inlier_frac[labels] >= min_inlier_frac)
          & (count[labels] >= min_support) & (inv_z > 1e-6))
    return torch.where(ok, depth, 0.0)


def inv_depth_spacing(depth: torch.Tensor) -> torch.Tensor:
    """Data-driven residual scale (0-dim tensor): the median |change of
    inverse depth| between horizontally adjacent valid pixels, the analog
    of the reference's CGAL ``compute_average_spacing`` behind every
    fransac* threshold (ref: SceneDensify.cpp:1335,1362), with
    scale-relative floors for constant or (near-)empty maps."""
    nan = torch.tensor(float("nan"), device=depth.device)
    z = torch.where(depth > 0, 1.0 / torch.clamp_min(depth, 1e-9), 0.0)
    both = (depth[:, 1:] > 0) & (depth[:, :-1] > 0)
    d = torch.where(both, torch.abs(z[:, 1:] - z[:, :-1]), nan)
    med = _nanmedian(d)
    zv = torch.where(depth > 0, z, nan)
    rng_scale = torch.where(
        (depth > 0).any(),
        (torch.where(depth > 0, z, -float("inf")).max()
         - torch.where(depth > 0, z, float("inf")).min()) * 1e-3, nan)
    med_z = _nanmedian(zv)
    floor = torch.where(torch.isfinite(med_z), torch.abs(med_z), 1.0) * 1e-4
    med = torch.where(torch.isfinite(med) & (med > 1e-12), med, rng_scale)
    return torch.where(torch.isfinite(med) & (med > floor), med, floor)


def hyps_from_probability(probability: float, w_inlier: float = 0.5,
                          m: int = 3, lo: int = 32, hi: int = 256) -> int:
    """The hypothesis count for the reference's ``ransacprobability``
    (the probability of missing the largest primitive,
    SceneDensify.cpp:1353): P(miss) = (1 - w^m)^H, so H = log(P) /
    log(1 - w^m), clamped to [lo, hi] and rounded up to a multiple of
    32."""
    h = math.log(max(probability, 1e-12)) / math.log(1.0 - w_inlier ** m)
    return int(min(hi, max(lo, 32 * math.ceil(h / 32))))


def segment_plane_nfa(labels: torch.Tensor, depth: torch.Tensor,
                      planes: torch.Tensor, n_labels: int,
                      spacing: torch.Tensor, m: int = 3, n_r: int = 12
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A-contrario validation of per-segment planes (ref: AutoEstimator.h:
    230 driving EstimatePlane*, DepthMap.h:661-664), every segment at once.

    For each segment and each threshold r of a geometric ladder anchored
    at ``spacing``, the inlier count k gives

        log NFA(seg, r) = log n_r + log C(n, k) + log C(k, m)
                          + (k - m) * log alpha(r)

    where alpha(r) is the share of the view's inverse depths within r of
    an unrelated plane prediction (the prediction field rolled by half
    the image, flat).  A segment's significance is its minimum over the
    ladder; log NFA >= 0 is indistinguishable from chance.

    Returns (log_nfa (L,), fine_frac (L,)): fine_frac is the segment's
    inlier share at r = spacing (a fronto-parallel segment has no spread
    and no defined NFA; its fine_frac is near 1 instead).
    """
    h, w = depth.shape
    yy, xx = _pixel_grid(h, w, depth.device)
    flat = labels.reshape(-1)
    valid = (depth > 0).reshape(-1)
    z = 1.0 / torch.clamp_min(depth.reshape(-1), 1e-9)
    pred = _plane_pred(planes, flat, xx.reshape(-1), yy.reshape(-1))
    res = torch.abs(z - pred)
    # the empirical null: residuals against plane predictions half the
    # (flat) image away
    half = res.shape[0] // 2
    valid_null = valid & torch.roll(valid, half)
    res_null = torch.abs(z - torch.roll(pred, half))
    ladder = spacing * torch.as_tensor(
        np.geomspace(0.5, 64.0, n_r).astype(np.float32),
        device=depth.device)                              # (n_r,)
    fine = (res < spacing) & valid
    # inliers at every rung, the valid and the fine pixels in one sum
    # (counts: exact in any order)
    inl = (res[:, None] < ladder[None, :]) & valid[:, None]   # (P, n_r)
    sums = _Segments(flat, n_labels).sum(
        torch.cat([inl, valid[:, None], fine[:, None]], 1).float())
    k_r = sums[:, :n_r].T                                    # (n_r, L)
    n_seg = sums[:, n_r]
    n_null = torch.clamp_min(valid_null.float().sum(), 1.0)
    alpha = (((res_null[None, :] < ladder[:, None])
              & valid_null[None, :]).sum(dim=1) / n_null)   # (n_r,)

    def log_c(n, k):
        return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
                - torch.lgamma(torch.clamp_min(n - k, 0.0) + 1.0))

    log_alpha = torch.log(torch.clamp(alpha, 1e-12, 1.0))
    nfa = (float(np.log(n_r))
           + log_c(n_seg[None], k_r) + log_c(k_r, torch.full_like(
               k_r, float(m)))
           + (k_r - m) * log_alpha[:, None])              # (n_r, L)
    nfa = torch.where(k_r > m, nfa, float("inf"))
    log_nfa = nfa.min(dim=0).values
    fine_frac = sums[:, n_r + 1] / torch.clamp_min(n_seg, 1.0)
    return log_nfa, fine_frac


def ransac_draws(generator: torch.Generator, h: int, w: int,
                 n_hyps: int = 64, radius: int = 12
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC's random draws on the generator's device: ``n_hyps`` anchor
    pixels (flat indices in [0, h*w)) and, per hypothesis, two (dy, dx)
    offsets in [-radius, radius] (K, 2, 2)."""
    dev = generator.device
    anchor = torch.randint(0, h * w, (n_hyps,), generator=generator,
                           device=dev)
    offs = torch.randint(-radius, radius + 1, (n_hyps, 2, 2),
                         generator=generator, device=dev)
    return anchor, offs


def ransac_segment_planes(draws: Tuple[torch.Tensor, torch.Tensor],
                          labels: torch.Tensor, depth: torch.Tensor,
                          n_labels: int, epsilon=0.01
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """RANSAC plane per segment (the replacement for the reference's CGAL
    Efficient_RANSAC in GenerateDepthPrior / GenerateSuperDepthPrior,
    SceneDensify.cpp:1171-1950) from ``draws`` = (anchor (K,), offsets
    (K, 2, 2)), as ``ransac_draws`` makes them.

    Hypothesis k is the plane through its anchor and the two offset
    pixels (clamped to the image); it is valid if all three share the
    anchor's segment, carry depth and are not collinear.  It scores the
    inliers (|1/depth - plane| < ``epsilon``) of its segment, and each
    segment keeps its best valid hypothesis (the lowest index on a tie).

    Returns (planes (L, 3), inlier_frac (L,), count (L,)).
    """
    anchor, offs = draws
    h, w = depth.shape
    dev = depth.device
    n_hyps = anchor.shape[0]
    flat_lbl = labels.reshape(-1)
    z_flat = 1.0 / torch.clamp_min(depth.reshape(-1), 1e-9)
    valid_flat = depth.reshape(-1) > 0
    yy, xx = _pixel_grid(h, w, dev)
    u_flat = xx.reshape(-1)
    v_flat = yy.reshape(-1)

    anchor = anchor.to(dev).long()
    offs = offs.to(dev).long()
    py = torch.clamp((anchor // w)[:, None] + offs[:, :, 0], 0, h - 1)
    px = torch.clamp((anchor % w)[:, None] + offs[:, :, 1], 0, w - 1)
    idx = torch.cat([anchor[:, None], py * w + px], dim=1)       # (K, 3)

    seg = flat_lbl[idx[:, 0]]
    same = ((flat_lbl[idx[:, 1]] == seg) & (flat_lbl[idx[:, 2]] == seg)
            & valid_flat[idx].all(dim=1))
    # the plane through the three samples: [u v 1] p = 1/d
    A = torch.stack([u_flat[idx], v_flat[idx],
                     torch.ones_like(u_flat[idx])], dim=-1)     # (K, 3, 3)
    det_ok = torch.abs(torch.linalg.det(A)) > 1e-6
    A_safe = torch.where(det_ok[:, None, None], A,
                         torch.eye(3, device=dev)[None])
    hyp_planes = torch.linalg.solve_ex(A_safe, z_flat[idx][..., None])[0][..., 0]
    hyp_valid = same & det_ok

    # masked inlier counting: (K, P) residuals restricted to the segment
    pred = (hyp_planes[:, 0:1] * u_flat[None] + hyp_planes[:, 1:2]
            * v_flat[None] + hyp_planes[:, 2:3])                 # (K, P)
    in_seg = (flat_lbl[None] == seg[:, None]) & valid_flat[None]
    inl = (torch.abs(z_flat[None] - pred) < epsilon) & in_seg
    del pred, in_seg
    score = torch.where(hyp_valid, inl.sum(dim=1, dtype=torch.int32), -1)
    del inl

    # each segment's best hypothesis, ties to the lowest index
    best = _segment_extreme(score, seg, n_labels, "amax")        # (L,)
    is_best = hyp_valid & (score == best[seg]) & (score > 0)
    hyp_ids = torch.arange(n_hyps, dtype=torch.int32, device=dev)
    win = _segment_extreme(torch.where(is_best, hyp_ids, n_hyps), seg,
                           n_labels, "amin")                     # (L,)
    has_plane = win < n_hyps
    planes = torch.where(has_plane[:, None],
                         hyp_planes[torch.clamp_max(win, n_hyps - 1).long()],
                         0.0)

    # the winning plane's statistics over its segment
    inl_seg = ((torch.abs(z_flat - _plane_pred(planes, flat_lbl, u_flat,
                                                v_flat)) < epsilon)
               & valid_flat)
    cnt, icnt = _Segments(flat_lbl, n_labels).sum(
        torch.stack([valid_flat, inl_seg], 1).float()).unbind(1)
    frac = torch.where(has_plane, icnt / torch.clamp_min(cnt, 1.0), 0.0)
    return planes, frac, cnt


def generate_priors(gray: torch.Tensor, depth: torch.Tensor,
                    grid_step: int = 16,
                    semantic: Optional[torch.Tensor] = None,
                    n_semantic_labels: int = 0,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    epsilon_mul: float = 1.4,
                    min_points_div: float = 40.0,
                    probability: float = 0.005,
                    nfa_gate: bool = True) -> torch.Tensor:
    """The prior pass of one view (GenerateSuperDepthPrior +
    GenerateDepthPrior + GenerateFinalPrior): superpixels on the image,
    robust planes on the current depth, prior depth where planes are
    trustworthy.  With a ``semantic`` label map (the reference's
    nUseSemantic masks), RANSAC planes per semantic region, from
    ``draws`` (default: ``ransac_draws`` of a generator seeded 0), win
    over the superpixel prior where they are valid.

    Thresholds follow the reference's a-contrario discipline
    (AutoEstimator.h:230, SceneDensify.cpp:1350-1375): every inlier
    threshold is the measured spacing times ``epsilon_mul``
    (fransacEpsilonMul), a plane needs ``count / min_points_div`` inliers
    (fransacMinPointsDiv), the hypothesis count follows ``probability``
    (ransacprobability), and with ``nfa_gate`` a plane must be
    NFA-significant (log NFA < 0) or fit finely before it may feed the
    prior.  Returns the (H, W) prior depth (0 = none).
    """
    h, w = gray.shape
    n_sp = max(h // grid_step, 1) * max(w // grid_step, 1)
    spacing = inv_depth_spacing(depth)
    eps = spacing * epsilon_mul
    labels = slic_superpixels(gray, grid_step)
    planes, frac, cnt = fit_segment_planes(labels, depth, n_sp, tukey_c=eps)
    if nfa_gate:
        log_nfa, fine = segment_plane_nfa(labels, depth, planes, n_sp,
                                          spacing)
        frac = torch.where((log_nfa < 0.0) | (fine >= 0.9), frac, 0.0)
    # fransacMinPointsDiv: a segment plane needs >= count/div inliers
    frac = torch.where(frac * cnt >= cnt / min_points_div, frac, 0.0)
    prior = prior_depth_map(labels, planes, frac, cnt)
    if semantic is not None and n_semantic_labels > 0:
        if draws is None:
            gen = torch.Generator(device=depth.device).manual_seed(0)
            draws = ransac_draws(gen, h, w,
                                 hyps_from_probability(probability))
        sp, sf, sc = ransac_segment_planes(draws, semantic, depth,
                                           n_semantic_labels, epsilon=eps)
        if nfa_gate:
            s_nfa, s_fine = segment_plane_nfa(semantic, depth, sp,
                                              n_semantic_labels, spacing)
            sf = torch.where((s_nfa < 0.0) | (s_fine >= 0.9), sf, 0.0)
        sem_prior = prior_depth_map(semantic, sp, sf, sc, min_support=100,
                                    min_inlier_frac=0.5)
        prior = torch.where(sem_prior > 0, sem_prior, prior)
    return prior


def merge_final_prior(ext_prior: torch.Tensor,
                      super_prior: torch.Tensor) -> torch.Tensor:
    """GenerateFinalPrior's merge of the external prior channel (the
    meanshift maps) with the superpixel/semantic one (ref:
    SceneDensify.cpp:1129-1146): the external prior wins where it is
    nonzero, the superpixel prior fills the rest, 0 where both are 0."""
    return torch.where(ext_prior > 0, ext_prior,
                       torch.where(super_prior > 0, super_prior, 0.0))
