"""Two-view geometry: essential-matrix RANSAC + pose recovery (PyTorch port
of ``hcmvs_tpu/sfm/two_view.py``).

Replaces OpenMVG's robust relative-pose estimation (driven from
frame_main/MvgMvsPipeline.py:190-192 IncrementalSfM): all RANSAC
hypotheses are solved at once -- a batch of 8-point problems (batched
SVD) scored by vectorized Sampson distances.

Draws are split from their use: ``draw_samples`` picks each hypothesis's
minimal sample from a ``torch.Generator`` (uniformly among the valid
slots), and ``ransac_essential`` / ``ransac_homography`` take the
(n_hyp, m) indices, so a caller (or a test) can feed another source's
draws.  Ties in a ranking break towards the lower index, as JAX's
``top_k`` and ``argmax``: rankings use a stable sort.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.sfm.features import top_desc

# (valid (N,) bool, n_hyp, m) -> (n_hyp, m) int64 sample indices
Sampler = Callable[[torch.Tensor, int, int], torch.Tensor]


class TwoViewResult(NamedTuple):
    E: torch.Tensor          # (3, 3) best essential matrix
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # scalar
    R: torch.Tensor          # (3, 3) relative rotation (cam1 <- cam0 frame)
    t: torch.Tensor          # (3,) unit translation
    threshold: torch.Tensor  # realized squared-Sampson inlier threshold


class HomographyResult(NamedTuple):
    H: torch.Tensor           # (3, 3)
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # scalar


def draw_samples(gen: torch.Generator, valid: torch.Tensor, n_hyp: int,
                 m: int) -> torch.Tensor:
    """(n_hyp, m) indices drawn uniformly (with replacement) among the
    valid slots, on the generator's device."""
    idx = torch.nonzero(valid.to(gen.device)).reshape(-1)
    pick = torch.randint(len(idx), (n_hyp, m), generator=gen,
                         device=gen.device)
    return idx[pick]


def generator_sampler(gen: torch.Generator) -> Sampler:
    """The default sampler: every call draws from ``gen``."""
    return lambda valid, n_hyp, m: draw_samples(gen, valid, n_hyp, m)


def _null_vector(A: torch.Tensor, full: bool = True) -> torch.Tensor:
    return torch.linalg.svd(A, full_matrices=full).Vh[..., -1, :]


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Onto the essential manifold: singular values (s, s, 0)."""
    u, s, vt = torch.linalg.svd(E)
    s_mean = (s[..., 0] + s[..., 1]) / 2
    d = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return u @ torch.diag_embed(d) @ vt


def _epipolar_rows(pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    x0, y0 = pts0[..., 0], pts0[..., 1]
    x1, y1 = pts1[..., 0], pts1[..., 1]
    ones = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, ones], dim=-1)


def _eight_point(pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """Essential matrices from (..., 8, 2) normalized correspondences."""
    e = _null_vector(_epipolar_rows(pts0, pts1))
    return _project_essential(e.reshape(e.shape[:-1] + (3, 3)))


def _homog(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def sampson_distance(E: torch.Tensor, pts0: torch.Tensor,
                     pts1: torch.Tensor) -> torch.Tensor:
    """(..., N) squared Sampson distances in normalized coords for
    (..., 3, 3) essential matrices."""
    p0 = _homog(pts0)
    p1 = _homog(pts1)
    Ep0 = p0 @ E.transpose(-1, -2)       # (..., N, 3): E @ p0
    Etp1 = p1 @ E                        # (..., N, 3): E^T @ p1
    num = torch.sum(p1 * Ep0, dim=-1) ** 2
    den = (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2
           + Etp1[..., 1] ** 2)
    return num / torch.clamp_min(den, 1e-12)


def skew3(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def ransac_essential(idx: torch.Tensor, pts0: torch.Tensor,
                     pts1: torch.Tensor, valid: torch.Tensor,
                     threshold: float = 1e-5, adaptive: bool = True,
                     alpha0: float = 2.83) -> TwoViewResult:
    """Batched-hypothesis RANSAC for E on normalized correspondences.

    idx: (n_hyp, 8) sample indices (``draw_samples``); pts0/pts1: (N, 2)
    normalized coords; valid: (N,) mask (padded slots).  ``threshold`` is
    on squared Sampson distance in normalized units.  ``adaptive``:
    a-contrario (AC-RANSAC/ORSA) mode -- hypotheses are ranked by log-NFA
    and the threshold becomes the data-driven r_k* of the best model,
    floored at ``threshold`` (sfm/acransac.py; the JAX package's reasons).
    """
    from hcmvs_tpu_torch.sfm.acransac import nfa_threshold_batch
    Es = _eight_point(pts0[idx], pts1[idx])               # (H, 3, 3)
    thr = _f32(threshold, pts0)
    if adaptive:
        ds = sampson_distance(Es, pts0, pts1)
        log_nfa, thr2, _ = nfa_threshold_batch(ds, valid, m=8, alpha0=alpha0)
        thr = torch.maximum(thr2[torch.argmin(log_nfa)], thr)
        counts = -log_nfa
    else:
        d = sampson_distance(Es, pts0, pts1)
        counts = ((d < thr) & valid).sum(-1)

    # Sampson inlier count alone cannot discriminate low-parallax twins:
    # take the top candidates, GN-refine each from its own recovered t and
    # from 13 translation-direction restarts, and select by the refined
    # robust Sampson cost (the JAX package's reasons)
    n_top = 4
    top_idx = top_desc(counts, n_top)
    cap = 4.0 * thr
    t_seeds = torch.tensor(np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
         [0, 1, 1], [0, 1, -1], [1, 1, 1], [1, -1, 1],
         [-1, 1, 1], [-1, -1, 1]], np.float32), device=pts0.device)
    t_seeds = t_seeds / torch.linalg.norm(t_seeds, dim=1, keepdim=True)
    own = torch.full((1, 3), torch.nan, device=pts0.device)
    seeds = torch.cat([own, t_seeds])                     # (S, 3)
    cand_E = torch.repeat_interleave(Es[top_idx], seeds.shape[0], dim=0)
    cand_seed = seeds.repeat(n_top, 1)

    inl0 = (sampson_distance(cand_E, pts0, pts1) < thr) & valid
    R0, t0 = recover_pose(cand_E, pts0, pts1, inl0)
    t_init = torch.where(torch.isnan(cand_seed[:, :1]), t0, cand_seed)
    R1, t1 = refine_pose(R0, t_init, pts0, pts1, inl0, n_iters=6)
    d = sampson_distance(skew3(t1) @ R1, pts0, pts1)
    costs = torch.sum(torch.minimum(d, cap) * valid, dim=-1)
    best = torch.argmin(costs)
    R, t = R1[best], t1[best]
    E = skew3(t) @ R
    inliers = (sampson_distance(E, pts0, pts1) < thr) & valid

    # seeded t directions carry no cheirality: re-derive (R, t) from the
    # winning E with the positive-depth test, then polish
    R, t = recover_pose(E, pts0, pts1, inliers)
    R, t = refine_pose(R, t, pts0, pts1, inliers)
    E = skew3(t) @ R
    inliers = (sampson_distance(E, pts0, pts1) < thr) & valid
    R, t = recover_pose(E, pts0, pts1, inliers)
    return TwoViewResult(E=E, inliers=inliers, n_inliers=inliers.sum(),
                         R=R, t=t, threshold=thr)


def _refine_residuals(params, R0, t0, wf, pts0, pts1):
    """One pose's weighted Sampson residuals (N,) over the local chart
    (rvec, dt); reductions keep a dimension (see ``ba.rodrigues``)."""
    from hcmvs_tpu_torch.sfm.ba import rodrigues
    R = rodrigues(params[:3]) @ R0
    t = t0 + params[3:]
    t = t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True),
                            1e-9)
    d2 = sampson_distance(skew3(t) @ R, pts0, pts1)
    return torch.sqrt(torch.clamp_min(d2, 1e-18)) * wf


_refine_jac = torch.func.vmap(torch.func.jacfwd(_refine_residuals),
                              in_dims=(0, 0, 0, 0, None, None))
_refine_res = torch.func.vmap(_refine_residuals,
                              in_dims=(0, 0, 0, 0, None, None))


def refine_pose(R0: torch.Tensor, t0: torch.Tensor, pts0: torch.Tensor,
                pts1: torch.Tensor, w: torch.Tensor, n_iters: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize weighted Sampson error over a local (rvec, dt) chart, for
    (..., 3, 3) / (..., 3) poses with (..., N) weights."""
    from hcmvs_tpu_torch.sfm.ba import rodrigues, solve
    batch = R0.shape[:-2]
    R0 = R0.reshape(-1, 3, 3)
    t0 = t0.reshape(-1, 3)
    wf = w.reshape(-1, w.shape[-1]).to(torch.float32)
    args = (R0, t0, wf, pts0, pts1)
    eye6 = torch.eye(6, dtype=torch.float32, device=R0.device)

    def cost(p):
        return torch.sum(_refine_res(p, *args) ** 2, dim=-1)

    params = torch.zeros(R0.shape[0], 6, device=R0.device)
    for _ in range(n_iters):
        r = _refine_res(params, *args)                   # (B, N)
        J = _refine_jac(params, *args)                   # (B, N, 6)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * eye6
        step = solve(JtJ, (J.transpose(-1, -2)
                                        @ r[..., None])[..., 0])
        # backtracking: halve until the cost decreases (3 tries)
        c0 = cost(params)
        trial = params - step
        for _ in range(3):
            trial = torch.where((cost(trial) < c0)[:, None], trial,
                                params - (trial - params) * -0.5)
        params = torch.where((cost(trial) < c0)[:, None], trial, params)
    R = rodrigues(params[:, :3]) @ R0
    t = t0 + params[:, 3:]
    t = t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-9)
    return R.reshape(batch + (3, 3)), t.reshape(batch + (3,))


def triangulate_midpoint(R: torch.Tensor, t: torch.Tensor,
                         pts0: torch.Tensor, pts1: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DLT triangulation for relative poses (I|0), (R|t) of shape
    (..., 3, 3) / (..., 3) over (..., N, 2) correspondences (leading
    dimensions broadcast).

    Returns (X (..., N, 3) in cam0 frame, depth0 (..., N))."""
    P1 = torch.cat([R, t[..., None]], dim=-1)[..., None, :, :]  # (...,1,3,4)
    p0x, p0y = pts0[..., 0], pts0[..., 1]
    zero = torch.zeros_like(p0x)
    one = torch.ones_like(p0x)
    row0 = torch.stack([one, zero, -p0x, zero], dim=-1)
    row1 = torch.stack([zero, one, -p0y, zero], dim=-1)
    row2 = pts1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :]    # (..., N, 4)
    row3 = pts1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :]
    A = torch.stack(torch.broadcast_tensors(row0, row1, row2, row3), dim=-2)
    Xh = _null_vector(A)                                          # (..., N, 4)
    w = torch.where(torch.abs(Xh[..., 3]) < 1e-12, 1e-12, Xh[..., 3])
    X = Xh[..., :3] / w[..., None]
    return X, X[..., 2]


def recover_pose(E: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor,
                 inliers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, t) among the 4 decompositions of each (..., 3, 3) E with
    the most points in front of both cameras (first of the ties)."""
    u, _, vt = torch.linalg.svd(E)
    # ensure proper rotations
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t1 = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)             # (..., 4, 3, 3)
    ts = torch.stack([t1, -t1, t1, -t1], dim=-2)           # (..., 4, 3)
    X, z0 = triangulate_midpoint(Rs, ts, pts0, pts1)       # (..., 4, N, 3)
    z1 = (X @ Rs.transpose(-1, -2) + ts[..., None, :])[..., 2]
    counts = torch.sum((z0 > 0) & (z1 > 0) & inliers[..., None, :], dim=-1)
    best = torch.argmax(counts, dim=-1)                     # (...,)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, t


def _dlt_homography(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """(..., 4+, 2) point pairs -> (..., 3, 3) homographies (DLT)."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -ones, zeros, zeros, zeros,
                      u * x, u * y, u], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, -x, -y, -ones,
                      v * x, v * y, v], dim=-1)
    H = _null_vector(torch.cat([r1, r2], dim=-2))
    H = H.reshape(H.shape[:-1] + (3, 3))
    h22 = H[..., 2, 2]
    return H / torch.where(torch.abs(h22) < 1e-12, 1e-12,
                           h22)[..., None, None]


def homography_transfer_error(H: torch.Tensor, p0: torch.Tensor,
                              p1: torch.Tensor) -> torch.Tensor:
    """(..., N) squared forward transfer errors |H p0 - p1|^2."""
    q = p0 @ H[..., :, :2].transpose(-1, -2) + H[..., None, :, 2]
    z = torch.where(torch.abs(q[..., 2]) < 1e-12, 1e-12, q[..., 2])
    return torch.sum((q[..., :2] / z[..., None] - p1) ** 2, dim=-1)


def ransac_homography(idx: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                      valid: torch.Tensor, threshold: float = 2e-5
                      ) -> HomographyResult:
    """Batched 4-point homography RANSAC (normalized coordinates) for
    (n_hyp, 4) sample indices: the OpenMVG-style AUTO model selection
    (ref: MvgMvsPipeline.py:325-328): a pair whose matches a homography
    explains as well as E is planar / low-parallax."""
    Hs = _dlt_homography(p0[idx], p1[idx])
    errs = homography_transfer_error(Hs, p0, p1)
    inl = (errs < _f32(threshold, p0)) & valid[None]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    return HomographyResult(H=Hs[best], inliers=inl[best],
                            n_inliers=scores[best])
