"""Perspective-n-Point: camera pose from 2D-3D correspondences (PyTorch
port of ``hcmvs_tpu/sfm/pnp.py``).

Used by the incremental SfM loop to register new views (the reference
delegates this to OpenMVG's resectioning inside IncrementalSfM).  Batched
DLT hypotheses + reprojection-inlier scoring, then Gauss-Newton polish on
the winner; the (n_hyp, 6) samples come from the caller
(``two_view.draw_samples`` or another source's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hcmvs_tpu_torch.sfm.ba import rodrigues, solve


class PnPResult(NamedTuple):
    R: torch.Tensor         # (3, 3) world->cam
    t: torch.Tensor         # (3,)
    inliers: torch.Tensor   # (N,)
    n_inliers: torch.Tensor


def _dlt_pose(X: torch.Tensor, uv_norm: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P from (..., n >= 6) correspondences (normalized image coords);
    returns R (..., 3, 3), t (..., 3)."""
    zeros = torch.zeros(X.shape[:-1] + (4,), device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    rows1 = torch.cat([Xh, zeros, -uv_norm[..., :1] * Xh], dim=-1)
    rows2 = torch.cat([zeros, Xh, -uv_norm[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)               # (..., 2n, 12)
    vt = torch.linalg.svd(A, full_matrices=False).Vh
    P = vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    M = P[..., :3]
    # orthogonalize M -> R via SVD; fix scale/sign
    u, s, vtm = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(u @ vtm))
    ones = torch.ones_like(d)
    R = u @ torch.diag_embed(torch.stack([ones, ones, ones], -1)
                             * d[..., None]) @ vtm
    scale = d * 3.0 / torch.clamp_min(s.sum(-1), 1e-12)
    t = P[..., 3] * scale[..., None]
    return R, t


def _reproj_err(R, t, X, uv_norm):
    """(..., N) squared reprojection errors, +inf behind the camera."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    proj = Xc[..., :2] / z[..., None]
    err = torch.sum((proj - uv_norm) ** 2, dim=-1)
    return torch.where(Xc[..., 2] > 0, err, torch.inf)


def _polish_residuals(params, R, t, X, uv_norm, w):
    Rp = rodrigues(params[:3]) @ R
    tp = t + params[3:]
    Xc = X @ Rp.T + tp
    z = torch.where(torch.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    proj = Xc[:, :2] / z[:, None]
    return ((proj - uv_norm) * w[:, None]).reshape(-1)


_polish_jac = torch.func.jacfwd(_polish_residuals)


def ransac_pnp(idx: torch.Tensor, X: torch.Tensor, uv_norm: torch.Tensor,
               valid: torch.Tensor, threshold: float = 1e-5,
               n_refine: int = 8) -> PnPResult:
    """idx: (n_hyp, 6) sample indices; X: (N, 3) world points; uv_norm:
    (N, 2) normalized image coords; valid: (N,) mask.

    LO-RANSAC flavor: hypotheses are selected with a truncated robust cost
    at a wide (9x) gate, then GN-polished with a shrinking inlier gate
    (9x -> 6x -> 4x -> 2x -> 1x), as the JAX package."""
    Rs, ts = _dlt_pose(X[idx], uv_norm[idx])
    thr = torch.tensor(threshold, dtype=torch.float32, device=X.device)
    wide = 9.0 * thr
    e = _reproj_err(Rs, ts, X, uv_norm)
    costs = torch.sum(torch.minimum(e, wide) * valid, dim=-1)
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    best = torch.argmin(costs)
    R, t = Rs[best], ts[best]
    eye6 = torch.eye(6, dtype=torch.float32, device=X.device)

    for gate in (wide, 6.0 * thr, 4.0 * thr, 2.0 * thr, thr):
        w = ((_reproj_err(R, t, X, uv_norm) < gate) & valid).to(torch.float32)
        params = torch.zeros(6, device=X.device)
        for _ in range(n_refine):
            r = _polish_residuals(params, R, t, X, uv_norm, w)
            J = _polish_jac(params, R, t, X, uv_norm, w)
            JtJ = J.T @ J + 1e-9 * eye6
            params = params - solve(JtJ, J.T @ r)
        R, t = rodrigues(params[:3]) @ R, t + params[3:]
    inliers = (_reproj_err(R, t, X, uv_norm) < thr) & valid
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=inliers.sum())
