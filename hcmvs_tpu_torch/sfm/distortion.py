"""Brown radial lens-distortion model for the real-photo SfM frontend
(PyTorch port of ``hcmvs_tpu/sfm/distortion.py``).

The reference pipeline starts from photographs: OpenMVG seeds intrinsics
from EXIF (ref: frame_main/MvgMvsPipeline.py:181-183) with a radial-K3
camera model, refines the distortion inside bundle adjustment, and
undistorts the images at `.mvs` export so the MVS stage sees pinhole
cameras (ref: MvgMvsPipeline.py:208-210; OpenMVS's camera model is
distortion-free, Camera.h).

The model acts in normalized camera coordinates,
  x_d = x_n * (1 + k1 r^2 + k2 r^4 + k3 r^6),   r^2 = |x_n|^2
with the inverse solved by a fixed-count Newton iteration.  Estimation
alternates with the pose/point bundle (sfm/ba.py): a k1 grid search with
re-bundling, then geometry-fixed Gauss-Newton on (k1, k2) and a re-bundle,
twice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


def distort_normalized(xn: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Apply Brown radial distortion to (..., 2) normalized coords."""
    r2 = torch.sum(xn ** 2, dim=-1, keepdim=True)
    factor = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    return xn * factor


def undistort_normalized(xd: torch.Tensor, k: torch.Tensor,
                         n_iters: int = 8) -> torch.Tensor:
    """Invert the radial model by Newton on the scalar radius: with
    s = |x_n|, solve s (1 + k1 s^2 + k2 s^4 + k3 s^6) = |x_d| per point;
    the direction of x_n equals x_d's."""
    rd = torch.linalg.norm(xd, dim=-1, keepdim=True)
    s = rd
    for _ in range(n_iters):
        s2 = s * s
        g = s * (1.0 + s2 * (k[0] + s2 * (k[1] + s2 * k[2])))
        dg = 1.0 + s2 * (3.0 * k[0] + s2 * (5.0 * k[1] + s2 * 7.0 * k[2]))
        s = s - (g - rd) / torch.where(torch.abs(dg) < 1e-6, 1e-6, dg)
    scale = torch.where(rd > 1e-12, s / torch.clamp_min(rd, 1e-12), 1.0)
    return xd * scale


def _focal_centre(K: torch.Tensor):
    return (torch.stack([K[0, 0], K[1, 1]]), torch.stack([K[0, 2], K[1, 2]]))


def distort_points_px(uv: torch.Tensor, K: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """Ideal pixel coords -> observed (distorted) pixel coords."""
    f, c = _focal_centre(K)
    return distort_normalized((uv - c) / f, k) * f + c


def undistort_points_px(uv: torch.Tensor, K: torch.Tensor, k: torch.Tensor,
                        n_iters: int = 8) -> torch.Tensor:
    """Observed (distorted) pixel coords -> ideal pinhole pixel coords."""
    f, c = _focal_centre(K)
    return undistort_normalized((uv - c) / f, k, n_iters) * f + c


def _undistort_plane(img: torch.Tensor, K: torch.Tensor,
                     k: torch.Tensor) -> torch.Tensor:
    """Resample a distorted (H, W) image onto the pinhole grid: the output
    pixel at ideal coords p samples the input at distort(p); outside the
    input it is 0."""
    h, w = img.shape
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    uv = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
    src = distort_points_px(uv, K, k).reshape(h, w, 2)
    x, y = src[..., 0], src[..., 1]
    # the floor truncated to int32, then clipped, as the JAX package
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2).long()
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2).long()
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    out = ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
           + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)
    inside = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))
    return torch.where(inside, out, 0.0)


def undistort_image(img: np.ndarray, K: np.ndarray, k: np.ndarray,
                    device="cuda") -> np.ndarray:
    """Host wrapper: undistort a (H, W) grayscale or (H, W, C) image on
    ``device``, channel by channel."""
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=device)
    kt = torch.as_tensor(np.asarray(k, np.float32), device=device)

    def plane(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return _undistort_plane(t, Kt, kt).cpu().numpy()

    if img.ndim == 2:
        return plane(img).astype(img.dtype)
    return np.stack([plane(img[..., c]) for c in range(img.shape[-1])],
                    axis=-1).astype(img.dtype)


def _fit_k(xn_proj: torch.Tensor, xd_obs: torch.Tensor, valid: torch.Tensor,
           k0: torch.Tensor, n_iters: int = 10,
           n_coeffs: int = 2) -> torch.Tensor:
    """Gauss-Newton on the distortion coefficients with geometry fixed.

    ``xn_proj`` (M, 2): ideal normalized projections of the current points
    through the current poses; ``xd_obs`` (M, 2): observed (distorted)
    normalized feature coords.  Solves for k minimizing
    |distort(xn_proj; k) - xd_obs|^2 (linear in k per observation;
    iterations only re-weight, Huber-style); ``n_coeffs`` limits the
    model order, the higher coefficients stay 0."""
    from hcmvs_tpu_torch.sfm.ba import solve
    r2 = torch.sum(xn_proj ** 2, dim=-1, keepdim=True)     # (M, 1)
    r4 = r2 * r2
    basis = torch.cat([xn_proj * r2, xn_proj * r4,
                       xn_proj * (r2 * r4)], dim=-1)        # (M, 6) paired
    A = basis.reshape(-1, 3, 2).transpose(1, 2).reshape(-1, 3)  # (2M, 3)
    b = (xd_obs - xn_proj).reshape(-1)                      # (2M,)
    wv = torch.repeat_interleave(valid.to(torch.float32), 2)
    eye = torch.eye(3, device=A.device)
    mask = torch.arange(3, device=A.device) < n_coeffs
    k = k0
    for _ in range(n_iters):
        res = A @ k - b
        w = wv * torch.clamp_max(5e-3 / torch.clamp_min(torch.abs(res), 1e-9),
                                 1.0)
        AtA = (A * w[:, None]).T @ A + 1e-9 * eye
        Atb = (A * w[:, None]).T @ b
        # freeze unused higher-order coefficients at zero
        AtA = torch.where(mask[:, None] & mask[None, :], AtA,
                          eye * 1.0 + 0.0 * AtA)
        Atb = torch.where(mask, Atb, 0.0)
        k = solve(AtA, Atb)
    return k


def estimate_distortion(result, K: np.ndarray, n_coeffs: int = 2,
                        device="cuda") -> np.ndarray:
    """Fit Brown radial coefficients from an SfM result's raw (distorted)
    observations with poses/points fixed (the alternation half-step).
    Returns k (3,) float32 (unused orders zero)."""
    obs_xn, obs_xd = [], []
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    for tid, obs in enumerate(result.track_obs):
        X = result.points[tid]
        for (img, kp) in obs:
            if img not in result.poses:
                continue
            R, C = result.poses[img]
            Xc = R @ (X - C)
            if Xc[2] <= 1e-6:
                continue
            obs_xn.append(Xc[:2] / Xc[2])
            obs_xd.append((result.keypoints[img][kp] - c) / f)
    if len(obs_xn) < 50:
        return np.zeros(3, np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    k = _fit_k(f32(np.stack(obs_xn)), f32(np.stack(obs_xd)),
               torch.ones(len(obs_xn), dtype=torch.bool, device=device),
               f32(np.zeros(3)), n_coeffs=n_coeffs)
    return k.cpu().numpy()


def _rebundle(cur, raw_xy: List[np.ndarray], K: np.ndarray,
              k: np.ndarray, n_iters: int = 15, device="cuda"):
    """Re-run the pose/point bundle under distortion model ``k``, with the
    residual distortion-aware against the RAW observations, so the RMS is
    comparable across models.  Returns (result', rms_px) with
    result'.keypoints undistorted for the downstream pinhole stages."""
    from hcmvs_tpu_torch.sfm.ba import (BAState, build_problem, rodrigues,
                                        rotation_to_rvec, run_ba)
    reg = sorted(cur.poses)
    cam_of = {img: ci for ci, img in enumerate(reg)}
    obs_cam, obs_pt, obs_uv = [], [], []
    for tid, obs in enumerate(cur.track_obs):
        for (img, kp) in obs:
            if img in cam_of:
                obs_cam.append(cam_of[img])
                obs_pt.append(tid)
                obs_uv.append(raw_xy[img][kp])
    Ks = np.tile(K[None], (len(reg), 1, 1))
    problem = build_problem(Ks, obs_cam, obs_pt, obs_uv, len(cur.points),
                            fixed_cams=[ci == 0 for ci in range(len(reg))],
                            dist=k, device=device)
    rvecs = np.stack([rotation_to_rvec(cur.poses[img][0]) for img in reg])
    # poses stored as (R, C); BA state wants t = -R C
    tvecs = np.stack([-cur.poses[img][0] @ cur.poses[img][1]
                      for img in reg])

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    state = BAState(rvecs=f32(rvecs), tvecs=f32(tvecs),
                    points=f32(cur.points))
    state, cost = run_ba(problem, state, n_iters)
    Rn = rodrigues(state.rvecs).cpu().numpy()
    tn = state.tvecs.cpu().numpy()
    poses = {img: (Rn[ci], -Rn[ci].T @ tn[ci]) for ci, img in enumerate(reg)}
    rms = float(np.sqrt(cost / max(len(obs_cam), 1)))
    Kt, kt = f32(K), f32(k)
    xy_u = [undistort_points_px(f32(x), Kt, kt).cpu().numpy()
            for x in raw_xy]
    return dataclasses.replace(cur, poses=poses,
                               points=state.points.cpu().numpy(),
                               keypoints=xy_u, reproj_rms=rms), rms


# k1 candidates for the bootstrap line search (photographic barrel /
# pincushion range)
K1_GRID = (-0.30, -0.20, -0.12, -0.06, 0.0, 0.06, 0.12, 0.20, 0.30)


def refine_with_distortion(result, K: np.ndarray, cfg=None,
                           n_rounds: int = 2, n_coeffs: int = 2,
                           k1_grid=K1_GRID, verbose: bool = False,
                           device="cuda") -> Tuple[object, np.ndarray]:
    """Estimate radial distortion jointly with the bundle.

    1. k1 line search with re-bundling: re-bundle under each candidate k1
       and keep the lowest raw-space RMS (distortion cannot be absorbed
       consistently across views with parallax).
    2. Alternation from the winner: geometry-fixed GN fit of (k1, k2) ->
       re-bundle, ``n_rounds`` times (the analog of OpenMVG refining
       radial K3 inside BA, ref: MvgMvsPipeline.py:190-192).
    A model that improves the RMS by less than 0.5% over pinhole is
    dropped (warping with it would only add resampling error).

    Returns (result_undistorted, k): keypoints replaced by their
    undistorted coordinates, poses/points re-bundled.
    """
    del cfg
    raw_xy = [np.asarray(x) for x in result.keypoints]
    best_k1, best_rms, best_res = 0.0, np.inf, result
    rms_zero = None
    for k1 in k1_grid:
        cand, rms = _rebundle(result, raw_xy, K,
                              np.array([k1, 0.0, 0.0], np.float32),
                              n_iters=12, device=device)
        if verbose:
            print(f"[distortion] grid k1={k1:+.2f}: rms {rms:.4f}px")
        if k1 == 0.0:
            rms_zero = rms
        if rms < best_rms:
            best_k1, best_rms, best_res = k1, rms, cand
    cur = best_res
    k = np.array([best_k1, 0.0, 0.0], np.float32)
    for rnd in range(n_rounds):
        k = estimate_distortion(dataclasses.replace(cur, keypoints=raw_xy),
                                K, n_coeffs, device=device)
        cur, rms = _rebundle(cur, raw_xy, K, k, n_iters=15, device=device)
        if verbose:
            print(f"[distortion] round {rnd}: k = {k}, rms {rms:.4f}px")
    if rms_zero is not None and rms > rms_zero * (1.0 - 0.005):
        if verbose:
            print(f"[distortion] improvement {rms_zero:.4f} -> "
                  f"{rms:.4f}px below the 0.5% gate; keeping pinhole")
        cur, _ = _rebundle(result, raw_xy, K, np.zeros(3, np.float32),
                           n_iters=15, device=device)
        return cur, np.zeros(3, np.float32)
    return cur, k
