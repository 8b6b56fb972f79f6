"""Pose-quality evaluation harness (PyTorch port of
``hcmvs_tpu/eval/pose_eval.py``).

The analog of the reference's MvgOptimizeSfM.py (ref:
frame_main/MvgOptimizeSfM.py:69-77 -- export poses, re-run SfM structure
from the known poses, openMVG_main_evalQuality ATE-style comparison):

- ``umeyama_align`` / ``ate``: similarity-aligned absolute trajectory
  error between estimated and reference camera centres (SfM is
  gauge-free, so comparison is up to a 7-DoF similarity).
- ``structure_from_known_poses``: hold the poses fixed and polish the
  points only -- the reprojection RMS under frozen poses measures pose
  quality independent of the original structure.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Similarity (s, R, t) minimizing ||s R src + t - dst||."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(xs.T @ xd)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = (U @ D @ Vt).T
    scale = (S * np.diag(D)).sum() / max((xs ** 2).sum(), 1e-12)
    t = mu_d - scale * R @ mu_s
    return float(scale), R, t


def ate(est_centers: np.ndarray, gt_centers: np.ndarray) -> Dict:
    """Absolute trajectory error after similarity alignment."""
    s, R, t = umeyama_align(est_centers, gt_centers)
    aligned = (s * (R @ est_centers.T)).T + t
    err = np.linalg.norm(aligned - gt_centers, axis=1)
    return {"rmse": float(np.sqrt((err ** 2).mean())),
            "mean": float(err.mean()), "max": float(err.max()),
            "scale": s}


def structure_from_known_poses(result, K: np.ndarray, n_iters: int = 10,
                               device="cuda") -> float:
    """Points-only BA under frozen poses; returns the reprojection RMS in
    pixels (the evalQuality harness core)."""
    import torch
    from hcmvs_tpu_torch.sfm.ba import (BAState, build_problem,
                                        rotation_to_rvec, run_ba)
    reg = sorted(result.poses)
    cam_of = {img: c for c, img in enumerate(reg)}
    obs_cam, obs_pt, obs_uv = [], [], []
    for tid, obs in enumerate(result.track_obs):
        for img, kp in obs:
            if img in cam_of:
                obs_cam.append(cam_of[img])
                obs_pt.append(tid)
                obs_uv.append(result.keypoints[img][kp])
    Ks = np.tile(np.asarray(K)[None], (len(reg), 1, 1))
    # every camera fixed: only points move
    problem = build_problem(Ks, obs_cam, obs_pt, obs_uv,
                            len(result.points),
                            fixed_cams=[True] * len(reg), device=device)
    rvecs, tvecs = [], []
    for img in reg:
        R, C = result.poses[img]
        rvecs.append(rotation_to_rvec(R))
        tvecs.append(-R @ C)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    state = BAState(rvecs=f32(np.stack(rvecs)), tvecs=f32(np.stack(tvecs)),
                    points=f32(result.points))
    state, cost = run_ba(problem, state, n_iters=n_iters)
    return float(np.sqrt(float(cost) / max(len(obs_cam), 1)))
