"""Global SfM: rotation averaging + translation averaging + triangulation
(PyTorch port of ``hcmvs_tpu/sfm/global_sfm.py``).

The counterpart of the reference pipeline's GLOBAL preset
(ref: frame_main/MvgMvsPipeline.py:193-195 openMVG_main_GlobalSfM):

- pairwise relative poses from the batched essential-matrix RANSAC
  (sfm/two_view.py) over all candidate pairs, in sorted pair order, each
  drawing its samples from ``sampler`` (a ``torch.Generator`` seeded with
  0 by default);
- rotation averaging: chordal least squares with IRLS (host numpy, as in
  the JAX package);
- translation averaging: least squares on the cross-product constraints
  with the gauge fixed (C_0 = 0, summed baseline projection = m), IRLS;
- tracks by union-find over the matches, triangulated from their two
  widest-baseline observations, then the shared LM bundle adjustment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.sfm.incremental import (SfMConfig, SfMResult,
                                             _normalize, _tensors,
                                             compute_features_and_matches,
                                             default_sampler)
from hcmvs_tpu_torch.sfm.two_view import (Sampler, ransac_essential,
                                          triangulate_midpoint)
from hcmvs_tpu_torch.utils.profiling import stage_timer


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        U[:, -1] *= -1
        R = U @ Vt
    return R


def rotation_averaging(n: int, pairs: List[Tuple[int, int]],
                       R_rel: List[np.ndarray], n_irls: int = 4,
                       sigma: float = 0.1) -> np.ndarray:
    """Global rotations from pairwise R_ij (R_j = R_ij R_i), chordal LS
    with IRLS (Geman-McClure weights).  Returns (N, 3, 3) with R_0 = I."""
    m = len(pairs)
    w = np.ones(m)
    R = np.stack([np.eye(3)] * n)
    for _ in range(n_irls + 1):
        A = np.zeros((3 * m + 3, 3 * n))
        B = np.zeros((3 * m + 3, 3))
        for e, (i, j) in enumerate(pairs):
            sw = np.sqrt(w[e])
            A[3 * e:3 * e + 3, 3 * j:3 * j + 3] = sw * np.eye(3)
            A[3 * e:3 * e + 3, 3 * i:3 * i + 3] = -sw * R_rel[e]
        A[3 * m:, 0:3] = 10.0 * np.eye(3)
        B[3 * m:] = 10.0 * np.eye(3)
        X, *_ = np.linalg.lstsq(A, B, rcond=None)
        R = np.stack([_project_so3(X[3 * i:3 * i + 3]) for i in range(n)])
        for e, (i, j) in enumerate(pairs):
            r = np.linalg.norm(R[j] - R_rel[e] @ R[i]) / np.sqrt(8.0)
            w[e] = 1.0 / (1.0 + (r / sigma) ** 2) ** 2
    # re-gauge: R_0 exactly identity
    R0 = R[0].copy()
    return np.stack([Ri @ R0.T for Ri in R])


def translation_averaging(n: int, pairs: List[Tuple[int, int]],
                          R_glob: np.ndarray, t_rel: List[np.ndarray],
                          n_irls: int = 4, sigma: float = 0.05
                          ) -> np.ndarray:
    """Camera centres from pairwise translation directions: for pair
    (i, j), d_ij = -R_j^T t_ij and (C_j - C_i) x d_ij = 0; LS with gauge
    C_0 = 0 and the summed baseline projection fixed (scale), IRLS."""
    m = len(pairs)
    dirs = np.zeros((m, 3))
    for e, (i, j) in enumerate(pairs):
        d = -(R_glob[j].T @ t_rel[e])
        dirs[e] = d / max(np.linalg.norm(d), 1e-12)
    w = np.ones(m)
    C = np.zeros((n, 3))
    for _ in range(n_irls + 1):
        rows, rhs = [], []
        for e, (i, j) in enumerate(pairs):
            d = dirs[e]
            Dx = np.array([[0, -d[2], d[1]], [d[2], 0, -d[0]],
                           [-d[1], d[0], 0]])
            r = np.zeros((3, 3 * n))
            r[:, 3 * j:3 * j + 3] = Dx
            r[:, 3 * i:3 * i + 3] = -Dx
            rows.append(np.sqrt(w[e]) * r)
            rhs.append(np.zeros(3))
        g = np.zeros((3, 3 * n))
        g[:, 0:3] = 10.0 * np.eye(3)
        rows.append(g)
        rhs.append(np.zeros(3))
        s = np.zeros((1, 3 * n))
        for e, (i, j) in enumerate(pairs):
            s[0, 3 * j:3 * j + 3] += dirs[e]
            s[0, 3 * i:3 * i + 3] -= dirs[e]
        rows.append(s)
        rhs.append(np.array([float(m)]))
        X, *_ = np.linalg.lstsq(np.concatenate(rows), np.concatenate(rhs),
                                rcond=None)
        C = X.reshape(n, 3)
        for e, (i, j) in enumerate(pairs):
            b = C[j] - C[i]
            nb = np.linalg.norm(b)
            r = np.linalg.norm(np.cross(b / max(nb, 1e-9), dirs[e]))
            w[e] = 1.0 / (1.0 + (r / sigma) ** 2) ** 2
    return C


def _build_tracks(n: int, xy: List[np.ndarray],
                  pair_matches: Dict[Tuple[int, int], np.ndarray]):
    """Union-find over keypoint identities -> track lists (tracks that
    see an image twice are dropped)."""
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(a):
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i, j), pairs in pair_matches.items():
        for a, b in pairs:
            ra, rb = find((i, int(a))), find((j, int(b)))
            if ra != rb:
                parent[ra] = rb
    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for kp in list(parent.keys()):
        groups.setdefault(find(kp), []).append(kp)
    tracks = []
    for members in groups.values():
        imgs = [m[0] for m in members]
        if len(members) >= 2 and len(set(imgs)) == len(imgs):
            tracks.append(sorted(members))
    return tracks


def global_sfm(images: List[np.ndarray], K: np.ndarray,
               cfg: Optional[SfMConfig] = None, verbose: bool = False,
               sampler: Optional[Sampler] = None,
               device="cuda") -> SfMResult:
    cfg = cfg or SfMConfig()
    xy, _, pair_matches = compute_features_and_matches(images, cfg, device)
    return global_sfm_from_matches(xy, pair_matches, K, len(images), cfg,
                                   verbose, sampler=sampler, device=device)


def global_sfm_from_matches(xy: List[np.ndarray],
                            pair_matches: Dict[Tuple[int, int], np.ndarray],
                            K: np.ndarray, n: int,
                            cfg: Optional[SfMConfig] = None,
                            verbose: bool = False,
                            sampler: Optional[Sampler] = None,
                            device="cuda") -> SfMResult:
    """Relative poses on every pair, rotation + translation averaging,
    triangulated tracks and the final bundle (stages timed as
    ``sfm.relative_poses``, ``sfm.averaging``, ``sfm.tracks``,
    ``sfm.ba``)."""
    from hcmvs_tpu_torch.sfm.ba import (BAState, build_problem, rodrigues,
                                        rotation_to_rvec, run_ba)
    cfg = cfg or SfMConfig()
    dev = torch.device(device)
    sampler = sampler or default_sampler(dev)

    # 1. relative poses on every pair
    pairs, R_rel, t_rel = [], [], []
    with stage_timer("sfm.relative_poses", block_on=dev):
        for (i, j), pm in sorted(pair_matches.items()):
            p0 = _normalize(xy[i][pm[:, 0]], K).astype(np.float32)
            p1 = _normalize(xy[j][pm[:, 1]], K).astype(np.float32)
            p0, p1 = _tensors(dev, p0, p1)
            valid = torch.ones(len(p0), dtype=torch.bool, device=dev)
            res = ransac_essential(sampler(valid, 512, 8), p0, p1, valid,
                                   cfg.ransac_threshold,
                                   adaptive=cfg.adaptive_ransac)
            if int(res.n_inliers) < cfg.min_matches:
                continue
            pairs.append((i, j))
            R_rel.append(res.R.cpu().numpy())
            t_rel.append(res.t.cpu().numpy())
    if not pairs:
        raise ValueError("no pair passed two-view RANSAC")
    connected = sorted({i for p in pairs for i in p})
    if verbose:
        print(f"[gsfm] {len(pairs)} pairs over {len(connected)} cameras")

    # 2. rotation + translation averaging
    with stage_timer("sfm.averaging"):
        R_glob = rotation_averaging(n, pairs, R_rel)
        C_glob = translation_averaging(n, pairs, R_glob, t_rel)

    # 3. tracks + triangulation from the two widest-baseline observations
    # (one batch over the tracks; each track's point as the JAX package's
    # one-point call)
    points, track_obs = [], []
    with stage_timer("sfm.tracks", block_on=dev):
        tracks = _build_tracks(n, xy, pair_matches)
        firsts, Rs, ts, p0s, p1s = [], [], [], [], []
        for members in tracks:
            best, best_base = None, -1.0
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    i, j = members[a][0], members[b][0]
                    base = np.linalg.norm(C_glob[j] - C_glob[i])
                    if base > best_base:
                        best, best_base = (members[a], members[b]), base
            (i, ka), (j, kb) = best
            # relative pose i->j from globals
            firsts.append(i)
            Rs.append(R_glob[j] @ R_glob[i].T)
            ts.append(-R_glob[j] @ (C_glob[j] - C_glob[i]))
            p0s.append(_normalize(xy[i][None, ka], K))
            p1s.append(_normalize(xy[j][None, kb], K))
        if tracks:
            X, z0 = triangulate_midpoint(*_tensors(
                dev, *(np.stack(a).astype(np.float32)
                       for a in (Rs, ts, p0s, p1s))))
            X, z0 = X[:, 0].cpu().numpy(), z0[:, 0].cpu().numpy()
        for k, members in enumerate(tracks):
            if z0[k] <= 0:
                continue
            i = firsts[k]
            # cam_i coords -> world
            points.append(R_glob[i].T @ X[k] + C_glob[i])
            track_obs.append([(img, int(kp)) for img, kp in members])
    if verbose:
        print(f"[gsfm] {len(points)} triangulated tracks")
    if not points:
        raise ValueError("triangulation produced no points")

    # 4. global bundle adjustment (shared LM engine)
    with stage_timer("sfm.ba", block_on=dev):
        reg = connected
        cam_of = {img: c for c, img in enumerate(reg)}
        obs_cam, obs_pt, obs_uv = [], [], []
        for tid, obs in enumerate(track_obs):
            for img, kp in obs:
                if img in cam_of:
                    obs_cam.append(cam_of[img])
                    obs_pt.append(tid)
                    obs_uv.append(xy[img][kp])
        Ks = np.tile(K[None], (len(reg), 1, 1))
        problem = build_problem(Ks, np.asarray(obs_cam), np.asarray(obs_pt),
                                np.asarray(obs_uv, np.float32), len(points),
                                fixed_cams=[img == reg[0] for img in reg],
                                device=dev)
        rvecs = np.stack([rotation_to_rvec(R_glob[i]) for i in reg])
        tvecs = np.stack([-R_glob[i] @ C_glob[i] for i in reg])
        state = BAState(*_tensors(dev, rvecs.astype(np.float32),
                                  tvecs.astype(np.float32),
                                  np.stack(points).astype(np.float32)))
        state, cost = run_ba(problem, state, cfg.final_ba_iters)
    rms = float(np.sqrt(float(cost) / max(len(obs_cam), 1)))

    Rn = rodrigues(state.rvecs).cpu().numpy()
    tn = state.tvecs.cpu().numpy()
    out_poses = {img: (Rn[cam_of[img]], -Rn[cam_of[img]].T @ tn[cam_of[img]])
                 for img in reg}
    return SfMResult(poses=out_poses, points=state.points.cpu().numpy(),
                     track_obs=track_obs, keypoints=xy, reproj_rms=rms)
