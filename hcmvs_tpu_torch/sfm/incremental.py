"""Incremental structure-from-motion driver (PyTorch port of
``hcmvs_tpu/sfm/incremental.py``).

The replacement for the OpenMVG pipeline the reference shells out to
(ref: frame_main/MvgMvsPipeline.py:181-192 -- SfMInit_ImageListing,
ComputeFeatures, ComputeMatches, IncrementalSfM): feature detection,
matching, two-view init, PnP registration and bundle adjustment run on
the device; the track bookkeeping (ragged, data-dependent) stays on the
host, as in the JAX package.

Random draws: every RANSAC takes its minimal samples from ``sampler``
(``two_view.Sampler``), called once per estimate in the JAX package's
order (per init pair: E, then H; per registration: PnP); by default it
draws from a ``torch.Generator`` seeded with 0 on the run's device.  The
RANSAC inputs keep the JAX package's power-of-two padding with a
validity mask (``_bucket_pad``): the a-contrario threshold counts the
padded slots (its n), so the padding is part of the result, and draws
index only the valid rows.

Stages are timed into ``utils.profiling``'s report: ``sfm.features``,
``sfm.matching``, ``sfm.init_pair``, ``sfm.registration`` (one call per
candidate view), ``sfm.ba`` (one call per bundle).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord, Platform,
                                    Pose, SceneMVS)
from hcmvs_tpu_torch.sfm.ba import (BAState, build_problem, rodrigues,
                                    rotation_to_rvec, run_ba)
from hcmvs_tpu_torch.sfm.features import (detect_and_describe,
                                          detect_and_describe_pyramid)
from hcmvs_tpu_torch.sfm.matching import match_descriptors
from hcmvs_tpu_torch.sfm.pnp import ransac_pnp
from hcmvs_tpu_torch.sfm.two_view import (Sampler, generator_sampler,
                                          ransac_essential,
                                          ransac_homography,
                                          triangulate_midpoint)
from hcmvs_tpu_torch.utils.profiling import stage_timer


@dataclasses.dataclass
class SfMConfig:
    max_keypoints: int = 1024
    n_octaves: int = 3       # downsampled DoG octaves (1 = single-octave)
    match_ratio: float = 0.8
    min_matches: int = 30
    ransac_threshold: float = 2e-5   # squared Sampson, normalized coords
                                     # (fallback / homography-check scale)
    adaptive_ransac: bool = True     # a-contrario (AC-RANSAC/ORSA) mode
                                     # for the two-view E estimation
                                     # (AutoEstimator.h:230)
    pnp_threshold: float = 1e-4
    min_pnp_inliers: int = 12
    ba_every: int = 3
    final_ba_iters: int = 25
    max_homography_ratio: float = 0.85  # init pairs with H/E inlier ratio
                                        # above this are planar-degenerate
    max_init_pairs: int = 40            # only the best pairs (by match
                                        # count) run init two-view RANSAC
    match_window: int = 0               # 0 = exhaustive pairwise matching;
                                        # k > 0 = only pairs |i - j| <= k
                                        # (VIDEO_MODE_MATCHING analog)
    ba_growth: float = 0.0              # 0 = global BA every ba_every
                                        # registrations; g > 1 = BA when
                                        # the map grew by factor g


@dataclasses.dataclass
class SfMResult:
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]]  # img -> (R, C)
    points: np.ndarray                               # (P, 3)
    track_obs: List[List[Tuple[int, int]]]           # per point: (img, kp)
    keypoints: List[np.ndarray]                      # per image (K, 2)
    reproj_rms: float = 0.0


def _normalize(uv: np.ndarray, K: np.ndarray) -> np.ndarray:
    return (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])


def _bucket_pad(*arrays, valid=None, min_size: int = 64):
    """Pad leading dims to the next power of two (>= min_size) with a
    validity mask, as the JAX package (its a-contrario threshold counts
    the padded slots)."""
    m = arrays[0].shape[0]
    size = min_size
    while size < m:
        size *= 2
    pad = size - m
    out = [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
    v = np.zeros(size, bool)
    v[:m] = True if valid is None else valid
    return (*out, v)


def default_sampler(device) -> Sampler:
    """Draws from a ``torch.Generator`` seeded with 0 on ``device``."""
    return generator_sampler(torch.Generator(
        device=torch.device(device)).manual_seed(0))


def _tensors(device, *arrays):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


def compute_features_and_matches(images: List[np.ndarray], cfg: SfMConfig,
                                 device="cuda"):
    """Stages 1+2: per-image features and pairwise matches (device)."""
    dev = torch.device(device)
    n = len(images)
    with stage_timer("sfm.features", block_on=dev):
        kps = []
        for im in images:
            g = torch.as_tensor(np.asarray(im, np.float32), device=dev)
            kps.append(detect_and_describe_pyramid(g, cfg.max_keypoints,
                                                   cfg.n_octaves)
                       if cfg.n_octaves > 1 else
                       detect_and_describe(g, cfg.max_keypoints))
        xy = [k.xy.cpu().numpy() for k in kps]
        valid = [k.score.cpu().numpy() > 0 for k in kps]
    pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
    with stage_timer("sfm.matching", block_on=dev):
        valid_t = [k.score > 0 for k in kps]
        for i in range(n):
            for j in range(i + 1, n):
                if cfg.match_window and j - i > cfg.match_window:
                    continue
                m = match_descriptors(kps[i].desc, kps[j].desc, valid_t[i],
                                      valid_t[j], cfg.match_ratio)
                mi = m.idx.cpu().numpy()
                mv = m.valid.cpu().numpy()
                pairs = np.stack([np.nonzero(mv)[0], mi[mv]], axis=1)
                if len(pairs) >= cfg.min_matches:
                    pair_matches[(i, j)] = pairs
    return xy, valid, pair_matches


def incremental_sfm(images: List[np.ndarray], K: np.ndarray,
                    cfg: Optional[SfMConfig] = None,
                    verbose: bool = False,
                    sampler: Optional[Sampler] = None,
                    device="cuda") -> SfMResult:
    cfg = cfg or SfMConfig()
    xy, valid, pair_matches = compute_features_and_matches(images, cfg,
                                                           device)
    return sfm_from_matches(xy, pair_matches, K, len(images), cfg, verbose,
                            sampler=sampler, device=device)


def _triangulate(R_rel, t_rel, p0, p1, dev) -> Tuple[np.ndarray, np.ndarray]:
    R, t, a, b = _tensors(dev, np.asarray(R_rel, np.float32),
                          np.asarray(t_rel, np.float32), p0, p1)
    X, z0 = triangulate_midpoint(R, t, a, b)
    return X.cpu().numpy(), z0.cpu().numpy()


def sfm_from_matches(xy: List[np.ndarray],
                     pair_matches: Dict[Tuple[int, int], np.ndarray],
                     K: np.ndarray, n: int,
                     cfg: Optional[SfMConfig] = None,
                     verbose: bool = False,
                     sampler: Optional[Sampler] = None,
                     device="cuda") -> SfMResult:
    """Stages 3-6 from precomputed keypoints + matches (the track,
    registration, and BA machinery)."""
    cfg = cfg or SfMConfig()
    dev = torch.device(device)
    sampler = sampler or default_sampler(dev)

    if not pair_matches:
        raise ValueError("no image pairs with enough matches")

    # 3. init pair: two-view RANSAC on every candidate, pick the pair with
    # the most E inliers among pairs NOT explained by a homography --
    # OpenMVG's AUTO model selection
    best_pair, best_res, best_inl = None, None, -1
    fallback = (None, None, -1)
    init_pairs = sorted(pair_matches, key=lambda p: -len(pair_matches[p]))
    with stage_timer("sfm.init_pair", block_on=dev):
        for (i, j) in init_pairs[:cfg.max_init_pairs]:
            pairs = pair_matches[(i, j)]
            p0 = _normalize(xy[i][pairs[:, 0]], K).astype(np.float32)
            p1 = _normalize(xy[j][pairs[:, 1]], K).astype(np.float32)
            p0, p1, vmask = _tensors(dev, *_bucket_pad(p0, p1))
            res = ransac_essential(sampler(vmask, 512, 8), p0, p1, vmask,
                                   cfg.ransac_threshold,
                                   adaptive=cfg.adaptive_ransac)
            n_inl = int(res.n_inliers)
            # the H-vs-E planarity guard stays at the FIXED calibrated
            # scale (the JAX package's choice, mirrored for parity)
            hres = ransac_homography(sampler(vmask, 256, 4), p0, p1, vmask,
                                     2.0 * cfg.ransac_threshold)
            h_ratio = int(hres.n_inliers) / max(n_inl, 1)
            # fallback ranking for the all-planar case: support weighted by
            # how much of it the homography does NOT explain
            fb_score = n_inl * max(1.0 - h_ratio, 0.02)
            if fb_score > fallback[2]:
                fallback = ((i, j), res, fb_score)
            if h_ratio > cfg.max_homography_ratio:
                continue
            if n_inl > best_inl:
                best_pair, best_res, best_inl = (i, j), res, n_inl
    if best_pair is None:
        # every pair is near-planar: take the least-planar strong pair
        best_pair, best_res, best_inl = fallback
    i0, i1 = best_pair
    if verbose:
        print(f"[sfm] init pair ({i0},{i1}) inliers={best_inl}")

    # 4. initialize map: camera i0 at origin, i1 at recovered pose
    R1 = best_res.R.cpu().numpy()
    t1 = best_res.t.cpu().numpy()
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        i0: (np.eye(3), np.zeros(3)),
        i1: (R1, t1),
    }
    pairs01 = pair_matches[best_pair]
    m01 = len(pairs01)
    inl = best_res.inliers.cpu().numpy()[:m01]
    p0 = _normalize(xy[i0][pairs01[:, 0]], K).astype(np.float32)
    p1 = _normalize(xy[i1][pairs01[:, 1]], K).astype(np.float32)
    X, z0 = _triangulate(R1, t1, p0, p1, dev)
    z1 = (X @ R1.T + t1)[:, 2]
    good = inl & (z0 > 0) & (z1 > 0)

    # track bookkeeping as dense arrays:
    #   track_of (N, K) int32: keypoint -> track id (-1 unassigned)
    #   adj_*[i]: image i's matches across ALL pairs, concatenated
    n_kp = max(len(x) for x in xy)
    track_of = np.full((n, n_kp), -1, np.int32)
    adj_other = [[] for _ in range(n)]
    adj_kp_self = [[] for _ in range(n)]
    adj_kp_other = [[] for _ in range(n)]
    for (a, b), pairs in pair_matches.items():
        adj_other[a].append(np.full(len(pairs), b, np.int32))
        adj_kp_self[a].append(pairs[:, 0].astype(np.int32))
        adj_kp_other[a].append(pairs[:, 1].astype(np.int32))
        adj_other[b].append(np.full(len(pairs), a, np.int32))
        adj_kp_self[b].append(pairs[:, 1].astype(np.int32))
        adj_kp_other[b].append(pairs[:, 0].astype(np.int32))

    def cat(ls):
        return np.concatenate(ls) if ls else np.zeros(0, np.int32)

    adj_other = [cat(v) for v in adj_other]
    adj_kp_self = [cat(v) for v in adj_kp_self]
    adj_kp_other = [cat(v) for v in adj_kp_other]
    registered = np.zeros(n, bool)
    registered[[i0, i1]] = True

    points: List[np.ndarray] = []
    track_obs: List[List[Tuple[int, int]]] = []
    for m_idx in np.nonzero(good)[0]:
        a, b = pairs01[m_idx]
        tid = len(points)
        points.append(X[m_idx])
        track_obs.append([(i0, int(a)), (i1, int(b))])
        track_of[i0, a] = tid
        track_of[i1, b] = tid

    def run_global_ba():
        nonlocal points
        with stage_timer("sfm.ba", block_on=dev):
            reg = sorted(poses.keys())
            cam_of = {img: c for c, img in enumerate(reg)}
            obs_cam, obs_pt, obs_uv = [], [], []
            for tid, obs in enumerate(track_obs):
                for (img, kp) in obs:
                    if img in cam_of:
                        obs_cam.append(cam_of[img])
                        obs_pt.append(tid)
                        obs_uv.append(xy[img][kp])
            Ks = np.tile(K[None], (len(reg), 1, 1))
            problem = build_problem(Ks, obs_cam, obs_pt, obs_uv, len(points),
                                    fixed_cams=[img == i0 for img in reg],
                                    device=dev)
            rvecs = np.stack([rotation_to_rvec(poses[img][0])
                              for img in reg])
            tvecs = np.stack([poses[img][1] for img in reg])
            state = BAState(*_tensors(dev, rvecs.astype(np.float32),
                                      tvecs.astype(np.float32),
                                      np.stack(points).astype(np.float32)))
            state, cost = run_ba(problem, state, cfg.final_ba_iters)
            Rn = rodrigues(state.rvecs).cpu().numpy()
            tn = state.tvecs.cpu().numpy()
            for c, img in enumerate(reg):
                poses[img] = (Rn[c], tn[c])
            points = [p for p in state.points.cpu().numpy()]
            return float(np.sqrt(cost / max(len(obs_cam), 1)))

    # 5. register remaining views by 2D-3D support
    remaining = set(range(n)) - set(poses)
    n_registered = 2
    last_ba_size = 2
    while remaining:
        # count 2D-3D correspondences per candidate (iterating the set as
        # the JAX package does, so ties break the same way)
        counts = {}
        for img in remaining:
            ok = (registered[adj_other[img]]
                  & (track_of[adj_other[img], adj_kp_other[img]] >= 0))
            counts[img] = int(ok.sum())
        img = max(counts, key=counts.get)
        if counts[img] < cfg.min_pnp_inliers:
            break
        remaining.discard(img)

        # PnP from its 2D-3D correspondences, then new tracks
        # triangulated against every registered partner
        with stage_timer("sfm.registration", block_on=dev):
            tid_other = track_of[adj_other[img], adj_kp_other[img]]
            sel = (registered[adj_other[img]] & (tid_other >= 0)
                   & (track_of[img, adj_kp_self[img]] < 0))
            corr_kp = adj_kp_self[img][sel]
            corr_tid = tid_other[sel]
            if len(corr_kp) < cfg.min_pnp_inliers:
                continue
            pts_np = np.stack(points)
            n_corr = len(corr_kp)
            corr_X = pts_np[corr_tid].astype(np.float32)
            uvn = _normalize(xy[img][corr_kp], K).astype(np.float32)
            corr_X, uvn, vmask = _tensors(dev, *_bucket_pad(corr_X, uvn))
            res = ransac_pnp(sampler(vmask, 1024, 6), corr_X, uvn, vmask,
                             cfg.pnp_threshold)
            if int(res.n_inliers) < cfg.min_pnp_inliers:
                if verbose:
                    print(f"[sfm] image {img}: PnP failed "
                          f"({int(res.n_inliers)}/{n_corr} inliers)")
                continue
            R = res.R.cpu().numpy()
            t = res.t.cpu().numpy()
            poses[img] = (R, t)
            registered[img] = True
            inl = res.inliers.cpu().numpy()[:n_corr]
            for k_i in np.nonzero(inl)[0]:
                track_of[img, corr_kp[k_i]] = corr_tid[k_i]
                track_obs[corr_tid[k_i]].append((img, int(corr_kp[k_i])))
            if verbose:
                print(f"[sfm] registered image {img} "
                      f"({int(res.n_inliers)}/{len(corr_X)} inliers)")
            for (a, b), pairs in pair_matches.items():
                if (a == img or b == img) and (b if a == img else a) in poses:
                    _triangulate_pair(img, a, b, pairs, xy, K, cfg, poses,
                                      points, track_obs, track_of, dev)

        n_registered += 1
        if cfg.ba_growth > 1.0:
            if n_registered >= last_ba_size * cfg.ba_growth:
                run_global_ba()
                last_ba_size = n_registered
        elif n_registered % cfg.ba_every == 0:
            run_global_ba()

    # 6. final global BA
    rms = run_global_ba()
    if verbose:
        print(f"[sfm] done: {len(poses)}/{n} cams, {len(points)} points, "
              f"rms {rms:.3f}px")
    # convert t to camera centers
    out_poses = {img: (R, -R.T @ t) for img, (R, t) in poses.items()}
    return SfMResult(poses=out_poses, points=np.stack(points),
                     track_obs=track_obs, keypoints=xy, reproj_rms=rms)


def _triangulate_pair(img, a, b, pairs, xy, K, cfg, poses, points,
                      track_obs, track_of, dev) -> None:
    """New tracks between the just-registered ``img`` and its registered
    partner in the pair (a, b): matches whose keypoints have no track
    yet, triangulated and kept when in front of both cameras and within
    the reprojection gate in both views (appended in place)."""
    other = b if a == img else a
    kp_s_all = (pairs[:, 0] if a == img else pairs[:, 1]).astype(
        np.int32)
    kp_o_all = (pairs[:, 1] if a == img else pairs[:, 0]).astype(
        np.int32)
    fresh = ((track_of[img, kp_s_all] < 0)
             & (track_of[other, kp_o_all] < 0))
    if not fresh.any():
        return
    kp_s = kp_s_all[fresh]
    kp_o = kp_o_all[fresh]
    Rs, ts = poses[img]
    Ro, to = poses[other]
    # relative pose other->img: X_img = R_rel X_other + t_rel
    R_rel = Rs @ Ro.T
    t_rel = ts - R_rel @ to
    po = _normalize(xy[other][kp_o], K).astype(np.float32)
    ps = _normalize(xy[img][kp_s], K).astype(np.float32)
    Xo, zo = _triangulate(R_rel, t_rel, po, ps, dev)
    Xs = Xo @ R_rel.T + t_rel
    zs = Xs[:, 2]
    # to world: X_w = Ro^T (X_other - to)
    Xw = (Xo - to) @ Ro
    # reprojection gate in both views (mismatched pairs triangulate
    # somewhere, but not consistently with the measured rays)
    with np.errstate(divide="ignore", invalid="ignore"):
        r_o = Xo[:, :2] / Xo[:, 2:3]
        r_s = Xs[:, :2] / Xs[:, 2:3]
    err = (np.sum((r_o - po) ** 2, 1) + np.sum((r_s - ps) ** 2, 1))
    okc = ((zo > 0) & (zs > 0) & (err < 4 * cfg.pnp_threshold))
    acc = np.nonzero(okc)[0]
    tids = len(points) + np.arange(len(acc), dtype=np.int32)
    track_of[other, kp_o[acc]] = tids
    track_of[img, kp_s[acc]] = tids
    for k_i in acc:
        points.append(Xw[k_i])
        track_obs.append([(other, int(kp_o[k_i])),
                          (img, int(kp_s[k_i]))])


def sfm_to_scene(result: SfMResult, K: np.ndarray, image_names: List[str],
                 width: int, height: int) -> SceneMVS:
    """Package an SfM result as a SceneMVS for the dense stage / .mvs IO."""
    plat = Platform(name="p0")
    plat.cameras.append(CameraIntrinsic(
        name="cam0", width=width, height=height, K=K.astype(np.float64),
        R=np.eye(3), C=np.zeros(3)))
    scene = SceneMVS(platforms=[plat])
    img_to_pose = {}
    for img_idx in sorted(result.poses):
        R, C = result.poses[img_idx]
        img_to_pose[img_idx] = len(plat.poses)
        plat.poses.append(Pose(R=R.astype(np.float64),
                               C=C.astype(np.float64)))
        scene.images.append(ImageRecord(
            name=image_names[img_idx], platform_id=0, camera_id=0,
            pose_id=img_to_pose[img_idx], id=img_idx))
    # points + view lists (only registered images)
    reg = {img: k for k, img in enumerate(sorted(result.poses))}
    pts, counts, ids, confs = [], [], [], []
    for tid, obs in enumerate(result.track_obs):
        vids = [reg[img] for img, _ in obs if img in reg]
        if len(vids) < 2:
            continue
        pts.append(result.points[tid])
        counts.append(len(vids))
        ids.extend(vids)
        confs.extend([1.0] * len(vids))
    scene.points = (np.stack(pts).astype(np.float32) if pts
                    else np.zeros((0, 3), np.float32))
    scene.point_view_counts = np.asarray(counts, np.int32)
    scene.point_view_ids = np.asarray(ids, np.uint32)
    scene.point_view_confs = np.asarray(confs, np.float32)
    return scene
