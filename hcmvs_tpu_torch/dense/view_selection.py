"""Neighbour-view selection from sparse covisibility (port of
``pair_scores``, ``select_neighbors`` and ``depth_range_from_points`` of
``hcmvs_tpu/dense/view_selection.py``, copies in numpy: the port imports
nothing of the JAX package).

Each image pair is scored by the sparse points they co-observe, weighted
by triangulation angle peaked at fOptimAngle (ref: frame_main/libs/MVS/
SceneDensify.cpp:307-327 SelectViews); each image keeps its top-k
neighbours.  The single global pair assignment of the nNumViews==1 path
(the TRW-S MRF, ``global_pair_assignment``) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pair_scores(points: np.ndarray, view_counts: np.ndarray,
                view_ids: np.ndarray, cam_centers: np.ndarray,
                n_images: int, optim_angle_deg: float = 10.0,
                min_angle_deg: float = 3.0,
                max_angle_deg: float = 65.0) -> np.ndarray:
    """(N, N) covisibility score matrix from sparse points."""
    score = np.zeros((n_images, n_images), np.float64)
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    optim = np.radians(optim_angle_deg)
    amin = np.radians(min_angle_deg)
    amax = np.radians(max_angle_deg)
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        if len(ids) < 2:
            continue
        X = points[p]
        rays = cam_centers[ids] - X[None, :]
        rays = rays / np.maximum(np.linalg.norm(rays, axis=1, keepdims=True),
                                 1e-12)
        cos = np.clip(rays @ rays.T, -1.0, 1.0)
        ang = np.arccos(cos)
        w = np.exp(-((ang - optim) / optim) ** 2)
        w[(ang < amin) | (ang > amax)] = 0.0
        for a in range(len(ids)):
            for b in range(len(ids)):
                if a != b:
                    score[ids[a], ids[b]] += w[a, b]
    return score


def select_neighbors(score: np.ndarray, num_views: int,
                     min_score_ratio: float = 0.3
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k neighbors per image (ref: FilterNeighborViews semantics).

    Returns (nbr_idx (N, V) int32, nbr_valid (N, V) bool); rows are padded
    with the image's best neighbor so device-side gathers stay in range.
    """
    n = score.shape[0]
    v = min(num_views, max(n - 1, 1))
    nbr_idx = np.zeros((n, v), np.int32)
    nbr_valid = np.zeros((n, v), bool)
    for i in range(n):
        s = score[i].copy()
        s[i] = -1.0
        order = np.argsort(-s)
        best = s[order[0]]
        cnt = 0
        for j in order[:v]:
            if s[j] > 0 and s[j] >= best * min_score_ratio:
                nbr_idx[i, cnt] = j
                nbr_valid[i, cnt] = True
                cnt += 1
        # pad with the best neighbor (or self if isolated)
        fill = nbr_idx[i, 0] if cnt > 0 else i
        nbr_idx[i, cnt:] = fill
    return nbr_idx, nbr_valid


def depth_range_from_points(points: np.ndarray, view_counts: np.ndarray,
                            view_ids: np.ndarray, R: np.ndarray,
                            C: np.ndarray, image_idx: int,
                            margin: Tuple[float, float] = (0.9, 1.1)
                            ) -> Tuple[float, float]:
    """[dMin, dMax] for one image from its visible sparse points
    (ref: DepthData dMin/dMax init from sparse depths in InitDepthMap)."""
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    depths = []
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        if image_idx in ids:
            d = (R @ (points[p] - C))[2]
            if d > 0:
                depths.append(d)
    if not depths:
        return 0.1, 100.0
    depths = np.array(depths)
    return (float(np.percentile(depths, 1) * margin[0]),
            float(np.percentile(depths, 99) * margin[1]))
