"""Dense depth initialisation from sparse points by 2-D Delaunay (numpy
port of ``hcmvs_tpu/dense/init_tri.py``).

The reference's TriangulatePoints2DepthMap (ref: frame_main/libs/MVS/
DepthMap.cpp:1879-1938): a 2-D Delaunay triangulation of the sparse
points' projections, depth interpolated barycentrically across every
facet, optionally with the image corners at robust depths (bAddCorners).
It seeds ``init_triangulate=1`` runs.  Host-side scipy (Qhull), as in the
JAX package; the projection of the points into every view is vectorised.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import Delaunay, QhullError


def triangulate_init(uv: np.ndarray, depth: np.ndarray, h: int, w: int,
                     add_corners: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric-interpolated dense depth from sparse projections.

    Args:
      uv: (P, 2) pixel coordinates of the sparse points in this view.
      depth: (P,) their camera depths.
      add_corners: add the 4 image corners at a robust depth (median of
        the nearest points) so the triangulation spans the whole image
        (ref: bAddCorners, DepthMap.cpp:1889-1911).

    Returns (depth map (h, w) float32, 0 where uncovered; mask (h, w) bool
    of covered pixels).
    """
    uv = np.asarray(uv, np.float64)
    depth = np.asarray(depth, np.float64)
    ok = (depth > 0) & np.isfinite(depth)
    uv, depth = uv[ok], depth[ok]
    if len(uv) < 3:
        return np.zeros((h, w), np.float32), np.zeros((h, w), bool)
    if add_corners:
        corners = np.array([[0, 0], [w - 1.0, 0], [0, h - 1.0],
                            [w - 1.0, h - 1.0]])
        extra = []
        for c in corners:
            d2 = np.sum((uv - c) ** 2, axis=1)
            near = np.argsort(d2)[:max(3, len(uv) // 20)]
            extra.append(np.median(depth[near]))
        uv = np.concatenate([uv, corners])
        depth = np.concatenate([depth, extra])
    try:
        tri = Delaunay(uv)
    except (QhullError, ValueError):   # degenerate (e.g. collinear) or
        # non-finite points: no triangulation, nothing covered
        return np.zeros((h, w), np.float32), np.zeros((h, w), bool)
    ys, xs = np.mgrid[0:h, 0:w]
    q = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
    simplex = tri.find_simplex(q)
    inside = simplex >= 0
    s = np.maximum(simplex, 0)
    # barycentric coordinates of each query in its simplex
    T = tri.transform[s]                       # (Q, 3, 2)
    r = q - T[:, 2]
    bary = np.einsum("qij,qj->qi", T[:, :2], r)
    b = np.concatenate([bary, 1.0 - bary.sum(1, keepdims=True)], 1)
    verts = tri.simplices[s]                   # (Q, 3)
    d = np.sum(b * depth[verts], axis=1)
    d = np.where(inside & (d > 0), d, 0.0)
    return d.reshape(h, w).astype(np.float32), inside.reshape(h, w)


def scene_triangulated_seeds(points: np.ndarray, view_counts: np.ndarray,
                             view_ids: np.ndarray, cams_np,
                             n_images: int, h: int, w: int,
                             add_corners: bool = True) -> np.ndarray:
    """(N, H, W) Delaunay-interpolated seed depth maps for every view, the
    InitDepthMap(initTriangulate=1) analogue (``splat_sparse_depths`` is
    the point-splat one).  ``cams_np``: per image (K, R, C)."""
    counts = np.asarray(view_counts, np.int64)
    ids = np.asarray(view_ids, np.int64)
    # one (point, view) entry per listed view, in the lists' order
    owner = np.repeat(np.arange(len(points)), counts)
    pts = np.asarray(points)
    seeds = np.zeros((n_images, h, w), np.float32)
    for i in range(n_images):
        p = owner[ids == i]
        if len(p) < 3:
            continue
        K, R, C = cams_np[i]
        Xc = (pts[p] - C) @ np.asarray(R).T
        front = Xc[:, 2] > 0
        Xc = Xc[front]
        if len(Xc) < 3:
            continue
        pp = Xc @ np.asarray(K).T
        seeds[i], _ = triangulate_init(pp[:, :2] / pp[:, 2:3], Xc[:, 2],
                                       h, w, add_corners)
    return seeds
