"""Visibility-based point-cloud filtering (DensifyPointCloud
--filter-point-cloud; port of ``hcmvs_tpu/dense/point_filter.py``, numpy
as there, taking the port's ``Camera``).

Re-design of the reference's Scene::PointCloudFilter
(ref: frame_main/libs/MVS/SceneDensify.cpp:4189-4320): the reference casts,
for every (point, view) observation, a one-pixel-wide cone from the camera
through the point and walks an octree collecting points inside it — points
found *in front of* the observed point (free-space violations) are
penalized by the observation's view count, points *behind* it are
supported by their own view count; points whose accumulated vote ends
<= thRemove are deleted.

The cone with per-pixel angular width (angle = FOV/width,
SceneDensify.cpp:4256) IS the pixel footprint, so the octree cone walk
becomes a rasterization: project every point into every view, bucket the
view's *observations* per pixel sorted by depth, and resolve each
projected point's votes against its bucket with prefix sums + binary
search — exact pairwise semantics (every observation votes), O((N+M)logM)
per view instead of the reference's octree cone walks, fully vectorized.
This stage is host-side bookkeeping around the fused cloud (like the
reference's), not a device kernel: it runs once per scene on ragged data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hcmvs_tpu_torch.core.camera import Camera

_TH_SIMILAR = 0.01   # ref: SceneDensify.cpp:4235 thSimilar


def _project(points, K, R, C, h, w):
    Xc = (points - C[None]) @ R.T
    z = Xc[:, 2]
    uvw = Xc @ K.T
    inv_z = 1.0 / np.where(np.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
    u = np.round(uvw[:, 0] * inv_z).astype(np.int64)
    v = np.round(uvw[:, 1] * inv_z).astype(np.int64)
    valid = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    pix = np.where(valid, v * w + u, 0)
    return z.astype(np.float64), pix, valid


def _votes_one_view(points, counts, obs, K, R, C, h, w):
    """Exact per-observation voting for one view: (N,) int64."""
    z, pix, valid = _project(points, K, R, C, h, w)
    votes = np.zeros(len(points), np.int64)
    ob = obs & valid
    if not ob.any():
        return votes
    # observations sorted by (pixel, depth)
    o_pix, o_z, o_w = pix[ob], z[ob], counts[ob].astype(np.int64)
    order = np.lexsort((o_z, o_pix))
    o_pix, o_z, o_w = o_pix[order], o_z[order], o_w[order]
    # per-pixel bucket ranges + weight prefix sums
    bucket_lo = np.searchsorted(o_pix, pix[valid], side="left")
    bucket_hi = np.searchsorted(o_pix, pix[valid], side="right")
    pw = np.concatenate([[0], np.cumsum(o_w)])
    # composite key: strictly ordered by (pixel, depth); z scaled into [0,1)
    z_max = max(o_z.max(), z[valid].max()) * 1.02 + 1.0
    key_obs = o_pix * 2.0 + o_z / z_max
    zq = z[valid]
    # q behind obs i  <=>  z_i < z_q / (1+th): support += count_q per i
    t_behind = np.minimum(zq / (1.0 + _TH_SIMILAR) / z_max, 0.9999999)
    n_behind = (np.searchsorted(key_obs, pix[valid] * 2.0 + t_behind,
                                side="left") - bucket_lo)
    # q in front of obs i  <=>  z_i > z_q / (1-th): penalty += w_i
    t_front = np.minimum(zq / (1.0 - _TH_SIMILAR) / z_max, 0.9999999)
    idx_front = np.searchsorted(key_obs, pix[valid] * 2.0 + t_front,
                                side="right")
    w_front = pw[bucket_hi] - pw[idx_front]
    votes[valid] = (counts[valid].astype(np.int64) * np.maximum(n_behind, 0)
                    - w_front)
    return votes


def filter_point_cloud(points: np.ndarray, view_counts: np.ndarray,
                       view_ids: np.ndarray, cams: Camera,
                       image_hw: Tuple[int, int],
                       th_remove: int = 0) -> np.ndarray:
    """Free-space-violation filter over a fused cloud.

    Args:
      points: (N, 3) float32.
      view_counts: (N,) per-point view-list lengths.
      view_ids: (sum counts,) flattened view lists.
      cams: batched Camera (one per image, tensors on any device).
      image_hw: (H, W) of the images the cameras project into.
      th_remove: keep points with vote > th_remove (ref: thRemove — the
        CLI passes --filter-point-cloud as a negative value).

    Returns a (N,) bool keep mask.
    """
    points = np.asarray(points, np.float64)
    view_counts = np.asarray(view_counts)
    n = len(points)
    h, w = image_hw
    Ks, Rs, Cs = (x.detach().cpu().numpy().astype(np.float64)
                  for x in (cams.K, cams.R, cams.C))
    n_views = Ks.shape[0]
    # per-view observation masks from the flat ragged lists
    offs = np.concatenate([[0], np.cumsum(view_counts)])
    pt_of_obs = np.repeat(np.arange(n), view_counts)
    vid = np.asarray(view_ids)[:len(pt_of_obs)]
    obs = np.zeros((n_views, n), bool)
    ok = vid < n_views
    obs[vid[ok], pt_of_obs[ok]] = True

    votes = np.zeros(n, np.int64)
    for v in range(n_views):
        votes += _votes_one_view(points, view_counts, obs[v],
                                 Ks[v], Rs[v], Cs[v], h, w)
    return votes > th_remove
