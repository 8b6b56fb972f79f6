"""Evaluation utilities: depth / normal map comparison and the point-cloud
F-score (port of ``hcmvs_tpu/eval/compare.py``, a numpy copy: the port
imports nothing of the JAX package).

Analogs of the reference's built-in eval tools (ref:
frame_main/libs/MVS/DepthMap.cpp:2931 CompareDepthMaps and :3011
CompareNormalMaps), plus the ETH3D / Tanks-and-Temples-style F-score that
the mesh path is judged by (a mesh is sampled with
``mesh.mesh_ops.sample_points`` first).  The JAX package resizes a
ground truth of another size with cv2; the port with
``io.images.resize_linear`` (cv2's INTER_LINEAR, no cv2 needed).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def compare_depth_maps(depth: np.ndarray, depth_gt: np.ndarray,
                       threshold: float = 0.01) -> Dict[str, float]:
    """Per-pixel depth error stats (ref: CompareDepthMaps semantics:
    relative error against the ground truth, plus extra / missing
    coverage)."""
    if depth_gt.shape != depth.shape:
        from hcmvs_tpu_torch.io.images import resize_linear
        depth_gt = resize_linear(depth_gt, *depth.shape)
    est = depth > 0
    gt = depth_gt > 0
    both = est & gt
    rel = np.zeros_like(depth)
    rel[both] = np.abs(depth[both] - depth_gt[both]) / depth_gt[both]
    errors = rel[both]
    return {
        "n_both": int(both.sum()),
        "n_extra": int((est & ~gt).sum()),
        "n_missing": int((~est & gt).sum()),
        "completeness": float(both.sum() / max(gt.sum(), 1)),
        "mean_rel_err": float(errors.mean()) if len(errors) else np.nan,
        "median_rel_err": float(np.median(errors)) if len(errors) else np.nan,
        "frac_error_gt_threshold": (float((errors > threshold).mean())
                                    if len(errors) else np.nan),
    }


def compare_normal_maps(normal: np.ndarray, normal_gt: np.ndarray
                        ) -> Dict[str, float]:
    """Angular error stats between (3, H, W) normal maps (ref:
    CompareNormalMaps)."""
    n1 = normal / np.maximum(np.linalg.norm(normal, axis=0), 1e-12)
    n2 = normal_gt / np.maximum(np.linalg.norm(normal_gt, axis=0), 1e-12)
    cos = np.clip(np.abs((n1 * n2).sum(0)), -1, 1)
    ang = np.degrees(np.arccos(cos))
    valid = np.isfinite(ang)
    return {
        "mean_angle_deg": float(ang[valid].mean()),
        "median_angle_deg": float(np.median(ang[valid])),
        "frac_below_10deg": float((ang[valid] < 10).mean()),
    }


def point_cloud_fscore(points: np.ndarray, points_gt: np.ndarray,
                       threshold: float) -> Dict[str, float]:
    """Precision = fraction of reconstructed points within ``threshold``
    of the ground truth, recall = fraction of ground-truth points within
    ``threshold`` of the reconstruction, and their harmonic mean."""
    if len(points) == 0 or len(points_gt) == 0:
        return {"precision": 0.0, "recall": 0.0, "fscore": 0.0}
    d_est, _ = cKDTree(points_gt).query(points, k=1)
    precision = float((d_est <= threshold).mean())
    d_gt, _ = cKDTree(points).query(points_gt, k=1)
    recall = float((d_gt <= threshold).mean())
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": f}
