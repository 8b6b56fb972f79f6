"""Point-cloud F-score (port of ``point_cloud_fscore`` in
``hcmvs_tpu/eval/compare.py``, a copy: the port imports nothing of the JAX
package).

The ETH3D / Tanks-and-Temples-style F-score that the mesh path is judged
by (a mesh is sampled with ``mesh.mesh_ops.sample_points`` first).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


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
