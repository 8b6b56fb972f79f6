"""Descriptor matching (PyTorch port of ``hcmvs_tpu/sfm/matching.py``).

Replaces OpenMVG's CPU matcher (ref: frame_main/MvgMvsPipeline.py:187-189
openMVG_main_ComputeMatches): a (K, 128) x (128, K) similarity product in
full float32 (TF32 is off package-wide), Lowe's ratio test and
mutual-best cross-checking.  Ties take the lower index, as JAX's
``top_k`` and ``argmax``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Matches(NamedTuple):
    idx: torch.Tensor     # (K,) best match in image B for each keypoint of A
    valid: torch.Tensor   # (K,) passed ratio + mutual check
    score: torch.Tensor   # (K,) cosine similarity of the best match


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      ratio: float = 0.8) -> Matches:
    """Mutual-best ratio-test matching between two descriptor sets.

    desc_*: (K, 128) L2-normalized; valid_*: (K,) bool masks for padded
    keypoint slots.
    """
    sim = desc_a @ desc_b.T                                 # (Ka, Kb)
    sim = torch.where(valid_a[:, None] & valid_b[None, :], sim, -2.0)

    # top-2 per row for the ratio test (on distance: d^2 = 2 - 2 sim)
    top2 = torch.sort(sim, dim=1, descending=True, stable=True)
    best = top2.values[:, 0]
    second = top2.values[:, 1]
    d1 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * best, 0.0))
    d2 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * second, 1e-12))
    ratio_ok = d1 < ratio * d2

    # mutual best
    best_b_for_a = top2.indices[:, 0]
    best_a_for_b = torch.argmax(sim, dim=0)                  # (Kb,)
    mutual = best_a_for_b[best_b_for_a] == torch.arange(
        sim.shape[0], device=sim.device)

    valid = ratio_ok & mutual & valid_a & (best > -1.0)
    return Matches(idx=best_b_for_a, valid=valid, score=best)
