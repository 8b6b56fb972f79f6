"""Pinhole camera model (PyTorch port of ``hcmvs_tpu/core/camera.py``).

Conventions are the reference's: ``K`` intrinsics, ``R`` world->camera
rotation, ``C`` camera centre, ``t = -R @ C``.  Every field broadcasts over
leading batch axes.  All products are full float32: TF32 is switched off
for the whole package (``hcmvs_tpu_torch/__init__.py``), because a 0.4%
error in these 3x3 products moves rect positions by pixels
(``hcmvs_tpu/ops/rect_gather.py:98-102``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """A (batch of) pinhole camera(s): ``K``, ``R`` (..., 3, 3), ``C``
    (..., 3)."""

    K: torch.Tensor
    R: torch.Tensor
    C: torch.Tensor

    @property
    def t(self) -> torch.Tensor:
        """Translation t = -R @ C, shape (..., 3)."""
        return -torch.einsum("...ij,...j->...i", self.R, self.C)

    @property
    def K_inv(self) -> torch.Tensor:
        """Closed-form inverse of the (upper-triangular) intrinsics."""
        fx = self.K[..., 0, 0]
        fy = self.K[..., 1, 1]
        s = self.K[..., 0, 1]
        cx = self.K[..., 0, 2]
        cy = self.K[..., 1, 2]
        zero = torch.zeros_like(fx)
        one = torch.ones_like(fx)
        inv_fx = 1.0 / fx
        inv_fy = 1.0 / fy
        row0 = torch.stack([inv_fx, -s * inv_fx * inv_fy,
                            (s * cy - cx * fy) * inv_fx * inv_fy], dim=-1)
        row1 = torch.stack([zero, inv_fy, -cy * inv_fy], dim=-1)
        row2 = torch.stack([zero, zero, one], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def __getitem__(self, idx) -> "Camera":
        """Index the batch axis (a view, or a list of neighbour views)."""
        return Camera(K=self.K[idx], R=self.R[idx], C=self.C[idx])

    def to(self, device) -> "Camera":
        return Camera(K=self.K.to(device), R=self.R.to(device),
                      C=self.C.to(device))


def relative_motion(ref: Camera, src: Camera
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``X_src = R_rel @ X_ref + t_rel`` with ``R_rel = R_s R_r^T`` and
    ``t_rel = R_s (C_r - C_s)``."""
    R_rel = torch.einsum("...ij,...kj->...ik", src.R, ref.R)
    t_rel = torch.einsum("...ij,...j->...i", src.R, ref.C - src.C)
    return R_rel, t_rel


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]_x."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def fundamental_matrix(ref: Camera, src: Camera) -> torch.Tensor:
    """``F = K_s^-T [t]_x R_rel K_r^-1``: ref pixel -> src epiline."""
    R_rel, t_rel = relative_motion(ref, src)
    E = torch.einsum("...ij,...jk->...ik", skew(t_rel), R_rel)
    return torch.einsum("...ji,...jk,...kl->...il", src.K_inv, E, ref.K_inv)


def plane_homography(ref: Camera, src: Camera, n: torch.Tensor,
                     d_plane: torch.Tensor) -> torch.Tensor:
    """Plane-induced homography ref image -> src image, (..., 3, 3), of
    the plane ``n . X = d_plane`` in ref-camera coordinates (``n`` unit,
    facing the camera, so ``d_plane < 0`` for OpenMVS-convention
    normals; ref: DepthMap.h:412-444, the Hl/Hm/Hr constants)."""
    R_rel, t_rel = relative_motion(ref, src)
    H_cam = R_rel + torch.einsum("...i,...j->...ij", t_rel,
                                 n) / d_plane[..., None, None]
    return torch.einsum("...ij,...jk,...kl->...il", src.K, H_cam, ref.K_inv)


def apply_homography(H: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homography applied to (..., 2) points -> (..., 2)."""
    ones = torch.ones_like(uv[..., :1])
    x = torch.einsum("...ij,...j->...i", H, torch.cat([uv, ones], dim=-1))
    return x[..., :2] / x[..., 2:3]


def point_to_epiline_dist(F: torch.Tensor, uv_ref: torch.Tensor,
                          uv_src: torch.Tensor) -> torch.Tensor:
    """Distance of ``uv_src`` (..., 2) to the epipolar line of ``uv_ref``
    under ``F`` (``fundamental_matrix``)."""
    ones = torch.ones_like(uv_ref[..., :1])
    line = torch.einsum("...ij,...j->...i", F,
                        torch.cat([uv_ref, ones], dim=-1))
    num = (line[..., 0] * uv_src[..., 0] + line[..., 1] * uv_src[..., 1]
           + line[..., 2]).abs()
    den = torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2) + 1e-12
    return num / den
