"""Per-pixel state and precomputed view geometry for PatchMatch (PyTorch
port of ``hcmvs_tpu/dense/types.py``).

Per-pixel vector fields stay planes-first, ``(3, H, W)``, as in the JAX
package, so the two can be compared array for array; 3x3 algebra on them
is written out as scalar-coefficient elementwise ops (``mat3_apply``).

Random draws are split from the arithmetic that uses them: ``*_draws``
takes a ``torch.Generator``, the apply function takes the draws.  Tests
feed the JAX package's own ``jax.random`` draws to the apply functions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from hcmvs_tpu_torch.core.camera import Camera, relative_motion, skew


def mat3_apply(M: torch.Tensor, v) -> Tuple[torch.Tensor, ...]:
    """``M @ v`` with M (3, 3) and v a 3-sequence of (H, W) planes."""
    vx, vy, vz = v[0], v[1], v[2]
    return (M[0, 0] * vx + M[0, 1] * vy + M[0, 2] * vz,
            M[1, 0] * vx + M[1, 1] * vy + M[1, 2] * vz,
            M[2, 0] * vx + M[2, 1] * vy + M[2, 2] * vz)


def mat3_apply_t(M: torch.Tensor, v) -> Tuple[torch.Tensor, ...]:
    """``M^T @ v`` without materialising the transpose."""
    vx, vy, vz = v[0], v[1], v[2]
    return (M[0, 0] * vx + M[1, 0] * vy + M[2, 0] * vz,
            M[0, 1] * vx + M[1, 1] * vy + M[2, 1] * vz,
            M[0, 2] * vx + M[1, 2] * vy + M[2, 2] * vz)


def dot3(a, b) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(a) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot3(a, a), 1e-18))


def normalize3(a) -> Tuple[torch.Tensor, ...]:
    inv = 1.0 / norm3(a)
    return a[0] * inv, a[1] * inv, a[2] * inv


@dataclasses.dataclass(frozen=True)
class ViewGeometry:
    """Constants for one reference view against V neighbour views."""

    A: torch.Tensor          # (V, 3, 3)  K_s R_rel K_r^-1
    wv: torch.Tensor         # (V, 3)     K_s t_rel
    R_rel: torch.Tensor      # (V, 3, 3)
    t_rel: torch.Tensor      # (V, 3)
    K_src: torch.Tensor      # (V, 3, 3)
    K_inv_src: torch.Tensor  # (V, 3, 3)
    F: torch.Tensor          # (V, 3, 3)  ref pixel -> src epiline
    K_ref: torch.Tensor      # (3, 3)
    K_inv_ref: torch.Tensor  # (3, 3)


def make_view_geometry(ref_cam: Camera, src_cams: Camera) -> ViewGeometry:
    """Per-src-view warp constants (ref: DepthMap.h:412-444)."""
    R_rel, t_rel = relative_motion(ref_cam, src_cams)
    K_inv_ref = ref_cam.K_inv
    K_src = src_cams.K
    K_inv_src = src_cams.K_inv
    A = torch.einsum("vij,vjk,kl->vil", K_src, R_rel, K_inv_ref)
    wv = torch.einsum("vij,vj->vi", K_src, t_rel)
    E = torch.einsum("vij,vjk->vik", skew(t_rel), R_rel)
    Fm = torch.einsum("vji,vjk,kl->vil", K_inv_src, E, K_inv_ref)
    return ViewGeometry(A=A, wv=wv, R_rel=R_rel, t_rel=t_rel, K_src=K_src,
                        K_inv_src=K_inv_src, F=Fm, K_ref=ref_cam.K,
                        K_inv_ref=K_inv_ref)


@dataclasses.dataclass(frozen=True)
class PatchMatchState:
    """Per-pixel hypothesis state of one view."""

    depth: torch.Tensor   # (H, W) f32; 0 marks invalid
    normal: torch.Tensor  # (3, H, W) f32 unit, camera space, n . ray < 0
    cost: torch.Tensor    # (H, W) f32 aggregated score (0 best, 2 worst)


class Rows(NamedTuple):
    """Where a field of a row band lies in its image: its first image row
    and the image's height (the tile axis sweeps such fields; every
    per-pixel coordinate and image bound is taken from here)."""

    start: int
    height: int


def pixel_grid(h: int, w: int, device, rows: Optional[Rows] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v, u) pixel coordinates (H, W) f32 of a field of ``h`` rows, the
    image rows of ``rows`` (from 0 without)."""
    r0 = 0 if rows is None else rows.start
    return torch.meshgrid(
        torch.arange(r0, r0 + h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def pixel_rays(K_inv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(3, H, W) camera rays with z == 1 for every pixel centre."""
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=K_inv.device),
        torch.arange(w, dtype=torch.float32, device=K_inv.device),
        indexing="ij")
    return torch.stack(mat3_apply(K_inv, (u, v, torch.ones_like(u))))


def tangent_frame(d):
    """Orthonormal (t1, t2) perpendicular to unit direction planes d."""
    use_z = d[2].abs() < 0.9
    ux = torch.where(use_z, 0.0, 1.0)
    uz = torch.where(use_z, 1.0, 0.0)
    # t1 = up x d  (up = (ux, 0, uz))
    t1 = normalize3((0.0 * d[0] - uz * d[1],
                     uz * d[0] - ux * d[2],
                     ux * d[1] - 0.0 * d[0]))
    # t2 = d x t1
    t2 = (d[1] * t1[2] - d[2] * t1[1],
          d[2] * t1[0] - d[0] * t1[2],
          d[0] * t1[1] - d[1] * t1[0])
    return t1, t2


def face_camera_t(n, rays):
    """Flip normal planes so n . ray <= 0 (pointing toward the camera)."""
    s = torch.where(dot3(n, rays) > 0, -1.0, 1.0)
    return (n[0] * s, n[1] * s, n[2] * s)


def random_normals(rays: torch.Tensor, cos_t: torch.Tensor,
                   phi: torch.Tensor) -> torch.Tensor:
    """(3, H, W) unit normals facing the camera, tilted from the viewing
    direction by acos(cos_t) at azimuth phi (draws: cos_t in [0.5, 1),
    phi in [0, 2 pi))."""
    sin_t = torch.sqrt(1.0 - cos_t ** 2)
    d = normalize3((-rays[0], -rays[1], -rays[2]))
    t1, t2 = tangent_frame(d)
    cp = sin_t * torch.cos(phi)
    sp = sin_t * torch.sin(phi)
    n = tuple(d[i] * cos_t + t1[i] * cp + t2[i] * sp for i in range(3))
    return torch.stack(face_camera_t(n, rays))


def _upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h0, w0) -> (h, w) bilinear upsampling with half-pixel centres
    (the same as ``jax.image.resize(..., "bilinear")`` when enlarging)."""
    return F.interpolate(x[None, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0]


class InitDraws(NamedTuple):
    """The random numbers ``init_state`` consumes."""

    coarse: torch.Tensor   # (hc, wc) uniform in [d_min, d_max)
    jitter: torch.Tensor   # (H, W) uniform in [-0.02, 0.02)
    cos_t: torch.Tensor    # (H, W) uniform in [0.5, 1)
    phi: torch.Tensor      # (H, W) uniform in [0, 2 pi)


def _uniform(gen: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def init_state_draws(gen: torch.Generator, h: int, w: int, d_min, d_max,
                     device, smooth_grid: int = 8) -> InitDraws:
    hc = max(2, h // smooth_grid)
    wc = max(2, w // smooth_grid)
    return InitDraws(
        coarse=_uniform(gen, (hc, wc), d_min, d_max, device),
        jitter=_uniform(gen, (h, w), -0.02, 0.02, device),
        cos_t=_uniform(gen, (h, w), 0.5, 1.0, device),
        phi=_uniform(gen, (h, w), 0.0, 2 * math.pi, device))


def init_state_apply(rays: torch.Tensor, draws: InitDraws, d_min,
                     d_max) -> PatchMatchState:
    """Random-plane initialisation from its draws: a coarse random depth
    grid, bilinearly upsampled, plus per-pixel jitter."""
    _, h, w = rays.shape
    depth = _upsample_bilinear(draws.coarse, h, w)
    span = d_max - d_min
    depth = torch.clamp(depth + draws.jitter * span, d_min, d_max)
    normal = random_normals(rays, draws.cos_t, draws.phi)
    cost = torch.full((h, w), 2.0, dtype=torch.float32, device=rays.device)
    return PatchMatchState(depth=depth, normal=normal, cost=cost)


def init_state(gen: torch.Generator, rays: torch.Tensor, d_min,
               d_max) -> PatchMatchState:
    """Random-plane initialisation (ref: InitDepthMap's random fallback)."""
    _, h, w = rays.shape
    draws = init_state_draws(gen, h, w, d_min, d_max, rays.device)
    return init_state_apply(rays, draws, d_min, d_max)
