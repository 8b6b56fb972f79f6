"""Image gradient operators (PyTorch port of ``hcmvs_tpu/ops/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from hcmvs_tpu_torch.ops.sampling import pad_edge


def sobel_xy(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel x/y responses of a (H, W) image, edges replicated."""
    h, w = img.shape
    p = pad_edge(img, 1)

    def at(dy: int, dx: int) -> torch.Tensor:   # img[y - dy, x - dx]
        return p[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]

    tl, t, tr = at(1, 1), at(1, 0), at(1, -1)
    l, r = at(0, 1), at(0, -1)
    bl, b, br = at(-1, 1), at(-1, 0), at(-1, -1)
    gx = (tr + 2 * r + br) - (tl + 2 * l + bl)
    gy = (bl + 2 * b + br) - (tl + 2 * t + tr)
    return gx, gy


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """``0.5*|Sobel_x| + 0.5*|Sobel_y|`` of a [0, 1] image in the
    reference's 8-bit range, saturated at 255 (ref: SceneDensify.cpp:589-596
    InitGraMap)."""
    gx, gy = sobel_xy(img * 255.0)
    return torch.clamp_max(0.5 * (gx.abs() + gy.abs()), 255.0)


def normals_from_depth(depth: torch.Tensor, rays: torch.Tensor
                       ) -> torch.Tensor:
    """(3, H, W) camera-frame normals from a depth map's 3D gradients
    (ref: EstimateNormalMap, frame_main/libs/MVS/DepthMap.cpp:2272): the
    cross product of the central differences along x and y (edges
    replicated), oriented toward the camera; (0, 0, -1) where the depth
    is 0.  ``rays`` is the (3, H, W) pixel-ray field
    (``dense.types.pixel_rays``)."""
    h, w = depth.shape
    X = rays * depth[None]                                 # (3, H, W)
    p = pad_edge(X, 1)

    def at(dy: int, dx: int) -> torch.Tensor:   # X[:, y - dy, x - dx]
        return p[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]

    dx = at(0, 1) - at(0, -1)
    dy = at(1, 0) - at(-1, 0)
    n = (dy[1] * dx[2] - dy[2] * dx[1],
         dy[2] * dx[0] - dy[0] * dx[2],
         dy[0] * dx[1] - dy[1] * dx[0])
    norm = torch.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2)
    inv = 1.0 / torch.clamp_min(norm, 1e-12)
    n = tuple(c * inv for c in n)
    # face the camera: n . ray < 0
    n_dot_r = n[0] * rays[0] + n[1] * rays[1] + n[2] * rays[2]
    sign = torch.where(n_dot_r > 0, -1.0, 1.0)
    n = torch.stack([c * sign for c in n])
    background = torch.stack([torch.zeros_like(depth),
                              torch.zeros_like(depth),
                              -torch.ones_like(depth)])
    return torch.where((depth > 0)[None], n, background)
