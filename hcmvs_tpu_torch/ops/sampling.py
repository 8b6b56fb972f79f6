"""Image sampling (PyTorch port of ``hcmvs_tpu/ops/sampling.py``).

The JAX package packs taps into channels because a TPU gather costs per
index; here each tap is a plain index into the flattened image.  The
arithmetic, validity rules and clamping are the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_edge(x: torch.Tensor, top: int, bottom: int = None,
             left: int = None, right: int = None) -> torch.Tensor:
    """Edge-replicating pad of the last two axes (``jnp.pad(mode="edge")``);
    one argument pads all four sides alike."""
    bottom = top if bottom is None else bottom
    left = top if left is None else left
    right = left if right is None else right
    *lead, h, w = x.shape
    y = F.pad(x.reshape(1, -1, h, w), (left, right, top, bottom),
              mode="replicate")
    return y.reshape(*lead, h + top + bottom, w + left + right)


def bilinear_sample_xy(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       oob_value: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (H, W) ``img`` at planes of continuous coordinates x
    (column), y (row); returns (values, in-bounds mask)."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0c = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0c = torch.clamp(y0.to(torch.int64), 0, h - 2)
    flat = img.reshape(-1)
    base = y0c * w + x0c
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(valid, out, oob_value), valid


def _catmull_rom(t: torch.Tensor):
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t + t2 - 0.5 * t3,
            1.0 - 2.5 * t2 + 1.5 * t3,
            0.5 * t + 2.0 * t2 - 1.5 * t3,
            -0.5 * t2 + 0.5 * t3)


def bicubic_sample_xy(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      oob_value: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Catmull-Rom resampling of (H, W) ``img`` (edge-replicated 4x4
    neighbourhood) at planes x, y."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 2)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    r = pad_edge(img, 1, 2, 1, 2)                    # (H+3, W+3)
    wp = w + 3
    flat = r.reshape(-1)
    base = y0i * wp + x0i                            # r[y0i, x0i]
    wx = _catmull_rom(fx)
    wy = _catmull_rom(fy)
    out = 0
    for i in range(4):
        row = 0
        for j in range(4):
            row = row + wx[j] * flat[base + (i * wp + j)]
        out = out + wy[i] * row
    return torch.where(valid, out, oob_value), valid


def nearest_sample_planes_batched(planes: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor, oob_value: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sampling of V independent (C, H, W) maps (``planes`` is
    (V, C, H, W)) at per-map coordinates x, y (V, ...); returns
    ((V, C, ...), valid (V, ...)).  Coordinates are truncated toward zero,
    so pass them pre-rounded."""
    v, c, h, w = planes.shape
    xi = torch.clamp(x.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y.to(torch.int64), 0, h - 1)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    idx = (yi * w + xi).reshape(v, 1, -1).expand(v, c, -1)
    taps = torch.gather(planes.reshape(v, c, h * w), 2, idx)
    out = taps.reshape((v, c) + tuple(x.shape[1:]))
    return torch.where(valid[:, None], out, oob_value), valid


def nearest_sample_xy(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      oob_value: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sampling of (H, W) ``img`` at x (column), y (row), truncated
    toward zero (pass pre-rounded coordinates); returns (values, in-bounds
    mask)."""
    h, w = img.shape[:2]
    xi = torch.clamp(x.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y.to(torch.int64), 0, h - 1)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    return torch.where(valid, img[yi, xi], oob_value), valid


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor,
                    oob_value: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sampling of ``img`` (H, W) or (H, W, C) at packed
    coordinates ``uv`` (..., 2), uv[..., 0] = x (column), uv[..., 1] = y
    (row); returns (values (...) or (..., C), in-bounds mask (...))."""
    h, w = img.shape[:2]
    x = uv[..., 0]
    y = uv[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0c = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0c = torch.clamp(y0.to(torch.int64), 0, h - 2)
    v00 = img[y0c, x0c]
    v01 = img[y0c, x0c + 1]
    v10 = img[y0c + 1, x0c]
    v11 = img[y0c + 1, x0c + 1]
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    mask = valid[..., None] if img.dim() == 3 else valid
    return torch.where(mask, out, oob_value), valid


def nearest_sample_planes(planes: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, oob_value: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sampling of C planes (C, H, W) at shared coordinates x, y
    (truncated toward zero: pass them pre-rounded); returns ((C, ...),
    valid (...))."""
    c, h, w = planes.shape
    xi = torch.clamp(x.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y.to(torch.int64), 0, h - 1)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    taps = planes.reshape(c, -1)[:, (yi * w + xi).reshape(-1)]
    out = taps.reshape((c,) + tuple(x.shape))
    return torch.where(valid[None], out, oob_value), valid


def nearest_sample(img: torch.Tensor, uv: torch.Tensor,
                   oob_value: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest sampling of ``img`` (H, W) or (H, W, C) at packed
    coordinates ``uv`` (..., 2), rounded half to even (label and segment
    maps); valid where the rounded pixel lies in the image."""
    h, w = img.shape[:2]
    x = torch.round(uv[..., 0]).to(torch.int64)
    y = torch.round(uv[..., 1]).to(torch.int64)
    valid = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    out = img[torch.clamp(y, 0, h - 1), torch.clamp(x, 0, w - 1)]
    mask = valid[..., None] if img.dim() == 3 else valid
    return torch.where(mask, out, oob_value), valid
