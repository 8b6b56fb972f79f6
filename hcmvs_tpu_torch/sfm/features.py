"""On-device feature detection + description (DoG + SIFT-like descriptors;
PyTorch port of ``hcmvs_tpu/sfm/features.py``).

The reference pipeline shells out to OpenMVG's SIFT binaries
(ref: frame_main/MvgMvsPipeline.py:184-186 openMVG_main_ComputeFeatures);
here the front end runs on the device: separable Gaussian pyramid,
difference-of-Gaussians extrema with shifted-array comparisons, fixed-K
selection, and 128-d gradient-orientation-histogram descriptors built
from per-keypoint gathers.

- K is fixed; weak images yield masked (score <= 0) keypoints.
- Selections take the lower flat index on ties, as JAX's ``lax.top_k``
  and ``argmax`` (stable sorts), so the same keypoint slots come out.
- The orientation and descriptor histograms add their samples one after
  another in sample order (as XLA's scatter-add on the CPU), the same on
  every device and every run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Keypoints(NamedTuple):
    xy: torch.Tensor          # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor       # (K,) DoG response magnitude; <= 0 -> invalid
    scale: torch.Tensor       # (K,) pyramid sigma
    angle: torch.Tensor       # (K,) dominant orientation (radians)
    desc: torch.Tensor        # (K, 128) L2-normalized descriptors


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(lo, n + hi, device=device), 0, n - 1)


def _sep_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur via shifted adds (edge padding)."""
    h, w = img.shape
    r = len(kernel) // 2
    pad = img[_clamped(h, -r, r, img.device)]
    out = torch.zeros_like(img)
    for i, kv in enumerate(kernel):
        out = out + float(kv) * pad[i:i + h, :]
    pad = out[:, _clamped(w, -r, r, img.device)]
    out2 = torch.zeros_like(img)
    for i, kv in enumerate(kernel):
        out2 = out2 + float(kv) * pad[:, i:i + w]
    return out2


def _shift2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y + dy, x + dx] with edge padding."""
    h, w = img.shape
    return img[_clamped(h, dy, dy, img.device)][
        :, _clamped(w, dx, dx, img.device)]


def top_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dimension, ties to the
    lower index (``lax.top_k``)."""
    return torch.sort(x, descending=True, stable=True).indices[..., :k]


def detect_and_describe(gray: torch.Tensor, max_keypoints: int = 1024,
                        n_scales: int = 4,
                        contrast_threshold: float = 0.015) -> Keypoints:
    """Detect DoG keypoints and compute descriptors for one (H, W) image."""
    h, w = gray.shape
    dev = gray.device
    sigmas = [1.2 * (1.6 ** i) for i in range(n_scales + 1)]
    blurred = [_sep_blur(gray, _gauss_kernel1d(s, int(3 * s)))
               for s in sigmas]
    dogs = [blurred[i + 1] - blurred[i] for i in range(n_scales)]

    # scale-space extrema: strict max/min against 8 spatial neighbours at
    # the same scale and the centre of adjacent scales
    best_score = torch.zeros((h, w), dtype=torch.float32, device=dev)
    best_scale = torch.zeros((h, w), dtype=torch.float32, device=dev)
    r_edge = 10.0  # SIFT edge-response ratio
    for si in range(1, n_scales - 1):
        d = dogs[si]
        neigh = [_shift2(d, dy, dx)
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if (dy, dx) != (0, 0)]
        stack = torch.stack(neigh + [dogs[si - 1], dogs[si + 1]])
        is_max = (d > torch.amax(stack, dim=0)) & (d > contrast_threshold)
        is_min = (d < torch.amin(stack, dim=0)) & (d < -contrast_threshold)
        # per-scale edge suppression via the Hessian ratio at this scale
        hxx = _shift2(d, 0, 1) + _shift2(d, 0, -1) - 2 * d
        hyy = _shift2(d, 1, 0) + _shift2(d, -1, 0) - 2 * d
        hxy = 0.25 * (_shift2(d, 1, 1) + _shift2(d, -1, -1)
                      - _shift2(d, 1, -1) - _shift2(d, -1, 1))
        tr = hxx + hyy
        det = hxx * hyy - hxy * hxy
        edge_ok = (det > 0) & (tr * tr * r_edge < (r_edge + 1) ** 2 * det)
        resp = torch.abs(d) * (is_max | is_min) * edge_ok
        better = resp > best_score
        best_score = torch.where(better, resp, best_score)
        best_scale = torch.where(better, sigmas[si], best_scale)

    # keep away from borders (descriptor support)
    margin = 16
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    interior = ((xx >= margin) & (xx < w - margin)
                & (yy >= margin) & (yy < h - margin))
    best_score = torch.where(interior, best_score, 0.0)

    flat = best_score.reshape(-1)
    idx = top_desc(flat, max_keypoints)
    scores = flat[idx]
    ky = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    kx = (idx % w).to(torch.float32)
    kscale = best_scale.reshape(-1)[idx]

    # sub-pixel refinement: 1D quadratic fit of the response peak along x
    # and y
    yi = ky.to(torch.int64)
    xi = kx.to(torch.int64)
    resp = best_score

    def _quad(dm, d0, dp):
        denom = dm + dp - 2.0 * d0
        off = 0.5 * (dm - dp) / torch.where(torch.abs(denom) < 1e-12, 1e-12,
                                            denom)
        return torch.clamp(off, -0.5, 0.5)

    xm = torch.clamp(xi - 1, 0, w - 1)
    xp = torch.clamp(xi + 1, 0, w - 1)
    ym = torch.clamp(yi - 1, 0, h - 1)
    yp = torch.clamp(yi + 1, 0, h - 1)
    kx = kx + _quad(resp[yi, xm], resp[yi, xi], resp[yi, xp])
    ky = ky + _quad(resp[ym, xi], resp[yi, xi], resp[yp, xi])

    # gradients of the base blur for orientation + descriptors
    base = blurred[1]
    gx = 0.5 * (_shift2(base, 0, -1) - _shift2(base, 0, 1))
    gy = 0.5 * (_shift2(base, -1, 0) - _shift2(base, 1, 0))

    # descriptor/orientation support scales with the detected sigma,
    # normalised so the first interior DoG scale keeps the base support
    ksup = torch.clamp_min(kscale, sigmas[1]) / sigmas[1]
    angle = _dominant_orientation(gx, gy, kx, ky, sup=ksup)
    desc = _descriptors(gx, gy, kx, ky, angle, sup=ksup)
    return Keypoints(xy=torch.stack([kx, ky], dim=-1), score=scores,
                     scale=kscale, angle=angle, desc=desc)


def detect_and_describe_pyramid(gray: torch.Tensor,
                                max_keypoints: int = 1024,
                                n_octaves: int = 3,
                                n_scales: int = 4,
                                contrast_threshold: float = 0.015
                                ) -> Keypoints:
    """Multi-octave detection: the single-octave detector on a
    half-resolution pyramid, keypoints mapped back to full-res coords
    (OpenMVG's SIFT octaves, ref: MvgMvsPipeline.py:184-186).  The budget
    is split 4:1:0.25 by pixel count; the strongest features over all
    octaves fill the K = max_keypoints slots (masked entries pad)."""
    weights = [4.0 ** -o for o in range(n_octaves)]
    total = sum(weights)
    parts = []
    img = gray
    for o in range(n_octaves):
        h, w = img.shape
        if min(h, w) < 48:      # descriptor support no longer fits
            break
        per_oct = max(int(max_keypoints * weights[o] / total), 16)
        kp = detect_and_describe(img, per_oct, n_scales, contrast_threshold)
        f = float(2 ** o)
        parts.append(Keypoints(xy=kp.xy * f, score=kp.score,
                               scale=kp.scale * f, angle=kp.angle,
                               desc=kp.desc))
        if o < n_octaves - 1:   # anti-alias blur, then decimate
            img = _sep_blur(img, _gauss_kernel1d(1.2, 3))[::2, ::2]
    kps = Keypoints(*(torch.cat([getattr(p, f) for p in parts])
                      for f in Keypoints._fields))
    k = min(max_keypoints, kps.score.shape[0])
    order = top_desc(kps.score, k)
    kps = Keypoints(*(getattr(kps, f)[order] for f in Keypoints._fields))
    if k < max_keypoints:
        pad = max_keypoints - k

        def padded(x, value=0.0):
            fill = torch.full((pad,) + tuple(x.shape[1:]), value,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, fill])

        kps = Keypoints(xy=padded(kps.xy), score=padded(kps.score, -1.0),
                        scale=padded(kps.scale, 1.0),
                        angle=padded(kps.angle), desc=padded(kps.desc))
    return kps


def _bilinear_at(img: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0 = torch.clamp(y0.to(torch.int64), 0, h - 2)
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _histogram(bins: torch.Tensor, weights: torch.Tensor, n_bins: int,
               hist: torch.Tensor) -> torch.Tensor:
    """Adds (K, P) weights into (K, n_bins) rows at (K, P) bins, sample by
    sample in order."""
    lanes = torch.arange(n_bins, device=bins.device)
    for p in range(bins.shape[1]):
        hist = hist + torch.where(bins[:, p, None] == lanes,
                                  weights[:, p, None], 0.0)
    return hist


def _dominant_orientation(gx: torch.Tensor, gy: torch.Tensor,
                          kx: torch.Tensor, ky: torch.Tensor,
                          n_bins: int = 36, radius: int = 6,
                          sup=None) -> torch.Tensor:
    """Histogram of gradient directions in a disc around each keypoint;
    ``sup``: per-keypoint support multiplier (sigma-proportional)."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]
    offs = np.array(offs, np.float32)          # (P, 2)
    sig2 = (radius / 2) ** 2
    if sup is None:
        sup = torch.ones_like(kx)
    dev = kx.device
    oy = torch.from_numpy(offs[:, 0]).to(dev)
    ox = torch.from_numpy(offs[:, 1]).to(dev)
    g = torch.exp(torch.from_numpy(
        -(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2 * sig2)).to(dev))
    xs = kx[:, None] + ox * sup[:, None]
    ys = ky[:, None] + oy * sup[:, None]
    gxs = _bilinear_at(gx, xs, ys)
    gys = _bilinear_at(gy, xs, ys)
    mag = torch.hypot(gxs, gys)
    wgt = mag * g
    ang = torch.atan2(gys, gxs)                # [-pi, pi]
    bins = ((ang + math.pi) / (2 * math.pi) * n_bins).to(torch.int64)
    bins = torch.clamp(bins, 0, n_bins - 1)
    hist = _histogram(bins, wgt, n_bins,
                      torch.zeros(len(kx), n_bins, device=dev))
    b = torch.argmax(hist, dim=1)
    return (b.to(torch.float32) + 0.5) / n_bins * 2 * math.pi - math.pi


def _descriptors(gx: torch.Tensor, gy: torch.Tensor, kx: torch.Tensor,
                 ky: torch.Tensor, angle: torch.Tensor,
                 n_cells: int = 4, n_ori: int = 8,
                 cell_size: float = 3.0, sup=None) -> torch.Tensor:
    """SIFT-like 4x4x8 gradient histograms, rotation-normalized."""
    half = n_cells * cell_size / 2.0
    step = cell_size
    r = np.arange(n_cells) * step - half + step / 2
    sy, sx = np.meshgrid(r, r, indexing="ij")
    # supersample each cell 2x2
    sub = np.array([-0.75, 0.75]) * (step / 4)
    pts = []
    for oy in sub:
        for ox in sub:
            pts.append(np.stack([sy + oy, sx + ox], axis=-1).reshape(-1, 2))
    pts = np.concatenate(pts, 0).astype(np.float32)      # (P, 2) (y, x)
    cell_of = np.tile(np.arange(n_cells * n_cells), len(sub) ** 2)
    if sup is None:
        sup = torch.ones_like(kx)
    dev = kx.device
    py = torch.from_numpy(pts[:, 0]).to(dev)
    px = torch.from_numpy(pts[:, 1]).to(dev)
    cell = torch.from_numpy(cell_of).to(dev)
    ca = (torch.cos(angle) * sup)[:, None]
    sa = (torch.sin(angle) * sup)[:, None]
    xs = kx[:, None] + ca * px - sa * py
    ys = ky[:, None] + sa * px + ca * py
    gxs = _bilinear_at(gx, xs, ys)
    gys = _bilinear_at(gy, xs, ys)
    mag = torch.hypot(gxs, gys)
    ang = torch.atan2(gys, gxs) - angle[:, None]
    bins = torch.remainder((ang + math.pi) / (2 * math.pi) * n_ori, n_ori)
    b0 = torch.remainder(torch.floor(bins).to(torch.int64), n_ori)
    fb = bins - torch.floor(bins)
    idx0 = cell * n_ori + b0
    idx1 = cell * n_ori + torch.remainder(b0 + 1, n_ori)
    n_out = n_cells * n_cells * n_ori
    d = torch.zeros(len(kx), n_out, device=dev)
    d = _histogram(idx0, mag * (1 - fb), n_out, d)
    d = _histogram(idx1, mag * fb, n_out, d)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=1, keepdim=True), 1e-9)
    d = torch.clamp_max(d, 0.2)                     # SIFT clamp
    return d / torch.clamp_min(torch.linalg.norm(d, dim=1, keepdim=True),
                               1e-9)
