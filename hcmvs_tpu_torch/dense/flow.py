"""Dense optical flow for the cross-consistency term (PyTorch port of
``hcmvs_tpu/dense/flow.py``).

The reference computes Farneback flow from each reference image to its
best neighbour (ref: frame_main/libs/MVS/SceneDensify.cpp:404-508,
cv::calcOpticalFlowFarneback at :470) and scores PatchMatch hypotheses
against it (``score.flow_score``).  The JAX package does the same through
OpenCV wherever cv2 imports (every run that reads images) and falls back
to pyramidal Lucas-Kanade without it.  The port has both backends, in
plain PyTorch on the images' device: ``scene_flows`` takes
``DEFAULT_BACKEND`` ("farneback", the counterpart of the JAX package's
``_HAVE_CV2``) unless a backend is named.

Farneback (``farneback_flow``), as OpenCV's optflowgf.cpp computes it
with flags 0: the 8-bit images, per pyramid level a Gaussian blur of the
full image (reflect-101) and a bilinear resize to the level, the
polynomial expansion of both images (poly_n, poly_sigma), then
``iterations`` rounds of the normal-equation terms (the neighbour's
expansion read at the pixel moved by the flow, damped near the edges)
and the flow from their box means over ``winsize``.  The arithmetic is
OpenCV's term for term: f32 where it is f32 (the blur, the vertical
expansion pass, the terms), f64 where it is f64 (the horizontal pass, the
window sums and the solve), so the flow agrees with cv2's to ~1e-4 px
(tests/test_torch_flow.py).  OpenCV updates the terms in row stripes
behind its sweep, which equals a whole-image update; its window sums run
in f64 cumulative sums here.

Lucas-Kanade (``lk_flow``), coarse to fine: at each pyramid level the
neighbour is warped by the upsampled flow (bilinear, ``ops.sampling``),
the image gradients and the temporal difference feed per-pixel 2x2 normal
equations over a (2r+1)^2 window, and the clamped increment accumulates.
Window sums are zero-padded ("SAME") and taken as two passes of shifted
adds; the pyramid blurs with wrap-around rolls before striding, and the
flow is upsampled with half-pixel centres and clamped edges, as
``jax.image.resize(..., "bilinear")`` does when enlarging.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hcmvs_tpu_torch.ops.sampling import bilinear_sample_xy

DEFAULT_BACKEND = "farneback"   # scene_flows' backend when none is named

_MIN_SIZE = 32           # coarsest pyramid level's least width and height
_EDGE = 5                # rows / columns damped at the image border
_EDGE_WEIGHTS = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-padded (2r+1) x (2r+1) window sums of (H, W) ``x``."""
    h, w = x.shape
    p = F.pad(x, (r, r, r, r))
    rows = p[:, 0:w]
    for dx in range(1, 2 * r + 1):
        rows = rows + p[:, dx:dx + w]
    out = rows[0:h]
    for dy in range(1, 2 * r + 1):
        out = out + rows[dy:dy + h]
    return out


def _down(x: torch.Tensor) -> torch.Tensor:
    x = (x + torch.roll(x, 1, 0) + torch.roll(x, 1, 1)
         + torch.roll(torch.roll(x, 1, 0), 1, 1)) * 0.25
    return x[::2, ::2]


def upsample_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(2, h0, w0) -> (2, h, w), bilinear, values unchanged."""
    return F.interpolate(flow[None], size=(h, w), mode="bilinear",
                         align_corners=False)[0]


def lk_flow(ref: torch.Tensor, nbr: torch.Tensor, levels: int = 3,
            iters: int = 5, radius: int = 7) -> torch.Tensor:
    """Dense pyramidal Lucas-Kanade: (2, H, W) flow ref -> nbr."""
    pyr_r, pyr_n = [ref], [nbr]
    for _ in range(levels - 1):
        pyr_r.append(_down(pyr_r[-1]))
        pyr_n.append(_down(pyr_n[-1]))
    flow = torch.zeros((2,) + tuple(pyr_r[-1].shape), dtype=torch.float32,
                       device=ref.device)
    lim = 2.0 ** 3
    for lvl in range(levels - 1, -1, -1):
        r_img, n_img = pyr_r[lvl], pyr_n[lvl]
        hh, ww = r_img.shape
        if tuple(flow.shape[1:]) != (hh, ww):
            flow = 2.0 * upsample_flow(flow, hh, ww)
        yy, xx = torch.meshgrid(
            torch.arange(hh, dtype=torch.float32, device=ref.device),
            torch.arange(ww, dtype=torch.float32, device=ref.device),
            indexing="ij")
        ix = (torch.roll(r_img, -1, 1) - torch.roll(r_img, 1, 1)) * 0.5
        iy = (torch.roll(r_img, -1, 0) - torch.roll(r_img, 1, 0)) * 0.5
        a11 = _box_sum(ix * ix, radius)
        a12 = _box_sum(ix * iy, radius)
        a22 = _box_sum(iy * iy, radius)
        det = a11 * a22 - a12 * a12
        ok = det > 1e-9
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        for _ in range(iters):
            warped, valid = bilinear_sample_xy(n_img, xx + flow[0],
                                               yy + flow[1])
            it = torch.where(valid, warped - r_img, 0.0)
            b1 = -_box_sum(ix * it, radius)
            b2 = -_box_sum(iy * it, radius)
            du = (a22 * b1 - a12 * b2) * inv_det
            dv = (a11 * b2 - a12 * b1) * inv_det
            flow = flow + torch.stack([torch.clamp(du, -lim, lim),
                                       torch.clamp(dv, -lim, lim)])
    return flow


@functools.lru_cache(maxsize=None)
def _gaussian_taps(n: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel(n, sigma, CV_32F): the weights of x = -(n-1)/2
    .. (n-1)/2 in double, normalised, as f32; sigma 0 (the full-size
    level, where n is 3) takes OpenCV's fixed [1/4, 1/2, 1/4]."""
    if sigma <= 0:
        return np.array([0.25, 0.5, 0.25], np.float32)
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-x * x / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


# The constant tables below (pad indices, resize taps, edge damping) are
# built once per size and device and kept there: rebuilding them from host
# arrays would copy from pageable memory, which waits for the stream.
@functools.lru_cache(maxsize=256)
def _pad_index(n: int, size: int, device, reflect: bool) -> torch.Tensor:
    """Indices of a pad of ``n`` on each side of ``size``: reflect-101 or
    edge-replicating."""
    i = torch.arange(-n, size + n, device=device)
    if not reflect:
        return torch.clamp(i, 0, size - 1)
    period = 2 * (size - 1)
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= size, period - i, i)


def _symmetric_filter(x: torch.Tensor, taps: np.ndarray, dim: int
                      ) -> torch.Tensor:
    """A symmetric f32 filter along ``dim`` with the reflect-101 border:
    the centre tap, then each pair of outer taps (summed first), in a
    fixed order."""
    n = len(taps) // 2
    size = x.shape[dim]
    src = x.index_select(dim, _pad_index(n, size, x.device, True))
    sl = lambda k: src.narrow(dim, n + k, size)
    out = sl(0) * float(taps[n])
    for k in range(1, n + 1):
        out = out + (sl(-k) + sl(k)) * float(taps[n - k])
    return out


def _gaussian_blur(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """cv::GaussianBlur of (..., H, W) f32 with a separable kernel and
    the reflect-101 border: along the rows, then along the columns."""
    return _symmetric_filter(_symmetric_filter(img, taps, -1), taps, -2)


@functools.lru_cache(maxsize=256)
def _linear_taps(dst: int, src: int, clamp_weight: bool, device):
    """cv::resize INTER_LINEAR along one axis, on ``device``: each output
    position's two source indices (the floor of its half-pixel-centred
    coordinate, in double, and the next one, both clamped to the source)
    and the f32 weight of the second, widened to f64; with
    ``clamp_weight``, a position whose floor is clamped takes weight 0."""
    fx = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(fx)
    t = (fx - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    if clamp_weight:
        t[(i0 < 0) | (i0 >= src - 1)] = 0.0
    return (torch.as_tensor(np.clip(i0, 0, src - 1), device=device),
            torch.as_tensor(np.clip(i0 + 1, 0, src - 1), device=device),
            torch.as_tensor(t, device=device).to(torch.float64))


def _resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cv::resize(..., INTER_LINEAR) of (..., H0, W0) f32 to (h, w): along
    x into f32 rows (indices clamped, a clamped position weighted 0 on the
    far tap), then pairs of rows along y (indices clamped), each blend
    rounded once to f32; an exact 2x reduction takes OpenCV's fast area
    path (the mean of each 2 x 2 block)."""
    h0, w0 = img.shape[-2:]
    dev = img.device
    if (h0, w0) == (h, w):
        return img
    if (h0, w0) == (2 * h, 2 * w):
        a, b = img[..., 0::2, 0::2], img[..., 0::2, 1::2]
        c, d = img[..., 1::2, 0::2], img[..., 1::2, 1::2]
        return (((a + b) + c) + d) * 0.25

    def blend(x, dim, size, clamp_weight):
        i0, i1, t = _linear_taps(size, x.shape[dim], clamp_weight, dev)
        if dim == -2:
            t = t[:, None]
        return (x.index_select(dim, i0) * (1.0 - t)
                + x.index_select(dim, i1) * t).to(torch.float32)

    return blend(blend(img, -1, w, True), -2, h, False)


@functools.lru_cache(maxsize=None)
def _poly_basis(n: int, sigma: float):
    """FarnebackPrepareGaussian: the f32 taps g, x g, x^2 g of the
    expansion window at x = 0 .. n, and the entries ig11, ig03, ig33,
    ig55 of the inverse of its 6 x 6 Gram matrix (sums of f32 products
    in f64)."""
    f = np.float32
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma)).astype(f)
    g = (g.astype(np.float64) / float(np.sum(g.astype(np.float64)))
         ).astype(f)
    xg = (x.astype(f) * g).astype(f)
    xxg = ((x * x).astype(f) * g).astype(f)
    G = np.zeros((6, 6))
    xf = x.astype(f)
    for yi in range(2 * n + 1):
        gg = (g[yi] * g).astype(f)
        gxx = gg * xf * xf
        G[0, 0] += float(np.sum(gg.astype(np.float64)))
        G[1, 1] += float(np.sum(gxx.astype(np.float64)))
        G[3, 3] += float(np.sum((gxx * xf * xf).astype(np.float64)))
        G[5, 5] += float(np.sum((gxx * xf[yi] * xf[yi]).astype(np.float64)))
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return (g[n:], xg[n:], xxg[n:],
            (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]))


def _poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """FarnebackPolyExp: (B, H, W) f32 -> (B, 5, H, W) f32 coefficients
    of the local quadratic fit, in OpenCV's channel order (d/dy, d/dx,
    y^2, x^2, xy).  The vertical pass is f32 over edge-replicated rows,
    the horizontal one f64 over edge-replicated columns, each term
    rounded where OpenCV rounds it."""
    _, h, w = img.shape
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_basis(n, sigma)
    src = img.index_select(1, _pad_index(n, h, img.device, False))
    row = lambda k: src[:, n + k:n + k + h]
    r0 = row(0) * float(g[0])
    r1 = r2 = 0.0
    for k in range(1, n + 1):
        p = row(-k) + row(k)
        d = row(k) - row(-k)
        r0 = r0 + p * float(g[k])
        r1 = r1 + d * float(xg[k])
        r2 = r2 + p * float(xxg[k])
    # (B, 3, H, W + 2n): the three vertical terms, edge-replicated columns
    r = torch.stack([r0, r1, r2], 1).index_select(
        3, _pad_index(n, w, img.device, False))
    col = lambda k: r[..., n + k:n + k + w]
    f64 = torch.float64
    b1, b3, b5 = (col(0) * float(g[0])).to(f64).unbind(1)
    b2 = b4 = b6 = 0.0
    for k in range(1, n + 1):
        p, d = col(k) + col(-k), col(k) - col(-k)
        tg = p[:, 0].to(f64)
        b1 = b1 + tg * float(g[k])
        b4 = b4 + tg * float(xxg[k])
        b2 = b2 + (d[:, 0] * float(xg[k])).to(f64)
        b3 = b3 + (p[:, 1] * float(g[k])).to(f64)
        b6 = b6 + (d[:, 1] * float(xg[k])).to(f64)
        b5 = b5 + (p[:, 2] * float(g[k])).to(f64)
    f32 = torch.float32
    return torch.stack([(b3 * ig11).to(f32), (b2 * ig11).to(f32),
                        (b1 * ig03 + b5 * ig33).to(f32),
                        (b1 * ig03 + b4 * ig33).to(f32),
                        (b6 * ig55).to(f32)], 1)


@functools.lru_cache(maxsize=64)
def _level_grid(h: int, w: int, device):
    """A level's pixel columns (1, W) and rows (H, 1), f32, and the (H, W)
    damping of the matrices within _EDGE of an edge."""
    def edge(size):
        s = np.ones(size, np.float32)
        for i in range(min(_EDGE, size)):
            s[i] *= np.float32(_EDGE_WEIGHTS[i])
            s[size - 1 - i] *= np.float32(_EDGE_WEIGHTS[i])
        return torch.as_tensor(s, device=device)
    return (torch.arange(w, dtype=torch.float32, device=device)[None],
            torch.arange(h, dtype=torch.float32, device=device)[:, None],
            edge(w)[None] * edge(h)[:, None])


def _update_matrices(R: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: the (5, H, W) f32 normal-equation terms
    of every pixel, R = (R0, R1) (2, 5, H, W), R1 read bilinearly at the
    pixel moved by ``flow`` where its 2 x 2 taps lie in the image."""
    R0, R1 = R[0], R[1]
    _, h, w = R0.shape
    xs, ys, scale = _level_grid(h, w, R0.device)
    dx, dy = flow[0], flow[1]
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fx = fx - x1
    fy = fy - y1
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    base = (torch.clamp(y1, 0, h - 2) * w
            + torch.clamp(x1, 0, w - 2)).to(torch.int64).reshape(-1)
    flat = R1.reshape(5, -1)
    tap = lambda off: flat[:, base + off].reshape(5, h, w)
    a00 = (1.0 - fx) * (1.0 - fy)
    a01 = fx * (1.0 - fy)
    a10 = (1.0 - fx) * fy
    a11 = fx * fy
    r = ((a00 * tap(0) + a01 * tap(1)) + a10 * tap(w)) + a11 * tap(w + 1)
    r2 = torch.where(inside, r[0], 0.0)
    r3 = torch.where(inside, r[1], 0.0)
    r4 = torch.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = torch.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = torch.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5 + (r4 * dy + r6 * dx)
    r3 = (R0[1] - r3) * 0.5 + (r6 * dy + r5 * dx)
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6,
                        r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3])


def _box_mean(m: torch.Tensor, size: int) -> torch.Tensor:
    """(C, H, W) -> f64 means over ``size`` x ``size`` windows with
    edge-replicated borders: differences of f64 cumulative sums, along
    the columns, then along the rows."""
    r = size // 2
    x = m.to(torch.float64)
    for dim in (1, 2):
        n = x.shape[dim]
        c = torch.cumsum(x.index_select(
            dim, _pad_index(r + 1, n, m.device, False)), dim)
        x = c.narrow(dim, size, n) - c.narrow(dim, 0, n)
    return x * (1.0 / (size * size))


def _solve_flow(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """FarnebackUpdateFlow_Blur: every pixel's flow from the window means
    of its terms, the 2 x 2 system regularised by 1e-3, (2, H, W) f32."""
    g11, g12, g22, h1, h2 = _box_mean(M, winsize)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet]).to(torch.float32)


def pyramid_levels(h: int, w: int, levels: int = 3,
                   pyr_scale: float = 0.5) -> int:
    """Farneback's pyramid levels at (h, w): the full size and up to
    ``levels`` reductions by ``pyr_scale`` while both sides stay at least
    _MIN_SIZE."""
    top, scale = 0, 1.0
    while top < levels:
        scale *= pyr_scale
        if w * scale < _MIN_SIZE or h * scale < _MIN_SIZE:
            break
        top += 1
    return top + 1


def farneback_flow(ref_gray: torch.Tensor, nbr_gray: torch.Tensor,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3,
                   poly_n: int = 5, poly_sigma: float = 1.2
                   ) -> torch.Tensor:
    """(2, H, W) f32 flow (u, v) from ``ref_gray`` to ``nbr_gray`` ((H, W)
    in [0, 1]), on their device: cv::calcOpticalFlowFarneback(a, b, None,
    pyr_scale, levels, winsize, iterations, poly_n, poly_sigma, 0) of the
    images as 8-bit (times 255, clipped, truncated), as the JAX package
    computes it through OpenCV."""
    h, w = ref_gray.shape
    imgs = torch.floor(torch.clamp(
        torch.stack([ref_gray, nbr_gray]).to(torch.float32) * 255.0,
        0.0, 255.0))
    flow = None
    for k in range(pyramid_levels(h, w, levels, pyr_scale) - 1, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(round(sigma * 5) | 1, 3)
        hk, wk = round(h * scale), round(w * scale)
        R = _poly_exp(_resize_linear(_gaussian_blur(
            imgs, _gaussian_taps(ksize, sigma)), hk, wk), poly_n, poly_sigma)
        if flow is None:
            flow = torch.zeros((2, hk, wk), dtype=torch.float32,
                               device=imgs.device)
        else:
            flow = _resize_linear(flow, hk, wk) * (1.0 / pyr_scale)
        M = _update_matrices(R, flow)
        for i in range(iterations):
            flow = _solve_flow(M, winsize)
            if i < iterations - 1:
                M = _update_matrices(R, flow)
    return flow


def scene_flows(grays: torch.Tensor, nbr_idx,
                backend: Optional[str] = None) -> torch.Tensor:
    """(N, 2, H, W) flow from each view of ``grays`` (N, H, W) to its best
    (first) neighbour (ref: DepthData.flow_images, DepthMap.h:242), on the
    images' device: ``backend`` "farneback" or "lk", None taking
    ``DEFAULT_BACKEND``."""
    backend = DEFAULT_BACKEND if backend is None else backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown flow backend {backend!r}")
    fn = _BACKENDS[backend]
    first = [int(row[0]) for row in nbr_idx]
    return torch.stack([fn(grays[i], grays[j])
                        for i, j in enumerate(first)])


_BACKENDS = {"farneback": farneback_flow, "lk": lk_flow}
