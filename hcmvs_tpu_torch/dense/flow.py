"""Dense optical flow for the cross-consistency term (PyTorch port of the
"lk" backend of ``hcmvs_tpu/dense/flow.py``).

The reference computes Farneback flow from each reference image to its
best neighbour (ref: frame_main/libs/MVS/SceneDensify.cpp:404-508,
cv::calcOpticalFlowFarneback at :470) and scores PatchMatch hypotheses
against it (``score.flow_score``).  Farneback needs OpenCV, which the
port's machine does not have, so the port has only the backend the JAX
package itself takes where cv2 is missing: pyramidal Lucas-Kanade.

Lucas-Kanade, coarse to fine: at each pyramid level the neighbour is
warped by the upsampled flow (bilinear, ``ops.sampling``), the image
gradients and the temporal difference feed per-pixel 2x2 normal equations
over a (2r+1)^2 window, and the clamped increment accumulates.  Window
sums are zero-padded ("SAME") and taken as two passes of shifted adds;
the pyramid blurs with wrap-around rolls before striding, and the flow is
upsampled with half-pixel centres and clamped edges, as
``jax.image.resize(..., "bilinear")`` does when enlarging.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hcmvs_tpu_torch.ops.sampling import bilinear_sample_xy


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


def scene_flows(grays: torch.Tensor, nbr_idx) -> torch.Tensor:
    """(N, 2, H, W) Lucas-Kanade flow from each view of ``grays`` (N, H,
    W) to its best (first) neighbour (ref: DepthData.flow_images,
    DepthMap.h:242), on the images' device."""
    first = [int(row[0]) for row in nbr_idx]
    return torch.stack([lk_flow(grays[i], grays[j])
                        for i, j in enumerate(first)])
