"""Weighted-ZNCC accumulation over static patch offsets against the
centre-warped source images (PyTorch port of
``hcmvs_tpu/ops/pallas_zncc.py``).

The warped scoring mode (``dense/score.photometric_scores_warped``)
samples each source view once per pixel at the hypothesis' warp centre
and reads the patch from that image at static offsets.  Kernel E,
``zncc_warped`` (``kernels/csrc/zncc_warped.cu``), replaces the Pallas
``_kernel``; ``zncc_warped_plain`` is its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hcmvs_tpu_torch import kernels

_SIGMA_COLOR = 0.2   # ref: DepthMap.h:538 GetWeight sigmaColor


def zncc_warped_plain(ref_pad: torch.Tensor, tm: torch.Tensor,
                      nsq0: torch.Tensor, warped_pad: torch.Tensor,
                      valid_pad: torch.Tensor, hw: torch.Tensor,
                      acc: torch.Tensor, scan_offsets, pad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel E: the per-offset loop of the JAX package's
    warped scan (``score.py`` ``photometric_scores_warped``), in its order;
    the spatial weight takes the Pallas kernel's form
    ``(dy^2 + dx^2) * (-0.5 / hw^2)``.

    ``ref_pad`` (H+2p, W+2p); ``tm``, ``nsq0``, ``hw`` (H, W);
    ``warped_pad``, ``valid_pad`` (V, H+2p, W+2p); ``acc`` (V, 4, H, W)
    initial (num, s1, sq1, sw).  Returns (score, var1), both (V, H, W):
    ``1 - clip(num / sqrt(nsq0 * var1))`` before robust masking, and the
    warped patch variance.  K candidates against the same reference:
    ``warped_pad``, ``valid_pad`` (K, V, H+2p, W+2p), ``acc`` (K, V, 4, H,
    W) -> (K, V, H, W) each."""
    h, w = tm.shape

    def shifted(x, dy, dx):
        return x[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    ref_c = shifted(ref_pad, 0, 0)
    inv_2sc2 = -1.0 / (2.0 * _SIGMA_COLOR ** 2)
    inv_2hw2 = -0.5 * torch.reciprocal(hw * hw)
    scores, var1s = [], []
    for vi in range(warped_pad.shape[-3]):
        num, s1, sq1, sw = acc[..., vi, :, :, :].unbind(-3)
        for dy, dx in scan_offsets:
            v_d = shifted(ref_pad, dy, dx)
            w_d = shifted(warped_pad[..., vi, :, :], dy, dx)
            ok = shifted(valid_pad[..., vi, :, :], dy, dx)
            w_color = (v_d - ref_c) ** 2 * inv_2sc2
            w_sp = float(dy * dy + dx * dx) * inv_2hw2
            in_win = (max(abs(dy), abs(dx)) <= hw).to(torch.float32)
            wt = torch.exp(w_color + w_sp) * in_win * ok
            num = num + wt * (v_d - tm) * w_d
            s1 = s1 + wt * w_d
            sq1 = sq1 + wt * w_d * w_d
            sw = sw + wt
        var1 = sq1 - s1 * s1 / torch.clamp_min(sw, 1e-12)
        denom = torch.sqrt(torch.clamp_min(nsq0 * var1, 1e-16))
        scores.append(1.0 - torch.clamp(num / denom, -1.0, 1.0))
        var1s.append(var1)
    return torch.stack(scores, dim=-3), torch.stack(var1s, dim=-3)


def zncc_warped(ref_pad: torch.Tensor, tm: torch.Tensor, nsq0: torch.Tensor,
                warped_pad: torch.Tensor, valid_pad: torch.Tensor,
                hw: torch.Tensor, acc: torch.Tensor, scan_offsets, pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, var1) of the warped-mode ZNCC (see ``zncc_warped_plain``).
    Kernel E on CUDA, the plain version on the CPU."""
    if kernels.use_kernel(tm):
        return kernels.zncc_warped(ref_pad, tm, nsq0, warped_pad, valid_pad,
                                   hw, acc, scan_offsets, pad)
    return zncc_warped_plain(ref_pad, tm, nsq0, warped_pad, valid_pad, hw,
                             acc, scan_offsets, pad)
