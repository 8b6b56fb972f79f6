"""A-contrario (NFA) adaptive RANSAC thresholding (PyTorch port of
``hcmvs_tpu/sfm/acransac.py``).

The reference's generic robust-estimation driver is AC-RANSAC (ORSA,
Moisan-Stival) -- ref: frame_main/libs/Common/AutoEstimator.h:230 --
which scores each model by the Number of False Alarms

    NFA(model, k) = N_out * C(n, k) * C(k, m) * alpha(r_k)^(k - m)

over every candidate inlier count k (r_k = k-th smallest residual,
alpha(r) = alpha0 * r, m = minimal sample size); the (model, k) minimizing
NFA gives both the model ranking and the data-driven threshold r_k*.

The log-combinatorial tables are computed on the host per problem size
(float64, scipy's ``gammaln``) and used in float32; the hypothesis batch
is one sort and one reduction on the device.  Residuals are squared
Sampson distances, r = sqrt(d2).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _log_comb_tables(n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(logC(n, k), logC(k, m)) for k = 0..n (float64 host tables)."""
    from scipy.special import gammaln
    k = np.arange(n + 1, dtype=np.float64)
    log_c_n_k = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    with np.errstate(invalid="ignore"):
        log_c_k_m = gammaln(k + 1) - gammaln(m + 1) - gammaln(k - m + 1)
    log_c_k_m[k < m] = np.inf           # k < m impossible
    return log_c_n_k, log_c_k_m


def nfa_threshold_batch(d2: torch.Tensor, valid: torch.Tensor, m: int,
                        alpha0: float = 2.0 * 1.4142,
                        n_outcomes: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best log-NFA over inlier counts for each model's residuals.

    Args:
      d2: (H, N) squared residuals (Sampson, normalized units).
      valid: (N,) mask; invalid slots are excluded (treated as +inf).
      m: minimal sample size (8 for the eight-point E solver).
      alpha0: alpha(r) = alpha0 * r, the geometric probability slope.
      n_outcomes: the N_out multiplicity term (only shifts log NFA).

    Returns (log_nfa, d2_threshold, k_star), each (H,): the minimal log
    NFA, the squared-residual threshold realizing it, and its count.
    """
    n = d2.shape[-1]
    dev = d2.device
    log_c_n_k, log_c_k_m = _log_comb_tables(n, m)
    d2s = torch.sort(torch.where(valid, d2, torch.inf), dim=-1).values
    k = torch.arange(n + 1, dtype=torch.float32, device=dev)
    # r_k = sqrt of the k-th smallest residual (k models = first k pts)
    r_k = torch.sqrt(torch.clamp_min(d2s, 1e-24))
    log_alpha = torch.log(torch.clamp(alpha0 * r_k, 1e-12, 1.0))
    log_alpha_at_k = torch.cat([torch.zeros_like(log_alpha[..., :1]),
                                log_alpha], dim=-1)          # idx by k
    # ORSA's multiplicity over candidate counts, the (n - m) factor: the
    # two constants are summed in float32 first, as in the JAX package
    const = np.float32(np.log(np.float32(n_outcomes))) + np.float32(
        np.log(max(n - m, 1)))
    tab_n = torch.as_tensor(log_c_n_k, dtype=torch.float32, device=dev)
    tab_m = torch.as_tensor(np.where(np.isfinite(log_c_k_m), log_c_k_m,
                                     1e30), dtype=torch.float32, device=dev)
    log_nfa_k = (torch.as_tensor(const, device=dev) + tab_n + tab_m
                 + (k - m) * log_alpha_at_k)
    # only counts with finite residuals are admissible
    n_valid = torch.sum(valid)
    admissible = (k >= m + 1) & (k <= n_valid)
    log_nfa_k = torch.where(admissible, log_nfa_k, torch.inf)
    k_star = torch.argmin(log_nfa_k, dim=-1)
    log_nfa = torch.gather(log_nfa_k, -1, k_star[..., None])[..., 0]
    thr = torch.gather(d2s, -1, torch.clamp_min(k_star - 1, 0)[..., None])
    return log_nfa, thr[..., 0], k_star


def nfa_threshold(d2: torch.Tensor, valid: torch.Tensor, m: int,
                  alpha0: float = 2.0 * 1.4142 / 1.0,
                  n_outcomes: float = 1.0):
    """``nfa_threshold_batch`` for ONE model's (N,) residuals."""
    out = nfa_threshold_batch(d2[None], valid, m, alpha0, n_outcomes)
    return tuple(x[0] for x in out)
