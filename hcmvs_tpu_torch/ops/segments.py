"""Sums of rows into targets in an order that does not depend on the run.

CUDA's ``index_add_`` adds with atomics, so the order of the additions,
and with it the last bits of a float sum, varies between runs; a solver
that feeds such sums into its next step (mesh refine, bundle
adjustment) then drifts apart between two runs.  ``FixedSum`` sorts the
rows by target once and reduces each target's rows in that order.
"""

from __future__ import annotations

from typing import Optional

import torch


class FixedSum:
    """Sums of the rows of ``x`` (N, ...) into ``n`` targets by the fixed
    ids (N,) (rows along ``dim``, 0 by default).  On the CPU
    ``index_add_`` in row order; on CUDA (or with ``fixed_order=True``)
    the rows sorted by target, stable, and each target's rows reduced in
    that order, so the sums do not depend on the run."""

    def __init__(self, ids: torch.Tensor, n: int,
                 fixed_order: Optional[bool] = None):
        self.ids, self.n = ids, n
        self.fixed_order = (ids.is_cuda if fixed_order is None
                            else fixed_order)
        if self.fixed_order:
            self.order = torch.argsort(ids, stable=True)
            self.lengths = torch.bincount(ids, minlength=n)

    def sum(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if dim != 0:
            return self.sum(x.movedim(dim, 0)).movedim(0, dim)
        if not self.fixed_order:
            out = torch.zeros((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            return out.index_add_(0, self.ids, x)
        return torch.segment_reduce(x[self.order], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)
