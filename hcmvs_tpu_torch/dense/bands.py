"""Row bands of a view and their halo exchange: the dense sweeps with
every view's pixel rows split into bands (the tile axis of
``hcmvs_tpu_torch.parallel``; the JAX package shards (N, H, W) fields
over ("view", "tile"), ``hcmvs_tpu/parallel/sharding.py:54-60``).
``scene_driver.scene_sweeps`` sweeps a process's bands of each view
one after another when it is given a ``HaloExchange``.

A band is whole 8-row tile rows of the image (the rect build's (8, 128)
tiles lie in raster order, so a band's table rows are one contiguous
run): ceil(tile rows / n) tile rows a band, the last one shorter (or
empty).  A band's sweep holds a window: its own rows and ``halo_rows``
rows either side, cut at the image.  Every per-pixel field of the window
is cut from the whole view's (the patch statistics, rays, gradients, the
rect engine's fields, the random draws: each drawn whole and cut), the
tables are the window's rows, and the neighbour images and maps stay
whole, so at the band's own rows a half-sweep computes what the whole
view's computes there, bit for bit, given the state at the window's
rows.  What a half-sweep at pixel p reads:

- propagation: the state at +-``propagate`` rows (``propagation_offsets``:
  +-5 at ``DenseConfig()``);
- the table routes' scores (kernels B, D) and the direct route's: the
  scored hypothesis at p alone, but the table rows and index fields of
  the sample pixels, +-``pad`` rows (the patch radius,
  ``score.patch_offsets``: +-7 at ``DenseConfig()``);
- the warped route's score (kernel E, ``score_mode`` "warped", and
  "hybrid"'s photometric phase): the hypothesis at +-``pad`` rows, and
  each refinement step scores a perturbation of the running best, so
  the state at +-(propagate + pad * (1 + steps)), steps the
  ``random_iters`` (1 with ``refine_batched``);
- the smoothness terms: the state at +-1 (``smoothness_bonus``) and +-2
  rows (``local_smoothness_score``);
- ``delta_c2pmax``, a max over the whole view's state: each band's max
  over its own rows, then the max of those (exact, so bit-equal);
- the red-black parity: the image row.

``halo_rows`` is the largest of these, rounded up to whole tile rows: 8
at ``DenseConfig()`` on the table routes, 56 on the warped ones; 8 and 16
at ``parallel.mh_check``'s configs.  After every half-sweep the first and
last ``halo`` of each band's own rows of depth and normal, with its max,
go to the bands whose windows hold them (``HaloExchange``; across
processes an all-gather inside the tile group, timed as
``parallel.halo``); nothing else moves until the bands are put together
after the last one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import score as S
from hcmvs_tpu_torch.dense.patchmatch import propagation_offsets
from hcmvs_tpu_torch.dense.types import PatchMatchState, Rows
from hcmvs_tpu_torch.utils import profiling

TILE_ROWS = 8       # the rect build's tile height: bands are whole tiles


@dataclasses.dataclass(frozen=True)
class Band:
    """A view's image rows [start, stop) and the window [lo, hi) its sweep
    holds, in an image of ``height`` rows."""

    start: int
    stop: int
    lo: int
    hi: int
    height: int

    @property
    def empty(self) -> bool:
        return self.start == self.stop

    @property
    def whole(self) -> bool:
        """Whether the window is the whole image (one band a view)."""
        return self.lo == 0 and self.hi == self.height

    @property
    def rows(self) -> Optional[Rows]:
        """Where the window lies in the image (None: the whole image)."""
        return None if self.whole else Rows(self.lo, self.height)

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """Rows [lo, hi) of a (..., H, W) field, as a tensor of its own
        (the field itself for the whole image)."""
        return x if self.whole else x[..., self.lo:self.hi, :].clone()

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The band's own rows of a (..., hi - lo, W) window field."""
        return x[..., self.start - self.lo:self.stop - self.lo, :]


def halo_rows(cfg: DenseConfig) -> int:
    """The rows a band's window holds past the band at each side (see the
    module's docstring), rounded up to whole tile rows.  The patch radius
    is the largest half-window whatever the sampling step, so the coarse
    sampling of early sweeps reads no further."""
    pad = S._pad_of(S.patch_offsets(cfg))
    prop = max(max(abs(dy), abs(dx))
               for dy, dx in propagation_offsets(cfg))
    reach = max(prop, pad, 2)
    if cfg.score_mode in ("warped", "hybrid"):
        steps = min(cfg.random_iters, 1) if cfg.refine_batched \
            else cfg.random_iters
        reach = max(reach, prop + pad * (1 + steps))
    return TILE_ROWS * math.ceil(reach / TILE_ROWS)


def row_bands(h: int, n_tile: int, halo: int) -> List[Band]:
    """The ``n_tile`` bands of an ``h``-row image: ceil(tile rows /
    n_tile) tile rows each, the last ones shorter or empty, each with
    its window of ``halo`` rows either side.  More bands than tile rows
    raise ValueError."""
    tiles = -(-h // TILE_ROWS)
    if not 1 <= n_tile <= tiles:
        raise ValueError(f"n_tile={n_tile}: an image of {h} rows has "
                         f"{tiles} tile rows of {TILE_ROWS} to split")
    per = -(-tiles // n_tile) * TILE_ROWS
    out = []
    for b in range(n_tile):
        start, stop = min(b * per, h), min((b + 1) * per, h)
        if start == stop:
            out.append(Band(start, stop, start, stop, h))
        else:
            out.append(Band(start, stop, max(0, start - halo),
                            min(h, stop + halo), h))
    return out


Gather = Callable[[torch.Tensor], List[torch.Tensor]]


class HaloExchange:
    """The exchange after every half-sweep of a view's bands.

    ``bands`` are a view's bands, ``group`` the bands of each process of
    this process's tile group in process order (one list, this process's
    own, when the whole group is in this process), ``me`` this process's
    place in it and ``gather`` the all-gather of the group (None in one
    process).  Each own band hands on the first and last ``halo`` of its
    own rows of depth and normal and its max of ``c2p_max``; each own
    band's window gets the rows past its band from the bands that own
    them.  Timed as ``parallel.halo`` (its bytes: the edge rows this
    process hands on)."""

    def __init__(self, bands: Sequence[Band], halo: int,
                 group: Sequence[Sequence[int]], me: int = 0,
                 gather: Optional[Gather] = None):
        self.bands, self.halo = list(bands), halo
        self.group = [list(g) for g in group]
        self.me, self.gather = me, gather

    def _edges(self, band: Band, win: PatchMatchState, mx) -> torch.Tensor:
        """(4 * 2 * halo * W + 1,) f32: the band's first and last rows of
        (depth, normal), zero-padded to ``halo`` rows each, and its max."""
        w = win.depth.shape[-1]
        dev = win.depth.device
        out = torch.zeros((2, 4, self.halo, w), dtype=torch.float32,
                          device=dev)
        if not band.empty:
            e = min(self.halo, band.stop - band.start)
            dn = torch.cat([band.own(win.depth)[None],
                            band.own(win.normal)])
            out[0, :, :e] = dn[:, :e]
            out[1, :, :e] = dn[:, dn.shape[1] - e:]
        mx = (torch.full((1,), -math.inf, device=dev) if band.empty
              else mx.reshape(1).to(torch.float32))
        return torch.cat([out.reshape(-1), mx])

    def _fill(self, band: Band, win: PatchMatchState, pieces: dict
              ) -> PatchMatchState:
        if band.empty:
            return win
        depth, normal = win.depth.clone(), win.normal.clone()
        for b, piece in pieces.items():
            other = self.bands[b]
            if other is band or other.empty:
                continue
            e = min(self.halo, other.stop - other.start)
            for lo, hi in ((band.lo, band.start), (band.stop, band.hi)):
                a, z = max(lo, other.start), min(hi, other.stop)
                if a >= z:
                    continue
                if z <= other.start + e:           # its first rows
                    src = piece[0, :, a - other.start:z - other.start]
                elif a >= other.stop - e:          # its last rows
                    base = other.stop - e
                    src = piece[1, :, a - base:z - base]
                else:
                    raise AssertionError(f"rows [{a}, {z}) of band "
                                         f"{other} are not edge rows")
                depth[a - band.lo:z - band.lo] = src[0]
                normal[:, a - band.lo:z - band.lo] = src[1:]
        return PatchMatchState(depth=depth, normal=normal, cost=win.cost)

    def __call__(self, windows: Sequence[PatchMatchState],
                 maxima: Sequence[torch.Tensor]
                 ) -> Tuple[List[PatchMatchState], torch.Tensor]:
        """The own bands' windows (in ``group[me]``'s order) after a
        half-sweep and their ``c2p_max`` of their own rows -> the
        windows with the rows past each band refreshed, and the whole
        view's ``c2p_max``."""
        own = self.group[self.me]
        dev = windows[0].depth.device
        with profiling.stage_timer("parallel.halo", block_on=dev):
            send = torch.cat([self._edges(self.bands[b], win, mx)
                              for b, win, mx in zip(own, windows, maxima)])
            profiling.add_bytes("parallel.halo",
                                send.numel() * send.element_size())
            parts = ([send] if self.gather is None
                     else self.gather(send))
            w = windows[0].depth.shape[-1]
            size = 2 * 4 * self.halo * w + 1
            pieces, tops = {}, []
            for bs, part in zip(self.group if self.gather else [own],
                                parts):
                for k, b in enumerate(bs):
                    chunk = part[k * size:(k + 1) * size]
                    pieces[b] = chunk[:-1].reshape(2, 4, self.halo, w)
                    tops.append(chunk[-1:])
            out = [self._fill(self.bands[b], win, pieces)
                   for b, win in zip(own, windows)]
            # -inf stands for an empty band; a NaN anywhere wins, as in
            # the whole view's amax
            return out, torch.cat(tops).amax()
