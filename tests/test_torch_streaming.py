"""Streamed tables and view chunks in the port's scene driver.

- ``volume_streaming``: view i's tables are built inside its sweep and
  dropped before view i + 1's; the maps equal those of the stage-attached
  scene-wide tables bit for bit (the port's counterpart of
  tests/test_volume.py::test_volume_streaming_matches_attached), through
  the rect build and through the per-plane build at 256 planes;
- ``scene_sweeps(..., view_start, view_chunk)``: chunks from one entry
  snapshot, a short last one included, give the maps of one unchunked
  call, and every view is swept exactly once, with its own context.  The
  JAX package's ``scene_sweeps`` slices the state with a clamped start but
  indexes the contexts with an unclamped one, so a short last chunk sweeps
  the wrong views with the wrong contexts (ROADMAP, "Known faults in the
  reference"); the last test pins that the port does not.

Scene: the ridge of tests/test_volume.py (48x64, 4 or 5 views, 3
neighbours).  Everything runs on the port's CPU path; equality is exact
(the same tables, the same generator, the same order of operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.utils.profiling import report, reset_report
from hcmvs_tpu_torch.utils.synth import make_ridge_scene

torch.set_num_threads(1)
H, W, NBR = 48, 64, 3
CFG = dict(estimation_iters=2, estimation_iters_external=2, random_iters=3,
           use_optical_flow=0, optimize=0)


def _scene(n_views):
    sc = make_ridge_scene(np.random.default_rng(2), h=H, w=W,
                          n_views=n_views)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    nbr = [[j for j in range(n_views) if j != i][:NBR]
           for i in range(n_views)]
    return tsd.SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]),
        cams=cams, nbr_idx=torch.tensor(nbr),
        nbr_valid=torch.ones(n_views, NBR, dtype=torch.bool),
        d_min=torch.full((n_views,), float(sc.depth_gt.min() * 0.7)),
        d_max=torch.full((n_views,), float(sc.depth_gt.max() * 1.3)))


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("depth", "normal", "cost"))


@pytest.mark.parametrize("build", [dict(), dict(volume_planes=256)])
def test_streamed_tables_equal_attached(build):
    scene = _scene(4)
    cfg = DenseConfig(**CFG, **build)
    assert tsd.attach_volumes(scene, cfg.replace(
        volume_streaming=True)).vols is None
    outs = {}
    for streaming in (False, True):
        reset_report()
        outs[streaming] = tsd.estimate_scene(
            torch.Generator().manual_seed(0), scene,
            cfg.replace(volume_streaming=streaming))
        streamed = report().get("estimate.tables.streamed", {"calls": 0})
        # one build per view and sweep call when streaming, none otherwise
        assert streamed["calls"] == (4 * 2 if streaming else 0)
    assert _equal(outs[True], outs[False])


def _chained(state, scene, cfg, gen, chunk):
    return tsd.sweep_in_chunks(state, scene, cfg, 1, cfg.estimation_iters,
                               True, gen, chunk)


def test_chunks_equal_one_call():
    scene = _scene(5)
    cfg = DenseConfig(**dict(CFG, estimation_iters=1),
                      volume_streaming=True)
    entry = tsd.init_scene_state(torch.Generator().manual_seed(0), scene)
    one = tsd.scene_sweeps(entry, scene, cfg, 1, cfg.estimation_iters, True,
                           torch.Generator().manual_seed(5))
    for chunk in (2, 3):          # 2 / 2 / 1 and 3 / 2: short last chunks
        out = _chained(entry, scene, cfg, torch.Generator().manual_seed(5),
                       chunk)
        assert _equal(out, one), chunk
    # one chunk leaves the other views as they were
    part = tsd.scene_sweeps(entry, scene, cfg, 1, cfg.estimation_iters,
                            True, torch.Generator().manual_seed(5),
                            view_start=4, view_chunk=2)
    assert torch.equal(part.depth[:4], entry.depth[:4])
    assert not torch.equal(part.depth[4], entry.depth[4])
    with pytest.raises(ValueError, match="view_start"):
        tsd.scene_sweeps(entry, scene, cfg, 1, 1, True,
                         torch.Generator().manual_seed(5), view_start=5,
                         view_chunk=2)


def test_short_last_chunk_sweeps_each_view_once(monkeypatch):
    """Over a chain of chunks of 2 on 5 views the port builds each view's
    context once and writes it to that view's slot.  The JAX package's
    index arithmetic (``dynamic_slice_in_dim`` clamps the slice's start,
    ``view_start + arange(view_chunk)`` does not) pairs the last chunk's
    state slots 3, 4 with contexts 4, 5: view 3 swept twice, once with
    view 4's context, and a context index past the scene."""
    n, chunk = 5, 2
    scene = _scene(n)
    cfg = DenseConfig(**dict(CFG, estimation_iters=1, random_iters=0),
                      volume_streaming=True)
    seen = []
    real = tsd._per_view_context

    def recording(scene_, i, *args):
        seen.append(i)
        return real(scene_, i, *args)

    monkeypatch.setattr(tsd, "_per_view_context", recording)
    entry = tsd.init_scene_state(torch.Generator().manual_seed(0), scene)
    out = _chained(entry, scene, cfg, torch.Generator().manual_seed(5),
                   chunk)
    assert seen == list(range(n))
    assert bool((out.depth != entry.depth).flatten(1).any(1).all())

    # the reference's pairs of (state slot, context index) for the chain
    pairs = []
    views = jnp.arange(n)
    for start in range(0, n, chunk):
        slot0 = int(jax.lax.dynamic_slice_in_dim(views, start, chunk, 0)[0])
        idx = start + np.arange(chunk)
        pairs += list(zip(range(slot0, slot0 + chunk), idx.tolist()))
    assert pairs[-2:] == [(3, 4), (4, 5)]
    assert [s for s, _ in pairs].count(3) == 2
    assert any(s != c for s, c in pairs)
