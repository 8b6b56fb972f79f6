"""PyTorch port vs the JAX package: the direct-gather routes, view spread
and the single-view API.

- ``photometric_scores`` (``exact_backend="bilinear"``: direct bilinear
  ZNCC, one sample per view and offset);
- ``geometric_scores`` with no rect context (``geo_backend="direct"``:
  nearest gathers of the neighbour maps);
- ``view_spread_candidates`` through nearest gathers and through the rect
  engine, and ``half_sweep`` with ``view_spread=1``;
- the sampling helpers the direct routes use;
- ``estimate_depth_map`` / ``confidence_from_cost``.

Scene: ``make_plane_scene`` at 48x64, 3 views, 2 neighbours, the JAX
package's random init as the neighbour maps.  The JAX side forces the
backends each test names.  Random refinement is off in the sweep test
(``random_iters=0``), so both packages consume no draws there.

Tolerances: scores and candidates at atol 1e-4 (float32 sums and
products in another order) with bad / valid masks equal on >= 99.9% of
pixels; the sweep by share of pixels (>= 99.5% within 1e-4), because an
argmin between near-tied candidates may flip under reordered rounding;
the single-view estimate by depth accuracy within 0.03 (the two packages'
random streams differ), as tests/test_torch_slice.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JConfig
from hcmvs_tpu.dense import patchmatch as jpm
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.dense import score as jscore
from hcmvs_tpu.dense.types import make_view_geometry as jmake_geometry
from hcmvs_tpu.ops import rect_gather as jrg
from hcmvs_tpu.ops import sampling as jsamp
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (geometry_from_numpy,
                                     rect_context_from_numpy)
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import estimate_depth_map
from hcmvs_tpu_torch.dense import patchmatch as tpm
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)
H, W, N, NBR = 48, 64, 3, 2
SLICE = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, random_iters=0, use_optical_flow=0,
             use_geo_consistency=1, use_part_consistency=1,
             estimation_iters_external=2, optimize=0)
DIRECT = dict(exact_backend="bilinear", geo_backend="direct")


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(_np(x))


@pytest.fixture(scope="module")
def world():
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    cams = JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                   R=jnp.stack([c.R for c in sc.cameras]),
                   C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([j for j in range(1, N)][:NBR])
    scene = jsd.SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(np.array(
            [[j for j in range(N) if j != i][:NBR] for i in range(N)])),
        nbr_valid=jnp.ones((N, NBR), bool),
        d_min=jnp.full((N,), sc.d_min, jnp.float32),
        d_max=jnp.full((N,), sc.d_max, jnp.float32))
    state0 = jsd.init_scene_state(jax.random.PRNGKey(0), scene)
    geom = jmake_geometry(jax.tree.map(lambda x: x[0], cams),
                          jax.tree.map(lambda x: x[nbr], cams))
    jcfg = JConfig(**SLICE, **DIRECT)
    nd, nn = state0.depth[nbr], state0.normal[nbr]
    ctx_j = jpm.make_context(geom, scene.gray[0], scene.gray[nbr],
                             sc.d_min, sc.d_max, jcfg, nbr_depth=nd,
                             nbr_normal=nn)
    tcfg = TConfig(**SLICE, **DIRECT)
    ctx_t = tpm.make_context(geometry_from_numpy(geom, device="cpu"),
                             _t(scene.gray[0]), _t(scene.gray[nbr]),
                             sc.d_min, sc.d_max, tcfg, nbr_depth=_t(nd),
                             nbr_normal=_t(nn))
    assert ctx_t.vol is None and ctx_t.rect is None
    rng = np.random.default_rng(2)
    gt = (sc.depth_gt * (1 + 0.01 * rng.standard_normal((H, W)))).astype(
        np.float32)
    n_gt = np.broadcast_to(sc.normal_gt[:, None, None], (3, H, W)).astype(
        np.float32)
    hyps = [(_np(state0.depth[0]), _np(state0.normal[0])), (gt, n_gt)]
    return dict(sc=sc, scene=scene, state0=state0, geom=geom, nbr=nbr,
                jcfg=jcfg, tcfg=tcfg, ctx_j=ctx_j, ctx_t=ctx_t, hyps=hyps)


def test_direct_photometric_scores_match(world):
    ctx_j, ctx_t = world["ctx_j"], world["ctx_t"]
    offsets = jscore.patch_offsets(world["jcfg"])
    for depth, normal in world["hyps"]:
        sj, bj = jscore.photometric_scores(
            ctx_j.geom, ctx_j.src_grays, ctx_j.stats, ctx_j.hw,
            jnp.asarray(depth), jnp.asarray(normal), ctx_j.rays, offsets,
            world["jcfg"])
        st, bt = tscore.score_photometric(
            ctx_t.geom, ctx_t.src_grays, ctx_t.stats, ctx_t.hw,
            torch.from_numpy(depth), torch.from_numpy(normal), ctx_t.rays,
            offsets, world["tcfg"], phase=0, vol=None)
        assert (bt.numpy() == _np(bj)).mean() >= 0.999
        np.testing.assert_allclose(st.numpy(), _np(sj), rtol=0, atol=1e-4)


def test_direct_geometric_scores_match(world):
    ctx_j, ctx_t = world["ctx_j"], world["ctx_t"]
    for depth, normal in world["hyps"]:
        gj = jscore.geometric_scores(
            ctx_j.geom, jnp.asarray(depth), jnp.asarray(normal), ctx_j.rays,
            ctx_j.nbr_depth, ctx_j.nbr_normal, world["jcfg"], rect=None)
        gt = tscore.geometric_scores(
            ctx_t.geom, torch.from_numpy(depth), torch.from_numpy(normal),
            ctx_t.rays, ctx_t.nbr_depth, ctx_t.nbr_normal, world["tcfg"],
            rect=None)
        np.testing.assert_allclose(gt.numpy(), _np(gj), rtol=0, atol=1e-4)
    # the rect route needs its context: no silent switch to direct reads
    with pytest.raises(ValueError, match="rect context"):
        tscore.geometric_scores(
            ctx_t.geom, ctx_t.nbr_depth[0], ctx_t.nbr_normal[0], ctx_t.rays,
            ctx_t.nbr_depth, ctx_t.nbr_normal, TConfig(**SLICE), rect=None)


@pytest.mark.parametrize("route", ["direct", "rect"])
def test_view_spread_candidates_match(world, route):
    ctx_j, ctx_t = world["ctx_j"], world["ctx_t"]
    rect_j = rect_t = None
    if route == "rect":
        rect_j = jrg.build_rect_context(ctx_j.geom, jrg.pack_depth_normals(
            ctx_j.nbr_depth, ctx_j.nbr_normal))
        rect_t = rect_context_from_numpy(rect_j, device="cpu")
    for depth, _ in world["hyps"]:
        dj, nj, vj = jscore.view_spread_candidates(
            ctx_j.geom, jnp.asarray(depth), ctx_j.rays, ctx_j.nbr_depth,
            ctx_j.nbr_normal, rect=rect_j)
        dt, nt, vt = tscore.view_spread_candidates(
            ctx_t.geom, torch.from_numpy(depth), ctx_t.rays,
            ctx_t.nbr_depth, ctx_t.nbr_normal, rect=rect_t)
        vj = _np(vj)
        assert (vt.numpy() == vj).mean() >= 0.999
        both = vt.numpy() & vj
        assert both.mean() > 0.3
        np.testing.assert_allclose(dt.numpy()[both], _np(dj)[both],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(nt.numpy().transpose(0, 2, 3, 1)[both],
                                   _np(nj).transpose(0, 2, 3, 1)[both],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("route", ["direct", "rect"])
def test_half_sweep_with_view_spread_matches(world, route):
    kw = dict(view_spread=1)
    if route == "rect":
        kw.update(geo_backend="rect")
    cfg_j = world["jcfg"].replace(**kw)
    cfg_t = world["tcfg"].replace(**kw)
    ctx_j, ctx_t = world["ctx_j"], world["ctx_t"]
    if route == "rect":
        ctx_j = dataclasses.replace(ctx_j, rect=jrg.build_rect_context(
            ctx_j.geom, jrg.pack_depth_normals(ctx_j.nbr_depth,
                                               ctx_j.nbr_normal)))
        ctx_t = dataclasses.replace(
            ctx_t, rect=rect_context_from_numpy(ctx_j.rect, device="cpu"))
    offsets = jscore.patch_offsets(cfg_j)
    prop = jpm.propagation_offsets(cfg_j)
    st = world["state0"]
    sj0 = jpm.PatchMatchState(depth=st.depth[0], normal=st.normal[0],
                              cost=st.cost[0], key=st.keys[0])
    sweep = jax.jit(functools.partial(
        jpm.half_sweep, cfg=cfg_j, phase=1, parity=0, offsets=offsets,
        prop_offsets=prop))
    sj = sweep(sj0, ctx_j)
    st0 = tpm.PatchMatchState(depth=_t(st.depth[0]), normal=_t(st.normal[0]),
                              cost=_t(st.cost[0]))
    stt = tpm.half_sweep(st0, ctx_t, cfg_t, 1, 0, offsets, prop,
                         torch.Generator().manual_seed(0))
    ok = ((np.abs(stt.depth.numpy() - _np(sj.depth)) <= 1e-4)
          & (np.abs(stt.normal.numpy() - _np(sj.normal)).max(0) <= 1e-4)
          & (np.abs(stt.cost.numpy() - _np(sj.cost)) <= 1e-4))
    assert ok.mean() >= 0.995, ok.mean()
    # the harvested hypotheses win somewhere: the sweep differs from one
    # without them
    plain = tpm.half_sweep(st0, ctx_t, cfg_t.replace(view_spread=0), 1, 0,
                           offsets, prop, torch.Generator().manual_seed(0))
    assert not torch.equal(plain.depth, stt.depth)


def test_sampling_helpers_match():
    rng = np.random.default_rng(3)
    img2 = rng.random((12, 17)).astype(np.float32)
    img3 = rng.random((12, 17, 3)).astype(np.float32)
    uv = np.stack([rng.uniform(-2, 18, (5, 7)), rng.uniform(-2, 13, (5, 7))],
                  -1).astype(np.float32)
    uv[0, 0] = (16.0, 11.0)                  # the last pixel exactly
    uv[0, 1] = (2.5, 3.5)                    # halves round to even
    for img in (img2, img3):
        for fn in ("bilinear_sample", "nearest_sample"):
            vj, okj = getattr(jsamp, fn)(jnp.asarray(img), jnp.asarray(uv))
            vt, okt = getattr(tsamp, fn)(torch.from_numpy(img),
                                         torch.from_numpy(uv))
            np.testing.assert_array_equal(okt.numpy(), _np(okj))
            np.testing.assert_allclose(vt.numpy(), _np(vj), rtol=0,
                                       atol=1e-6)
    planes = rng.random((4, 12, 17)).astype(np.float32)
    x = np.round(uv[..., 0])
    y = np.round(uv[..., 1])
    vj, okj = jsamp.nearest_sample_planes(jnp.asarray(planes),
                                          jnp.asarray(x), jnp.asarray(y))
    vt, okt = tsamp.nearest_sample_planes(torch.from_numpy(planes),
                                          torch.from_numpy(x),
                                          torch.from_numpy(y))
    np.testing.assert_array_equal(okt.numpy(), _np(okj))
    np.testing.assert_array_equal(vt.numpy(), _np(vj))


def _acc(depth, gt, margin=6):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


def test_estimate_depth_map_matches_jax(world):
    """The single-view driver without neighbour maps (photometric terms
    only, as ``estimate_depth_map`` runs alone): JAX (direct scoring, its
    make_context builds no tables) against the port's direct route and
    its default route (tables built by its make_context), by view 0's
    accuracy against the ground truth; the confidence threshold alike."""
    sc, scene, nbr = world["sc"], world["scene"], world["nbr"]
    cfg = dict(SLICE, random_iters=2, estimation_iters=2)
    jcfg = JConfig(**cfg, **DIRECT)
    ref = jpm.estimate_depth_map(jax.random.PRNGKey(0), world["geom"],
                                 scene.gray[0], scene.gray[nbr], sc.d_min,
                                 sc.d_max, jcfg)
    acc_j = _acc(_np(ref.depth), sc.depth_gt)
    geom_t = geometry_from_numpy(world["geom"], device="cpu")
    for kw in (DIRECT, {}):
        tcfg = TConfig(**cfg, **kw)
        out = estimate_depth_map(torch.Generator().manual_seed(0), geom_t,
                                 _t(scene.gray[0]), _t(scene.gray[nbr]),
                                 sc.d_min, sc.d_max, tcfg)
        acc_t = _acc(out.depth.numpy(), sc.depth_gt)
        assert acc_t > 0.5, (kw, acc_t)
        assert abs(acc_t - acc_j) <= 0.03, (kw, acc_t, acc_j)
    dj, nj, cj = jpm.confidence_from_cost(ref, jcfg)
    st = tpm.PatchMatchState(depth=_t(ref.depth), normal=_t(ref.normal),
                             cost=_t(ref.cost))
    dt, nt, ct = tpm.confidence_from_cost(st, tcfg)
    for a, b in ((dt, dj), (nt, nj), (ct, cj)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
