"""PyTorch port vs the JAX package: the dense PatchMatch slice.

Configuration: the bench workload (bench._build) plus two external
iterations and optimize=0 — one photometric and one geometric phase — at
4 views x 3 neighbours, 96x128.  JAX runs on the CPU with the table and
rect engines forced on (exact_backend="volume", geo_backend="rect",
volume_build="rect"), as tests/test_sharding.py does; the port takes them
by default.

Tolerances: score terms at atol 1e-4 (float32 sums in another order);
sweeps and the whole slice by share of pixels, because an argmin between
near-tied candidates may flip under reordered rounding.
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
from hcmvs_tpu.ops import rect_gather as jrg
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (geometry_from_numpy,
                                     rect_context_from_numpy,
                                     scene_from_numpy, state_from_numpy,
                                     tables_from_numpy)
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import patchmatch as tpm
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.utils.profiling import report, reset_report

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
H, W, N, NBR = 96, 128, 4, 3
SLICE = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=2, random_iters=0, use_optical_flow=0,
             use_geo_consistency=1, use_part_consistency=1,
             estimation_iters_external=2, optimize=0)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")


def _np(x):
    return np.array(x)


def _acc(depth, gt, margin=6):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


@pytest.fixture(scope="module")
def world():
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    cams = JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                   R=jnp.stack([c.R for c in sc.cameras]),
                   C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(N) if j != i][:NBR]
                    for i in range(N)], np.int32)
    scene = jsd.SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((N, NBR), bool),
        d_min=jnp.full((N,), sc.d_min, jnp.float32),
        d_max=jnp.full((N,), sc.d_max, jnp.float32))
    jcfg = JConfig(**SLICE, **FORCED)
    state0 = jsd.init_scene_state(jax.random.PRNGKey(0), scene)
    scene_v = jsd.attach_volumes(scene, jcfg)
    tscene = dataclasses.replace(
        scene_from_numpy(scene, device="cpu"),
        vols=tables_from_numpy(scene_v.vols, device="cpu"))
    return dict(sc=sc, scene=scene, scene_v=scene_v, jcfg=jcfg,
                tcfg=TConfig(**SLICE), state0=state0, tscene=tscene)


def _contexts(world, phase, cfg_j, cfg_t):
    """View 0's score contexts in both packages; the port's carries the
    converted JAX geometry, tables and rect context."""
    st = world["state0"]
    use_nbr = phase >= 1
    nidx = _np(world["scene"].nbr_idx[0])
    nd = st.depth[nidx] if use_nbr else None
    nn = st.normal[nidx] if use_nbr else None
    ctx_j = jsd._per_view_context(world["scene_v"], 0, nd, nn, cfg_j)
    if use_nbr:
        ctx_j = dataclasses.replace(ctx_j, rect=jrg.build_rect_context(
            ctx_j.geom, jrg.pack_depth_normals(nd, nn)))
    tst = state_from_numpy(st, device="cpu")
    ctx_t = tsd._per_view_context(
        world["tscene"], 0, tst.depth[nidx] if use_nbr else None,
        tst.normal[nidx] if use_nbr else None, cfg_t)
    ctx_t = dataclasses.replace(
        ctx_t, geom=geometry_from_numpy(ctx_j.geom, device="cpu"),
        rect=(rect_context_from_numpy(ctx_j.rect, device="cpu") if use_nbr
              else None))
    return ctx_j, ctx_t


def _hypotheses(world):
    """View 0's random init and a near-ground-truth field."""
    sc = world["sc"]
    st = world["state0"]
    rng = np.random.default_rng(2)
    gt = (sc.depth_gt * (1 + 0.01 * rng.standard_normal((H, W)))).astype(
        np.float32)
    n_gt = np.broadcast_to(sc.normal_gt[:, None, None], (3, H, W)).astype(
        np.float32)
    return [(_np(st.depth[0]), _np(st.normal[0])), (gt, n_gt)]


def test_photometric_scores_volume_match(world):
    ctx_j, ctx_t = _contexts(world, 0, world["jcfg"], world["tcfg"])
    offsets = jscore.patch_offsets(world["jcfg"])
    assert offsets == tscore.patch_offsets(world["tcfg"])
    for depth, normal in _hypotheses(world):
        sj, bj = jscore.photometric_scores_volume(
            ctx_j.geom, ctx_j.vol, ctx_j.stats, ctx_j.hw, jnp.asarray(depth),
            jnp.asarray(normal), ctx_j.rays, offsets, world["jcfg"])
        st_, bt = tscore.photometric_scores_volume(
            ctx_t.geom, ctx_t.vol, ctx_t.stats, ctx_t.hw,
            torch.from_numpy(depth), torch.from_numpy(normal), ctx_t.rays,
            offsets, world["tcfg"])
        assert (bt.numpy() == _np(bj)).mean() >= 0.999
        np.testing.assert_allclose(st_.numpy(), _np(sj), rtol=0, atol=1e-4)


def test_geometric_scores_match(world):
    ctx_j, ctx_t = _contexts(world, 1, world["jcfg"], world["tcfg"])
    for depth, normal in _hypotheses(world):
        gj = jscore.geometric_scores(
            ctx_j.geom, jnp.asarray(depth), jnp.asarray(normal), ctx_j.rays,
            ctx_j.nbr_depth, ctx_j.nbr_normal, world["jcfg"],
            rect=ctx_j.rect)
        gt = tscore.geometric_scores(
            ctx_t.geom, torch.from_numpy(depth), torch.from_numpy(normal),
            ctx_t.rays, ctx_t.nbr_depth, ctx_t.nbr_normal, world["tcfg"],
            rect=ctx_t.rect)
        np.testing.assert_allclose(gt.numpy(), _np(gj), rtol=0, atol=1e-4)


def test_perturb_matches_with_jax_draws(world):
    ctx_j, ctx_t = _contexts(world, 0, world["jcfg"], world["tcfg"])
    depth, normal = _hypotheses(world)[0]
    key = jax.random.PRNGKey(5)
    for scale in (1.0, 0.125):
        dj, nj = jpm._perturb(key, jnp.asarray(depth), jnp.asarray(normal),
                              ctx_j.rays, scale, world["jcfg"])
        # the draws _perturb makes, with its own key split
        kd, k1, k2 = jax.random.split(key, 3)
        a1 = jnp.radians(world["jcfg"].random_angle1_range) * scale
        a2 = jnp.radians(world["jcfg"].random_angle2_range) * scale
        draws = tpm.PerturbDraws(*(torch.from_numpy(_np(x)) for x in (
            jax.random.uniform(kd, (H, W), minval=-1.0, maxval=1.0),
            jax.random.uniform(k1, (H, W), minval=-a1, maxval=a1),
            jax.random.uniform(k2, (H, W), minval=-a2, maxval=a2))))
        dt, nt = tpm._perturb(draws, torch.from_numpy(depth),
                              torch.from_numpy(normal), ctx_t.rays, scale,
                              world["tcfg"])
        np.testing.assert_allclose(dt.numpy(), _np(dj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(nt.numpy(), _np(nj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("phase,sweep_mode,parity",
                         [(0, "jacobi", 0), (1, "jacobi", 0),
                          (0, "redblack", 1)])
def test_half_sweep_matches(world, phase, sweep_mode, parity):
    cfg_j = world["jcfg"].replace(sweep_mode=sweep_mode)
    cfg_t = world["tcfg"].replace(sweep_mode=sweep_mode)
    ctx_j, ctx_t = _contexts(world, phase, cfg_j, cfg_t)
    offsets = jscore.patch_offsets(cfg_j)
    prop = jpm.propagation_offsets(cfg_j)
    assert prop == tpm.propagation_offsets(cfg_t)
    st = world["state0"]
    sj0 = jpm.PatchMatchState(depth=st.depth[0], normal=st.normal[0],
                              cost=st.cost[0], key=st.keys[0])
    sweep = jax.jit(functools.partial(
        jpm.half_sweep, cfg=cfg_j, phase=phase, parity=parity,
        offsets=offsets, prop_offsets=prop))
    sj = sweep(sj0, ctx_j)
    tst = state_from_numpy(st, device="cpu")
    st0 = tpm.PatchMatchState(depth=tst.depth[0], normal=tst.normal[0],
                              cost=tst.cost[0])
    stt = tpm.half_sweep(st0, ctx_t, cfg_t, phase, parity, offsets, prop,
                         torch.Generator().manual_seed(0))
    ok = ((np.abs(stt.depth.numpy() - _np(sj.depth)) <= 1e-4)
          & (np.abs(stt.normal.numpy() - _np(sj.normal)).max(0) <= 1e-4)
          & (np.abs(stt.cost.numpy() - _np(sj.cost)) <= 1e-4))
    assert ok.mean() >= 0.995, ok.mean()
    if sweep_mode == "redblack":   # the other parity keeps its state
        keep = (np.add.outer(np.arange(H), np.arange(W)) % 2) != parity
        assert np.array_equal(stt.depth.numpy()[keep], _np(st.depth[0])[keep])


def test_estimate_scene_matches_jax(world):
    """The whole slice from the same (JAX) init, no random refinement: the
    port builds its own tables and rect contexts."""
    cfg_j, cfg_t = world["jcfg"], world["tcfg"]
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), world["scene"], cfg_j)
    scene_t = scene_from_numpy(world["scene"], device="cpu")
    reset_report()
    out = tsd.estimate_scene(torch.Generator().manual_seed(0), scene_t,
                             cfg_t,
                             init=state_from_numpy(world["state0"],
                                                   device="cpu"))
    assert list(report()) == ["estimate.tables",
                              "estimate.sweeps.ext0.phase0",
                              "estimate.sweeps.ext1.phase1"]
    d_ref, d_out = _np(ref.depth), out.depth.numpy()
    close = np.abs(d_out - d_ref) <= 1e-3 * np.abs(d_ref)
    assert close.mean() >= 0.99, close.mean()
    keep_j = _np(jsd.finalize(ref, cfg_j)[0]) > 0
    keep_t = tsd.finalize(out, cfg_t)[0].numpy() > 0
    assert (keep_j == keep_t).mean() >= 0.99


def test_estimate_scene_accuracy_with_own_generator(world):
    """Random refinement on: the port's own generator against JAX's keys,
    compared by interior depth accuracy against the ground truth."""
    cfg_j = world["jcfg"].replace(random_iters=4)
    cfg_t = world["tcfg"].replace(random_iters=4)
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), world["scene"], cfg_j)
    out = tsd.estimate_scene(torch.Generator().manual_seed(0),
                             scene_from_numpy(world["scene"], device="cpu"),
                             cfg_t)
    gt = world["sc"].depth_gt
    acc_j = _acc(_np(ref.depth[0]), gt)
    acc_t = _acc(out.depth[0].numpy(), gt)
    assert acc_t > 0.5, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)


def test_aggregate_scores_match():
    rng = np.random.default_rng(6)
    for v in (2, 3, 4):
        s = rng.uniform(0.0, 1.5, (v, 20, 30)).astype(np.float32)
        s[:, :4] = 0.5                                # ties across views
        out = tscore.aggregate_scores(torch.from_numpy(s), TConfig())
        ref = jscore.aggregate_scores(jnp.asarray(s), JConfig())
        assert np.array_equal(out.numpy(), _np(ref))


def test_unported_knobs_raise(world):
    """Every knob of the JAX package runs in the port: batch_candidates,
    the last one that raised, completes on the exact and warped routes
    (its parity with the JAX package: tests/test_torch_batch_candidates.py;
    the direct routes, the per-plane build at any plane count, streaming
    and view spread: tests/test_torch_{direct,planes,streaming}.py)."""
    scene_t = scene_from_numpy(world["scene"], device="cpu")
    for kw in (dict(batch_candidates=True),
               dict(batch_candidates=True, score_mode="warped")):
        out = tsd.estimate_scene(torch.Generator().manual_seed(0), scene_t,
                                 world["tcfg"].replace(**kw))
        assert tuple(out.depth.shape) == (N, H, W)
        assert torch.isfinite(out.depth).all()
        assert torch.isfinite(out.cost).all()
