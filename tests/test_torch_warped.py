"""PyTorch port vs the JAX package: warped scoring.

Kernel E's plain version (``ops/zncc_warped.zncc_warped_plain``) against
the Pallas kernel ``zncc_warped_pallas`` in interpret mode, at the shapes
of tests/test_pallas_kernels.py (the H > 192 case runs the Pallas row
tiling); ``photometric_scores_warped`` against the JAX package's CPU
(scan) branch; and the photometric-phase sweep of "warped" and "hybrid"
scoring.

Tolerances: the kernel at rtol 1e-4 / atol 2e-4 (the bar of
tests/test_pallas_kernels.py: exp differs by an ulp between
implementations and sq1 - s1^2 / sw cancels); scores at atol 1e-4 with
bad masks equal on >= 99.9% of pixels; sweeps on >= 99.5% of pixels
within 1e-4, because an argmin between near-tied candidates may flip
under reordered rounding.
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
from hcmvs_tpu.ops.pallas_zncc import zncc_warped_pallas
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (geometry_from_numpy, scene_from_numpy,
                                     state_from_numpy)
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import patchmatch as tpm
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.ops.zncc_warped import zncc_warped, zncc_warped_plain

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


def _kernel_case(h, w, pad, n_views, offsets, seed, full_valid=False,
                 hw_choices=(2.0, 3.0), acc_scale=0.1):
    """The inputs of tests/test_pallas_kernels.py, made with numpy."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * pad, w + 2 * pad
    f32 = np.float32
    valid = (np.ones((n_views, hp, wp), f32) if full_valid
             else (rng.random((n_views, hp, wp)) > 0.1).astype(f32))
    return dict(ref_pad=rng.random((hp, wp)).astype(f32),
                tm=rng.random((h, w)).astype(f32),
                nsq0=(rng.random((h, w)) + 0.1).astype(f32),
                warped_pad=rng.random((n_views, hp, wp)).astype(f32),
                valid_pad=valid,
                hw=rng.choice(hw_choices, (h, w)).astype(f32),
                acc=(rng.random((n_views, 4, h, w)) * acc_scale).astype(f32),
                scan_offsets=tuple(offsets), pad=pad)


def _grid_offsets(pad):
    offs = [(dy, dx) for dy in range(-pad, pad + 1, 2)
            for dx in range(-pad, pad + 1, 2)]
    return [(dy, dx) for dy, dx in offs
            if not (abs(dy) == pad and abs(dx) == pad)]


@pytest.mark.parametrize("h,w,pad,case", [
    (24, 32, 3, "grid"), (40, 48, 3, "grid"), (200, 64, 2, "row_tiles")])
def test_zncc_warped_plain_matches_pallas_interpret(h, w, pad, case):
    if case == "grid":
        args = _kernel_case(h, w, pad, 3, _grid_offsets(pad), seed=0)
    else:    # H > 192: the Pallas kernel runs 128-row tiles with halos
        args = _kernel_case(h, w, pad, 2,
                            ((0, 0), (-2, 1), (1, -2), (2, 2)), seed=1,
                            full_valid=True, hw_choices=(2.0,),
                            acc_scale=0.0)
    ref_s, ref_v = zncc_warped_pallas(
        *(jnp.asarray(args[k]) for k in ("ref_pad", "tm", "nsq0",
                                         "warped_pad", "valid_pad", "hw",
                                         "acc")),
        args["scan_offsets"], pad, interpret=True)
    targs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    out_s, out_v = zncc_warped_plain(**targs)
    assert out_s.shape == ref_s.shape
    np.testing.assert_allclose(out_s.numpy(), _np(ref_s), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out_v.numpy(), _np(ref_v), rtol=1e-4,
                               atol=2e-4)
    # CPU tensors take the plain version
    disp_s, _ = zncc_warped(**targs)
    assert torch.equal(disp_s, out_s)


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
    return dict(sc=sc, scene=scene,
                tscene=scene_from_numpy(scene, device="cpu"),
                state0=jsd.init_scene_state(jax.random.PRNGKey(0), scene))


def _contexts(world, cfg_j, cfg_t):
    """View 0's photometric-phase contexts in both packages (no tables:
    the warped mode reads the source images)."""
    ctx_j = jsd._per_view_context(world["scene"], 0, None, None, cfg_j)
    ctx_t = tsd._per_view_context(world["tscene"], 0, None, None, cfg_t)
    return ctx_j, dataclasses.replace(
        ctx_t, geom=geometry_from_numpy(ctx_j.geom, device="cpu"))


def _hypotheses(world):
    """View 0's random init and a near-ground-truth field."""
    sc, st = world["sc"], world["state0"]
    rng = np.random.default_rng(2)
    gt = (sc.depth_gt * (1 + 0.01 * rng.standard_normal((H, W)))).astype(
        np.float32)
    n_gt = np.broadcast_to(sc.normal_gt[:, None, None], (3, H, W)).astype(
        np.float32)
    return [(_np(st.depth[0]), _np(st.normal[0])), (gt, n_gt)]


@pytest.mark.parametrize("patch_step", [2, 4])
def test_photometric_scores_warped_match(world, patch_step):
    """Full (36 offsets, 4 corners) and explore (9 offsets, 1 corner)
    sampling."""
    cfg_j = JConfig(**SLICE, **FORCED).replace(score_mode="warped",
                                               patch_step=patch_step)
    cfg_t = TConfig(**SLICE).replace(score_mode="warped",
                                     patch_step=patch_step)
    ctx_j, ctx_t = _contexts(world, cfg_j, cfg_t)
    offsets = jscore.patch_offsets(cfg_j)
    for depth, normal in _hypotheses(world):
        sj, bj = jscore.photometric_scores_warped(
            ctx_j.geom, ctx_j.src_grays, ctx_j.stats, ctx_j.hw,
            jnp.asarray(depth), jnp.asarray(normal), ctx_j.rays, offsets,
            cfg_j)
        st_, bt = tscore.photometric_scores_warped(
            ctx_t.geom, ctx_t.src_grays, ctx_t.stats, ctx_t.hw,
            torch.from_numpy(depth), torch.from_numpy(normal), ctx_t.rays,
            offsets, cfg_t)
        # a bad flip (centre warp on the image border, var1 at its floor)
        # swaps a score for the flat thRobust cost: compare the rest
        same = bt.numpy() == _np(bj)
        assert same.mean() >= 0.999
        np.testing.assert_allclose(st_.numpy()[same], _np(sj)[same], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("score_mode", ["warped", "hybrid"])
def test_half_sweep_photometric_phase_matches(world, score_mode):
    cfg_j = JConfig(**SLICE, **FORCED).replace(score_mode=score_mode)
    cfg_t = TConfig(**SLICE).replace(score_mode=score_mode)
    ctx_j, ctx_t = _contexts(world, cfg_j, cfg_t)
    offsets = jscore.patch_offsets(cfg_j)
    prop = jpm.propagation_offsets(cfg_j)
    st = world["state0"]
    sj0 = jpm.PatchMatchState(depth=st.depth[0], normal=st.normal[0],
                              cost=st.cost[0], key=st.keys[0])
    sj = jax.jit(functools.partial(
        jpm.half_sweep, cfg=cfg_j, phase=0, parity=0, offsets=offsets,
        prop_offsets=prop))(sj0, ctx_j)
    tst = state_from_numpy(st, device="cpu")
    st0 = tpm.PatchMatchState(depth=tst.depth[0], normal=tst.normal[0],
                              cost=tst.cost[0])
    stt = tpm.half_sweep(st0, ctx_t, cfg_t, 0, 0, offsets, prop,
                         torch.Generator().manual_seed(0))
    ok = ((np.abs(stt.depth.numpy() - _np(sj.depth)) <= 1e-4)
          & (np.abs(stt.normal.numpy() - _np(sj.normal)).max(0) <= 1e-4)
          & (np.abs(stt.cost.numpy() - _np(sj.cost)) <= 1e-4))
    assert ok.mean() >= 0.995, ok.mean()


def test_warped_scoring_builds_no_tables(world):
    cfg = TConfig(**SLICE).replace(score_mode="warped")
    assert tsd.attach_volumes(world["tscene"], cfg).vols is None
    assert not tscore.use_volume_tables(cfg)
    assert tscore.use_volume_tables(cfg.replace(score_mode="hybrid"))
    with pytest.raises(ValueError):
        tscore.use_volume_tables(cfg.replace(score_mode="bilinear"))
