"""PyTorch port vs the JAX package: ``batch_candidates=True``, every
propagation candidate scored in one cost call on the (K, H, W) stack (the
JAX package's ``jax.vmap`` of ``cost_of``, hcmvs_tpu/dense/patchmatch.py
``half_sweep``).

1. The batched ``compute_cost`` on the K stacked candidates of a
   half-sweep (the cross pattern's propagations and the view-spread
   ones) against K single calls, on every route (exact tables + rect
   engine, warped + rect engine, direct bilinear + direct gathers) in
   both phases, with the flow and a prior map attached: atol 1e-5 (the
   same elementwise arithmetic on a longer axis; kernels B, C and E take
   the candidates as columns or a grid axis).
2. ``estimate_scene`` with ``batch_candidates=True`` against the JAX
   package's at 96x128, 4 views x 3 neighbours (tests/test_torch_slice.py's
   world: JAX on the CPU with the table and rect engines forced on, both
   from JAX's init, no random refinement) on the exact and the warped
   routes: depth within rel 1e-5 on >= 99% of pixels, view 0's
   depth_acc_2pct within 0.03.
3. The batched half-sweep against the per-candidate one in the port:
   the same states (the tie order is the same: the incumbent first, the
   first minimum wins).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JConfig
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.utils.synth import make_plane_scene as jmake_plane_scene

from hcmvs_tpu_torch.convert import scene_from_numpy, state_from_numpy
from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import patchmatch as pm
from hcmvs_tpu_torch.dense import scene_driver as sd
from hcmvs_tpu_torch.dense import score as S
from hcmvs_tpu_torch.dense.flow import scene_flows
from hcmvs_tpu_torch.dense.types import make_view_geometry
from hcmvs_tpu_torch.utils.synth import make_plane_scene

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
# the three routes of compute_cost: the tables and the rect engine
# (kernels B and C), warped scoring (E; C in the geometric phase), and
# the direct paths (plain PyTorch on every device)
ROUTES = {"exact": dict(),
          "warped": dict(score_mode="warped"),
          "direct": dict(exact_backend="bilinear", geo_backend="direct")}


def _acc(depth, gt, margin=6):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


def _port_scene():
    """The slice's plane scene as the port's scene tensors on the CPU,
    with a random init (the port's own generator)."""
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    nbr = [[j for j in range(N) if j != i][:NBR] for i in range(N)]
    scene = sd.SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]),
        cams=cams, nbr_idx=torch.tensor(nbr),
        nbr_valid=torch.ones(N, NBR, dtype=torch.bool),
        d_min=torch.full((N,), sc.d_min), d_max=torch.full((N,), sc.d_max))
    state = sd.init_scene_state(torch.Generator().manual_seed(1), scene)
    return sc, scene, state


@pytest.fixture(scope="module")
def port_world():
    return _port_scene()


def _context(port_world, cfg, phase):
    """View 0's score context with the flow to its first neighbour, a
    prior map on its left half and, in the geometric phase, the
    neighbours' maps of the init."""
    sc, scene, state = port_world
    nbr = scene.nbr_idx[0]
    geom = make_view_geometry(scene.cams[0], scene.cams[nbr])
    flow = scene_flows(scene.gray, scene.nbr_idx.tolist())[0]
    prior = torch.from_numpy(sc.depth_gt.astype(np.float32)).clone()
    prior[:, W // 2:] = 0.0
    nd = state.depth[nbr] if phase >= 1 else None
    nn = state.normal[nbr] if phase >= 1 else None
    return pm.make_context(geom, scene.gray[0], scene.gray[nbr],
                           scene.d_min[0], scene.d_max[0], cfg, flow=flow,
                           prior_depth=prior, nbr_depth=nd, nbr_normal=nn)


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_batched_cost_matches_single_calls(port_world, route, phase):
    cfg = DenseConfig(**SLICE).replace(use_optical_flow=1, view_spread=1,
                                       batch_candidates=True,
                                       **ROUTES[route])
    cfg = sd.phase_cfg(cfg, phase, True)
    ctx = _context(port_world, cfg, phase)
    assert (ctx.vol is not None) == (route == "exact")
    assert (ctx.rect is not None) == (route != "direct" and phase >= 1)
    _, _, state = port_world
    cur_d, cur_n = state.depth[0], state.normal[0]
    cd, cn, _ = pm.propagation_candidates(
        ctx, cur_d, cur_n, pm.propagation_offsets(cfg), cfg)
    # the cross pattern's 8 and, in the geometric phase, 3 view-spread
    assert cd.shape[0] == 1 + 8 + (NBR if phase >= 1 else 0)
    offsets = S.patch_offsets(cfg)
    delta = pm.c2p_max(cur_d, cur_n, ctx.rays)

    def cost(d, n):
        return pm.compute_cost(ctx, d, n, cur_d, cur_n, delta, cfg, phase,
                               offsets)

    batched = cost(cd, cn)
    assert batched.shape == cd.shape
    single = torch.stack([cost(cd[k], cn[k]) for k in range(cd.shape[0])])
    assert torch.isfinite(single).all()
    np.testing.assert_allclose(batched.numpy(), single.numpy(), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_world():
    sc = jmake_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
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
    state0 = jsd.init_scene_state(jax.random.PRNGKey(0), scene)
    return dict(sc=sc, scene=scene, state0=state0)


@pytest.mark.parametrize("route", ["exact", "warped"])
def test_estimate_scene_batched_matches_jax(jax_world, route):
    extra = dict(batch_candidates=True, **ROUTES[route])
    cfg_j = JConfig(**SLICE, **FORCED).replace(**extra)
    cfg_t = DenseConfig(**SLICE).replace(**extra)
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), jax_world["scene"],
                             cfg_j)
    out = sd.estimate_scene(
        torch.Generator().manual_seed(0),
        scene_from_numpy(jax_world["scene"], device="cpu"), cfg_t,
        init=state_from_numpy(jax_world["state0"], device="cpu"))
    d_ref, d_out = np.array(ref.depth), out.depth.numpy()
    close = np.abs(d_out - d_ref) <= 1e-5 * np.abs(d_ref)
    assert close.mean() >= 0.99, close.mean()
    gt = jax_world["sc"].depth_gt
    acc_j, acc_t = _acc(d_ref[0], gt), _acc(d_out[0], gt)
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)


@pytest.mark.parametrize("route", ["exact", "warped", "hybrid", "direct"])
def test_batched_half_sweep_equals_per_candidate(port_world, route):
    """One geometric-phase sweep with view spread, random refinement and
    red/black parity: the batched path picks what the per-candidate path
    picks."""
    extra = (dict(score_mode="hybrid") if route == "hybrid"
             else ROUTES[route])
    cfg = DenseConfig(**SLICE).replace(view_spread=1, random_iters=2,
                                       sweep_mode="redblack", **extra)
    ctx = _context(port_world, cfg, 1)
    _, _, state = port_world
    st0 = pm.PatchMatchState(depth=state.depth[0], normal=state.normal[0],
                             cost=state.cost[0])
    offsets = S.patch_offsets(cfg)
    prop = pm.propagation_offsets(cfg)
    outs = [pm.half_sweep(st0, ctx, cfg.replace(batch_candidates=b), 1, 1,
                          offsets, prop, torch.Generator().manual_seed(3))
            for b in (False, True)]
    for field in ("depth", "normal", "cost"):
        np.testing.assert_allclose(getattr(outs[1], field).numpy(),
                                   getattr(outs[0], field).numpy(), rtol=0,
                                   atol=1e-5)


def test_estimate_scene_runs_batched_with_view_spread(port_world):
    """The whole scene on the exact route with view spread and the flow:
    finite maps, view 0 about as accurate as the per-candidate run."""
    sc, scene, _ = port_world
    scene = dataclasses.replace(
        scene, flows=scene_flows(scene.gray, scene.nbr_idx.tolist()))
    cfg = DenseConfig(**SLICE).replace(view_spread=1, use_optical_flow=1)
    accs = []
    for b in (False, True):
        out = sd.estimate_scene(torch.Generator().manual_seed(0), scene,
                                cfg.replace(batch_candidates=b))
        assert torch.isfinite(out.depth).all()
        assert torch.isfinite(out.cost).all()
        accs.append(_acc(out.depth[0].numpy(), sc.depth_gt))
    assert accs[1] > 0.5, accs
    assert abs(accs[1] - accs[0]) <= 0.01, accs
