"""PyTorch port vs the JAX package: the cross-scale channels.

The prior term (``score.prior_blend``) and the 0.1-bonus hypothesis
injection that the hierarchical schedule's restore stages feed, through
``scene_sweeps`` from the same state on the plane scene at 48x64 with 3
views: the injection in each of the three refinement branches (one
candidate after another; ``refine_batched`` scored by a loop; and
``refine_batched`` with ``candidate_kernel="on"``, against the JAX
package's packed TPU route run on the CPU, as tests/test_torch_batched.py
does), and the prior in a geometric phase.  The injected and prior maps
are the ground truth with 2% / 1% noise and holes.  JAX runs with the
table and rect engines forced on; the tables are the JAX package's,
converted.  No random refinement, so the random streams do not enter.

Tolerances: ``prior_blend`` at atol 1e-6; sweeps by share of pixels
(depth within 1e-3 on >= 99%), since an argmin between near-tied
candidates may flip under reordered rounding.
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
from hcmvs_tpu.dense import score as jscore
from hcmvs_tpu.ops import rect_gather as jrg
from hcmvs_tpu.ops import volume as jvol
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (scene_from_numpy, state_from_numpy,
                                     tables_from_numpy)
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.utils.synth import make_plane_scene as tmake_plane
from hcmvs_tpu_torch.utils.synth import plane_depth_of_view

torch.set_num_threads(1)
H, W, N = 48, 64, 3
BASE = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
            estimation_iters=1, random_iters=0, use_optical_flow=0,
            use_geo_consistency=1, use_part_consistency=0,
            estimation_iters_external=2, optimize=0)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")
BRANCHES = {"serial": dict(refine_batched=False),
            "scan": dict(refine_batched=True),
            "batched": dict(refine_batched=True, candidate_kernel="on")}


@pytest.fixture
def tpu_route(monkeypatch):
    """The JAX package's TPU route on the CPU: the backend answers "tpu"
    and the Pallas kernels it reaches run in interpret mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    multi = jvol.volume_lookup_multi
    monkeypatch.setattr(jvol, "volume_lookup_multi",
                        lambda tab, f, bounds=None: multi(tab, f, bounds,
                                                          interpret=True))
    lookup = jvol.volume_lookup
    monkeypatch.setattr(jvol, "volume_lookup",
                        lambda tab, f: lookup(tab, f, interpret=True))
    rect = jrg.rect_lookup
    monkeypatch.setattr(jrg, "rect_lookup",
                        lambda ctx, sigma: rect(ctx, sigma, interpret=True))


@pytest.fixture(scope="module")
def world():
    """The plane scene in both packages, every other view a neighbour,
    with noisy ground-truth maps attached as the cross-scale prior and
    injected hypothesis, the JAX package's tables, and its random init."""
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    tsc = tmake_plane(np.random.default_rng(0), h=H, w=W, n_views=N)
    rng = np.random.default_rng(8)
    gt = np.stack([plane_depth_of_view(tsc, i) for i in range(N)])
    inject = gt * (1 + 0.02 * rng.standard_normal(gt.shape))
    inject[:, 10:20, 20:40] = 0.0                    # no hypothesis here
    prior = gt * (1 + 0.01 * rng.standard_normal(gt.shape))
    prior[:, 30:40, :] = 0.0                         # no prior here
    n_cam = np.stack([c.R.numpy().astype(np.float64) @ tsc.n_w
                      for c in tsc.cameras])         # (N, 3)
    normal = (n_cam[:, :, None, None]
              + 0.05 * rng.standard_normal((N, 3, H, W)))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    nbr = np.array([[j for j in range(N) if j != i] for i in range(N)],
                   np.int32)
    scene = jsd.SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=JCamera(*(jnp.stack([getattr(c, f) for c in sc.cameras])
                       for f in "KRC")),
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((N, N - 1), bool),
        d_min=jnp.full((N,), sc.d_min, jnp.float32),
        d_max=jnp.full((N,), sc.d_max, jnp.float32),
        prior_depth=jnp.asarray(prior, jnp.float32),
        inject_depth=jnp.asarray(inject, jnp.float32),
        inject_normal=jnp.asarray(normal, jnp.float32))
    scene_v = jsd.attach_volumes(scene, JConfig(**BASE, **FORCED))
    tscene = dataclasses.replace(
        scene_from_numpy(scene, device="cpu"),
        vols=tables_from_numpy(scene_v.vols, device="cpu"))
    return dict(sc=sc, scene_v=scene_v, tscene=tscene, inject=inject,
                state0=jsd.init_scene_state(jax.random.PRNGKey(0), scene))


def _close(a, b) -> float:
    return float((np.abs(a - b) <= 1e-3 * np.abs(b)).mean())


def _sweeps(world, kw, phase, inject):
    """One sweep from the JAX init in both packages: (JAX depth, port
    depth)."""
    jcfg = JConfig(**BASE, **FORCED, **kw)
    tcfg = TConfig(**BASE, **kw)
    use_nbr = phase >= 1
    ref = jsd.scene_sweeps(world["state0"], world["scene_v"], jcfg, phase,
                           1, use_nbr, inject=inject)
    out = tsd.scene_sweeps(state_from_numpy(world["state0"], device="cpu"),
                           world["tscene"], tcfg, phase, 1, use_nbr,
                           torch.Generator().manual_seed(0), inject=inject)
    return np.asarray(ref.depth), out.depth.numpy()


def test_prior_blend_matches_jax():
    rng = np.random.default_rng(2)
    score = rng.uniform(0, 2, (32, 40)).astype(np.float32)
    depth = rng.uniform(2, 5, (32, 40)).astype(np.float32)
    prior = (depth * (1 + 0.3 * rng.standard_normal((32, 40)))
             ).astype(np.float32)
    prior[::3] = 0.0
    prior[1::7] = -1.0
    for kw in ({}, dict(para_prior=0.7, sigma_prior=0.05)):
        ref = jscore.prior_blend(jnp.asarray(score), jnp.asarray(depth),
                                 jnp.asarray(prior), JConfig(**kw))
        out = tscore.prior_blend(torch.from_numpy(score),
                                 torch.from_numpy(depth),
                                 torch.from_numpy(prior), TConfig(**kw))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    assert np.array_equal(out.numpy()[::3], score[::3])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_injection_matches_jax(world, request, branch):
    """A photometric sweep with the injection, in each refinement branch;
    the injected hypothesis wins on part of the image, and never where it
    has a hole."""
    if branch == "batched":
        request.getfixturevalue("tpu_route")
    d_ref, d_out = _sweeps(world, BRANCHES[branch], 0, True)
    share = _close(d_out, d_ref)
    assert share >= 0.99, share
    won = d_out == world["inject"].astype(np.float32)
    assert 0.05 < won.mean() < 0.95, won.mean()
    assert not won[:, 10:20, 20:40].any()


def test_injection_changes_the_sweep_only_when_asked(world):
    plain_ref, plain_out = _sweeps(world, BRANCHES["serial"], 0, False)
    assert _close(plain_out, plain_ref) >= 0.99
    won = plain_out == world["inject"].astype(np.float32)
    assert won.mean() < 0.01, won.mean()


def test_prior_in_the_geometric_phase_matches_jax(world):
    """The prior enters the cost from phase 1 on; without the prior map
    the same sweep ends elsewhere on part of the image."""
    d_ref, d_out = _sweeps(world, BRANCHES["serial"], 1, False)
    share = _close(d_out, d_ref)
    assert share >= 0.99, share
    no_prior = dataclasses.replace(world["tscene"], prior_depth=None)
    alt = tsd.scene_sweeps(state_from_numpy(world["state0"], device="cpu"),
                           no_prior, TConfig(**BASE), 1, 1, True,
                           torch.Generator().manual_seed(0))
    assert (alt.depth.numpy() != d_out).mean() > 0.01
