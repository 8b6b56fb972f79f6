"""PyTorch port vs the JAX package: the planar-prior pass.

``dense/priors.py`` function by function, and ``scene_driver.
_priors_batched`` / ``compute_scene_priors``, on the same numpy inputs:
the ridge scene's view depths (two planes meeting at a ridge) with 0.3%
multiplicative noise, 10% random holes and a hole block, its sinusoid
images, and its face map as the semantic labels, at 48x64 and 96x128.
RANSAC takes the JAX package's own draws (``jax.random.split(
PRNGKey(7), n)`` per view, each split again into the anchor and offset
keys), fed to the port's apply function.

Tolerances: SLIC labels, the spacing, the hypothesis count, segment
counts, RANSAC inlier shares and the NFA's fine shares exactly; the
prior maps of a scene's views by support (equal on >= 99% of their
pixels) and value (relative 1e-4 where both are nonzero).  The float32
3x3 solves of the two packages (each its own LAPACK) differ in the last
bits; the IRLS weights carry that to a pixel's inlier flag, and a
superpixel whose log NFA sits within one inlier of 0 may then pass the
gate in one package only (one such superpixel in three views at 96x128:
98.8% of that view's pixels agree).  IRLS planes are held by the inverse
depth they predict (relative 1e-3 on valid pixels) and their inlier
shares within 0.02; NFA values within 8 float32 ulps of the segment's
largest ``lgamma`` term (each package has its own ``lgamma``); what is
fed identical planes exactly or at 1e-6.
"""

import functools
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SIZES = [(48, 64), (96, 128)]
N_VIEWS = 3
K_HYPS = 64


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(x)))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request):
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn)
    h, w = request.param
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=N_VIEWS, fx=180.0 * w / 192.0,
                          texture_fn=sinusoid_texture_fn(
                              np.random.default_rng(1)))
    rng = np.random.default_rng(3)
    depths = []
    for d in sc.depths:
        d = d * (1 + rng.normal(0, 0.003, d.shape))
        d[rng.uniform(size=d.shape) < 0.1] = 0
        d[h // 4:h // 3, w // 5:w // 3] = 0
        depths.append(d.astype(np.float32))
    return dict(h=h, w=w, gray=np.stack(sc.images), depth=np.stack(depths),
                sem=np.stack(sc.faces).astype(np.int32))


def _jax_draws(key, h, w, n_hyps=K_HYPS, radius=12):
    """The anchors and offsets ``ransac_segment_planes`` draws from
    ``key``."""
    import jax
    k0, k1 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k0, (n_hyps,), 0, h * w)),
            np.asarray(jax.random.randint(k1, (n_hyps, 2, 2), -radius,
                                          radius + 1)))


def _assert_priors_agree(ours, ref):
    """Support equal on >= 99% of pixels; relative 1e-4 where both > 0."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    same = float(((ours > 0) == (ref > 0)).mean())
    assert same >= 0.99, same
    both = (ours > 0) & (ref > 0)
    rel = np.abs(ours[both] - ref[both]) / ref[both]
    assert rel.max(initial=0.0) <= 1e-4, rel.max()


def test_slic_labels_equal(world):
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    for g in world["gray"]:
        ref = np.asarray(JP.slic_superpixels(jnp.asarray(g)))
        ours = TP.slic_superpixels(_t(g)).numpy()
        assert np.array_equal(ours, ref)


def test_spacing_and_hypothesis_count_equal(world):
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    d = world["depth"][0]
    cases = [d, np.zeros_like(d), np.full_like(d, 3.0),
             np.where(np.arange(d.size).reshape(d.shape) % 7 == 0, d, 0)]
    for x in cases:
        ref = float(JP.inv_depth_spacing(jnp.asarray(x)))
        assert float(TP.inv_depth_spacing(_t(x))) == ref
    for p in (0.005, 0.05, 0.5, 1e-6, 1e-20):
        assert (TP.hyps_from_probability(p)
                == JP.hyps_from_probability(p))


def test_fit_planes_and_prior_map(world):
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    h, w = world["h"], world["w"]
    n_lbl = (h // 16) * (w // 16)
    g, d = world["gray"][0], world["depth"][0]
    labels = np.asarray(JP.slic_superpixels(jnp.asarray(g)))
    eps = JP.inv_depth_spacing(jnp.asarray(d)) * 1.4
    pj, fj, cj = (np.asarray(x) for x in JP.fit_segment_planes(
        jnp.asarray(labels), jnp.asarray(d), None, n_lbl, tukey_c=eps))
    pt, ft, ct = TP.fit_segment_planes(_t(labels, torch.int64), _t(d),
                                       n_lbl, tukey_c=_t(eps))
    assert np.array_equal(ct.numpy(), cj)
    assert np.abs(ft.numpy() - fj).max() <= 0.02
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    valid = d > 0

    def inv_depth(p):
        q = p[labels]
        return q[..., 0] * xx + q[..., 1] * yy + q[..., 2]

    ref_z = inv_depth(pj)
    rel = np.abs(inv_depth(pt.numpy()) - ref_z)[valid] / np.abs(ref_z[valid])
    assert rel.max() <= 1e-3, rel.max()
    # fed the same planes and statistics, the prior map matches
    ref = np.asarray(JP.prior_depth_map(jnp.asarray(labels), jnp.asarray(pj),
                                        jnp.asarray(fj), jnp.asarray(cj),
                                        n_lbl))
    ours = TP.prior_depth_map(_t(labels, torch.int64), _t(pj), _t(fj),
                              _t(cj)).numpy()
    assert np.array_equal(ours > 0, ref > 0)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert (ref > 0).mean() > 0.2


@pytest.mark.parametrize("kind", ["superpixels", "semantic"])
def test_segment_plane_nfa(world, kind):
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    h, w = world["h"], world["w"]
    d = world["depth"][1]
    if kind == "semantic":
        labels, n_lbl = world["sem"][1], 2
    else:
        labels = np.asarray(JP.slic_superpixels(jnp.asarray(
            world["gray"][1])))
        n_lbl = (h // 16) * (w // 16)
    sp = JP.inv_depth_spacing(jnp.asarray(d))
    planes = np.asarray(JP.fit_segment_planes(
        jnp.asarray(labels), jnp.asarray(d), None, n_lbl,
        tukey_c=sp * 1.4)[0])
    nj, fj = (np.asarray(x) for x in JP.segment_plane_nfa(
        jnp.asarray(labels), jnp.asarray(d), jnp.asarray(planes), n_lbl, sp))
    nt, ft = TP.segment_plane_nfa(_t(labels, torch.int64), _t(d),
                                  _t(planes), n_lbl, _t(sp))
    nt, ft = nt.numpy(), ft.numpy()
    assert np.array_equal(ft, fj)
    assert np.array_equal(np.isfinite(nt), np.isfinite(nj))
    fin = np.isfinite(nj)
    # log NFA sums lgamma terms up to lgamma(n + 1) of the segment's n
    # pixels: 8 float32 ulps of that term
    n_seg = np.bincount(labels.reshape(-1)[d.reshape(-1) > 0],
                        minlength=n_lbl).astype(np.float64)
    tol = 8 * np.finfo(np.float32).eps * np.array(
        [math.lgamma(x + 1.0) for x in n_seg])
    assert (np.abs(nt - nj)[fin] <= tol[fin]).all()
    assert np.array_equal(nt < 0, nj < 0)


def test_ransac_with_jax_draws(world):
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    h, w = world["h"], world["w"]
    for i in range(N_VIEWS):
        d, sem = world["depth"][i], world["sem"][i]
        key = jax.random.split(jax.random.PRNGKey(7), N_VIEWS)[i]
        eps = JP.inv_depth_spacing(jnp.asarray(d)) * 1.4
        pj, fj, cj = (np.asarray(x) for x in JP.ransac_segment_planes(
            key, jnp.asarray(sem), jnp.asarray(d), 2, n_hyps=K_HYPS,
            epsilon=eps))
        anchor, offs = _jax_draws(key, h, w)
        pt, ft, ct = TP.ransac_segment_planes(
            (_t(anchor), _t(offs)), _t(sem, torch.int64), _t(d), 2,
            epsilon=_t(eps))
        assert np.array_equal(ct.numpy(), cj)
        assert np.array_equal(ft.numpy(), fj)
        scale = np.abs(pj).max(axis=0)
        assert (np.abs(pt.numpy() - pj) <= 1e-4 * scale).all()
        assert (fj > 0.2).all()


def test_ransac_draws():
    from hcmvs_tpu_torch.dense import priors as TP
    a1, o1 = TP.ransac_draws(torch.Generator().manual_seed(3), 48, 64, 64, 5)
    a2, o2 = TP.ransac_draws(torch.Generator().manual_seed(3), 48, 64, 64, 5)
    assert torch.equal(a1, a2) and torch.equal(o1, o2)
    assert a1.shape == (64,) and o1.shape == (64, 2, 2)
    assert 0 <= int(a1.min()) and int(a1.max()) < 48 * 64
    assert int(o1.min()) >= -5 and int(o1.max()) <= 5
    assert len(set(a1.tolist())) > 32


@pytest.mark.parametrize("semantic", [False, True])
def test_generate_priors(world, semantic):
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    h, w = world["h"], world["w"]
    refs, outs = [], []
    for i in range(N_VIEWS):
        g, d = world["gray"][i], world["depth"][i]
        kw_j, kw_t = {}, {}
        if semantic:
            key = jax.random.split(jax.random.PRNGKey(7), N_VIEWS)[i]
            kw_j = dict(semantic=jnp.asarray(world["sem"][i]),
                        n_semantic_labels=2, key=key)
            anchor, offs = _jax_draws(key, h, w)
            kw_t = dict(semantic=_t(world["sem"][i], torch.int64),
                        n_semantic_labels=2, draws=(_t(anchor), _t(offs)))
        refs.append(np.asarray(JP.generate_priors(
            jnp.asarray(g), jnp.asarray(d), None, **kw_j)))
        outs.append(TP.generate_priors(_t(g), _t(d), **kw_t).numpy())
        assert (refs[-1] > 0).mean() > 0.1
    _assert_priors_agree(np.stack(outs), np.stack(refs))


def test_merge_final_prior():
    import jax.numpy as jnp
    from hcmvs_tpu.dense import priors as JP
    from hcmvs_tpu_torch.dense import priors as TP
    rng = np.random.default_rng(4)
    ext = np.where(rng.uniform(size=(30, 40)) < 0.5, 0,
                   rng.uniform(1, 5, (30, 40))).astype(np.float32)
    sup = np.where(rng.uniform(size=(30, 40)) < 0.5, 0,
                   rng.uniform(1, 5, (30, 40))).astype(np.float32)
    ref = np.asarray(JP.merge_final_prior(jnp.asarray(ext), jnp.asarray(sup)))
    assert np.array_equal(TP.merge_final_prior(_t(ext), _t(sup)).numpy(), ref)


def _scenes(world, semantic: bool, ext: bool):
    """A JAX SceneTensors / SceneState of the world's views (only the
    fields the prior pass reads are meaningful) and the port's copy."""
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu_torch.convert import scene_from_numpy, state_from_numpy
    n, h, w = world["depth"].shape
    ext_map = None
    if ext:
        # the ground truth on the left half of view 0 and 2, nothing on 1
        ext_map = np.zeros((n, h, w), np.float32)
        for i in (0, 2):
            ext_map[i, :, :w // 2] = np.abs(world["depth"][i, :, :w // 2]) \
                + 0.01
    eye = jnp.tile(jnp.eye(3)[None], (n, 1, 1))
    js = jsd.SceneTensors(
        gray=jnp.asarray(world["gray"]),
        cams=Camera(K=eye, R=eye, C=jnp.zeros((n, 3))),
        nbr_idx=jnp.zeros((n, 1), jnp.int32),
        nbr_valid=jnp.ones((n, 1), bool), d_min=jnp.ones(n),
        d_max=jnp.ones(n) * 9,
        ext_prior_depth=None if ext_map is None else jnp.asarray(ext_map),
        semantic=jnp.asarray(world["sem"]) if semantic else None)
    jst = jsd.SceneState(depth=jnp.asarray(world["depth"]),
                         normal=jnp.zeros((n, 3, h, w)),
                         cost=jnp.zeros((n, h, w)),
                         keys=jnp.zeros((n, 2), jnp.uint32))
    return js, jst, scene_from_numpy(js, device="cpu"), state_from_numpy(
        jst, device="cpu")


@pytest.mark.parametrize("semantic,ext", [(False, False), (True, False),
                                          (True, True)])
def test_priors_batched_and_scene_priors(world, semantic, ext):
    import jax
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    h, w = world["h"], world["w"]
    js, jst, ts, tst = _scenes(world, semantic, ext)
    keys = jax.random.split(jax.random.PRNGKey(7), N_VIEWS)
    draws = [tuple(_t(x) for x in _jax_draws(k, h, w)) for k in keys]
    n_sem = 2 if semantic else 0
    if not ext:
        ref = jsd._priors_batched(jax.random.PRNGKey(7), js.gray, jst.depth,
                                  js.cams, js.semantic, n_sem, JConfig())
        ours = tsd._priors_batched(ts.gray, tst.depth, ts.semantic, n_sem,
                                   TConfig(), draws)
        _assert_priors_agree(ours, ref)
    ref = jsd.compute_scene_priors(jst, js, cfg=JConfig()).prior_depth
    out = tsd.compute_scene_priors(tst, ts, cfg=TConfig(), draws=draws)
    _assert_priors_agree(out.prior_depth, ref)
    assert out.semantic is ts.semantic and out.gray is ts.gray
    if ext:
        # the external channel wins where it is nonzero; alone without
        # the superpixel pass
        e = ts.ext_prior_depth
        assert torch.equal(out.prior_depth[e > 0], e[e > 0])
        alone = tsd.compute_scene_priors(tst, ts, with_super=False)
        assert alone.prior_depth is ts.ext_prior_depth
        ref = jsd.compute_scene_priors(jst, js, with_super=False).prior_depth
        assert np.array_equal(alone.prior_depth.numpy(), np.asarray(ref))


def test_prior_generators_per_view():
    """The port's own draws: seeded from (7, view) alone, so a view's
    draws do not depend on the other views."""
    from hcmvs_tpu_torch.dense import priors as TP
    from hcmvs_tpu_torch.dense.scene_driver import prior_generator
    a = [TP.ransac_draws(prior_generator(i, "cpu"), 48, 64) for i in (0, 1)]
    b = TP.ransac_draws(prior_generator(1, "cpu"), 48, 64)
    assert torch.equal(a[1][0], b[0]) and torch.equal(a[1][1], b[1])
    assert not torch.equal(a[0][0], a[1][0])


def test_fixed_order_sums(world, monkeypatch):
    """The order-fixed segment sums the card uses, forced on the CPU: equal
    to ``index_add_``'s within float32 rounding (exactly for counts), the
    same on every call; the prior pass with them agrees with the
    in-order one as two packages do."""
    from hcmvs_tpu_torch.dense import priors as TP
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 37, 5000))
    ids[ids == 5] = 6                                 # an empty segment
    x = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    ref = TP._Segments(ids, 40).sum(x)
    fixed = TP._Segments(ids, 40, fixed_order=True)
    out = fixed.sum(x)
    assert fixed.width == int(torch.bincount(ids).max())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    assert torch.equal(fixed.sum(x), out)
    ones = torch.ones(5000, 2)
    assert torch.equal(fixed.sum(ones), TP._Segments(ids, 40).sum(ones))
    assert not out[[5, 37, 38, 39]].any()
    g, d = _t(world["gray"][0]), _t(world["depth"][0])
    kw = dict(semantic=_t(world["sem"][0], torch.int64), n_semantic_labels=2,
              draws=TP.ransac_draws(torch.Generator().manual_seed(1),
                                    world["h"], world["w"]))
    ref = TP.generate_priors(g, d, **kw)
    monkeypatch.setattr(TP, "_Segments",
                        functools.partial(TP._Segments, fixed_order=True))
    _assert_priors_agree(TP.generate_priors(g, d, **kw), ref)
