"""PyTorch port vs the JAX package: Delaunay seeds and the ridge scene.

``dense/init_tri.py`` (``triangulate_init``, ``scene_triangulated_seeds``:
the init of ``init_triangulate=1``) and ``utils/synth.py``'s ridge scene,
both numpy, must give what the JAX package gives; then
``init_triangulate=1`` through the DensifyPointCloud path (``.mvs`` +
PNGs, 48x64, 3 views of the ridge scene) against the JAX package's,
from the same (JAX) init, as tests/test_torch_densify.py runs it: on
Farneback flow (each package's default) and on LK
(``test_torch_flow.flow_backend``).

Tolerances: the numpy modules exactly (atol 1e-6 on floats); densify by
view 0's depth accuracy and the valid share (within 0.03) and the point
count (within 2%).
"""

import os

import numpy as np
import pytest
import torch
from test_torch_flow import flow_backend

torch.set_num_threads(1)

H, W, N = 48, 64, 3
SMALL = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, estimation_iters_external=3, random_iters=0,
             use_optical_flow=1, optimize=1, use_geo_consistency=1,
             use_part_consistency=0, resolution_level=0, min_resolution=0,
             init_triangulate=1)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")


def _acc(depth, gt, margin=6):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


@pytest.mark.parametrize("texture", ["blobs", "sinusoids"])
def test_ridge_scene_is_bit_identical(texture):
    from hcmvs_tpu.utils import synth as jsynth
    from hcmvs_tpu_torch.utils import synth as tsynth
    kw = dict(h=24, w=32, n_views=3, fx=40.0)
    if texture == "sinusoids":
        kw["texture_fn"] = tsynth.sinusoid_texture_fn(
            np.random.default_rng(1))
    j = jsynth.make_ridge_scene(np.random.default_rng(5), **kw)
    t = tsynth.make_ridge_scene(np.random.default_rng(5), **kw)
    for a, b in zip(t.images, j.images):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(t.depth_gt, j.depth_gt)
    for (tn, tc), (jn, jc) in zip(t.planes, j.planes):
        assert np.array_equal(tn, jn) and tc == jc
    for tc_, jc_ in zip(t.cameras, j.cameras):
        for f in "KRC":
            assert np.array_equal(getattr(tc_, f).numpy(),
                                  np.asarray(getattr(jc_, f)))
    pts = np.random.default_rng(2).uniform(-2, 2, (50, 3))
    assert np.array_equal(t.surface_dist(pts), j.surface_dist(pts))
    # the blob texture alone, on a grid of world points
    xy = np.random.default_rng(3).uniform(-3, 3, (20, 30, 2))
    assert np.array_equal(
        tsynth.blob_texture_fn(np.random.default_rng(9), 50)(xy),
        jsynth.blob_texture_fn(np.random.default_rng(9), 50)(xy))


def test_ridge_sparse_points_lie_on_the_ridge():
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             ridge_sparse_points)
    sc = make_ridge_scene(np.random.default_rng(5), h=24, w=32, n_views=2,
                          fx=40.0)
    pts = ridge_sparse_points(sc, 40, seed=1).astype(np.float64)
    assert pts.shape == (40, 3)
    assert sc.surface_dist(pts).max() < 1e-5


@pytest.mark.parametrize("n_pts", [40, 5, 2])
@pytest.mark.parametrize("add_corners", [True, False])
def test_triangulate_init_matches_jax(n_pts, add_corners):
    from hcmvs_tpu.dense.init_tri import triangulate_init as jtri
    from hcmvs_tpu_torch.dense.init_tri import triangulate_init
    rng = np.random.default_rng(n_pts)
    uv = rng.uniform(-3, [35, 27], (n_pts, 2))
    depth = rng.uniform(2, 5, n_pts)
    depth[:1] = -1.0                                 # dropped
    d_t, m_t = triangulate_init(uv, depth, 24, 32, add_corners)
    d_j, m_j = jtri(uv, depth, 24, 32, add_corners)
    assert d_t.dtype == np.float32 and d_t.shape == (24, 32)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    assert np.array_equal(m_t, m_j)
    if n_pts == 2:
        assert not m_t.any() and not d_t.any()
    # collinear points: Qhull refuses them, both give an empty map
    line = np.stack([np.arange(6.0), np.arange(6.0)], 1)
    d_t, m_t = triangulate_init(line, np.ones(6), 24, 32, False)
    assert not m_t.any() and not jtri(line, np.ones(6), 24, 32,
                                      False)[1].any()


@pytest.mark.parametrize("add_corners", [True, False])
def test_scene_triangulated_seeds_match_jax(add_corners):
    """Random views and points, a view that sees fewer than 3 points and
    points behind some cameras."""
    from hcmvs_tpu.dense.init_tri import scene_triangulated_seeds as jseeds
    from hcmvs_tpu_torch.dense.init_tri import scene_triangulated_seeds
    rng = np.random.default_rng(3)
    n, p = 5, 120
    centers = rng.uniform(-1, 1, (n, 3))
    centers[:, 2] -= 4.0
    centers[3, 2] = 2.0                              # most points behind
    points = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    counts = rng.integers(0, 5, p).astype(np.int32)
    ids = np.concatenate([rng.choice(4, min(c, 4), replace=False)
                          for c in counts]).astype(np.uint32)
    counts = np.minimum(counts, 4).astype(np.int32)
    ids = np.concatenate([ids, [4, 4]]).astype(np.uint32)  # view 4: two
    counts[-1] += 2                                        # points only
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    cams = [(K, np.eye(3), centers[i]) for i in range(n)]
    out = scene_triangulated_seeds(points, counts, ids, cams, n, 24, 32,
                                   add_corners)
    ref = jseeds(points, counts, ids, cams, n, 24, 32, add_corners)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (out[0] > 0).mean() > 0.2 and not out[4].any()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene, write_ridge_scene
    root = tmp_path_factory.mktemp("tri")
    sc = make_ridge_scene(np.random.default_rng(4), h=H, w=W, n_views=N,
                          fx=180.0 * W / 192.0)
    scene_path, img_dir = write_ridge_scene(str(root), sc)
    return dict(sc=sc, root=root, scene_path=scene_path, img_dir=img_dir)


def test_densify_init_triangulate_matches_jax(world):
    """The Delaunay seeds equal the JAX package's, and densify from them
    (and from JAX's init) agrees with its run, on Farneback flow (both
    packages' default)."""
    _check_init_triangulate(world, "farneback")


def test_densify_init_triangulate_matches_jax_on_lk(world):
    """The same on LK flow in both packages."""
    _check_init_triangulate(world, "lk")


def _check_init_triangulate(world, backend):
    import jax
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.pipeline import densify as jd
    from hcmvs_tpu_torch.convert import state_from_numpy
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.io.images import load_image
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.pipeline.densify import build_scene_tensors, densify
    jcfg, tcfg = JConfig(**SMALL, **FORCED), TConfig(**SMALL)
    scene = read_mvs(world["scene_path"])
    grays = [load_image(os.path.join(world["img_dir"], im.name), gray=True)
             for im in scene.images]
    jt = jd.build_scene_tensors(scene, grays, jcfg)
    tt = build_scene_tensors(scene, grays, tcfg, device="cpu")
    np.testing.assert_allclose(tt.seed_depth.numpy(),
                               np.asarray(jt.seed_depth), rtol=0, atol=1e-6)
    assert (tt.seed_depth.numpy() > 0).mean() > 0.9  # dense, not splatted
    init = state_from_numpy(jsd.init_scene_state(jax.random.PRNGKey(0), jt),
                            device="cpu")
    with flow_backend(backend):
        ref = jd.densify(world["scene_path"], world["img_dir"],
                         str(world["root"] / f"jax_{backend}"), jcfg,
                         verbose=False)
        stats = densify(world["scene_path"], world["img_dir"],
                        str(world["root"] / f"port_{backend}"), tcfg,
                        verbose=False, device="cpu", init=init)
    gt = world["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.5, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    assert abs(stats["n_points"] - ref["n_points"]) <= 0.02 * ref["n_points"]
