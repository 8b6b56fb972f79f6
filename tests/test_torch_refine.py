"""PyTorch port vs the JAX package: mesh refinement on the CPU.

The setups of tests/test_refine.py (a plane and a ridge seen by 3-4
views, a grid mesh pushed off the surface), at fewer iterations.  JAX
runs on the CPU.

Tolerances.  The per-pixel gradient's normalised residual divides by
windowed deviations that are nearly zero where a 5x5 window is nearly
flat, so a last-bit change in one pixel moves the sum visibly: the JAX
package's own jitted gradient differs from its op-by-op (``disable_jit``)
run by 3.7% (relative L2) on the ridge below, and one fd step by 0.012
(more than its median move).  So one gradient is held to the op-by-op
JAX run within 1e-5 (relative L2; the same operations in the same
order) and to the jitted one within 0.1, one fd step to the op-by-op run
within 1e-4 (measured 2.5e-5); whole refinements
(whose steps are normalised by the gradient's 90th percentile) within a
vertex tolerance of 5% of the median move (median) / 25% (90th
percentile), and their error to the true surface within 10% of the JAX
run's.  The fixed-order sums equal ``index_add_`` bit for bit on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.mesh import refine as jref
from hcmvs_tpu.mesh.mesh_ops import rasterize_attributes as j_raster
from hcmvs_tpu.utils.synth import make_plane_scene, make_ridge_scene

from hcmvs_tpu_torch.mesh import refine as tref
from hcmvs_tpu_torch.mesh.mesh_ops import rasterize_attributes

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _ridge_z(x, y):
    return np.where(x < 0, 4.0 + 0.5 * x, 4.0 - 0.35 * x)


def _grid(nx, ny, x_ext, y_ext, z_fn):
    X, Y = np.meshgrid(np.linspace(-x_ext, x_ext, nx),
                       np.linspace(-y_ext, y_ext, ny))
    verts = np.stack([X.ravel(), Y.ravel(), z_fn(X, Y).ravel()],
                     1).astype(np.float32)
    faces = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i
            faces += [[a, a + 1, a + nx], [a + 1, a + nx + 1, a + nx]]
    return verts, np.asarray(faces, np.int32)


def _cams(sc):
    return tuple(np.stack([np.asarray(getattr(c, f)) for c in sc.cameras])
                 for f in "KRC")


@pytest.fixture(scope="module")
def ridge():
    """tests/test_refine.py's ridge: 4 views, a 14x14 noisy grid."""
    sc = make_ridge_scene(np.random.default_rng(7), h=96, w=128,
                          n_views=4, spacing=0.3)
    verts, faces = _grid(14, 14, 1.3, 1.0, _ridge_z)
    noisy = verts.copy()
    noisy[:, 2] += np.random.default_rng(0).uniform(
        -0.06, 0.06, len(verts)).astype(np.float32)
    Ks, Rs, Cs = _cams(sc)
    interior = (np.abs(verts[:, 0]) < 1.0) & (np.abs(verts[:, 1]) < 0.75)
    pairs = np.array([[0, 1], [0, 2], [0, 3], [1, 2]])
    return dict(images=np.stack(sc.images), Ks=Ks, Rs=Rs, Cs=Cs,
                noisy=noisy, faces=faces, pairs=pairs, interior=interior)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _jax_grad(r, V, fid, bar, dep):
    imj = jnp.asarray(r["images"])
    gx = jnp.stack([(jnp.roll(im, -1, 1) - jnp.roll(im, 1, 1)) * 0.5
                    for im in imj])
    gy = jnp.stack([(jnp.roll(im, -1, 0) - jnp.roll(im, 1, 0)) * 0.5
                    for im in imj])
    f32 = lambda x: jnp.asarray(x, jnp.float32)    # noqa: E731
    return jref.raster_refine_grad(
        jnp.asarray(V), jnp.asarray(r["faces"]), jnp.asarray(fid),
        jnp.asarray(bar), jnp.asarray(dep), imj, gx, gy, f32(r["Ks"]),
        f32(r["Rs"]), f32(r["Cs"]), jnp.asarray(r["pairs"][:, 0]),
        jnp.asarray(r["pairs"][:, 1]), len(r["pairs"]))


def _port_grad(r, V, fid, bar, dep, fixed_order=None):
    imgs = torch.from_numpy(r["images"])
    gx, gy = tref.image_gradients(imgs)
    F = torch.from_numpy(r["faces"]).long()
    ras = tref.ScaleRasters(torch.from_numpy(fid).long(),
                            torch.from_numpy(bar), torch.from_numpy(dep),
                            len(F), fixed_order)
    vsum = tref.VertexSum(F, len(V), len(r["pairs"]), fixed_order)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)   # noqa: E731
    g, w = tref.raster_refine_grad(torch.from_numpy(V), F, ras, imgs, gx,
                                   gy, t(r["Ks"]), t(r["Rs"]), t(r["Cs"]),
                                   r["pairs"], vsum)
    return g.numpy(), w.numpy()


def test_raster_refine_grad_matches(ridge):
    r = ridge
    V = r["noisy"]
    h, w = r["images"].shape[1:]
    out = [rasterize_attributes(V.astype(np.float64), r["faces"], r["Ks"][i],
                                r["Rs"][i], r["Cs"][i], h, w)
           for i in range(len(r["images"]))]
    dep, fid, bar = (np.stack(a) for a in zip(*out))
    for a, b in zip(out[0], j_raster(V.astype(np.float64), r["faces"],
                                     r["Ks"][0], r["Rs"][0], r["Cs"][0], h,
                                     w)):
        assert np.array_equal(a, b)
    g, wsum = _port_grad(r, V, fid, bar, dep)
    with jax.disable_jit():
        g_e, w_e = _jax_grad(r, V, fid, bar, dep)
    g_j, w_j = _jax_grad(r, V, fid, bar, dep)
    assert (wsum > 1).sum() > 50
    assert _rel_l2(g, g_e) <= 1e-5 and _rel_l2(wsum, w_e) <= 1e-6
    assert _rel_l2(g, g_j) <= 0.1 and _rel_l2(wsum, w_j) <= 1e-6
    # the fixed-order sums (CUDA's) equal index_add_ on the CPU
    g_f, w_f = _port_grad(r, V, fid, bar, dep, fixed_order=True)
    assert np.array_equal(g_f, g) and np.array_equal(w_f, wsum)


def test_fixed_sum_equals_index_add():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 500, 20000))
    ids[ids == 7] = 8                                 # an empty target
    x = torch.from_numpy(rng.standard_normal((20000, 3)).astype(np.float32))
    a = tref.FixedSum(ids, 500).sum(x)
    b = tref.FixedSum(ids, 500, fixed_order=True).sum(x)
    assert torch.equal(a, b) and (b[7] == 0).all()


def test_masked_quantile_and_box_sums_match():
    rng = np.random.default_rng(1)
    x = rng.random(1001).astype(np.float32)
    m = rng.random(1001) < 0.4
    q = tref._masked_quantile(torch.from_numpy(x), torch.from_numpy(m), 0.9)
    ref = torch.quantile(torch.from_numpy(x[m]), 0.9)
    assert float(q) == pytest.approx(float(ref), rel=1e-6)
    assert float(q) == pytest.approx(float(jnp.percentile(x[m], 90)),
                                     rel=1e-6)
    assert torch.isnan(tref._masked_quantile(
        torch.from_numpy(x), torch.zeros(1001, dtype=torch.bool), 0.9))
    img = rng.random((3, 20, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        tref._box_sum(torch.from_numpy(img[0])).numpy(),
        np.asarray(jref._box_sum(jnp.asarray(img[0]))))
    gx, gy = tref.image_gradients(torch.from_numpy(img))
    for k in range(3):
        im = jnp.asarray(img[k])
        np.testing.assert_array_equal(
            gx[k].numpy(), (jnp.roll(im, -1, 1) - jnp.roll(im, 1, 1)) * 0.5)
        np.testing.assert_array_equal(
            gy[k].numpy(), (jnp.roll(im, -1, 0) - jnp.roll(im, 1, 0)) * 0.5)


def test_refine_step_fd_matches(ridge):
    """One fd step against the JAX package's op-by-op run (its jitted run
    differs from that by 0.012, more than the median move of 0.005)."""
    r = ridge
    V = r["noisy"]
    from hcmvs_tpu.mesh.mesh_ops import compute_vertex_normals
    nrm = compute_vertex_normals(V, r["faces"])
    h, w = r["images"].shape[1:]
    raster = np.stack([rasterize_attributes(
        V.astype(np.float64), r["faces"], r["Ks"][i], r["Rs"][i],
        r["Cs"][i], h, w)[0] for i in range(len(r["images"]))])
    edges = tref.mesh_edges(r["faces"])
    step, pairs = 0.02, r["pairs"][:2]
    f32 = lambda x: jnp.asarray(x, jnp.float32)    # noqa: E731
    with jax.disable_jit():
        Vj = np.asarray(jref.refine_step(
            jnp.asarray(V), jnp.asarray(nrm), jnp.asarray(edges),
            jnp.asarray(r["images"]), f32(r["Ks"]), f32(r["Rs"]),
            f32(r["Cs"]), jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]),
            jnp.asarray(step, jnp.float32), 0.1, 1,
            raster_depth=jnp.asarray(raster)))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)   # noqa: E731
    lap = tref.Laplacian(torch.from_numpy(edges), len(V))
    Vt = tref.refine_step(t(V), t(nrm), lap, t(r["images"]), t(r["Ks"]),
                          t(r["Rs"]), t(r["Cs"]), pairs, step, 0.1, 1,
                          raster_depth=t(raster)).numpy()
    assert np.median(np.abs(Vj - V).max(1)) > 1e-3
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["raster", "fd"])
def test_refine_mesh_matches(ridge, mode):
    r = ridge
    kw = dict(scales=2, iters_per_scale=3, reg_weight=0.1,
              gradient_mode=mode)
    # two pairs in the fd mode: the JAX package compiles its unrolled
    # 5x5-patch probes for every pair (17 s for two, 50 s for four)
    args = (r["noisy"], r["faces"], r["images"], r["Ks"], r["Rs"], r["Cs"],
            r["pairs"] if mode == "raster" else r["pairs"][:2])
    Vj = jref.refine_mesh(*args, **kw)
    Vt = tref.refine_mesh(*args, device="cpu", **kw)
    interior = r["interior"]

    def err(V):
        return np.abs(V[interior, 2]
                      - _ridge_z(V[interior, 0], V[interior, 1])).mean()

    moved = np.abs(Vj - r["noisy"]).max(1)
    dv = np.abs(Vt - Vj).max(1)
    assert np.median(dv) <= 0.05 * np.median(moved)
    assert np.percentile(dv, 90) <= 0.25 * np.median(moved)
    assert err(Vj) < err(r["noisy"])
    assert abs(err(Vt) - err(Vj)) <= 0.1 * err(Vj)


def test_refine_pulls_plane_to_surface():
    """tests/test_refine.py's plane: both packages pull the perturbed
    mesh back, the port within 10% of the JAX package's error."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_mesh import _grid_mesh
    sc = make_plane_scene(np.random.default_rng(4), h=96, w=128,
                          n_views=3, fx=150.0, slant=(0.0, 0.0), z0=4.0)
    verts, faces = _grid_mesh(12, 12, z=4.0)
    verts[:, :2] *= 1.2
    noisy = verts.copy()
    noisy[:, 2] += np.random.default_rng(0).uniform(
        -0.08, 0.08, len(verts)).astype(np.float32)
    Ks, Rs, Cs = _cams(sc)
    args = (noisy, faces, np.stack(sc.images), Ks, Rs, Cs,
            np.array([[0, 1], [0, 2], [1, 2]]))
    kw = dict(scales=2, iters_per_scale=3, reg_weight=0.1)
    interior = (np.abs(verts[:, 0]) < 0.9) & (np.abs(verts[:, 1]) < 0.9)
    err_j = np.abs(jref.refine_mesh(*args, **kw)[interior, 2] - 4.0).mean()
    err_t = np.abs(tref.refine_mesh(*args, device="cpu", **kw)[interior, 2]
                   - 4.0).mean()
    assert err_j < np.abs(noisy[interior, 2] - 4.0).mean()
    assert abs(err_t - err_j) <= 0.1 * err_j
