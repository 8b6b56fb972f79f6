"""PyTorch port vs the JAX package: the rectified epipolar gather engine
(ops/rect_gather.py) and kernel C's plain version.

Context build: rect rows and band bases equal on >= 99.9% of pixels
(rounding ties can fall differently when the 3x3 products are evaluated
in another order), c0 / k at rtol 1e-5.  Lookup: on the same (converted)
context the plain version must equal both the Pallas kernel in interpret
mode and ``rect_lookup_xla`` exactly, as tests/test_rect_gather.py holds
the kernel to its replica.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.dense.types import make_view_geometry as j_geometry
from hcmvs_tpu.ops import rect_gather as jrg
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (geometry_from_numpy,
                                     rect_context_from_numpy)
from hcmvs_tpu_torch.ops import rect_gather as trg

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
H, W, V = 64, 200, 3     # W unaligned: exercises the tile padding


@pytest.fixture(scope="module")
def setup():
    sc = make_plane_scene(np.random.default_rng(3), h=H, w=W,
                          n_views=V + 1)
    cams = JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                   R=jnp.stack([c.R for c in sc.cameras]),
                   C=jnp.stack([c.C for c in sc.cameras]))
    geom = j_geometry(jax.tree.map(lambda x: x[0], cams),
                      jax.tree.map(lambda x: x[1:], cams))
    rng = np.random.default_rng(8)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 0.5 * (sc.d_min + sc.d_max)
    amp = 0.2 * (sc.d_max - sc.d_min)
    depth = np.stack([base + amp * np.sin(xx / (17.0 + i))
                      * np.cos(yy / 13.0) for i in range(V)])
    depth[:, 5:9, 30:40] = 0.0                       # invalid patch
    n = rng.standard_normal((V, 3, H, W))
    n[:, 2] = -np.abs(n[:, 2]) - 0.5
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:, 2, 20:24] *= -1.0                           # both n_z signs
    depth = depth.astype(np.float32)
    n = n.astype(np.float32)
    packed_j = jrg.pack_depth_normals(jnp.asarray(depth), jnp.asarray(n))
    ctx_j = jrg.build_rect_context(geom, packed_j)
    dcand = base + 0.3 * amp * np.sin(yy / 11.0) + 0.02 * rng.standard_normal(
        (H, W))
    sigma = (1.0 / dcand).astype(np.float32)
    return geom, depth, n, packed_j, ctx_j, sigma


def test_pack_depth_normals_matches_jax_bits(setup):
    _, depth, n, packed_j, _, _ = setup
    packed_t = trg.pack_depth_normals(torch.from_numpy(depth),
                                      torch.from_numpy(n))
    assert np.array_equal(packed_t.numpy().view(np.uint32),
                          np.asarray(packed_j).view(np.uint32))
    taps_t, ok_t = trg.unpack_taps(packed_t)
    taps_j, ok_j = jrg.unpack_taps(packed_j)
    taps_j = np.asarray(taps_j)
    # depth, n_x, n_y are moved bits; n_z = sqrt(1 - nx^2 - ny^2) rounds
    assert np.array_equal(taps_t[:, :3].numpy(), taps_j[:, :3])
    np.testing.assert_allclose(taps_t[:, 3].numpy(), taps_j[:, 3],
                               rtol=0, atol=1e-6)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    # the round trip: depth exact, n_x / n_y to bf16 precision (2^-8
    # relative), n_z rebuilt from them (coarser where |n_z| is small)
    assert np.array_equal(taps_t[:, 0].numpy(), np.abs(depth))
    np.testing.assert_allclose(taps_t[:, 1:3].numpy(), n[:, :2], rtol=0,
                               atol=4e-3)
    np.testing.assert_allclose(taps_t[:, 3].numpy(), n[:, 2], rtol=0,
                               atol=2e-2)


def test_rect_context_matches_jax(setup):
    geom, depth, n, _, ctx_j, _ = setup
    packed = trg.pack_depth_normals(torch.from_numpy(depth),
                                    torch.from_numpy(n))
    ctx_t = trg.build_rect_context(geometry_from_numpy(geom, device="cpu"),
                                   packed)
    ctx_c = rect_context_from_numpy(ctx_j, device="cpu")
    assert ctx_t.maps.shape == ctx_c.maps.shape
    assert (ctx_t.row_int == ctx_c.row_int).float().mean() >= 0.999
    assert (ctx_t.rb == ctx_c.rb).float().mean() >= 0.999
    ok = ctx_c.row_int < trg._INVALID
    assert ok.float().mean() > 0.9
    np.testing.assert_allclose(ctx_t.c0[ok].numpy(), ctx_c.c0[ok].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(ctx_t.k.numpy(), ctx_c.k.numpy(), rtol=1e-5)
    same = (ctx_t.maps.view(torch.int32) == ctx_c.maps.view(torch.int32))
    assert same.float().mean() >= 0.999


def test_rect_coverage_matches_jax(setup):
    """The banding diagnostic on the JAX context: the port's share equals
    the JAX package's and is near total (tests/test_rect_gather.py:57's
    gate, > 0.99)."""
    _, _, _, _, ctx_j, sigma = setup
    ctx_t = rect_context_from_numpy(ctx_j, device="cpu")
    cov_t = trg.rect_coverage(ctx_t, torch.from_numpy(sigma))
    cov_j = float(jrg.rect_coverage(ctx_j, jnp.asarray(sigma)))
    assert cov_t.dtype == torch.float32 and cov_t.dim() == 0
    assert float(cov_t) == pytest.approx(cov_j, rel=1e-6)
    assert float(cov_t) > 0.99


def test_rect_rows_cut_the_lookup_by_band(setup):
    """A row band's context (``rect_rows``) reads what the whole one
    reads at those rows (the tile axis cuts kernel C's fields so)."""
    _, _, _, _, ctx_j, sigma = setup
    ctx_t = rect_context_from_numpy(ctx_j, device="cpu")
    sig = torch.from_numpy(sigma)
    whole = trg.rect_lookup(ctx_t, sig)
    for r0, r1 in ((0, 24), (16, 48), (40, H)):
        part = trg.rect_lookup(trg.rect_rows(ctx_t, r0, r1), sig[r0:r1])
        assert torch.equal(part, whole[:, :, r0:r1])


def test_rect_lookup_plain_equals_jax_exactly(setup):
    _, _, _, _, ctx_j, sigma = setup
    ctx_t = rect_context_from_numpy(ctx_j, device="cpu")
    out = trg.rect_lookup(ctx_t, torch.from_numpy(sigma)).numpy()
    ref_xla = np.asarray(jrg.rect_lookup_xla(ctx_j, jnp.asarray(sigma)))
    ref_pl = np.asarray(jrg.rect_lookup(ctx_j, jnp.asarray(sigma),
                                        interpret=True))
    assert np.array_equal(out.view(np.uint32), ref_xla.view(np.uint32))
    assert np.array_equal(out.view(np.uint32), ref_pl.view(np.uint32))
    hit = out[:, 0] != 0
    assert hit.mean() > 0.8          # the window covers most reads


# --- kernel C's edge cases (tests/rect_edge_cases.py) -----------------------

@pytest.fixture(scope="module")
def edge_contexts():
    """{case: (JAX context, port context, sigma)} for each edge case, built
    by the JAX package from the same seeded inputs."""
    from rect_edge_cases import CASES, edge_inputs, edge_sigma
    out = {}
    for case in CASES:
        h, w, v, n_cand, mode, depth, n, base = edge_inputs(case)
        sc = make_plane_scene(np.random.default_rng(3), h=h, w=w,
                              n_views=v + 1)
        cams = JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                       R=jnp.stack([c.R for c in sc.cameras]),
                       C=jnp.stack([c.C for c in sc.cameras]))
        geom = j_geometry(jax.tree.map(lambda x: x[0], cams),
                          jax.tree.map(lambda x: x[1:], cams))
        ctx_j = jrg.build_rect_context(geom, jrg.pack_depth_normals(
            jnp.asarray(depth), jnp.asarray(n)))
        sigma = edge_sigma(np.asarray(ctx_j.c0)[0], np.asarray(ctx_j.k)[0],
                           ctx_j.frame_shape[1], base, mode)
        out[case] = (ctx_j, rect_context_from_numpy(ctx_j, device="cpu"),
                     sigma if n_cand else sigma[0])
    return out


_XLA_STACK = jax.jit(jax.vmap(jrg.rect_lookup_xla, in_axes=(None, 0)))
_PALLAS = jax.jit(lambda ctx, s: jrg.rect_lookup(ctx, s, interpret=True))


@pytest.mark.parametrize("case", ["61x203, K = 1", "61x203, a stack of 1",
                                  "61x331, K = 9", "a tile all out of frame",
                                  "columns past the frame"])
def test_rect_lookup_plain_equals_jax_on_edge_cases(edge_contexts, case):
    """Kernel C's plain version bit-equal to ``rect_lookup_xla`` (under
    ``jax.vmap`` for a stack) and to the Pallas kernel in interpret mode
    (one candidate at a time) where the CUDA kernel has its edges: H and
    W no multiple of 8, 128 or 4, K = 1 and one past a group of 8, a tile
    with no in-frame read (the sentinel base), columns past both ends of
    the frame."""
    ctx_j, ctx_t, sigma = edge_contexts[case]
    h_r, w_r = ctx_t.frame_shape
    out = trg.rect_lookup(ctx_t, torch.from_numpy(sigma)).numpy()
    stack = sigma if sigma.ndim == 3 else sigma[None]
    flat = out.reshape((len(stack),) + out.shape[-4:])
    ref = np.asarray(_XLA_STACK(ctx_j, jnp.asarray(stack)))
    assert out.shape == sigma.shape[:-2] + (3, 2) + sigma.shape[-2:]
    assert np.array_equal(flat.view(np.uint32), ref.view(np.uint32))
    for i, s in enumerate(stack):
        ref_pl = np.asarray(_PALLAS(ctx_j, jnp.asarray(s)))
        assert np.array_equal(flat[i].view(np.uint32),
                              ref_pl.view(np.uint32))
    assert (flat[:, :, 0] != 0).mean() > 0.5
    # the case reaches the edge it is named for
    icol = trg._icol(ctx_t, torch.from_numpy(stack)).numpy()
    if case == "a tile all out of frame":
        first = icol[0, :, :8, :128]
        assert ((first < 0) | (first > w_r - 1)).all()
        assert not flat[0, :, :, :8, :128].any()
        assert flat[1, :, 0, :8, :128].any()
    if case == "columns past the frame":
        band = icol[:, 0, 8:24]
        for col in (-1, 0, w_r - 1, w_r):
            assert (band == col).any(), col
        read = flat[:, 0, 0, 8:24] != 0
        assert read[(band == 0) | (band == w_r - 1)].any()
        assert not read[(band < 0) | (band > w_r - 1)].any()
