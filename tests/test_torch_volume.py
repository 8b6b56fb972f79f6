"""PyTorch port vs the JAX package: sigma tables (ops/volume.py) — the
rect-frame build around kernel A and the lookup of kernel B.

The JAX side runs as its own suite does on the CPU: the build through
its XLA replica ``_rect_build_xla``, the lookup both as the Pallas
kernel in interpret mode and as ``volume_lookup_xla``.  The port runs
its plain versions (what its wrappers take for CPU tensors).

Tolerances: tables within 1 u16 LSB on >= 99.9% of entries (the two
packages derive the 3x3 geometry with float32 products in another order,
which moves sample positions by ~1e-4 px); lookups at rtol = atol = 1e-6,
the bar of tests/test_volume.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.dense.types import make_view_geometry as j_geometry
from hcmvs_tpu.ops import volume as jvol
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import geometry_from_numpy
from hcmvs_tpu_torch.ops import volume as tvol

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
H, W, V = 96, 128, 3


@pytest.fixture(scope="module")
def builds():
    sc = make_plane_scene(np.random.default_rng(4), h=H, w=W,
                          n_views=V + 1)
    cams = JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                   R=jnp.stack([c.R for c in sc.cameras]),
                   C=jnp.stack([c.C for c in sc.cameras]))
    geom = j_geometry(jax.tree.map(lambda x: x[0], cams),
                      jax.tree.map(lambda x: x[1:], cams))
    src = np.stack(sc.images[1:])
    d_min, d_max = np.float32(sc.d_min), np.float32(sc.d_max)
    ref = jvol.build_volume_tables_rect(geom, jnp.asarray(src),
                                        jnp.asarray(d_min),
                                        jnp.asarray(d_max))
    out = tvol.build_volume_tables_rect(
        geometry_from_numpy(geom, device="cpu"), torch.from_numpy(src),
        torch.tensor(d_min), torch.tensor(d_max))
    return ref, out


def _image_order(tab_u16_rows: np.ndarray) -> np.ndarray:
    """(V, P_pad, D) tile-major rows -> (V, H, W, D) image order."""
    p = (H // 8) * 8 * (W // 128) * 128
    x = tab_u16_rows[:, :p].astype(np.int64)
    perm = np.asarray(jvol.to_volume_order(
        jnp.arange(H * W).reshape(H, W))).astype(int)
    img = np.zeros((x.shape[0], H * W, x.shape[2]), np.int64)
    img[:, perm] = x
    return img.reshape(x.shape[0], H, W, -1)


def test_rect_build_tables_match_jax(builds):
    ref, out = builds
    assert out.tab.dtype == torch.uint16
    assert tuple(out.tab.shape) == tuple(ref.tab.shape)
    t_ref = _image_order(np.asarray(ref.tab))
    t_out = _image_order(out.tab.view(torch.int16).numpy().view(np.uint16))
    diff = np.abs(t_out - t_ref)
    assert (diff <= 1).mean() >= 0.999, (diff <= 1).mean()
    # alignment padding rows stay zero
    p_used = (H // 8) * (W // 128) * 1024
    assert not out.tab[:, p_used:].to(torch.int32).any()
    np.testing.assert_allclose(out.sig0.numpy(), np.asarray(ref.sig0),
                               rtol=1e-6)
    np.testing.assert_allclose(out.inv_dsig.numpy(),
                               np.asarray(ref.inv_dsig), rtol=1e-6)


def test_rect_build_intervals_match_jax(builds):
    ref, out = builds
    for name in ("sig_lo", "sig_hi"):
        a = getattr(out, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert np.array_equal(np.isposinf(a), np.isposinf(b)), name
        assert np.array_equal(np.isneginf(a), np.isneginf(b)), name
        fin = np.isfinite(b)
        assert fin.mean() > 0.5, name
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=0)


def test_volume_order_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 150)).astype(np.float32)  # unaligned
    vo = tvol.to_volume_order(torch.from_numpy(x))
    assert np.array_equal(vo.numpy(),
                          np.asarray(jvol.to_volume_order(jnp.asarray(x))))
    assert np.array_equal(tvol.from_volume_order(vo, 20, 150).numpy(), x)
    v = rng.random(1000).astype(np.float32) * 1.2 - 0.1
    enc = tvol._encode_tab(torch.from_numpy(v))
    enc_j = np.asarray(jvol._encode_tab(jnp.asarray(v)))
    assert np.array_equal(enc.to(torch.int32).numpy(), enc_j)
    np.testing.assert_allclose(
        tvol._decode_tab(enc).numpy(),
        np.asarray(jvol._decode_tab(jnp.asarray(enc_j.astype(np.uint16)))),
        rtol=0, atol=0)


@pytest.mark.parametrize("s", [9, 36])
def test_volume_lookup_plain_matches_jax(s):
    rng = np.random.default_rng(s)
    p = jvol._CHUNK * 2
    tab = rng.integers(0, 65536, (p, jvol.D_PLANES)).astype(np.uint16)
    f = rng.uniform(-3.0, jvol.D_PLANES + 2.0, (p, s)).astype(np.float32)
    tab_t = torch.from_numpy(tab.view(np.int16)).view(torch.uint16)
    out = tvol.volume_lookup(tab_t, torch.from_numpy(f)).numpy()
    ref_xla = np.asarray(jvol.volume_lookup_xla(jnp.asarray(tab),
                                                jnp.asarray(f)))
    ref_pl = np.asarray(jvol.volume_lookup(jnp.asarray(tab), jnp.asarray(f),
                                           interpret=True))
    np.testing.assert_allclose(out, ref_xla, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out, ref_pl, rtol=1e-6, atol=1e-6)
