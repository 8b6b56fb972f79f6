"""PyTorch port vs the JAX package: the per-plane table build and the
consumers of its image-order tables.

- ``build_volume_tables`` at 128 / 256 / 384 planes (n_chunks 1 / 2 / 3);
- kernel B's plain version at D = 256 / 384 against the Pallas kernel in
  interpret mode (its per-chunk select-merge), as tests/test_volume.py
  holds the kernel against its XLA lerp;
- kernel D's plain version at D = 256 against its Pallas kernel in
  interpret mode, in the f32, packed and bounded modes;
- the bounds panels in image order (``volume_bounds(vol, False)``);
- table scoring on per-plane tables (``photometric_scores_volume``);
- ``estimate_scene`` at plane counts that are not a multiple of 128 or
  exceed 512 (200: 128 planes, 640: 5 chunks), taken as the JAX package
  takes them (``max(volume_planes // 128, 1)`` chunks);
- 1152 planes with ``candidate_kernel="on"``, past the 1024 that packed
  u16 index fields address: batched scoring and ``estimate_scene`` on f32
  fields against the JAX package's route off the TPU.

Scene: ``make_plane_scene`` at 48x64, 3 views, 2 neighbours; the JAX side
builds the per-plane tables by its own gate (``volume_build="planes"`` or
``volume_planes`` > 128, exact_backend "volume").

Tolerances: tables within one u16 step (bilinear sums and Catmull-Rom
weights in another order) and equal on >= 99% of entries; the sigma
intervals at rtol 1e-5; lookups at atol 1e-6 (values in [0, 1], the
JAX kernel's own test tolerance), u16 lookups exactly; scores at atol
1e-4 (float32 sums in another order), as tests/test_torch_slice.py;
``estimate_scene`` from the same (JAX) init by share of pixels (depth
within 1e-3 on >= 99%), as tests/test_torch_slice.py.
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
from hcmvs_tpu.dense.types import make_view_geometry as jmake_geometry
from hcmvs_tpu.ops import volume as jvol
from hcmvs_tpu.utils.synth import make_plane_scene

from hcmvs_tpu_torch.convert import (geometry_from_numpy, scene_from_numpy,
                                     state_from_numpy, tables_from_numpy)
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import patchmatch as tpm
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.ops import volume as tvol

torch.set_num_threads(1)
H, W, N, NBR = 48, 64, 3, 2
SLICE = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, random_iters=0, use_optical_flow=0,
             use_geo_consistency=1, use_part_consistency=1,
             estimation_iters_external=2, optimize=0)


def _np(x):
    return np.array(x)


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
    geom = jmake_geometry(jax.tree.map(lambda x: x[0], cams),
                          jax.tree.map(lambda x: x[nbr[0]], cams))
    return dict(sc=sc, scene=scene, geom=geom, nbr=nbr)


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_build_volume_tables_matches_jax(world, n_chunks):
    sc, geom = world["sc"], world["geom"]
    src = world["scene"].gray[world["nbr"][0]]
    ref = jvol.build_volume_tables(geom, src, jnp.float32(sc.d_min),
                                   jnp.float32(sc.d_max), n_chunks=n_chunks)
    out = tvol.build_volume_tables(
        geometry_from_numpy(geom, device="cpu"), torch.from_numpy(_np(src)),
        torch.tensor(sc.d_min, dtype=torch.float32),
        torch.tensor(sc.d_max, dtype=torch.float32), n_chunks=n_chunks)
    assert tuple(out.tab.shape) == tuple(ref.tab.shape) == (
        NBR, 4096, 128 * n_chunks)
    d = np.abs(out.tab.numpy().astype(np.int64)
               - _np(ref.tab).astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    assert (out.tab.numpy()[:, H * W:] == 0).all()
    for a, b in ((out.sig0, ref.sig0), (out.inv_dsig, ref.inv_dsig),
                 (out.sig_lo, ref.sig_lo), (out.sig_hi, ref.sig_hi)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5)


@pytest.mark.parametrize("d", [256, 384])
def test_plain_lookup_matches_interpret_kernel(d):
    rng = np.random.default_rng(0)
    p = jvol._CHUNK * 2
    tab = (rng.random((p, d)) * 65535).round().astype(np.uint16)
    f = (rng.random((p, 24)) * (d - 1)).astype(np.float32)
    # taps on both sides of each 128-plane chunk edge, and the grid's end
    f[:, 0] = 127.5
    f[:, 1] = 255.0 - 0.25
    f[:, 2] = d - 1.0
    ref = jvol.volume_lookup(jnp.asarray(tab), jnp.asarray(f),
                             interpret=True)
    out = tvol.volume_lookup_plain(torch.from_numpy(tab),
                                   torch.from_numpy(f))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-6)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tvol.volume_lookup(torch.from_numpy(tab), torch.from_numpy(f)),
        out)


@pytest.mark.parametrize("mode", ["f32", "packed", "bounded"])
def test_plain_multi_lookup_matches_interpret_kernel(mode):
    rng = np.random.default_rng(9)
    p, d, c = jvol._CHUNK, 256, 64
    tab = (rng.random((p, d)) * 65535).round().astype(np.uint16)
    f = (rng.random((p, c)) * (d - 1)).astype(np.float32)
    f[:, 0] = 127.75            # taps straddling the chunk edge
    bounds = None
    if mode == "f32":
        field = f
    else:
        field = np.round(f * jvol.F_PACK_SCALE).astype(np.uint16)
        if mode == "bounded":
            lo = (rng.random(p) * 100 * jvol.F_PACK_SCALE).astype(np.uint16)
            hi = ((120 + rng.random(p) * 130)
                  * jvol.F_PACK_SCALE).astype(np.uint16)
            bounds = np.concatenate([np.repeat(lo[:, None], 64, 1),
                                     np.repeat(hi[:, None], 64, 1)], 1)
    ref = _np(jvol.volume_lookup_multi(
        jnp.asarray(tab), jnp.asarray(field),
        None if bounds is None else jnp.asarray(bounds), interpret=True))
    out = tvol.volume_lookup_multi_plain(
        torch.from_numpy(tab), torch.from_numpy(field),
        None if bounds is None else torch.from_numpy(bounds)).numpy()
    if mode == "f32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(out, ref)
    if mode == "bounded":
        sentinel = out == 65535
        assert 0.2 < sentinel.mean() < 0.8    # both sides exercised


@pytest.fixture(scope="module")
def planes_scenes(world):
    """Scene-wide per-plane tables (JAX), 128 and 256 planes."""
    out = {}
    for planes in (128, 256):
        jcfg = JConfig(**SLICE, exact_backend="volume", geo_backend="rect",
                       volume_build="planes", volume_planes=planes)
        scene_v = jsd.attach_volumes(world["scene"], jcfg)
        out[planes] = (jcfg, scene_v)
    return out


@pytest.mark.parametrize("planes", [128, 256])
def test_bounds_panels_in_image_order_match(world, planes_scenes, planes):
    _, scene_v = planes_scenes[planes]
    vol_j = jax.tree.map(lambda x: x[0], scene_v.vols)
    ref = _np(jscore.volume_bounds(vol_j, False)).astype(np.int64)
    out = tscore.volume_bounds(tables_from_numpy(vol_j, device="cpu"),
                               False)
    np.testing.assert_array_equal(out.numpy().astype(np.int64), ref)
    # the rect build's tile-major panels differ from these rows
    blocked = tscore.volume_bounds(tables_from_numpy(vol_j, device="cpu"))
    assert not torch.equal(blocked, out)


@pytest.mark.parametrize("planes", [128, 256])
def test_volume_scores_on_plane_tables_match(world, planes_scenes, planes):
    jcfg, scene_v = planes_scenes[planes]
    tcfg = TConfig(**SLICE, volume_build="planes", volume_planes=planes)
    assert not tvol.use_rect_volume_build(tcfg, H, W)
    ctx_j = jsd._per_view_context(scene_v, 0, None, None, jcfg)
    tscene = dataclasses.replace(
        scene_from_numpy(world["scene"], device="cpu"),
        vols=tables_from_numpy(scene_v.vols, device="cpu"))
    ctx_t = tsd._per_view_context(tscene, 0, None, None, tcfg)
    ctx_t = dataclasses.replace(
        ctx_t, geom=geometry_from_numpy(ctx_j.geom, device="cpu"))
    offsets = jscore.patch_offsets(jcfg)
    sc = world["sc"]
    rng = np.random.default_rng(2)
    gt = (sc.depth_gt * (1 + 0.01 * rng.standard_normal((H, W)))).astype(
        np.float32)
    n_gt = np.broadcast_to(sc.normal_gt[:, None, None], (3, H, W)).astype(
        np.float32)
    sj, bj = jscore.photometric_scores_volume(
        ctx_j.geom, ctx_j.vol, ctx_j.stats, ctx_j.hw, jnp.asarray(gt),
        jnp.asarray(n_gt), ctx_j.rays, offsets, jcfg)
    st, bt = tscore.photometric_scores_volume(
        ctx_t.geom, ctx_t.vol, ctx_t.stats, ctx_t.hw, torch.from_numpy(gt),
        torch.from_numpy(n_gt), ctx_t.rays, offsets, tcfg)
    assert (bt.numpy() == _np(bj)).mean() >= 0.999
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=0, atol=1e-4)
    # most near-ground-truth scores are good: the rows line up
    assert (st.numpy() < 0.5).mean() > 0.5


def test_plane_counts_the_tables_take():
    """Every plane count, as the JAX package routes and chunks it."""
    cfg = TConfig()
    assert tvol.use_rect_volume_build(cfg, H, W)
    assert not tvol.use_rect_volume_build(cfg.replace(volume_build="planes"),
                                          H, W)
    for planes, chunks in ((64, 1), (128, 1), (200, 1), (256, 2), (384, 3),
                           (512, 4), (640, 5), (1024, 8), (1100, 8)):
        c = cfg.replace(volume_planes=planes)
        j = JConfig(volume_planes=planes, volume_build="rect")
        assert tvol.table_chunks(c) == chunks
        assert tvol.use_rect_volume_build(c, H, W) \
            == jvol.use_rect_volume_build(j, H, W) == (planes <= 128)


@pytest.mark.parametrize("planes", [200, 640])
def test_estimate_scene_at_any_plane_count_matches_jax(world, planes):
    """The slice with per-plane tables of 128 (``volume_planes`` 200) and
    640 planes, from the same (JAX) init, no random refinement."""
    jcfg = JConfig(**SLICE, exact_backend="volume", geo_backend="rect",
                   volume_planes=planes)
    tcfg = TConfig(**SLICE, volume_planes=planes)
    init = jsd.init_scene_state(jax.random.PRNGKey(0), world["scene"])
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), world["scene"], jcfg)
    scene_t = tsd.attach_volumes(
        scene_from_numpy(world["scene"], device="cpu"), tcfg)
    assert scene_t.vols.tab.shape[-1] == 128 * max(planes // 128, 1)
    out = tsd.estimate_scene(torch.Generator().manual_seed(0), scene_t,
                             tcfg, init=state_from_numpy(init, device="cpu"))
    d_ref, d_out = _np(ref.depth), out.depth.numpy()
    close = np.abs(d_out - d_ref) <= 1e-3 * np.abs(d_ref)
    assert close.mean() >= 0.99, close.mean()


def test_batched_scores_past_the_packed_depth_match(world):
    """Tables of 1152 planes (9 chunks), deeper than packed u16 index
    fields address (1024): scoring with ``candidate_kernel="on"`` takes
    f32 fields, as the JAX package off the TPU, and the packed builders
    raise rather than wrap."""
    planes = 1152
    jcfg = JConfig(**SLICE, exact_backend="volume", geo_backend="rect",
                   volume_planes=planes, candidate_kernel="on")
    tcfg = TConfig(**SLICE, volume_planes=planes, candidate_kernel="on")
    scene_v = jsd.attach_volumes(world["scene"], jcfg)
    ctx_j = jsd._per_view_context(scene_v, 0, None, None, jcfg)
    tscene = dataclasses.replace(
        scene_from_numpy(world["scene"], device="cpu"),
        vols=tables_from_numpy(scene_v.vols, device="cpu"))
    ctx_t = tsd._per_view_context(tscene, 0, None, None, tcfg)
    ctx_t = dataclasses.replace(
        ctx_t, geom=geometry_from_numpy(ctx_j.geom, device="cpu"))
    assert ctx_t.vol.tab.shape[-1] == planes
    assert not tscore.packed_lookup(ctx_t.vol) and ctx_t.vol_bounds is None
    offsets = jscore.patch_offsets(jcfg)
    sc = world["sc"]
    rng = np.random.default_rng(4)
    # the ground truth, and depths whose sigma (1 / depth) falls across the
    # grid's planes and on those past 1024
    sig0 = float(ctx_t.vol.sig0[0])
    dsig = 1.0 / float(ctx_t.vol.inv_dsig[0])
    depths = np.stack([sc.depth_gt.astype(np.float32)] + [
        (1.0 / (sig0 + dsig * rng.uniform(lo, planes - 1, (H, W))))
        .astype(np.float32) for lo in (0, 1000)])
    normals = np.broadcast_to(sc.normal_gt[None, :, None, None],
                              (3, 3, H, W)).astype(np.float32)
    dt, nt = torch.from_numpy(depths), torch.from_numpy(normals)
    _, fwd = tscore._sample_sigmas(ctx_t.geom, dt[2], nt[2], ctx_t.rays,
                                   offsets)
    idx = (fwd - ctx_t.vol.sig0[0]) * ctx_t.vol.inv_dsig[0]
    assert ((idx > 1024) & (idx <= planes - 1)).float().mean() > 0.3
    sj, bj = jscore.photometric_scores_volume_batched(
        ctx_j.geom, ctx_j.vol, ctx_j.stats, ctx_j.hw, jnp.asarray(depths),
        jnp.asarray(normals), ctx_j.rays, offsets, jcfg)
    st, bt = tscore.photometric_scores_volume_batched(
        ctx_t.geom, ctx_t.vol, ctx_t.stats, ctx_t.hw, dt, nt, ctx_t.rays,
        offsets, tcfg)
    assert (bt.numpy() == _np(bj)).mean() >= 0.999
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=0, atol=1e-4)
    assert (st.numpy()[0] < 0.5).mean() > 0.5
    with pytest.raises(ValueError, match="1024"):
        tscore.volume_bounds(ctx_t.vol, False)
    with pytest.raises(ValueError, match="1024"):
        tscore.packed_fields(ctx_t.geom, ctx_t.vol, dt, nt, ctx_t.rays,
                             offsets, False)


def test_estimate_scene_past_the_packed_depth_matches_jax(world):
    """The slice with 1152-plane tables and ``candidate_kernel="on"``
    (f32 index fields, no bounds panels in either context the port
    builds), from the same (JAX) init, no random refinement."""
    planes = 1152
    jcfg = JConfig(**SLICE, exact_backend="volume", geo_backend="rect",
                   volume_planes=planes, candidate_kernel="on")
    tcfg = TConfig(**SLICE, volume_planes=planes, candidate_kernel="on")
    gray = torch.from_numpy(_np(world["scene"].gray))
    sc = world["sc"]
    ctx = tpm.make_context(geometry_from_numpy(world["geom"], device="cpu"),
                           gray[0], gray[world["nbr"][0]], sc.d_min,
                           sc.d_max, tcfg)
    assert ctx.vol.tab.shape[-1] == planes and ctx.vol_bounds is None
    init = jsd.init_scene_state(jax.random.PRNGKey(0), world["scene"])
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), world["scene"], jcfg)
    scene_t = tsd.attach_volumes(
        scene_from_numpy(world["scene"], device="cpu"), tcfg)
    out = tsd.estimate_scene(torch.Generator().manual_seed(0), scene_t,
                             tcfg, init=state_from_numpy(init, device="cpu"))
    d_ref, d_out = _np(ref.depth), out.depth.numpy()
    close = np.abs(d_out - d_ref) <= 1e-3 * np.abs(d_ref)
    assert close.mean() >= 0.99, close.mean()
