"""PyTorch port vs the JAX package: semi-global matching (``dense/sgm.py``)
and the DensifyPointCloud ``--fusion-mode -1/-2`` path.

Inputs are made from a seed with numpy and go through both packages on
the CPU.  Tolerances:
- the census transform, the popcount (a million random 32-bit pattern
  pairs and every 24-bit pattern against 0), ``make_box_scene``'s images
  and cameras, ``lr_consistency`` and ``sgm_fuse_pairs`` on the same
  inputs: equal;
- the cost volume at tests/test_sgm.py's 48x64 plane scene: equal on
  >= 99.9% of entries (a pixel where the two packages round the warp's
  product differently takes another nearest neighbour);
- each of the 8 aggregation paths and ``sgm_aggregate`` on the same
  volume: within 1e-4 relative;
- ``normals_from_depth``: within 1e-5;
- ``sgm_match``, ``sgm_scene`` and densify's SGM modes end to end: depth
  within 1% on >= 98% of pixels and the valid masks equal on >= 98% (the
  form the densify checks use).
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 48, 64
PATHS = [(1, False, 0), (1, True, 0), (2, False, 0), (2, True, 0),
         (1, False, 1), (1, False, -1), (1, True, 1), (1, True, -1)]


def _cams(cameras):
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera
    return Camera(K=jnp.stack([jnp.asarray(c.K) for c in cameras]),
                  R=jnp.stack([jnp.asarray(c.R) for c in cameras]),
                  C=jnp.stack([jnp.asarray(c.C) for c in cameras]))


def _pair_geometries(cameras):
    """View 0 against view 1 in both packages."""
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera as JCamera
    from hcmvs_tpu.dense.types import make_view_geometry as jgeom
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.types import make_view_geometry
    k, r, c = (np.stack([np.asarray(getattr(cam, a)) for cam in cameras])
               for a in "KRC")
    j = jgeom(JCamera(K=jnp.asarray(k[0]), R=jnp.asarray(r[0]),
                      C=jnp.asarray(c[0])),
              JCamera(K=jnp.asarray(k[1:2]), R=jnp.asarray(r[1:2]),
                      C=jnp.asarray(c[1:2])))
    t = make_view_geometry(
        Camera(K=torch.from_numpy(k[0]), R=torch.from_numpy(r[0]),
               C=torch.from_numpy(c[0])),
        Camera(K=torch.from_numpy(k[1:2]), R=torch.from_numpy(r[1:2]),
               C=torch.from_numpy(c[1:2])))
    return j, t


def _scenes(images, cameras, nbr, d_min, d_max):
    """The JAX ``SceneTensors`` and the port's on the CPU."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.convert import scene_from_numpy
    n, v = nbr.shape
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in images]),
        cams=_cams(cameras), nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n, v), bool),
        d_min=jnp.full((n,), d_min, jnp.float32),
        d_max=jnp.full((n,), d_max, jnp.float32))
    return scene, scene_from_numpy(scene, device="cpu")


def _depth_agree(a, b) -> tuple:
    """(share of pixels where both are valid and within 1%, or both
    invalid; share where the valid masks agree)."""
    va, vb = a > 0, b > 0
    close = va & vb & (np.abs(a - b) <= 0.01 * np.maximum(a, 1e-9))
    return float((close | (~va & ~vb)).mean()), float((va == vb).mean())


@pytest.fixture(scope="module")
def plane():
    """tests/test_sgm.py's two-view plane scene and its cost volume in both
    packages."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense import sgm as jsgm
    from hcmvs_tpu.utils.synth import make_plane_scene
    from hcmvs_tpu_torch.dense import sgm
    sc = make_plane_scene(np.random.default_rng(3), h=H, w=W, n_views=2)
    jgeom, tgeom = _pair_geometries(sc.cameras)
    args_j = (jnp.asarray(sc.images[0]), jnp.asarray(sc.images[1]),
              jnp.asarray(sc.d_min, jnp.float32),
              jnp.asarray(sc.d_max, jnp.float32))
    args_t = (torch.from_numpy(sc.images[0]),
              torch.from_numpy(sc.images[1]),
              torch.tensor(sc.d_min, dtype=torch.float32),
              torch.tensor(sc.d_max, dtype=torch.float32))
    vol_j, inv_j = jsgm.cost_volume(jgeom, *args_j, 64)
    vol_t, inv_t = sgm.cost_volume(tgeom, *args_t, 64)
    return dict(sc=sc, jgeom=jgeom, tgeom=tgeom, args_j=args_j,
                args_t=args_t, vol_j=np.asarray(vol_j),
                inv_j=np.asarray(inv_j), vol_t=vol_t.numpy(),
                inv_t=inv_t.numpy())


def test_census_matches_jax():
    """Equal codes on a random image with ties (values on a grid of 8)."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense.sgm import census_transform as jcensus
    from hcmvs_tpu_torch.dense.sgm import census_transform
    img = (np.random.default_rng(0).integers(0, 8, (H, W)) / 8.0
           ).astype(np.float32)
    ref = np.asarray(jcensus(jnp.asarray(img))).astype(np.int64)
    out = census_transform(torch.from_numpy(img))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy().astype(np.int64), ref)
    assert ref.max() < 2 ** 24


def test_popcount_matches_jax_on_a_million_patterns():
    """A million random 32-bit pairs (the int32 sign bit included), and
    every 24-bit census pattern against 0."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense.sgm import hamming_distance as jham
    from hcmvs_tpu_torch.dense.sgm import hamming_distance
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64
                     ).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64
                     ).astype(np.uint32)
    ref = np.asarray(jham(jnp.asarray(a), jnp.asarray(b)))
    out = hamming_distance(torch.from_numpy(a.view(np.int32)),
                           torch.from_numpy(b.view(np.int32))).numpy()
    assert np.array_equal(out, ref)
    every = np.arange(2 ** 24, dtype=np.uint32)
    counts = hamming_distance(torch.from_numpy(every.view(np.int32)),
                              torch.zeros(2 ** 24, dtype=torch.int32))
    bits = np.unpackbits(every.view(np.uint8).reshape(-1, 4), axis=1)
    assert np.array_equal(counts.numpy(), bits.sum(1).astype(np.float32))


def test_cost_volume_matches_jax(plane):
    """The swept inverse depths equal; the census costs equal on >= 99.9%
    of the (64, 48, 64) entries."""
    assert np.array_equal(plane["inv_t"], plane["inv_j"])
    same = (plane["vol_t"] == plane["vol_j"]).mean()
    assert same >= 0.999, same


@pytest.mark.parametrize("axis,reverse,col_shift", PATHS)
def test_aggregation_paths_match_jax(plane, axis, reverse, col_shift):
    """Each of the 8 paths on JAX's volume, within 1e-4 relative."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense.sgm import _aggregate_dir as jdir
    from hcmvs_tpu_torch.dense.sgm import _aggregate_dir
    vol = np.array(plane["vol_j"])
    ref = np.asarray(jdir(jnp.asarray(vol), 3.0, 20.0, axis, reverse,
                          col_shift))
    out = _aggregate_dir(torch.from_numpy(vol), 3.0, 20.0, axis, reverse,
                         col_shift).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("n_paths", [4, 8])
def test_sgm_aggregate_matches_jax(plane, n_paths):
    import jax.numpy as jnp
    from hcmvs_tpu.dense.sgm import sgm_aggregate as jagg
    from hcmvs_tpu_torch.dense.sgm import sgm_aggregate
    vol = np.array(plane["vol_j"])
    ref = np.asarray(jagg(jnp.asarray(vol), 3.0, 20.0, n_paths))
    out = sgm_aggregate(torch.from_numpy(vol), 3.0, 20.0, n_paths).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=0)


def test_sgm_match_matches_jax(plane):
    from hcmvs_tpu.dense.sgm import sgm_match as jmatch
    from hcmvs_tpu_torch.dense.sgm import sgm_match
    dj, cj = jmatch(plane["jgeom"], *plane["args_j"], n_depths=64)
    dt, ct = sgm_match(plane["tgeom"], *plane["args_t"], n_depths=64)
    close, masks = _depth_agree(dt.numpy(), np.asarray(dj))
    assert close >= 0.98 and masks >= 0.98, (close, masks)
    assert (dt.numpy() > 0).mean() > 0.7


def test_lr_consistency_and_fuse_pairs_match_jax(plane):
    """On the same inputs (JAX's depth maps): the LR mask and the fused
    map equal."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense import sgm as jsgm
    from hcmvs_tpu_torch.dense import sgm
    sc = plane["sc"]
    rng = np.random.default_rng(6)
    d_ref = sc.depth_gt * rng.uniform(0.99, 1.01, sc.depth_gt.shape)
    d_src = sc.depth_gt * rng.uniform(0.97, 1.03, sc.depth_gt.shape)
    d_src[rng.random(d_src.shape) < 0.1] = 0
    d_ref, d_src = d_ref.astype(np.float32), d_src.astype(np.float32)
    dsig = np.float32((1 / sc.d_min - 1 / sc.d_max) / 64)
    ref = np.asarray(jsgm.lr_consistency(
        plane["jgeom"], jnp.asarray(d_ref), jnp.asarray(d_src),
        dsig=jnp.asarray(dsig)))
    out = sgm.lr_consistency(plane["tgeom"], torch.from_numpy(d_ref),
                             torch.from_numpy(d_src),
                             dsig=torch.tensor(dsig)).numpy()
    assert np.array_equal(out, ref) and 0.3 < ref.mean() < 0.95
    depths = np.stack([d_ref, d_src, d_ref * 1.05]).astype(np.float32)
    costs = rng.uniform(0, 22, depths.shape).astype(np.float32)
    for d in (None, dsig):
        jd, jc = jsgm.sgm_fuse_pairs(jnp.asarray(depths), jnp.asarray(costs),
                                     dsig=None if d is None
                                     else jnp.asarray(d))
        td, tc = sgm.sgm_fuse_pairs(torch.from_numpy(depths),
                                    torch.from_numpy(costs),
                                    dsig=None if d is None
                                    else torch.tensor(d))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_normals_from_depth_match_jax():
    import jax.numpy as jnp
    from hcmvs_tpu.dense.types import pixel_rays as jrays
    from hcmvs_tpu.ops.gradients import normals_from_depth as jnormals
    from hcmvs_tpu_torch.dense.types import pixel_rays
    from hcmvs_tpu_torch.ops.gradients import normals_from_depth
    from hcmvs_tpu_torch.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(2), h=H, w=W, n_views=2)
    depth = sc.depth_gt.copy()
    depth[10:14, 20:30] = 0                       # holes take (0, 0, -1)
    k_inv = np.linalg.inv(np.asarray(sc.cameras[0].K)).astype(np.float32)
    ref = np.asarray(jnormals(jnp.asarray(depth),
                              jrays(jnp.asarray(k_inv), H, W)))
    out = normals_from_depth(torch.from_numpy(depth),
                             pixel_rays(torch.from_numpy(k_inv), H, W))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert (out[2, 10:14, 20:30] == -1).all()


def test_box_scene_matches_jax():
    from hcmvs_tpu.utils.synth import make_box_scene as jbox
    from hcmvs_tpu_torch.utils.synth import make_box_scene
    a = jbox(np.random.default_rng(5), h=64, w=96, n_views=3)
    b = make_box_scene(np.random.default_rng(5), h=64, w=96, n_views=3)
    for x, y in zip(a.images + a.depth_gts, b.images + b.depth_gts):
        assert np.array_equal(x, y)
    for ca, cb in zip(a.cameras, b.cameras):
        for f in "KRC":
            assert np.array_equal(np.asarray(getattr(ca, f)),
                                  getattr(cb, f).numpy())
    assert (a.d_min, a.d_max) == (b.d_min, b.d_max)


def test_sgm_scene_matches_jax():
    """tests/test_sgm.py's 3-view plane scene, 2 pairs a view, 48 depths."""
    from hcmvs_tpu.dense.sgm import sgm_scene as jscene
    from hcmvs_tpu.utils.synth import make_plane_scene
    from hcmvs_tpu_torch.dense.sgm import sgm_scene
    sc = make_plane_scene(np.random.default_rng(4), h=H, w=W, n_views=3)
    nbr = np.array([[j for j in range(3) if j != i][:2] for i in range(3)],
                   np.int32)
    js, ts = _scenes(sc.images, sc.cameras, nbr, sc.d_min, sc.d_max)
    dj, nj, cj = (np.asarray(x) for x in jscene(js, n_depths=48))
    dt, nt, ct = (x.numpy() for x in sgm_scene(ts, n_depths=48))
    assert dt.shape == (3, H, W) and nt.shape == (3, 3, H, W)
    for i in range(3):
        close, masks = _depth_agree(dt[i], dj[i])
        assert close >= 0.98 and masks >= 0.98, (i, close, masks)
    both = (dt > 0) & (dj > 0)
    np.testing.assert_allclose(ct[both], cj[both], rtol=0.05, atol=0.02)
    assert (dt[0][8:-8, 8:-8] > 0).mean() > 0.5


def test_lr_check_kills_occlusion_ghosts():
    """tests/test_sgm.py's box-scene check on the port: in single-pair
    mode the left-right check stops the estimates in the occluded band
    and cuts the outliers."""
    from hcmvs_tpu_torch.dense.sgm import lr_consistency, sgm_scene
    from hcmvs_tpu_torch.dense.types import make_view_geometry
    from hcmvs_tpu_torch.utils.synth import make_box_scene
    sc = make_box_scene(np.random.default_rng(5), h=64, w=96, n_views=2)
    nbr = np.array([[1], [0]], np.int32)
    _, scene = _scenes(sc.images, sc.cameras, nbr, sc.d_min, sc.d_max)
    g01 = make_view_geometry(scene.cams[0], scene.cams[1:2])
    occl = ~lr_consistency(g01, torch.from_numpy(sc.depth_gts[0]),
                           torch.from_numpy(sc.depth_gts[1]),
                           rel_thr=0.01).numpy()
    inner = np.s_[6:-6, 6:-6]

    def stats(lr):
        depth, _, _ = sgm_scene(scene, n_depths=64, n_pairs=1, lr_check=lr)
        d0 = depth[0].numpy()
        gt = sc.depth_gts[0]
        val = d0 > 0
        ghost = val & (np.abs(d0 - gt) / gt > 0.05)
        return (ghost[inner].sum() / max(val[inner].sum(), 1),
                (val & occl)[inner].mean())

    g_no, occ_no = stats(False)
    g_lr, occ_lr = stats(True)
    assert occ_lr < occ_no * 0.35, (occ_no, occ_lr)
    assert g_lr < g_no * 0.75, (g_no, g_lr)


@pytest.mark.parametrize("mode", [-2, -1])
def test_densify_sgm_modes_match_jax(tmp_path, mode):
    """densify --fusion-mode -2 / -1 on the same .mvs + PNG files: the
    .dmap maps against the JAX package's, the fused cloud's size within 2%
    (mode -2), no cloud in mode -1; the CLI runs mode -1."""
    from hcmvs_tpu.pipeline.densify import densify as jdensify
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.pipeline.densify import densify, main
    from hcmvs_tpu_torch.utils.synth import (make_plane_scene,
                                             write_plane_scene)
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    sc = make_plane_scene(np.random.default_rng(9), h=H, w=W, n_views=3)
    scene_path, img_dir = write_plane_scene(str(tmp_path), sc)
    flags = dict(resolution_level=0, min_resolution=0, use_optical_flow=0)
    ref = jdensify(scene_path, img_dir, str(tmp_path / "jax"),
                   JConfig(**flags), verbose=False, fusion_mode=mode)
    out = densify(scene_path, img_dir, str(tmp_path / "port"),
                  DenseConfig(**flags), verbose=False, fusion_mode=mode,
                  device="cpu")
    for i in range(3):
        close, masks = _depth_agree(out["depth"][i], ref["depth"][i])
        assert close >= 0.98 and masks >= 0.98, (i, close, masks)
        dm = read_dmap(str(tmp_path / "port" / "depthmap"
                           / f"depth{i:04d}.dmap"))
        assert np.array_equal(dm.depth, out["depth"][i])
    assert out["valid_frac"] > 0.4
    if mode == -2:
        assert abs(out["n_points"] - ref["n_points"]) <= 0.02 * ref[
            "n_points"], (out["n_points"], ref["n_points"])
        assert os.path.exists(tmp_path / "port" / "scene_dense.ply")
    else:
        assert out["n_points"] == ref["n_points"] == 0
        cli = main(["--input-file", scene_path, "--images-dir", img_dir,
                    "-w", str(tmp_path / "cli"), "--device", "cpu",
                    "--fusion-mode", "-1", "--flags", "resolution-level=0",
                    "min-resolution=0", "use-optical-flow=0"])
        assert np.array_equal(cli["depth"], out["depth"])


def compare_at(h: int, w: int, which: str = "both") -> None:
    """densify --fusion-mode -2 at DenseConfig() plus resolution-level=0 on
    chip_smoke.py's 4-view plane scene at h x w (focal length scaled with
    width), in the JAX package and / or the port on the CPU; prints view
    0's interior depth_acc_2pct, its valid share, the point count and the
    wall (phase 24's floor rests on the JAX number)."""
    import tempfile
    import time
    from hcmvs_tpu_torch.utils.synth import (make_plane_scene,
                                             write_plane_scene)
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w, n_views=4,
                          fx=180.0 * w / 192.0)
    with tempfile.TemporaryDirectory() as root:
        scene_path, img_dir = write_plane_scene(root, sc)
        for name in ("jax", "port"):
            if which not in ("both", name):
                continue
            t0 = time.time()
            if name == "jax":
                import jax
                jax.config.update("jax_platforms", "cpu")
                from hcmvs_tpu.core.config import DenseConfig as JConfig
                from hcmvs_tpu.pipeline.densify import densify as jdensify
                st = jdensify(scene_path, img_dir, os.path.join(root, name),
                              JConfig(resolution_level=0), verbose=False,
                              fusion_mode=-2)
            else:
                from hcmvs_tpu_torch.core.config import DenseConfig
                from hcmvs_tpu_torch.pipeline.densify import densify
                st = densify(scene_path, img_dir, os.path.join(root, name),
                             DenseConfig(resolution_level=0), verbose=False,
                             fusion_mode=-2, device="cpu")
            d0 = st["depth"][0]
            rel = np.abs(d0 - sc.depth_gt) / sc.depth_gt
            m = 6
            acc = float((rel < 0.02)[m:-m, m:-m].mean())
            print(f"{name} {h}x{w}: view 0 depth_acc_2pct {acc:.4f}, valid "
                  f"{float((d0 > 0).mean()):.4f}, points {st['n_points']}, "
                  f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    compare_at(int(sys.argv[1]), int(sys.argv[2]),
               sys.argv[3] if len(sys.argv) > 3 else "both")
