"""PyTorch port vs the JAX package: the DensifyPointCloud path.

``.mvs`` + PNG scene in, ``.dmap`` files, ``scene_dense.ply`` and
``scene_dense.mvs`` out, at 48x64 with 3 views (plane scene).  The
configuration keeps DenseConfig's default schedule structure (optimize
at external iterations 1 and 2, LK optical flow, geometric phase from
iteration 1) at a size the CPU runs in seconds: 3 external iterations of
one sweep, small windows, no random refinement.  JAX runs on the CPU with
the table and rect engines forced on, as in tests/test_torch_slice.py;
``hcmvs_tpu.dense.flow._HAVE_CV2`` is patched to False inside this
module's fixture only, so both packages compute LK flow.

Tolerances: the host-side numpy modules (config, view selection, splat,
point filter) exactly; ``estimate_scene`` with optimize and flows from the
same init by share of pixels (depth within 1e-3 on >= 99%), since an
argmin between near-tied candidates may flip under reordered rounding;
``densify`` end to end, from the same init, by view 0's depth accuracy
and the valid share (within 0.03) and the point count (within 2%).

Run as a script, ``PYTHONPATH=. python tests/test_torch_densify.py H W
[jax|jax-forced|port]`` runs the packages' densify at DenseConfig()
defaults plus resolution-level=0 (Farneback flow in both) on an H x W,
4-view plane scene on the CPU and prints view 0's depth_acc_2pct, the
valid share, the point count and the fused cloud's median point-to-plane
distance over the median depth.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_flow import flow_backend

torch.set_num_threads(1)

H, W, N = 48, 64, 3
SMALL = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, estimation_iters_external=3, random_iters=0,
             use_optical_flow=1, optimize=1, use_geo_consistency=1,
             use_part_consistency=0, resolution_level=0, min_resolution=0)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")
MARGIN = 6


def _acc(depth, gt, margin=MARGIN):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


def cloud_distance(points, sc) -> float:
    """Median |n . X - c| of a cloud to the scene's plane, over the median
    ground-truth depth of view 0."""
    dist = np.abs(points.astype(np.float64) @ sc.n_w - sc.c_w)
    return float(np.median(dist) / np.median(sc.depth_gt))


def _jax_densify(scene_path, img_dir, out_dir, cfg, **kw):
    from hcmvs_tpu.pipeline import densify as jd
    return jd.densify(scene_path, img_dir, out_dir, cfg, verbose=False, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.utils.synth import (make_plane_scene,
                                             write_plane_scene)
    root = tmp_path_factory.mktemp("densify")
    sc = make_plane_scene(np.random.default_rng(9), h=H, w=W, n_views=N)
    scene_path, img_dir = write_plane_scene(str(root), sc)
    jcfg = JConfig(**SMALL, **FORCED)
    ref = _jax_densify(scene_path, img_dir, str(root / "jax"), jcfg)
    world = dict(sc=sc, root=root, scene_path=scene_path, img_dir=img_dir,
                 jcfg=jcfg, tcfg=TConfig(**SMALL), ref=ref)
    world.update(zip(("jscene", "tscene", "init"), _tensors(world)))
    return world


def test_cli_flags_match_jax():
    from hcmvs_tpu.core import config as jc
    from hcmvs_tpu_torch.core import config as tc
    assert tc.CLI_FLAG_MAP == jc.CLI_FLAG_MAP
    flags = {"resolution-level": "0", "n-EstimationIters": "2",
             "n-photometric_flow": "0.3", "use-semantic": "1",
             "n-nOptimize": "0", "unknown-flag": "7"}
    for base in (None, "explore"):
        jb = None if base is None else jc.DenseConfig(explore_patch_step=0)
        tb = None if base is None else tc.DenseConfig(explore_patch_step=0)
        j = dataclasses.asdict(jc.config_from_cli_flags(flags, jb))
        t = dataclasses.asdict(tc.config_from_cli_flags(flags, tb))
        assert t == j


def test_view_selection_and_splat_match_jax():
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.dense import view_selection as jvs
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    from hcmvs_tpu_torch.dense import view_selection as tvs
    rng = np.random.default_rng(3)
    n, p = 6, 80
    centers = rng.uniform(-1, 1, (n, 3))
    centers[:, 2] -= 4.0
    points = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    counts = rng.integers(0, 5, p).astype(np.int32)
    ids = np.concatenate([rng.choice(n, c, replace=False)
                          for c in counts]).astype(np.uint32)
    sj = jvs.pair_scores(points, counts, ids, centers, n)
    st = tvs.pair_scores(points, counts, ids, centers, n)
    assert np.array_equal(st, sj)
    for v, ratio in ((1, 0.3), (3, 0.3), (5, 0.9)):
        for a, b in zip(tvs.select_neighbors(st, v, ratio),
                        jvs.select_neighbors(sj, v, ratio)):
            assert np.array_equal(a, b)
    R = np.eye(3)
    for i in range(n):
        assert (tvs.depth_range_from_points(points, counts, ids, R,
                                            centers[i], i)
                == jvs.depth_range_from_points(points, counts, ids, R,
                                               centers[i], i))
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    cams = [(K, R, centers[i]) for i in range(n)]
    assert np.array_equal(
        tsd.splat_sparse_depths(points, counts, ids, cams, n, 24, 32),
        jsd.splat_sparse_depths(points, counts, ids, cams, n, 24, 32))


def test_point_filter_matches_jax():
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera as JCamera
    from hcmvs_tpu.dense.point_filter import filter_point_cloud as jfpc
    from hcmvs_tpu_torch.core.camera import Camera as TCamera
    from hcmvs_tpu_torch.dense.point_filter import filter_point_cloud as tfpc
    from hcmvs_tpu_torch.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(0), h=24, w=32, n_views=3)
    rng = np.random.default_rng(4)
    pts = np.concatenate([
        rng.uniform(-0.6, 0.6, (300, 3)) * [1, 1, 0] + [0, 0, 4.0],
        rng.uniform(-0.6, 0.6, (100, 3)) * [1, 1, 0] + [0, 0, 3.0]]
    ).astype(np.float32)
    counts = rng.integers(1, 4, len(pts)).astype(np.int32)
    ids = np.concatenate([rng.choice(3, c, replace=False)
                          for c in counts]).astype(np.uint32)
    tc = TCamera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                   for f in "KRC"))
    jcam = JCamera(*(jnp.asarray(getattr(tc, f).numpy()) for f in "KRC"))
    for th in (-1, 0, 2):
        keep_t = tfpc(pts, counts, ids, tc, (24, 32), th_remove=th)
        keep_j = jfpc(pts, counts, ids, jcam, (24, 32), th_remove=th)
        assert np.array_equal(keep_t, keep_j)


def _tensors(world):
    """Both packages' scene tensors of the written scene (flows from the
    JAX package's default backend, Farneback; seeds splatted) and the JAX
    init state."""
    import jax
    from hcmvs_tpu.dense import flow as jflow
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.dense.view_selection import pair_scores, select_neighbors
    from hcmvs_tpu.pipeline.densify import build_scene_tensors
    from hcmvs_tpu_torch.convert import scene_from_numpy, state_from_numpy
    from hcmvs_tpu_torch.io.images import load_image, to_gray
    from hcmvs_tpu_torch.io.mvs import read_mvs
    scene = read_mvs(world["scene_path"])
    grays = [to_gray(load_image(os.path.join(world["img_dir"], im.name)))
             for im in scene.images]
    centers = np.stack([scene.pose_of(i)[1] for i in range(N)])
    nbr1, _ = select_neighbors(pair_scores(
        scene.points, scene.point_view_counts, scene.point_view_ids,
        centers, N), 1)
    flows = jflow.scene_flows(np.stack(grays), nbr1)
    jscene = build_scene_tensors(scene, grays, world["jcfg"], flows)
    init = jsd.init_scene_state(jax.random.PRNGKey(0), jscene)
    return (jscene, scene_from_numpy(jscene, device="cpu"),
            state_from_numpy(init, device="cpu"))


def test_estimate_scene_optimize_flow_matches_jax(world):
    """The schedule with the mid-schedule filter and the flow term, from
    the same (JAX) init, no random refinement."""
    import jax
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    jscene, tscene, init = world["jscene"], world["tscene"], world["init"]
    assert tscene.flows is not None and tscene.seed_depth is not None
    ref = jsd.estimate_scene(jax.random.PRNGKey(0), jscene, world["jcfg"])
    reset_report()
    out = tsd.estimate_scene(torch.Generator().manual_seed(0), tscene,
                             world["tcfg"], init=init)
    assert [k for k in report() if k.startswith("estimate.optimize")] \
        == ["estimate.optimize.ext1", "estimate.optimize.ext2"]
    d_ref, d_out = np.asarray(ref.depth), out.depth.numpy()
    close = np.abs(d_out - d_ref) <= 1e-3 * np.abs(d_ref)
    assert close.mean() >= 0.99, close.mean()


def _check_outputs(out_dir, stats, with_cloud):
    from hcmvs_tpu.io.dmap import read_dmap as jread_dmap
    from hcmvs_tpu.io.mvs import read_mvs as jread_mvs
    from hcmvs_tpu_torch.io.dmap import read_dmap
    for i in range(N):
        path = os.path.join(out_dir, "depthmap", f"depth{i:04d}.dmap")
        dm, jdm = read_dmap(path), jread_dmap(path)
        assert dm.depth.shape == (H, W)
        assert np.array_equal(dm.depth, stats["depth"][i])
        assert np.array_equal(jdm.depth, dm.depth)
        assert dm.view_ids[0] == i and len(dm.view_ids) == N
    cloud = os.path.join(out_dir, "scene_dense.mvs")
    assert os.path.exists(cloud) == with_cloud
    assert os.path.exists(os.path.join(out_dir, "scene_dense.ply")) \
        == with_cloud
    if with_cloud:
        dense = jread_mvs(cloud)
        assert len(dense.points) == stats["n_points"] > 0
        assert dense.point_view_counts.min() >= 1


def test_densify_matches_jax(world):
    """Both packages on their default flow, Farneback, from the same
    init."""
    _check_densify(world, "farneback")


def test_densify_matches_jax_on_lk(world):
    """The same on LK flow in both packages."""
    _check_densify(world, "lk")


def _check_densify(world, backend):
    from hcmvs_tpu_torch.pipeline.densify import densify
    out_dir = str(world["root"] / f"port0_{backend}")
    with flow_backend(backend):
        ref = world["ref"] if backend == "farneback" else _jax_densify(
            world["scene_path"], world["img_dir"],
            str(world["root"] / f"jax_{backend}"), world["jcfg"])
        stats = densify(world["scene_path"], world["img_dir"], out_dir,
                        world["tcfg"], verbose=False, device="cpu",
                        init=world["init"])
    gt = world["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.7, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    assert abs(stats["n_points"] - ref["n_points"]) <= 0.02 * ref["n_points"]
    _check_outputs(out_dir, stats, with_cloud=True)


def test_densify_from_jpegs_matches_jax(world, tmp_path):
    """The densify app on the world's scene with its images saved as
    JPEGs (quality 95, the scene's image names changed to them): the port
    decodes them itself, the JAX package through cv2; held as
    test_densify_matches_jax holds the PNG run."""
    Image = pytest.importorskip("PIL.Image")
    from hcmvs_tpu_torch.io.mvs import read_mvs, write_mvs
    from hcmvs_tpu_torch.pipeline.densify import densify
    scene = read_mvs(world["scene_path"])
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for rec, img in zip(scene.images, world["sc"].images):
        rec.name = rec.name.replace(".png", ".jpg")
        Image.fromarray((img * 255).astype(np.uint8)).save(
            str(img_dir / rec.name), quality=95)
    scene_path = str(tmp_path / "scene.mvs")
    write_mvs(scene_path, scene)
    ref = _jax_densify(scene_path, str(img_dir), str(tmp_path / "jax"),
                       world["jcfg"])
    stats = densify(scene_path, str(img_dir), str(tmp_path / "port"),
                    world["tcfg"], verbose=False, device="cpu",
                    init=world["init"])
    gt = world["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.7, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    assert abs(stats["n_points"] - ref["n_points"]) <= 0.02 * ref["n_points"]


def test_densify_export_only_resume_and_cli(world):
    """fusion_mode 1 writes the maps only; a second run resumes from
    them; the CLI entry point runs the same path."""
    from hcmvs_tpu_torch.pipeline.densify import densify, main
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    out_dir = str(world["root"] / "port1")
    s1 = densify(world["scene_path"], world["img_dir"], out_dir,
                 world["tcfg"], verbose=False, fusion_mode=1, device="cpu")
    assert s1["n_points"] == 0
    _check_outputs(out_dir, s1, with_cloud=False)
    reset_report()
    s2 = densify(world["scene_path"], world["img_dir"], out_dir,
                 world["tcfg"], verbose=False, device="cpu")
    assert "densify.read_dmap" in report()
    assert "densify.estimate" not in report()
    assert np.array_equal(s2["depth"], s1["depth"])
    _check_outputs(out_dir, s2, with_cloud=True)
    cli_dir = str(world["root"] / "cli")
    s3 = main(["--input-file", world["scene_path"], "--images-dir",
               world["img_dir"], "-w", cli_dir, "--device", "cpu",
               "--flags", "resolution-level=0", "min-resolution=0",
               "n-EstimationIters=1", "n-EstimationIters-external=2",
               "n-adapthalfwin=3", "--fusion-mode", "1"])
    assert s3["n_points"] == 0 and s3["depth"].shape == (N, H, W)
    assert s3["valid_frac"] > 0.5


def test_densify_needs_a_device_and_raises_for_unported(world, tmp_path):
    """Without a card the default device raises; masks (under
    use_semantic), --priors-dir, --project-labels and mesh sampling run;
    SGM (fusion modes -1 / -2) and the viewer export run too
    (tests/test_torch_sgm.py and tests/test_torch_converters.py hold them
    against the JAX package)."""
    from hcmvs_tpu_torch.io.dmap import DepthMapData, write_dmap
    from hcmvs_tpu_torch.io.images import write_png
    from hcmvs_tpu_torch.pipeline.densify import densify, main
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    args = (world["scene_path"], world["img_dir"], str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            densify(*args, world["tcfg"], verbose=False)
    sgm = densify(world["scene_path"], world["img_dir"],
                  str(tmp_path / "sgm"), world["tcfg"], verbose=False,
                  device="cpu", fusion_mode=-1)
    assert sgm["n_points"] == 0 and (sgm["depth"] > 0).mean() > 0.3
    # masks are read under use_semantic only (without it they are ignored,
    # tests/test_torch_repairs.py); then they feed the planar priors, as
    # an external prior map does
    masks = tmp_path / "masks"
    masks.mkdir()
    write_png(str(masks / "im0000.png"),
              np.where(np.arange(W) < W // 2, 300, 700).astype(np.uint16)
              [None].repeat(H, 0))
    priors = tmp_path / "priors"
    priors.mkdir()
    write_dmap(str(priors / "depth0000.dmap"), DepthMapData(
        depth=np.ascontiguousarray(world["sc"].depth_gt[::2, ::2]),
        K=np.eye(3), R=np.eye(3), C=np.zeros(3)))
    priors = str(priors)
    for kw in (dict(masks_dir=str(masks)), dict(priors_dir=priors)):
        reset_report()
        st = densify(*args, world["tcfg"].replace(use_semantic=True),
                     verbose=False, device="cpu", fusion_mode=1,
                     resume=False, **kw)
        assert report()["estimate.priors"]["calls"] == 1, kw
        assert st["valid_frac"] > 0.5
    labels = main(["--input-file", world["scene_path"], "--images-dir",
                   world["img_dir"], "-w", str(tmp_path / "lab"),
                   "--masks-dir", str(masks), "--project-labels"])
    assert labels["n_label_images"] == 1
    from hcmvs_tpu_torch.io.ply import read_ply, write_ply_mesh
    write_ply_mesh(str(tmp_path / "quad.ply"),
                   np.array([[0, 0, 4], [1, 0, 4], [1, 1, 4], [0, 1, 4]],
                            np.float32), np.array([[0, 1, 2], [0, 2, 3]]))
    sampled = main(["--input-file", str(tmp_path / "quad.ply"), "-w",
                    str(tmp_path / "sampled"), "--sample-mesh", "-100"])
    pts, _ = read_ply(str(tmp_path / "sampled" / "scene_sampled.ply"))
    assert sampled["n_points"] == len(pts) == 100
    assert (pts[:, 2] == 4).all()
    viewer = tmp_path / "viewer"
    main(["--input-file", world["scene_path"], "--images-dir",
          world["img_dir"], "-w", str(viewer), "--device", "cpu",
          "--export-viewer", "--flags", "resolution-level=0",
          "min-resolution=0", "n-EstimationIters=1",
          "n-EstimationIters-external=1", "n-adapthalfwin=3"])
    html = (viewer / "scene_dense.html").read_text()
    assert f"{len(read_ply(str(viewer / 'scene_dense.ply'))[0])}" in html


def compare_at(h: int, w: int) -> None:
    """Both packages' densify at DenseConfig() defaults plus
    resolution-level=0 on an h x w, 4-view plane scene (focal length
    scaled with width); prints what chip_smoke.py's floors rest on."""
    import tempfile
    import time
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.pipeline.densify import densify
    from hcmvs_tpu_torch.utils.synth import (make_plane_scene,
                                             write_plane_scene)
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w, n_views=4,
                          fx=180.0 * w / 192.0)
    with tempfile.TemporaryDirectory() as root:
        scene_path, img_dir = write_plane_scene(root, sc)
        runs = [("jax", lambda d: _jax_densify(
                    scene_path, img_dir, d, JConfig(resolution_level=0))),
                ("jax-forced", lambda d: _jax_densify(
                    scene_path, img_dir, d,
                    JConfig(resolution_level=0, **FORCED))),
                ("port", lambda d: densify(
                    scene_path, img_dir, d, TConfig(resolution_level=0),
                    verbose=False, device="cpu"))]
        for name, run in runs:
            if len(sys.argv) > 3 and name not in sys.argv[3:]:
                continue
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            st = run(out)
            sec = time.perf_counter() - t0
            pts = read_mvs(os.path.join(out, "scene_dense.mvs")).points
            print(f"{name} {h}x{w}: depth_acc_2pct "
                  f"{_acc(st['depth'][0], sc.depth_gt):.4f}, valid "
                  f"{st['valid_frac']:.4f}, points {st['n_points']}, "
                  f"cloud distance / median depth "
                  f"{cloud_distance(pts, sc):.5f}, {sec:.1f} s", flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    compare_at(int(sys.argv[1]), int(sys.argv[2]))
