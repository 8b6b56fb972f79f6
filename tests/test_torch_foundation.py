"""PyTorch port vs the JAX package: configuration, synthetic scenes,
camera, view geometry, sampling, gradients and random init.

Inputs are made with numpy from a seed and go through both packages; JAX
runs on the CPU as in the rest of the suite.  Tolerances: bit equality
where both sides run the same numpy code, else atol 1e-5 (float32
rounding of short expressions evaluated in another order).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core import camera as jcam
from hcmvs_tpu.core import config as jconfig
from hcmvs_tpu.dense import types as jtypes
from hcmvs_tpu.ops import gradients as jgrad
from hcmvs_tpu.ops import sampling as jsamp
from hcmvs_tpu.utils import synth as jsynth

from hcmvs_tpu_torch.core import camera as tcam
from hcmvs_tpu_torch.core import config as tconfig
from hcmvs_tpu_torch.dense import types as ttypes
from hcmvs_tpu_torch.ops import gradients as tgrad
from hcmvs_tpu_torch.ops import sampling as tsamp
from hcmvs_tpu_torch.utils import synth as tsynth

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _close(t, j, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(h=40, w=56, n_views=4)
    return (jsynth.make_plane_scene(np.random.default_rng(3), **kw),
            tsynth.make_plane_scene(np.random.default_rng(3), **kw))


def test_config_fields_and_defaults_match():
    jf = dataclasses.fields(jconfig.DenseConfig)
    tf = dataclasses.fields(tconfig.DenseConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    jc, tc = jconfig.DenseConfig(), tconfig.DenseConfig()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    kw = dict(patch_step=4, window_ref_width=64, optimize=0)
    assert (dataclasses.asdict(tc.replace(**kw))
            == dataclasses.asdict(jc.replace(**kw)))
    assert tc.num_patch_samples == jc.num_patch_samples
    for w in (96, 128, 200):
        assert (dataclasses.asdict(tconfig.window_cfg_for_width(
            tc.replace(**kw), w))
            == dataclasses.asdict(jconfig.window_cfg_for_width(
                jc.replace(**kw), w)))


def test_plane_scene_is_bit_identical(scenes):
    js, ts = scenes
    for a, b in zip(js.images, ts.images):
        assert np.array_equal(a, b)
    for cj, ct in zip(js.cameras, ts.cameras):
        for f in ("K", "R", "C"):
            assert np.array_equal(np.asarray(getattr(cj, f)),
                                  getattr(ct, f).numpy())
    assert np.array_equal(js.depth_gt, ts.depth_gt)
    assert np.array_equal(js.normal_gt, ts.normal_gt)
    assert (js.d_min, js.d_max) == (ts.d_min, ts.d_max)
    # the JAX package evaluates this in float32 through jnp (its cameras
    # are jax arrays), the port in float64 numpy: equal to f32 rounding
    for v in (0, 2):
        _close(tsynth.plane_depth_of_view(ts, v),
               jsynth.plane_depth_of_view(js, v), atol=0, rtol=1e-6)


def _cams(scene, mod):
    stack = jnp.stack if mod is jcam else torch.stack
    return mod.Camera(K=stack([c.K for c in scene.cameras]),
                      R=stack([c.R for c in scene.cameras]),
                      C=stack([c.C for c in scene.cameras]))


def test_camera_and_view_geometry_match(scenes):
    js, ts = scenes
    jc, tc = _cams(js, jcam), _cams(ts, tcam)
    _close(tc.t, jc.t)
    _close(tc.K_inv, jc.K_inv)
    jref = jax.tree.map(lambda x: x[0], jc)
    jsrc = jax.tree.map(lambda x: x[1:], jc)
    tref, tsrc = tc[0], tc[1:]
    for a, b in zip(tcam.relative_motion(tref, tsrc),
                    jcam.relative_motion(jref, jsrc)):
        _close(a, b)
    _close(tcam.skew(tc.C), jcam.skew(jc.C))
    _close(tcam.fundamental_matrix(tref, tsrc),
           jcam.fundamental_matrix(jref, jsrc))
    jg = jtypes.make_view_geometry(jref, jsrc)
    tg = ttypes.make_view_geometry(tref, tsrc)
    for f in ("A", "wv", "R_rel", "t_rel", "K_src", "K_inv_src", "F",
              "K_ref", "K_inv_ref"):
        _close(getattr(tg, f), getattr(jg, f), rtol=1e-5)


def test_types_helpers_match(scenes):
    js, ts = scenes
    h, w = js.images[0].shape
    K_inv = np.array(_cams(js, jcam).K_inv[0])
    jr = jtypes.pixel_rays(jnp.asarray(K_inv), h, w)
    tr = ttypes.pixel_rays(torch.from_numpy(K_inv), h, w)
    _close(tr, jr)
    rng = np.random.default_rng(5)
    v = rng.standard_normal((3, h, w)).astype(np.float32)
    M = rng.standard_normal((3, 3)).astype(np.float32)
    vj, vt = tuple(jnp.asarray(v)), tuple(torch.from_numpy(v))
    for fj, ft in ((jtypes.mat3_apply, ttypes.mat3_apply),
                   (jtypes.mat3_apply_t, ttypes.mat3_apply_t)):
        for a, b in zip(ft(torch.from_numpy(M), vt),
                        fj(jnp.asarray(M), vj)):
            _close(a, b)
    dj = jtypes.normalize3(vj)
    dt = ttypes.normalize3(vt)
    for a, b in zip(dt, dj):
        _close(a, b)
    for a, b in zip(sum(ttypes.tangent_frame(dt), ()),
                    sum(jtypes.tangent_frame(dj), ())):
        _close(a, b)
    for a, b in zip(ttypes.face_camera_t(vt, tuple(tr)),
                    jtypes.face_camera_t(vj, tuple(jr))):
        _close(a, b)
    # upsampling: jax.image.resize(bilinear) == F.interpolate(
    # align_corners=False, antialias=False) when enlarging
    x = rng.random((5, 7)).astype(np.float32)
    _close(ttypes._upsample_bilinear(torch.from_numpy(x), h, w),
           jtypes._upsample_bilinear(jnp.asarray(x), h, w))


def test_sampling_and_sobel_match(scenes):
    js, _ = scenes
    img = js.images[1]
    h, w = img.shape
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, w + 2, (30, 20)).astype(np.float32)
    y = rng.uniform(-3, h + 2, (30, 20)).astype(np.float32)
    it, ij = torch.from_numpy(img), jnp.asarray(img)
    for ft, fj in ((tsamp.bilinear_sample_xy, jsamp.bilinear_sample_xy),
                   (tsamp.bicubic_sample_xy, jsamp.bicubic_sample_xy)):
        vt, okt = ft(it, torch.from_numpy(x), torch.from_numpy(y))
        vj, okj = fj(ij, jnp.asarray(x), jnp.asarray(y))
        _close(vt, vj)
        assert np.array_equal(okt.numpy(), np.asarray(okj))
    planes = rng.standard_normal((3, 2, h, w)).astype(np.float32)
    xs = np.round(rng.uniform(-3, w + 2, (3, 9, 11))).astype(np.float32)
    ys = np.round(rng.uniform(-3, h + 2, (3, 9, 11))).astype(np.float32)
    vt, okt = tsamp.nearest_sample_planes_batched(
        torch.from_numpy(planes), torch.from_numpy(xs), torch.from_numpy(ys))
    vj, okj = jsamp.nearest_sample_planes_batched(
        jnp.asarray(planes), jnp.asarray(xs), jnp.asarray(ys))
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    # 8-bit-scaled gradients: atol relative to the 255 range
    _close(tgrad.sobel_magnitude(it), jgrad.sobel_magnitude(ij),
           atol=ATOL * 255)


def test_init_state_apply_matches_with_jax_draws(scenes):
    js, _ = scenes
    h, w = js.images[0].shape
    K_inv = np.array(_cams(js, jcam).K_inv[0])
    rays_j = jtypes.pixel_rays(jnp.asarray(K_inv), h, w)
    key = jax.random.PRNGKey(11)
    ref = jtypes.init_state(key, rays_j, js.d_min, js.d_max)
    # the draws init_state makes, with its own key split
    k_c, k_j, k_n, _ = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_n)
    draws = ttypes.InitDraws(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k_c, (max(2, h // 8), max(2, w // 8)),
                           minval=js.d_min, maxval=js.d_max),
        jax.random.uniform(k_j, (h, w), minval=-0.02, maxval=0.02),
        jax.random.uniform(k1, (h, w), minval=0.5, maxval=1.0),
        jax.random.uniform(k2, (h, w), minval=0.0, maxval=2 * jnp.pi))))
    st = ttypes.init_state_apply(torch.from_numpy(np.array(rays_j)),
                                 draws, js.d_min, js.d_max)
    _close(st.depth, ref.depth)
    _close(st.normal, ref.normal)
    _close(st.cost, ref.cost)
    # the port's own generator gives a valid state of the same kind
    g = torch.Generator().manual_seed(0)
    own = ttypes.init_state(g, torch.from_numpy(np.array(rays_j)),
                            js.d_min, js.d_max)
    assert own.depth.min() >= js.d_min and own.depth.max() <= js.d_max
    n = own.normal
    assert torch.allclose((n * n).sum(0), torch.ones(h, w), atol=1e-5)


_NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "hcmvs_tpu", "cv2", "PIL")
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    import torch
    import hcmvs_tpu_torch
    for mod in pkgutil.walk_packages(hcmvs_tpu_torch.__path__,
                                     "hcmvs_tpu_torch."):
        importlib.import_module(mod.name)
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.dense.scene_driver import (SceneTensors,
                                                    estimate_scene, finalize)
    from hcmvs_tpu_torch.utils.synth import make_plane_scene
    h, w, n = 32, 48, 4
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w, n_views=n)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    scene = SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]),
        cams=cams,
        nbr_idx=torch.tensor([[j for j in range(n) if j != i]
                              for i in range(n)]),
        nbr_valid=torch.ones(n, 3, dtype=torch.bool),
        d_min=torch.full((n,), sc.d_min), d_max=torch.full((n,), sc.d_max))
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3, patch_step=2,
                      estimation_iters=2, estimation_iters_external=2,
                      random_iters=2, use_optical_flow=0, optimize=0,
                      use_geo_consistency=1, use_part_consistency=1)
    st = estimate_scene(torch.Generator().manual_seed(0), scene, cfg)
    depth, normal, conf = finalize(st, cfg)
    assert depth.shape == (n, h, w) and normal.shape == (n, 3, h, w)
    assert torch.isfinite(st.depth).all() and torch.isfinite(st.cost).all()
    # the DensifyPointCloud path on the CPU: .mvs + PNGs in, files out
    from hcmvs_tpu_torch.pipeline.densify import main
    from hcmvs_tpu_torch.utils.synth import write_plane_scene
    path, img_dir = write_plane_scene("scene", sc)     # in the cwd
    stats = main(["--input-file", path, "--images-dir", img_dir,
                  "-w", "out", "--device", "cpu", "--flags",
                  "resolution-level=0", "min-resolution=0",
                  "n-EstimationIters=1", "n-EstimationIters-external=3",
                  "n-adapthalfwin=3"])
    assert stats["n_points"] > 0 and os.path.exists("out/scene_dense.mvs")
    # the hierarchical-cross schedule on the CPU: a ridge scene through
    # the five default stages (levels 3, 2, 2, 1, 1)
    from hcmvs_tpu_torch.pipeline import hierarchy
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn,
                                             write_ridge_scene)
    ridge = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=3,
                             fx=180.0 * w / 192.0,
                             texture_fn=sinusoid_texture_fn(
                                 np.random.default_rng(1)))
    path, img_dir = write_ridge_scene("ridge", ridge)
    stats = hierarchy.main(["--input-file", path, "--images-dir", img_dir,
                            "-w", "hc", "--device", "cpu", "--flags",
                            "min-resolution=0", "n-EstimationIters=1",
                            "n-EstimationIters-external=2",
                            "n-adapthalfwin=3"])
    assert stats["depth"].shape == (3, h // 2, w // 2)
    assert os.path.exists("hc/scene_dense.ply")
    assert len(os.listdir("hc/stage_ckpt")) == 5
    # densify with 16-bit face masks beside the images and an external
    # prior map: the planar-prior pass runs once; then the labels
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    from hcmvs_tpu_torch.utils.synth import (write_ridge_masks,
                                             write_ridge_prior)
    write_ridge_masks(img_dir, ridge)
    write_ridge_prior("priors", ridge, 1)
    reset_report()
    stats = main(["--input-file", path, "--images-dir", img_dir,
                  "-w", "masked", "--device", "cpu", "--priors-dir",
                  "priors", "--flags", "resolution-level=0",
                  "min-resolution=0", "use-semantic=1",
                  "n-EstimationIters=1", "n-EstimationIters-external=3",
                  "n-adapthalfwin=3"])
    assert report()["estimate.priors"]["calls"] == 1
    assert stats["n_points"] > 0
    labels = main(["--input-file", "masked/scene_dense.mvs", "--images-dir",
                   img_dir, "-w", "labels", "--project-labels"])
    assert labels["n_label_images"] == 3
    assert (labels["colors"] != 255).any(1).mean() > 0.9
    # the mesh apps on the masked run's cloud: graph cut and clean-up on
    # the host (native max-flow and rasterizer built with g++), refine and
    # texture on the CPU; then densify's --sample-mesh of the result (the
    # walk above imported native, mesh.* and eval.compare)
    from hcmvs_tpu_torch.eval.compare import point_cloud_fscore
    from hcmvs_tpu_torch.pipeline import mesh_apps
    mvs = "masked/scene_dense.mvs"
    rec = mesh_apps.main(["reconstruct", "-i", mvs, "-o", "mesh.ply"])
    assert len(rec["faces"]) > 0
    ref = mesh_apps.main(["refine", "-i", mvs, "-m", "mesh.ply",
                          "--images-dir", img_dir, "--device", "cpu"])
    assert np.isfinite(ref["vertices"]).all()
    tex = mesh_apps.main(["texture", "-i", mvs, "-m", "mesh_refine.ply",
                          "--images-dir", img_dir, "--device", "cpu"])
    assert (tex["textured"].labels >= 0).any()
    assert os.path.exists("mesh_refine_texture.png")
    assert point_cloud_fscore(ref["vertices"], rec["vertices"],
                              1.0)["fscore"] > 0.5
    sampled = main(["--input-file", "mesh_refine_texture.obj", "-w",
                    "sampled", "--sample-mesh", "-500"])
    assert sampled["n_points"] == 500
    # the SfM front end's EXIF bootstrap (its own TIFF parser, no imaging
    # library) and one bundle-adjustment step
    from hcmvs_tpu_torch.eval.ba_bench import make_problem
    from hcmvs_tpu_torch.io.exif import exif_bytes, focal_from_exif
    from hcmvs_tpu_torch.io.images import write_png
    from hcmvs_tpu_torch.sfm.ba import ba_cost, ba_step
    write_png("exif.png", np.zeros((48, 64), np.uint8),
              exif=exif_bytes(FocalLengthIn35mmFilm=33.75))
    assert focal_from_exif("exif.png", 64, 48) == (33.75 * 64 / 36.0,
                                                   "exif35")
    problem, state, _ = make_problem(12, 300, device="cpu")
    stepped = ba_step(problem, state, 1e-3)
    assert float(ba_cost(problem, stepped)) < float(ba_cost(problem, state))
    # the quality ladder's CLI on the CPU (the per-plane build, streamed)
    # and the single-view API
    import contextlib, io, json
    from hcmvs_tpu_torch.dense import estimate_depth_map, make_view_geometry
    from hcmvs_tpu_torch.eval import quality_ladder
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quality_ladder.main(["--h", "32", "--w", "48", "--fx", "45",
                             "--views", "3", "--ext", "2", "--iters", "1",
                             "--device", "cpu", "--volume-planes", "256",
                             "--cfg", '{"volume_streaming": true}'])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert lines[-1]["final"] and 0 <= lines[-1]["acc2pct"] <= 1
    geom = make_view_geometry(cams[0], cams[torch.tensor([1, 2])])
    sv = estimate_depth_map(torch.Generator().manual_seed(0), geom,
                            scene.gray[0], scene.gray[1:3], sc.d_min,
                            sc.d_max, cfg)
    assert sv.depth.shape == (h, w) and torch.isfinite(sv.cost).all()
    # SGM (densify --fusion-mode -2) with the viewer export, then the
    # converters: the dense scene through COLMAP, NVM, OpenMVG and
    # PhotoScan files and back
    path, img_dir = write_plane_scene("sgm_scene", sc)
    stats = main(["--input-file", path, "--images-dir", img_dir, "-w",
                  "sgm", "--device", "cpu", "--fusion-mode", "-2",
                  "--export-viewer", "--flags", "resolution-level=0",
                  "min-resolution=0"])
    assert stats["n_points"] > 0 and os.path.exists("sgm/scene_dense.html")
    from hcmvs_tpu_torch import io as tio
    from hcmvs_tpu_torch.io.colmap import read_colmap_model, write_colmap_model
    scn = tio.read_mvs(path)
    write_colmap_model("colmap", scn)
    tio.write_nvm("scene.nvm", scn)
    tio.write_openmvg_json("sfm_data.json", scn)
    tio.write_photoscan_xml("cameras.xml", scn)
    for back in (read_colmap_model("colmap"), tio.read_nvm("scene.nvm"),
                 tio.read_openmvg_json("sfm_data.json"),
                 tio.read_photoscan_xml("cameras.xml")):
        assert len(back.images) == n
        for i in range(n):
            assert np.allclose(back.pose_of(i)[1], scn.pose_of(i)[1],
                               atol=1e-4)
    # a committed JPEG (4:2:0) and an oriented one through the port's own
    # decoder (native/jpeg.cpp), to the manifest's cv2 digests
    import hashlib
    import hcmvs_tpu_torch
    from hcmvs_tpu_torch.io.images import imread
    jdir = os.path.join(os.path.dirname(os.path.dirname(
        hcmvs_tpu_torch.__file__)), "tests", "data", "jpeg")
    with open(os.path.join(jdir, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    for name in ("variants/s420.jpg", "variants/orient6.jpg"):
        for mode, want in manifest[name].items():
            img = imread(os.path.join(jdir, name), mode)
            assert hashlib.sha256(img.tobytes()).hexdigest() \
                == want["sha256"], (name, mode)
    # the golden gate, tiny, on the CPU
    from hcmvs_tpu_torch.eval import golden
    g = golden.run(h=72, w=96, n_views=4, device="cpu")
    assert g["registered"] >= 2 and 0 <= g["depth_acc_2pct"] <= 1
    assert not any(m.split(".")[0] in BLOCKED
                   for m in sys.modules if sys.modules[m] is not None)
    print("OK", float((depth > 0).float().mean()))
""")


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT],
                          cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("OK"), proc.stdout
