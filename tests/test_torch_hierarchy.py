"""PyTorch port vs the JAX package: the hierarchical-cross schedule.

``pipeline/hierarchy.py`` on the ridge scene (two planes meeting at a
ridge) at 48x64 with 3 views: the schedule's structure, the map resize
between levels, ``run_hierarchy`` stage by stage, checkpoint resume, and
``densify_hierarchical`` from ``.mvs`` + PNGs to ``.dmap`` files and the
fused cloud.  JAX runs on the CPU with the table and rect engines forced
on, as in tests/test_torch_slice.py.  The random streams differ, so the
port's ``init_scene_state`` is patched inside a test to return the JAX
package's init of the same stage (``fold_in(PRNGKey(0), stage)``), and
random refinement is off.  Where flows are on, both packages compute
Farneback flow (each one's default), and the app's parity runs again on
LK (``test_torch_flow.flow_backend``).

Tolerances: the schedule exactly; resized maps at atol 1e-5; stage
results by share of pixels (depth within 1e-3 on >= 99%), since an argmin
between near-tied candidates may flip under reordered rounding; resume
against the uninterrupted run at atol 1e-4; ``densify_hierarchical`` by
view 0's depth accuracy and the valid share (within 0.03) and the point
count (within 2%).

Run as a script, ``PYTHONPATH=. python tests/test_torch_hierarchy.py H
W`` runs both packages' ``densify_hierarchical`` at DenseConfig() on an
H x W, 4-view ridge scene (sinusoid texture, focal length scaled with
width) on the CPU and prints view 0's depth_acc_2pct, the valid share,
the point count and the fused cloud's median distance to the ridge over
the median depth.
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
             estimation_iters=1, estimation_iters_external=2, random_iters=0,
             use_optical_flow=0, optimize=0, use_geo_consistency=1,
             use_part_consistency=0, resolution_level=0, min_resolution=0)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")
MARGIN = 6


def _acc(depth, gt, margin=MARGIN):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


def _close(a, b) -> float:
    """Share of pixels whose depths agree within 1e-3 (relative)."""
    return float((np.abs(a - b) <= 1e-3 * np.abs(b)).mean())


def _stages(Stage, cfg, b_photo2geo=99):
    """A three-stage A/B/A schedule over levels 2 and 1; the B stage runs
    without geometric consistency and with both cross-scale channels."""
    a = cfg.replace(init_triangulate=0, use_geo_consistency=1, photo2geo=1)
    b = cfg.replace(init_triangulate=1, use_geo_consistency=0,
                    photo2geo=b_photo2geo)
    return [Stage(level=2, variant="A", cfg=a),
            Stage(level=1, variant="B", cfg=b),
            Stage(level=1, variant="A", cfg=a)]


def _jax_level(h, w):
    """The ridge scene at h x w (focal length scaled with width) as the
    JAX package's SceneTensors, every other view a neighbour, the depth
    range from the ground truth."""
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera as JCamera
    from hcmvs_tpu.dense.scene_driver import SceneTensors as JTensors
    from hcmvs_tpu.utils.synth import make_ridge_scene
    sc = make_ridge_scene(np.random.default_rng(4), h=h, w=w, n_views=N,
                          fx=180.0 * w / 192.0)
    nbr = np.array([[j for j in range(N) if j != i] for i in range(N)],
                   np.int32)
    return sc, JTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=JCamera(*(jnp.stack([getattr(c, f) for c in sc.cameras])
                       for f in "KRC")),
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((N, N - 1), bool),
        d_min=jnp.full((N,), 0.9 * sc.depth_gt.min(), jnp.float32),
        d_max=jnp.full((N,), 1.1 * sc.depth_gt.max(), jnp.float32))


@pytest.fixture(scope="module")
def levels():
    from hcmvs_tpu_torch.convert import scene_from_numpy
    out = {}
    for lvl, (h, w) in ((2, (H // 2, W // 2)), (1, (H, W))):
        sc, jt = _jax_level(h, w)
        out[lvl] = dict(sc=sc, jax=jt,
                        port=scene_from_numpy(jt, device="cpu"))
    return out


def _patch_init(monkeypatch, jax_by_height):
    """The port's stage inits become the JAX package's: stage ``si`` (the
    number of inits so far) takes ``fold_in(PRNGKey(0), si)`` on the JAX
    tensors of the same image height."""
    import jax
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu_torch.convert import state_from_numpy
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    calls = []

    def init(gen, tensors):
        key = jax.random.fold_in(jax.random.PRNGKey(0), len(calls))
        calls.append(tensors.gray.shape[1])
        return state_from_numpy(jsd.init_scene_state(
            key, jax_by_height[tensors.gray.shape[1]]), device="cpu")

    monkeypatch.setattr(thier, "init_scene_state", init)
    return calls


def test_default_schedule_matches_jax():
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline.hierarchy import default_schedule as jsched
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.pipeline.hierarchy import default_schedule
    for kw in ({}, dict(SMALL)):
        ts, js = default_schedule(TConfig(**kw)), jsched(JConfig(**kw))
        assert [(s.level, s.variant) for s in ts] \
            == [(s.level, s.variant) for s in js] \
            == [(3, "A"), (2, "B"), (2, "A"), (1, "B"), (1, "A")]
        for t, j in zip(ts, js):
            assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)


@pytest.mark.parametrize("size", [(24, 32), (20, 27), (6, 8), (5, 7)])
def test_resize_maps_matches_jax(size):
    """Up (twice and by an uneven factor) and down (antialiased)."""
    import jax.numpy as jnp
    from hcmvs_tpu.pipeline.hierarchy import _resize_maps as jresize
    from hcmvs_tpu_torch.pipeline.hierarchy import _resize_maps
    rng = np.random.default_rng(6)
    depth = rng.uniform(2.0, 5.0, (2, 12, 16)).astype(np.float32)
    depth[:, 3:5, 4:9] = 0.0                           # holes
    normal = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    dj, nj = jresize(jnp.asarray(depth), jnp.asarray(normal), *size)
    dt, nt = _resize_maps(torch.from_numpy(depth), torch.from_numpy(normal),
                          *size)
    assert dt.shape == (2, *size) and nt.shape == (2, 3, *size)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b_photo2geo", [99, 1])
def test_run_hierarchy_matches_jax(levels, monkeypatch, tmp_path,
                                   b_photo2geo):
    """A/B/A over two levels, compared after every stage.  With the B
    stage's photo2geo at 99 (the default schedule's) only the injection
    acts there; at 1 its second iteration is geometric, so the cross-scale
    prior enters the cost too."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline import hierarchy as jhier
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    jcfg, tcfg = JConfig(**SMALL, **FORCED), TConfig(**SMALL)
    js = _stages(jhier.Stage, jcfg, b_photo2geo)
    ts = _stages(thier.Stage, tcfg, b_photo2geo)
    calls = _patch_init(monkeypatch, {lv["jax"].gray.shape[1]: lv["jax"]
                                      for lv in levels.values()})
    ck = str(tmp_path / "ck")
    thier.run_hierarchy({k: v["port"] for k, v in levels.items()}, tcfg,
                        schedule=ts, checkpoint_dir=ck, resume=False)
    assert calls == [H // 2, H, H]
    for k in range(1, len(js) + 1):
        ref = jhier.run_hierarchy({k_: v["jax"] for k_, v in levels.items()},
                                  jcfg, schedule=js[:k])
        out = torch.load(os.path.join(ck, f"stage{k - 1}.pt"))
        d_ref, d_out = np.asarray(ref.depth), out["depth"].numpy()
        assert np.isfinite(d_out).all()
        share = _close(d_out, d_ref)
        assert share >= 0.99, (k, share)
    sc = levels[1]["sc"]
    assert _acc(d_out[0], sc.depth_gt) > 0.5


def test_checkpoint_resume_reproduces_the_run(levels, tmp_path):
    """Stopped after stage 1 and resumed, with random refinement on: the
    result equals the uninterrupted run's (stage generators are seeded by
    stage index)."""
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    cfg = TConfig(**dict(SMALL, random_iters=2, estimation_iters_external=1))
    sched = _stages(thier.Stage, cfg)
    tensors = {k: v["port"] for k, v in levels.items()}
    full = thier.run_hierarchy(tensors, cfg, schedule=sched,
                               checkpoint_dir=str(tmp_path / "ck"),
                               resume=False)
    ck2 = str(tmp_path / "ck2")
    thier.run_hierarchy(tensors, cfg, schedule=sched[:2], checkpoint_dir=ck2,
                        resume=False)
    resumed = thier.run_hierarchy(tensors, cfg, schedule=sched,
                                  checkpoint_dir=ck2, resume=True,
                                  verbose=True)
    np.testing.assert_allclose(resumed.depth.numpy(), full.depth.numpy(),
                               rtol=0, atol=1e-4)
    # a run that does not resume starts over and removes the old stages
    again = thier.run_hierarchy(tensors, cfg, schedule=sched[:1],
                                checkpoint_dir=ck2, resume=False)
    assert sorted(os.listdir(ck2)) == ["stage0.pt"]
    assert again.depth.shape == (N, H // 2, W // 2)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The 48x64 ridge scene as scene.mvs + PNGs."""
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene, write_ridge_scene
    root = tmp_path_factory.mktemp("hier")
    sc = make_ridge_scene(np.random.default_rng(4), h=H, w=W, n_views=N,
                          fx=180.0 * W / 192.0)
    scene_path, img_dir = write_ridge_scene(str(root), sc)
    return dict(sc=sc, root=root, scene_path=scene_path, img_dir=img_dir)


def _jax_tensors_by_height(scene_path, img_dir, cfg, levels):
    """The JAX package's per-level tensors as its densify_hierarchical
    builds them (without flows, which the init does not read)."""
    from hcmvs_tpu.io.images import (compute_resolution_scale, load_image,
                                     resize_image)
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.pipeline.densify import build_scene_tensors
    scene = read_mvs(scene_path)
    raw = [load_image(os.path.join(img_dir, im.name), gray=True)
           for im in scene.images]
    out = {}
    for lvl in levels:
        scale = compute_resolution_scale(raw[0].shape[1], raw[0].shape[0],
                                         lvl, cfg.max_resolution,
                                         cfg.min_resolution)
        jt = build_scene_tensors(scene, [resize_image(g, scale)
                                         for g in raw], cfg)
        out[jt.gray.shape[1]] = jt
    return out


def _jax_densify_hierarchical(*args, **kw):
    from hcmvs_tpu.pipeline.hierarchy import densify_hierarchical
    return densify_hierarchical(*args, verbose=False, **kw)


def test_densify_hierarchical_matches_jax(written, monkeypatch):
    """.mvs + PNGs in; .dmap files and the fused cloud out; A at level 1,
    then B and A at level 0, with Farneback flows (both packages' default)
    and the mid-schedule filter."""
    _check_hierarchical(written, monkeypatch, "farneback")


def test_densify_hierarchical_matches_jax_on_lk(written, monkeypatch):
    """The same on LK flows in both packages."""
    _check_hierarchical(written, monkeypatch, "lk")


def _check_hierarchical(written, monkeypatch, backend):
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline import hierarchy as jhier
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    kw = dict(SMALL, use_optical_flow=1, optimize=1)
    jcfg, tcfg = JConfig(**kw, **FORCED), TConfig(**kw)

    def sched(Stage, cfg):
        return [Stage(1, "A", cfg), Stage(0, "B", cfg), Stage(0, "A", cfg)]

    args = (written["scene_path"], written["img_dir"])
    out_dir = str(written["root"] / f"port_{backend}")
    with flow_backend(backend):
        ref = _jax_densify_hierarchical(
            *args, str(written["root"] / f"jax_{backend}"), jcfg,
            schedule=sched(jhier.Stage, jcfg))
        _patch_init(monkeypatch, _jax_tensors_by_height(*args, jcfg, (1, 0)))
        stats = thier.densify_hierarchical(*args, out_dir, tcfg,
                                           schedule=sched(thier.Stage, tcfg),
                                           verbose=False, device="cpu")
    gt = written["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.5, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    assert abs(stats["n_points"] - ref["n_points"]) \
        <= 0.02 * ref["n_points"]
    for i in range(N):
        dm = read_dmap(os.path.join(out_dir, "depthmap", f"depth{i:04d}.dmap"))
        assert np.array_equal(dm.depth, stats["depth"][i])
        assert dm.view_ids[0] == i
    pts, _ = read_ply(os.path.join(out_dir, "scene_dense.ply"))
    assert len(pts) == stats["n_points"] > 0
    assert sorted(os.listdir(os.path.join(out_dir, "stage_ckpt"))) \
        == ["stage0.pt", "stage1.pt", "stage2.pt"]


def test_densify_hierarchical_raises_for_unported(written, tmp_path):
    """Masks for a use_semantic stage and --priors-dir run the planar
    priors (once in each stage they reach; tests/test_torch_masks.py holds
    them against JAX); without a card the default device raises."""
    from hcmvs_tpu_torch.io.images import write_png
    from hcmvs_tpu_torch.pipeline.hierarchy import densify_hierarchical, main
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    from hcmvs_tpu_torch.utils.synth import write_ridge_prior
    args = (written["scene_path"], written["img_dir"], str(tmp_path / "o"))
    masks = tmp_path / "masks"
    masks.mkdir()
    for i, face in enumerate(written["sc"].faces):
        write_png(str(masks / f"im{i:04d}.png"),
                  (face.astype(np.uint16) + 1) * 500)
    quick = ["--flags", "min-resolution=0", "n-EstimationIters=1",
             "n-EstimationIters-external=2", "n-adapthalfwin=3"]
    reset_report()
    stats = main(["--input-file", args[0], "--images-dir", args[1], "-w",
                  args[2], "--device", "cpu", "--no-resume", "--masks-dir",
                  str(masks), *quick])
    # the default schedule's restore stages and last stage use the masks
    assert report()["stage.priors"]["calls"] == 3
    assert stats["valid_frac"] > 0.3
    write_ridge_prior(str(tmp_path / "priors"), written["sc"], 1)
    reset_report()
    stats = main(["--input-file", args[0], "--images-dir", args[1], "-w",
                  args[2], "--device", "cpu", "--no-resume", "--priors-dir",
                  str(tmp_path / "priors"), *quick])
    # the external channel starts the pass in every stage
    assert report()["stage.priors"]["calls"] == 5
    assert stats["valid_frac"] > 0.3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            densify_hierarchical(*args)


def compare_at(h: int, w: int, which=("jax", "port"),
               external_iters=None) -> None:
    """Both packages' densify_hierarchical at DenseConfig() on an h x w,
    4-view ridge scene (the JAX package with the volume / rect backends,
    as the parity tests force them; ``external_iters`` sets both
    packages' n-EstimationIters-external, as chip_smoke.py's HIER_FLAGS
    does); prints what chip_smoke.py's hierarchy gate rests on: view 0's
    accuracy against the ground truth at the last stage's size."""
    import tempfile
    import time
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline.hierarchy import densify_hierarchical
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn,
                                             write_ridge_scene)

    def ridge(hh, ww, textured=True):
        tex = sinusoid_texture_fn(np.random.default_rng(12345)) \
            if textured else (lambda xy: np.zeros(xy.shape[:-1], np.float32))
        return make_ridge_scene(np.random.default_rng(0), h=hh, w=ww,
                                n_views=4, fx=180.0 * ww / 192.0,
                                texture_fn=tex)

    extra = ({} if external_iters is None
             else dict(estimation_iters_external=external_iters))
    sc = ridge(h, w)
    with tempfile.TemporaryDirectory() as root:
        scene_path, img_dir = write_ridge_scene(root, sc)
        runs = [("jax", lambda d: _jax_densify_hierarchical(
                    scene_path, img_dir, d, JConfig(**FORCED, **extra))),
                ("port", lambda d: densify_hierarchical(
                    scene_path, img_dir, d, TConfig(**extra), verbose=False,
                    device="cpu"))]
        for name, run in runs:
            if name not in which:
                continue
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            st = run(out)
            sec = time.perf_counter() - t0
            pts, _ = read_ply(os.path.join(out, "scene_dense.ply"))
            d0 = st["depth"][0]
            gt = ridge(*d0.shape, textured=False).depth_gt
            dist = np.median(sc.surface_dist(pts.astype(np.float64)))
            print(f"{name} {h}x{w} (depth {d0.shape[0]}x{d0.shape[1]}): "
                  f"depth_acc_2pct {_acc(d0, gt):.4f}, valid "
                  f"{st['valid_frac']:.4f}, points {st['n_points']}, "
                  f"cloud distance / median depth "
                  f"{dist / np.median(gt):.5f}, {sec:.1f} s", flush=True)


if __name__ == "__main__":
    # python tests/test_torch_hierarchy.py H W [jax|port] [external=N]
    import jax
    jax.config.update("jax_platforms", "cpu")
    opts = sys.argv[3:]
    ext = [int(a.split("=")[1]) for a in opts if a.startswith("external=")]
    compare_at(int(sys.argv[1]), int(sys.argv[2]),
               [a for a in opts if a in ("jax", "port")] or ("jax", "port"),
               ext[0] if ext else None)
