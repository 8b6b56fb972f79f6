"""PyTorch port vs the JAX package: the hierarchical-cross schedule with
semantic masks and external prior maps.

- ``run_hierarchy`` (A / B / A over two levels at 24x32 and 48x64, the B
  stage and the last A with ``use_semantic``) on the ridge scene with its
  face map as the masks, each stage from the JAX package's maps of the
  stage before (resumed from a checkpoint of them), with JAX's per-stage
  init (``fold_in(PRNGKey(0), stage)``, as tests/test_torch_hierarchy.py
  feeds it) and its RANSAC draws: depth within 1e-3 on >= 99% of pixels
  after every stage; the whole schedule from the first stage: view 0's
  accuracy within 0.03 of JAX's.  The B stage at ``photo2geo`` 99 (the
  default schedule's: the prior is computed and has no effect) and 1.
- ``densify_hierarchical`` from files (48x64 ridge scene, 16-bit masks
  beside the images, ``--priors-dir``): view 0's accuracy and the valid
  share within 0.03 of JAX's, the point count within 2%.

Where flows are on, both packages compute Farneback flow, each one's
default.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_masks import (FORCED, SMALL, _acc, _close, _jax_call,
                              _patch_draws, _written_ridge)

torch.set_num_threads(1)


def _hier_levels():
    """The ridge scene at 48x64 (level 1) and 24x32 (level 2), 3 views, as
    the JAX package's SceneTensors with the faces as semantic labels, and
    the port's copies."""
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera as JCamera
    from hcmvs_tpu.dense.scene_driver import SceneTensors as JTensors
    from hcmvs_tpu_torch.convert import scene_from_numpy
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    n, out = 3, {}
    for lvl, (h, w) in ((2, (24, 32)), (1, (48, 64))):
        sc = make_ridge_scene(np.random.default_rng(4), h=h, w=w, n_views=n,
                              fx=180.0 * w / 192.0)
        nbr = np.array([[j for j in range(n) if j != i] for i in range(n)],
                       np.int32)
        jt = JTensors(
            gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
            cams=JCamera(*(jnp.stack([jnp.asarray(getattr(c, f).numpy())
                                      for c in sc.cameras]) for f in "KRC")),
            nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((n, n - 1), bool),
            d_min=jnp.full((n,), 0.9 * sc.depth_gt.min(), jnp.float32),
            d_max=jnp.full((n,), 1.1 * sc.depth_gt.max(), jnp.float32),
            semantic=jnp.asarray(np.stack(sc.faces).astype(np.int32)))
        out[lvl] = dict(sc=sc, jax=jt, port=scene_from_numpy(jt,
                                                             device="cpu"))
    return out


def _patch_init(monkeypatch, jax_by_height, first_stage=0):
    """Stage ``si``'s init is the JAX package's ``fold_in(PRNGKey(0),
    si)`` on its tensors of the same height (as in
    tests/test_torch_hierarchy.py); the first init is stage
    ``first_stage``'s."""
    import jax
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu_torch.convert import state_from_numpy
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    calls = []

    def init(gen, tensors):
        key = jax.random.fold_in(jax.random.PRNGKey(0),
                                 first_stage + len(calls))
        calls.append(tensors.gray.shape[1])
        return state_from_numpy(jsd.init_scene_state(
            key, jax_by_height[tensors.gray.shape[1]]), device="cpu")

    monkeypatch.setattr(thier, "init_scene_state", init)
    return calls


def _stages(Stage, cfg, b_photo2geo):
    a = cfg.replace(init_triangulate=0, use_geo_consistency=1, photo2geo=1,
                    use_semantic=False)
    b = cfg.replace(init_triangulate=1, use_geo_consistency=0,
                    photo2geo=b_photo2geo, use_semantic=True)
    return [Stage(level=2, variant="A", cfg=a),
            Stage(level=1, variant="B", cfg=b),
            Stage(level=1, variant="A", cfg=a.replace(use_semantic=True))]


@pytest.mark.parametrize("b_photo2geo", [99, 1])
def test_masked_hierarchy_matches_jax(monkeypatch, tmp_path, b_photo2geo):
    """Each stage from the JAX package's maps of the stage before
    (resumed from a checkpoint of them), compared with its run; then the
    whole schedule, whose last stage's accuracy is held within 0.03 of
    JAX's (differences carried through three stages).  With the B stage
    at photo2geo 99 (the default schedule's) its prior is computed and has
    no effect; at 1 it acts there too."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline import hierarchy as jhier
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    kw = dict(SMALL, use_optical_flow=0, optimize=0)
    jcfg, tcfg = JConfig(**kw, **FORCED), TConfig(**kw)
    levels = _hier_levels()
    js = _stages(jhier.Stage, jcfg, b_photo2geo)
    ts = _stages(thier.Stage, tcfg, b_photo2geo)
    by_height = {lv["jax"].gray.shape[1]: lv["jax"] for lv in levels.values()}
    port = {k: v["port"] for k, v in levels.items()}
    # the JAX package's result after each stage, from one run
    refs, run_stage = [], jhier._run_stage
    with monkeypatch.context() as mp:
        mp.setattr(jhier, "_run_stage",
                   lambda *a: refs.append(run_stage(*a)) or refs[-1])
        jhier.run_hierarchy({k: v["jax"] for k, v in levels.items()}, jcfg,
                            schedule=js)
    assert len(refs) == len(js)
    draws = _patch_draws(monkeypatch)
    for si in range(len(ts)):
        ck = tmp_path / f"from{si}"
        ck.mkdir()
        if si:
            prev = refs[si - 1]
            torch.save({f: torch.from_numpy(np.array(getattr(prev, f)))
                        for f in ("depth", "normal", "cost")},
                       str(ck / f"stage{si - 1}.pt"))
        with monkeypatch.context() as mp:
            _patch_init(mp, by_height, first_stage=si)
            out = thier.run_hierarchy(port, tcfg, schedule=ts[:si + 1],
                                      checkpoint_dir=str(ck), resume=True)
        d_ref, d_out = np.asarray(refs[si].depth), out.depth.numpy()
        assert np.isfinite(d_out).all()
        share = _close(d_out, d_ref)
        assert share >= 0.99, (si, share)
    # the prior pass once in each use_semantic stage, at its size
    assert draws == [(48, 64), (48, 64)]
    del draws[:]
    reset_report()
    _patch_init(monkeypatch, by_height)
    out = thier.run_hierarchy(port, tcfg, schedule=ts,
                              checkpoint_dir=str(tmp_path / "all"),
                              resume=False)
    assert draws == [(48, 64), (48, 64)]
    assert report()["stage.priors"]["calls"] == 2
    gt = levels[1]["sc"].depth_gt
    acc_t = _acc(out.depth[0].numpy(), gt)
    acc_j = _acc(np.asarray(refs[-1].depth[0]), gt)
    assert acc_t > 0.5 and abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)


def test_masked_densify_hierarchical_matches_jax(tmp_path, monkeypatch):
    """From files (the written ridge scene at 48x64): masks beside the
    images and --priors-dir, A at level 1, then B and A at level 0 with
    use_semantic and Farneback flows."""
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline import hierarchy as jhier
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.pipeline import hierarchy as thier
    kw = dict(SMALL, optimize=0)
    jcfg, tcfg = JConfig(**kw, **FORCED), TConfig(**kw)

    def sched(Stage, cfg):
        return [Stage(1, "A", cfg.replace(use_semantic=False)),
                Stage(0, "B", cfg.replace(photo2geo=99)), Stage(0, "A", cfg)]

    ridge = _written_ridge(tmp_path, 48, 64)
    h, w = ridge["h"], ridge["w"]
    args = (ridge["scene_path"], ridge["img_dir"])
    ref = _jax_call(jhier.densify_hierarchical, *args,
                    str(ridge["root"] / "hjax"), jcfg,
                    schedule=sched(jhier.Stage, jcfg),
                    priors_dir=ridge["priors"])
    _patch_init(monkeypatch, _jax_tensors_by_height(ridge, jcfg, (1, 0)))
    draws = _patch_draws(monkeypatch)
    stats = thier.densify_hierarchical(
        *args, str(ridge["root"] / "hport"), tcfg,
        schedule=sched(thier.Stage, tcfg), priors_dir=ridge["priors"],
        verbose=False, device="cpu")
    # the external channel starts the pass in every stage; the masks
    # join it in the use_semantic ones
    assert draws == [(h // 2, w // 2), (h, w), (h, w)]
    gt = ridge["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.8, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    assert abs(stats["n_points"] - ref["n_points"]) \
        <= 0.02 * ref["n_points"]


def _jax_tensors_by_height(ridge, cfg, levels):
    """The JAX package's per-level tensors as its densify_hierarchical
    builds them (masks included, no flows: the init does not read
    them)."""
    from hcmvs_tpu.io.images import (compute_resolution_scale, load_image,
                                     resize_image)
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.pipeline.densify import (build_scene_tensors,
                                            find_scene_masks,
                                            load_scene_masks)
    scene = read_mvs(ridge["scene_path"])
    raw = [load_image(os.path.join(ridge["img_dir"], im.name), gray=True)
           for im in scene.images]
    paths = find_scene_masks(scene, ridge["img_dir"])
    out = {}
    for lvl in levels:
        scale = compute_resolution_scale(raw[0].shape[1], raw[0].shape[0],
                                         lvl, cfg.max_resolution,
                                         cfg.min_resolution)
        grays = [resize_image(g, scale) for g in raw]
        jt = build_scene_tensors(scene, grays, cfg, semantic=load_scene_masks(
            paths, grays[0].shape))
        out[jt.gray.shape[1]] = jt
    return out
