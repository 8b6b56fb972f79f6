"""Golden end-to-end quality gate (port of ``hcmvs_tpu/eval/golden.py``).

One command running the whole pipeline (SfM from images -> dense ->
surface) on a synthetic ridge scene with known ground truth, printing one
JSON line of quality metrics with the JAX package's keys:

    python -m hcmvs_tpu_torch.eval.golden [--device cpu]
    python -m hcmvs_tpu_torch.eval.golden --hierarchy
    python -m hcmvs_tpu_torch.eval.golden --full-stack --fx 180

Metrics of ``run``:
  ate_rmse        trajectory error of the SfM poses (similarity-aligned)
  sfm_rms_px      frozen-pose reprojection RMS (pose quality)
  depth_acc_2pct  share of valid dense-depth pixels within 2% of the truth
                  (dense with the ground-truth poses)
  cloud_dist      median distance of the fused points to the surface
  mesh_fscore     graph-cut mesh of the fused cloud against the surface
``run_hierarchy`` (``--hierarchy``, ``--full-stack``): the hierarchical
schedule on the SfM poses, depth accuracy after median-scale alignment.

``HCMVS_GOLDEN_CFG`` (JSON of DenseConfig overrides) and
``HCMVS_GOLDEN_SFM`` (JSON of SfMConfig overrides, ``run_hierarchy``)
are the JAX package's A/B hooks.  Everything runs on the card unless
``device="cpu"`` is asked for.  Unlike the JAX package, a failing mesh
step raises (the JAX package reports ``mesh_fscore`` -1.0).  The random
draws (SfM RANSACs, PatchMatch) are the port's own, seeded with 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np


def _env_cfg(cfg):
    """A/B hook: HCMVS_GOLDEN_CFG = JSON dict of DenseConfig overrides
    (not set in production runs)."""
    ov = os.environ.get("HCMVS_GOLDEN_CFG")
    return cfg.replace(**json.loads(ov)) if ov else cfg


def _golden_sfm_cfg():
    from hcmvs_tpu_torch.sfm.incremental import SfMConfig
    return SfMConfig(max_keypoints=512, min_matches=20, min_pnp_inliers=10,
                     ba_every=2)


def mesh_fscore(cloud: dict, sc) -> float:
    """Graph-cut mesh of 4,000 fused points (with their view lists) against
    8,000 ground-truth samples of view 0, at twice the subsampled cloud's
    point spacing (the JAX package's golden mesh gate)."""
    from scipy.spatial import cKDTree
    from hcmvs_tpu_torch.eval.compare import point_cloud_fscore
    from hcmvs_tpu_torch.mesh.delaunay import reconstruct_mesh
    from hcmvs_tpu_torch.mesh.mesh_ops import sample_points
    sub = np.random.default_rng(1).permutation(len(cloud["points"]))[:4000]
    pts = cloud["points"][sub].astype(np.float64)
    offs = np.concatenate([[0], np.cumsum(cloud["view_counts"])])
    obs_pt, obs_cam, obs_w = [], [], []
    for ci, p in enumerate(sub):
        for k in range(offs[p], offs[p + 1]):
            obs_pt.append(ci)
            obs_cam.append(cloud["view_ids"][k])
            obs_w.append(max(cloud["view_confs"][k], 0.1))
    centers = np.stack([c.C.numpy() for c in sc.cameras])
    mesh = reconstruct_mesh(pts, centers, cloud["owner_view"][sub],
                            obs_pt=np.asarray(obs_pt),
                            obs_cam=np.asarray(obs_cam),
                            obs_weight=np.asarray(obs_w))
    samples, _ = sample_points(mesh.vertices, mesh.faces, 8000)
    # ground-truth surface samples: view 0's depth backprojected
    k0 = sc.cameras[0].K.numpy().astype(np.float64)
    hh, ww = sc.depth_gt.shape
    vv, uu = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    sel = np.random.default_rng(2).permutation(hh * ww)[:8000]
    rays = np.linalg.inv(k0) @ np.stack(
        [uu.ravel()[sel], vv.ravel()[sel], np.ones(len(sel))])
    gt_pts = (rays * sc.depth_gt.ravel()[sel]).T
    h_sub = float(np.median(cKDTree(pts).query(pts, k=2)[0][:, 1]))
    return point_cloud_fscore(samples, gt_pts, 2.0 * h_sub)["fscore"]


def run(h: int = 144, w: int = 192, n_views: int = 5, seed: int = 0,
        verbose: bool = False, fx: float = None, device="cuda") -> dict:
    import torch
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.dense.fusion import (compact_point_cloud,
                                              fuse_point_cloud)
    from hcmvs_tpu_torch.dense.scene_driver import (SceneTensors,
                                                    estimate_scene, finalize)
    from hcmvs_tpu_torch.eval.pose_eval import (ate,
                                                structure_from_known_poses)
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    from hcmvs_tpu_torch.sfm.incremental import incremental_sfm
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if fx is None:      # FOV-preserving focal scaling (the JAX package's)
        fx = 180.0 * w / 192.0
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=fx)
    K = sc.cameras[0].K.numpy().astype(np.float64)

    # --- SfM from pixels ---
    result = incremental_sfm([im.astype(np.float32) for im in sc.images], K,
                             _golden_sfm_cfg(), verbose=verbose, device=dev)
    gt_C = np.stack([c.C.numpy() for c in sc.cameras])
    reg = sorted(result.poses)
    est_C = np.stack([result.poses[i][1] for i in reg])
    pose_stats = ate(est_C, gt_C[reg])
    sfm_rms = structure_from_known_poses(result, K, device=dev)

    # --- dense with the ground-truth poses (dense quality alone) ---
    f32 = torch.float32
    cams = Camera(K=torch.stack([c.K for c in sc.cameras]).to(dev, f32),
                  R=torch.stack([c.R for c in sc.cameras]).to(dev, f32),
                  C=torch.stack([c.C for c in sc.cameras]).to(dev, f32))
    v = min(3, n_views - 1)
    nbr = np.array([[j for j in range(n_views) if j != i][:v]
                    for i in range(n_views)], np.int64)
    zs = sc.depth_gt[sc.depth_gt > 0]
    scene = SceneTensors(
        gray=torch.as_tensor(np.stack(sc.images), device=dev),
        cams=cams, nbr_idx=torch.as_tensor(nbr, device=dev),
        nbr_valid=torch.ones((n_views, v), dtype=torch.bool, device=dev),
        d_min=torch.full((n_views,), float(zs.min()) * 0.7, dtype=f32,
                         device=dev),
        d_max=torch.full((n_views,), float(zs.max()) * 1.4, dtype=f32,
                         device=dev))
    cfg = _env_cfg(DenseConfig(
        adapt_half_window=5, patch_half_window=3, patch_step=2,
        estimation_iters=2, estimation_iters_external=3, photo2geo=1,
        random_iters=3, use_optical_flow=0, use_geo_consistency=1,
        use_part_consistency=0, optimize=0))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = estimate_scene(gen, scene, cfg, verbose=verbose)
    depth, normal, conf = finalize(state, cfg)
    d0 = depth[0].cpu().numpy()
    valid = (d0 > 0) & (sc.depth_gt > 0)
    rel = np.abs(d0 - sc.depth_gt) / np.maximum(sc.depth_gt, 1e-9)
    depth_acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))

    fused = fuse_point_cloud(depth, normal,
                             torch.clamp_min(1.0 - state.cost, 0.01),
                             scene.cams, scene.nbr_idx, scene.nbr_valid,
                             torch.arange(n_views, dtype=f32, device=dev),
                             cfg)
    cloud = compact_point_cloud(fused, nbr_idx=scene.nbr_idx, confs=conf)
    dist = (float(np.median(sc.surface_dist(cloud["points"])))
            if len(cloud["points"]) else float("inf"))

    # surface F-score gate: graph-cut mesh from the fused multi-view
    # cloud (ETH3D / T&T-style metric); a failure raises
    fscore = mesh_fscore(cloud, sc) if len(cloud["points"]) > 100 else 0.0

    return {"ate_rmse": round(pose_stats["rmse"], 5),
            "sfm_rms_px": round(sfm_rms, 3),
            "depth_acc_2pct": round(depth_acc, 3),
            "cloud_dist": round(dist, 5),
            "mesh_fscore": round(fscore, 3),
            "n_points": len(cloud["points"]),
            "registered": len(reg), "views": n_views}


def run_hierarchy(h: int = 144, w: int = 192, n_views: int = 5,
                  seed: int = 0, fx: float = None,
                  full_stack: bool = False, sweep_mult: int = 1,
                  ablate: str = "", device="cuda") -> dict:
    """The product path: SfM poses (not the ground truth) -> scene.mvs ->
    3-stage hierarchical-cross densification (5 stages with the priors,
    view spread, the mid-schedule filter and part consistency under
    ``full_stack``; ``ablate``: a comma list of those to turn back off,
    priors / viewspread / optimize / part); depth accuracy after
    median-scale alignment (the SfM scale is arbitrary)."""
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.io.images import write_png
    from hcmvs_tpu_torch.io.mvs import write_mvs
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    from hcmvs_tpu_torch.pipeline.hierarchy import (Stage,
                                                    densify_hierarchical)
    from hcmvs_tpu_torch.sfm.incremental import incremental_sfm, sfm_to_scene
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if fx is None:
        fx = 180.0 * w / 192.0
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=fx)
    K = sc.cameras[0].K.numpy().astype(np.float64)
    sfm_cfg = _golden_sfm_cfg()
    sfm_ov = os.environ.get("HCMVS_GOLDEN_SFM")   # A/B hook
    if sfm_ov:
        sfm_cfg = dataclasses.replace(sfm_cfg, **json.loads(sfm_ov))
    res = incremental_sfm([im.astype(np.float32) for im in sc.images], K,
                          sfm_cfg, device=dev)
    cfg = _env_cfg(DenseConfig(
        adapt_half_window=5, patch_half_window=3, patch_step=2,
        estimation_iters=2 * sweep_mult, estimation_iters_external=2,
        photo2geo=1, random_iters=3, use_optical_flow=0,
        use_geo_consistency=1, use_part_consistency=0, optimize=0,
        resolution_level=0, min_resolution=0, use_semantic=False))
    if full_stack:
        off = set(ablate.split(",")) if ablate else set()
        cfg = cfg.replace(
            use_semantic="priors" not in off,
            view_spread=0 if "viewspread" in off else 1,
            optimize=0 if "optimize" in off else 1,
            estimation_iters_external=3,
            use_part_consistency=0 if "part" in off else 1)
    a = cfg.replace(init_triangulate=0)
    b = cfg.replace(init_triangulate=1, use_geo_consistency=0, photo2geo=99)
    if full_stack:
        sched = [Stage(level=2, variant="A", cfg=a),
                 Stage(level=1, variant="B", cfg=b),
                 Stage(level=1, variant="A", cfg=a),
                 Stage(level=0, variant="B", cfg=b),
                 Stage(level=0, variant="A", cfg=a)]
    else:
        sched = [Stage(level=1, variant="A", cfg=a),
                 Stage(level=0, variant="B", cfg=b),
                 Stage(level=0, variant="A", cfg=a)]
    with tempfile.TemporaryDirectory(prefix="hcmvs_golden_") as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        names = [f"im{i:04d}.png" for i in range(n_views)]
        for name, im in zip(names, sc.images):
            write_png(os.path.join(img_dir, name),
                      (im * 255).astype(np.uint8))
        scene_path = os.path.join(tmp, "scene.mvs")
        write_mvs(scene_path, sfm_to_scene(res, K, names, w, h))
        stats = densify_hierarchical(scene_path, img_dir,
                                     os.path.join(tmp, "out"), cfg,
                                     schedule=sched, verbose=False,
                                     device=dev)
    d0 = stats["depth"][0]
    gt = sc.depth_gt
    valid = (d0 > 0) & (gt > 0)
    scale = np.median(gt[valid] / d0[valid])
    rel = np.abs(d0 * scale - gt) / gt
    acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))
    return {"hier_depth_acc_2pct": round(acc, 3),
            "valid_frac": round(float(valid.mean()), 3),
            "n_points": stats["n_points"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hierarchy", action="store_true")
    ap.add_argument("--full-stack", action="store_true",
                    help="5-stage schedule + priors + view-spread + "
                         "filter (the wide-FOV saturation experiment)")
    ap.add_argument("--h", type=int, default=144)
    ap.add_argument("--w", type=int, default=192)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--sweep-mult", type=int, default=1)
    ap.add_argument("--ablate", default="",
                    help="full-stack components to disable "
                         "(priors,viewspread,optimize,part)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must "
                         "be asked for)")
    args = ap.parse_args(argv)
    if args.hierarchy or args.full_stack:
        out = run_hierarchy(h=args.h, w=args.w, n_views=args.views,
                            fx=args.fx, full_stack=args.full_stack,
                            sweep_mult=args.sweep_mult, ablate=args.ablate,
                            device=args.device)
    else:
        out = run(h=args.h, w=args.w, n_views=args.views, fx=args.fx,
                  device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
