"""The hierarchical-cross schedule: multi-level, alternating-variant dense
reconstruction (PyTorch port of ``hcmvs_tpu/pipeline/hierarchy.py``).

Replaces the reference's run.sh orchestration (frame_main@resize3 ->
restore@resize2 -> frame_main@resize2 -> restore@resize1 ->
frame_main@resize1, with ``mv depthmap normalmap`` between stages) and the
per-stage flag sets (data/*/resize*/run.py) with one driver: each stage's
maps stay on the device and enter the next stage upsampled, either as its
initial hypotheses (variant A, "read-init"; ref: frame_main InitDepthMap,
SceneDensify.cpp:522-558) or through the cross-scale channels of variant
B ("restore"): the prior term (ref: restore/libs/MVS/
SceneDensify.cpp:500-533) and the 0.1-bonus hypothesis injection at the
last iteration (ref: restore/DepthMap.cpp:1527-1549).

    python -m hcmvs_tpu_torch.pipeline.hierarchy --input-file scene.mvs \\
        -w out [--flags n-EstimationIters=2 ...] [--device cpu]

Every level's scene tensors are built from the base configuration, as in
the JAX package, so a stage's own ``init_triangulate`` does not change
its seeds; only ``--flags n-initTriangulate=1`` does.  Semantic masks
(found as the densify app finds them, when a stage runs ``use_semantic``:
the default's restore stages and last stage) and ``--priors-dir`` maps
are read at every level's size; in each stage they start the planar-prior
pass once, before external iteration max(n - 2, 1), whose maps replace
the stage's cross-scale prior (the JAX package's ``_run_stage``).  The
prior acts only in a geometric phase, so in the default's restore stages
(``photo2geo=99``) it is computed and has no effect, as in the JAX
package; it acts in the last stage.  Stage results are checkpointed as
``torch.save`` files under ``<out>/stage_ckpt/`` and a rerun resumes
after the last completed stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hcmvs_tpu_torch.core.config import DenseConfig, config_from_cli_flags
from hcmvs_tpu_torch.dense.fusion import compact_point_cloud, fuse_point_cloud
from hcmvs_tpu_torch.dense.scene_driver import (SceneState, SceneTensors,
                                                estimate_scene, finalize,
                                                init_scene_state)
from hcmvs_tpu_torch.io.dmap import DepthMapData, write_dmap
from hcmvs_tpu_torch.io.images import (compute_resolution_scale, load_image,
                                       resize_image)
from hcmvs_tpu_torch.io.mvs import read_mvs
from hcmvs_tpu_torch.io.ply import write_ply_points
from hcmvs_tpu_torch.pipeline.densify import (build_scene_tensors,
                                              find_scene_masks,
                                              load_prior_maps,
                                              load_scene_masks,
                                              resolve_device)
from hcmvs_tpu_torch.utils.profiling import log_report, stage_timer


@dataclasses.dataclass(frozen=True)
class Stage:
    """One hierarchical-cross stage (one run.py invocation)."""

    level: int           # resolution level (3 = coarsest)
    variant: str         # "A" (frame_main) | "B" (restore)
    cfg: DenseConfig


def default_schedule(base: DenseConfig) -> List[Stage]:
    """The 5-stage schedule of run.sh with each stage's flag profile (ref:
    data/frame_main/resize{3,2,1}/run.py, data/restore/resize{2,1}/run.py:
    frame_main stages run geometric consistency with read-init, restore
    stages triangulate-init without geo)."""
    a = base.replace(init_triangulate=0, use_geo_consistency=1,
                     photo2geo=1)
    b = base.replace(init_triangulate=1, use_geo_consistency=0,
                     photo2geo=99, use_semantic=True)
    return [
        Stage(level=3, variant="A", cfg=a),
        Stage(level=2, variant="B", cfg=b),
        Stage(level=2, variant="A", cfg=a),
        Stage(level=1, variant="B", cfg=b),
        Stage(level=1, variant="A", cfg=a.replace(use_semantic=True)),
    ]


def _resize_maps(depth: torch.Tensor, normal: torch.Tensor, h: int, w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resize (N, H0, W0) depth and (N, 3, H0, W0) normals to (h, w),
    bilinear with half-pixel centres as ``jax.image.resize`` does
    (antialiased when shrinking), normals renormalised."""
    h0, w0 = depth.shape[1:]
    aa = h < h0 or w < w0
    d = F.interpolate(depth[:, None], size=(h, w), mode="bilinear",
                      align_corners=False, antialias=aa)[:, 0]
    nm = F.interpolate(normal, size=(h, w), mode="bilinear",
                       align_corners=False, antialias=aa)
    nm = nm / torch.clamp_min(torch.linalg.vector_norm(nm, dim=1,
                                                       keepdim=True), 1e-9)
    return d, nm


def stage_generator(seed: int, si: int, device) -> torch.Generator:
    """Stage ``si``'s generator, seeded from (seed, si) alone, so a resumed
    run draws what the uninterrupted one drew."""
    state = np.random.SeedSequence([seed, si]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2 ** 63 - 1))


def _checkpoint_path(checkpoint_dir: str, si: int) -> str:
    return os.path.join(checkpoint_dir, f"stage{si}.pt")


def _last_checkpoint(checkpoint_dir: str) -> Optional[int]:
    found = [int(m.group(1)) for p in glob.glob(
        os.path.join(checkpoint_dir, "stage*.pt"))
        for m in [re.fullmatch(r"stage(\d+)\.pt", os.path.basename(p))] if m]
    return max(found) if found else None


def run_hierarchy(tensors_per_level: Dict[int, SceneTensors],
                  base_cfg: DenseConfig,
                  schedule: Optional[List[Stage]] = None, seed: int = 0,
                  checkpoint_dir: Optional[str] = None, resume: bool = True,
                  verbose: bool = False) -> SceneState:
    """Run the alternating multi-level schedule.

    ``tensors_per_level`` maps a resolution level to the scene tensors at
    that level's image size (``pipeline.densify.build_scene_tensors`` on
    resized images).  With ``checkpoint_dir`` every stage's result (depth,
    normal, cost) is saved there, and ``resume`` restarts after the last
    saved stage (without it, earlier files are removed first).  Each stage
    runs ``estimate_scene``'s external schedule from its initial state
    (the JAX package's ``_run_stage``: the cross-scale injection at the
    last iteration of a restore stage, and the planar-prior pass, timed
    as ``stage.priors``, whose maps replace the cross-scale prior), timed
    into ``utils.profiling``'s report as ``hierarchy.stage{si}``.
    """
    schedule = schedule or default_schedule(base_cfg)
    state = None
    prev_maps = None     # (depth, normal) of the previous stage
    start_stage = 0
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        latest = _last_checkpoint(checkpoint_dir)
        if not resume:
            for si in range((latest or 0) + 1):
                if os.path.exists(_checkpoint_path(checkpoint_dir, si)):
                    os.remove(_checkpoint_path(checkpoint_dir, si))
        elif latest is not None and latest < len(schedule):
            dev = tensors_per_level[schedule[latest].level].gray.device
            saved = torch.load(_checkpoint_path(checkpoint_dir, latest),
                               map_location=dev)
            state = SceneState(depth=saved["depth"], normal=saved["normal"],
                               cost=saved["cost"])
            prev_maps = (state.depth, state.normal)
            start_stage = latest + 1
            if verbose:
                print(f"[hierarchy] resumed after stage {latest}")
    for si, stage in enumerate(schedule):
        if si < start_stage:
            continue
        tensors = tensors_per_level[stage.level]
        h, w = tensors.gray.shape[1:]
        dev = tensors.gray.device
        gen = stage_generator(seed, si, dev)
        with stage_timer(f"hierarchy.stage{si}", block_on=dev):
            if prev_maps is None:
                state = init_scene_state(gen, tensors)
            else:
                d_up, n_up = _resize_maps(*prev_maps, h, w)
                if stage.variant == "A":
                    # read-init: the previous maps are the starting
                    # hypotheses where they exist
                    st0 = init_scene_state(gen, tensors)
                    state = SceneState(
                        depth=torch.where(d_up > 0, d_up, st0.depth),
                        normal=torch.where((d_up > 0)[:, None], n_up,
                                           st0.normal),
                        cost=st0.cost)
                else:
                    # restore: the seeded init, and the previous maps
                    # through the prior and the injection, each gated by
                    # its knob
                    updates = {}
                    if stage.cfg.cross_scale_prior:
                        updates["prior_depth"] = d_up
                    if stage.cfg.cross_scale_inject:
                        updates["inject_depth"] = d_up
                        updates["inject_normal"] = n_up
                    tensors = dataclasses.replace(tensors, **updates)
                    state = init_scene_state(gen, tensors)
            state = estimate_scene(gen, tensors, stage.cfg, verbose,
                                   init=state, replace_prior=True)
        prev_maps = (state.depth, state.normal)
        if checkpoint_dir is not None:
            path = _checkpoint_path(checkpoint_dir, si)
            torch.save({"depth": state.depth, "normal": state.normal,
                        "cost": state.cost}, path + ".tmp")
            os.replace(path + ".tmp", path)
        if verbose:
            print(f"[hierarchy] stage {si} (level {stage.level}, variant "
                  f"{stage.variant}) done")
    return state


def densify_hierarchical(scene_path: str, images_dir: str, out_dir: str,
                         base_cfg: Optional[DenseConfig] = None,
                         schedule: Optional[List[Stage]] = None,
                         resume: bool = True, verbose: bool = True,
                         masks_dir: Optional[str] = None,
                         priors_dir: Optional[str] = None,
                         device="cuda") -> dict:
    """Hierarchical-cross densification of a ``.mvs`` scene, the run.sh
    top-level entry (ref: run.sh:1-20): builds the
    per-level scene tensors from resized images, runs the schedule with
    stage checkpoints, and writes the final ``depthmap/depth%04d.dmap``
    maps and the fused ``scene_dense.ply``.  ``masks_dir`` and
    ``priors_dir`` as in ``pipeline.densify.densify`` (masks are read
    when a stage runs ``use_semantic``).  ``device``: where the tensors
    live ("cuda" by default; "cpu" must be asked for)."""
    base_cfg = base_cfg or DenseConfig()
    schedule = schedule or default_schedule(base_cfg)
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = read_mvs(scene_path)
    n = len(scene.images)
    # masks feed the RANSAC planar priors of the use_semantic stages (the
    # reference's last stage: --use-semantic 1, data/frame_main/resize1/
    # run.py)
    mask_paths = (find_scene_masks(scene, images_dir, masks_dir)
                  if any(s.cfg.use_semantic for s in schedule) else None)
    if verbose and mask_paths is not None:
        print(f"[hierarchy] semantic masks on "
              f"{sum(p is not None for p in mask_paths)}/{n} images")
    raw = []
    for im in scene.images:
        path = im.name if os.path.isabs(im.name) else os.path.join(
            images_dir, os.path.basename(im.name))
        raw.append(load_image(path, gray=True))

    levels = sorted({s.level for s in schedule}, reverse=True)
    tensors_per_level: Dict[int, SceneTensors] = {}
    with stage_timer("hierarchy.build_levels", block_on=dev, log=verbose):
        for lvl in levels:
            scale = compute_resolution_scale(
                raw[0].shape[1], raw[0].shape[0], lvl,
                base_cfg.max_resolution, base_cfg.min_resolution)
            grays = [resize_image(g, scale) for g in raw]
            flows = None
            if base_cfg.use_optical_flow:
                # per-level ref -> best-neighbour flows (ref: InitViews
                # flow, SceneDensify.cpp:404-508), at every stage
                from hcmvs_tpu_torch.dense.flow import scene_flows
                from hcmvs_tpu_torch.dense.view_selection import (
                    pair_scores, select_neighbors)
                centers = np.stack([scene.pose_of(i)[1] for i in range(n)])
                score = pair_scores(scene.points, scene.point_view_counts,
                                    scene.point_view_ids, centers, n)
                nbr1, _ = select_neighbors(score, 1)
                with stage_timer("hierarchy.flows", block_on=dev):
                    flows = scene_flows(torch.as_tensor(np.stack(grays),
                                                        device=dev), nbr1)
            semantic = (None if mask_paths is None
                        else load_scene_masks(mask_paths, grays[0].shape))
            tensors_per_level[lvl] = build_scene_tensors(
                scene, grays, base_cfg, flows, semantic=semantic,
                device=dev)
            ext = (None if priors_dir is None
                   else load_prior_maps(priors_dir, scene, grays[0].shape))
            if ext is not None:
                # the external channel at every level's size (ref:
                # GenerateFinalPrior's resize + merge,
                # SceneDensify.cpp:1088-1161)
                tensors_per_level[lvl] = dataclasses.replace(
                    tensors_per_level[lvl],
                    ext_prior_depth=torch.as_tensor(ext, device=dev))

    with stage_timer("hierarchy.schedule", block_on=dev, log=verbose):
        state = run_hierarchy(
            tensors_per_level, base_cfg, schedule=schedule,
            checkpoint_dir=os.path.join(out_dir, "stage_ckpt"),
            resume=resume, verbose=verbose)

    # final artifacts at the finest level
    final_cfg = schedule[-1].cfg
    depth, normal, conf = finalize(state, final_cfg)
    tensors = tensors_per_level[schedule[-1].level]
    h, w = tensors.gray.shape[1:]
    dmap_dir = os.path.join(out_dir, "depthmap")
    os.makedirs(dmap_dir, exist_ok=True)
    depth_np = depth.cpu().numpy()
    normal_np = normal.cpu().numpy()
    conf_np = conf.cpu().numpy()
    nbr_np = tensors.nbr_idx.cpu().numpy()
    with stage_timer("hierarchy.write_dmap", log=verbose):
        for i in range(n):
            R, C = scene.pose_of(i)
            write_dmap(os.path.join(dmap_dir, f"depth{i:04d}.dmap"),
                       DepthMapData(
                           depth=depth_np[i],
                           normal=np.moveaxis(normal_np[i], 0, -1),
                           conf=conf_np[i], K=scene.intrinsics_of(i, w, h),
                           R=R, C=C, d_min=float(tensors.d_min[i]),
                           d_max=float(tensors.d_max[i]), image_size=(w, h),
                           image_name=scene.images[i].name,
                           view_ids=[i] + [int(j) for j in nbr_np[i]]))
    with stage_timer("hierarchy.fuse", block_on=dev, log=verbose):
        priority = torch.arange(n, dtype=torch.float32, device=dev)
        fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                                 tensors.nbr_idx, tensors.nbr_valid,
                                 priority, final_cfg)
        cloud = compact_point_cloud(fused, nbr_idx=tensors.nbr_idx,
                                    confs=conf)
    del fused
    with stage_timer("hierarchy.write_ply", log=verbose):
        write_ply_points(os.path.join(out_dir, "scene_dense.ply"),
                         cloud["points"], cloud["normals"])
    return {"n_views": n, "n_points": len(cloud["points"]),
            "valid_frac": float((depth_np > 0).mean()),
            "depth": depth_np, "normal": normal_np, "conf": conf_np,
            "cloud": cloud}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Hierarchical-cross densification (run.sh equivalent, "
                    "PyTorch/CUDA)")
    ap.add_argument("--input-file", required=True)
    ap.add_argument("--images-dir", default=None)
    ap.add_argument("-w", "--working-dir", default="mvs_hc_out")
    ap.add_argument("--flags", nargs="*", default=[])
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--masks-dir", default=None,
                    help="per-image semantic masks for the use-semantic "
                         "stages (<image-stem>.png; <stem>.mask.png beside "
                         "the images is found without it)")
    ap.add_argument("--priors-dir", default=None,
                    help="external prior depth maps (depth%%04d.dmap or "
                         "<image-stem>.dmap), merged per pixel with the "
                         "superpixel prior")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must "
                         "be asked for)")
    args = ap.parse_args(argv)
    cfg = config_from_cli_flags(dict(f.split("=", 1) for f in args.flags))
    images_dir = args.images_dir or os.path.dirname(args.input_file)
    stats = densify_hierarchical(args.input_file, images_dir,
                                 args.working_dir, cfg,
                                 resume=not args.no_resume,
                                 masks_dir=args.masks_dir,
                                 priors_dir=args.priors_dir,
                                 device=args.device)
    print({k: v for k, v in stats.items()
           if k not in ("depth", "normal", "conf", "cloud")})
    log_report()
    return stats


if __name__ == "__main__":
    main()
