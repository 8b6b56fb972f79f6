"""Dense reconstruction driver, the DensifyPointCloud equivalent (PyTorch
port of ``hcmvs_tpu/pipeline/densify.py``).

Loads a `.mvs` scene and its images, selects neighbours, computes the
optical flows, runs the PatchMatch schedule (with the mid-schedule
filter and, with semantic masks under ``use_semantic`` or external prior
maps, the planar-prior pass), fuses a point cloud, and writes the
per-view ``.dmap`` files, ``scene_dense.ply`` and ``scene_dense.mvs``
(ref: apps/DensifyPointCloud/DensifyPointCloud.cpp:373-458 main +
Scene::DenseReconstruction, SceneDensify.cpp:3532).  CLI flags map 1:1
to the reference's through ``core.config.CLI_FLAG_MAP``.

    python -m hcmvs_tpu_torch.pipeline.densify --input-file scene.mvs \\
        -w out --flags resolution-level=0 use-semantic=1 \\
        [--masks-dir masks] [--priors-dir priors] [--device cpu]
    python -m hcmvs_tpu_torch.pipeline.densify --input-file scene.mvs \\
        -w out --project-labels
    python -m hcmvs_tpu_torch.pipeline.densify --input-file mesh.ply \\
        -w out --sample-mesh -100000

Masks are found per image as ``find_scene_masks`` says (``<stem>.mask.png``
beside the image by default); ``--priors-dir`` holds ``depth%04d.dmap``
or ``<stem>.dmap`` prior maps; ``--project-labels`` colours the scene's
points from ``<stem>_l_colored.png`` label images; ``--sample-mesh``
writes an area-weighted sampling of a ``.ply`` / ``.obj`` mesh as
``scene_sampled.ply``.  Everything runs on
the card unless ``device="cpu"`` is asked for; without a card that
request is required (no quiet fallback).  ``--fusion-mode -1/-2`` takes
SGM stereo maps (``dense/sgm.py``) in place of PatchMatch;
``--export-viewer`` writes ``scene_dense.html`` (``io/viewer.py``) beside
the cloud.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig, config_from_cli_flags
from hcmvs_tpu_torch.dense.fusion import compact_point_cloud, fuse_point_cloud
from hcmvs_tpu_torch.dense.init_tri import scene_triangulated_seeds
from hcmvs_tpu_torch.dense.scene_driver import (SceneState, SceneTensors,
                                                estimate_scene, finalize,
                                                splat_sparse_depths)
from hcmvs_tpu_torch.dense.view_selection import (depth_range_from_points,
                                                  pair_scores,
                                                  select_neighbors)
from hcmvs_tpu_torch.io.dmap import DepthMapData, read_dmap, write_dmap
from hcmvs_tpu_torch.io.images import (compute_resolution_scale, load_image,
                                       load_semantic_mask, resize_image,
                                       resize_mask, save_depth_png, to_gray)
from hcmvs_tpu_torch.io.mvs import SceneMVS, read_mvs, write_mvs
from hcmvs_tpu_torch.io.obj import read_obj
from hcmvs_tpu_torch.io.ply import read_ply, write_ply_points
from hcmvs_tpu_torch.mesh.mesh_ops import sample_points
from hcmvs_tpu_torch.utils.profiling import log_report, stage_timer


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request without a card raises
    (the CPU must be asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                           "cpu) to run on the CPU")
    return dev


def find_scene_masks(scene: SceneMVS, images_dir: str,
                     masks_dir: Optional[str] = None
                     ) -> Optional[List[Optional[str]]]:
    """Per-image semantic-mask paths, or None when no image has one (ref:
    Image::maskName, frame_main/libs/MVS/Image.h:75-99): the scene's
    recorded ``mask_name``, then ``<masks_dir>/<image-stem>.<ext>`` (or the
    image's own name there) when a masks directory is given, then
    ``<image-stem>.mask.png`` beside the image."""
    exts = (".png", ".pgm", ".tif", ".tiff", ".bmp", ".jpg")
    paths: List[Optional[str]] = []
    for im in scene.images:
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand: List[str] = []
        if getattr(im, "mask_name", ""):
            m = im.mask_name
            if os.path.isabs(m):
                cand.append(m)
            else:
                cand.append(os.path.join(images_dir, m))
                cand.append(os.path.join(images_dir, os.path.basename(m)))
        if masks_dir:
            cand += [os.path.join(masks_dir, stem + e) for e in exts]
            cand.append(os.path.join(masks_dir, os.path.basename(im.name)))
        cand.append(os.path.join(images_dir, stem + ".mask.png"))
        paths.append(next((c for c in cand if os.path.exists(c)), None))
    return paths if any(p is not None for p in paths) else None


def load_scene_masks(mask_paths: List[Optional[str]],
                     shape_hw) -> np.ndarray:
    """Masks read and nearest-resized to the working resolution, their
    labels remapped to one dense id space for the whole scene ((N, H, W)
    int32; an image without a mask is one all-zero region).  Identical
    raw ids mean the same class in every view (the usual segmentation
    export), so the remap is joint."""
    masks = [np.zeros(shape_hw, np.int32) if p is None
             else resize_mask(load_semantic_mask(p), shape_hw)
             for p in mask_paths]
    stack = np.stack(masks)
    _, inv = np.unique(stack, return_inverse=True)
    return inv.reshape(stack.shape).astype(np.int32)


def load_prior_maps(priors_dir: str, scene: SceneMVS,
                    shape_hw) -> Optional[np.ndarray]:
    """Externally produced prior depth maps, the reference's meanshift
    prior channel (ref: GenerateFinalPrior's LoadDepthMap of
    ComposeMeanshiftDepthPriorsPath, SceneDensify.cpp:1088-1100; channel
    DepthMap.h:294-297): per image ``depth%04d.dmap`` (the stage-handoff
    name) or ``<image-stem>.dmap`` in ``priors_dir``, resized to the
    working resolution by nearest neighbour (a 0 hole must not bleed).
    Returns (N, H, W) float32, 0 where no map exists, or None when no
    image has one."""
    h, w = shape_hw
    out = np.zeros((len(scene.images), h, w), np.float32)
    found = False
    for i, im in enumerate(scene.images):
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand = [os.path.join(priors_dir, f"depth{i:04d}.dmap"),
                os.path.join(priors_dir, stem + ".dmap")]
        path = next((c for c in cand if os.path.exists(c)), None)
        if path is None:
            continue
        d = read_dmap(path).depth
        ys = (np.arange(h) * (d.shape[0] / h)).astype(np.int64)
        xs = (np.arange(w) * (d.shape[1] / w)).astype(np.int64)
        out[i] = d[ys[:, None], xs[None, :]]
        found = True
    return out if found else None


def load_mesh_any(path: str):
    """Load a mesh from .obj or .ply -> (vertices (V,3), faces (F,3))."""
    if path.lower().endswith(".obj"):
        m = read_obj(path)
        return m.vertices, m.faces
    verts, extras = read_ply(path)
    faces = extras.get("faces")
    if faces is None:
        raise ValueError(f"{path}: no faces — not a mesh")
    return verts, faces


def sample_mesh(input_path: str, out_path: str, f_sample: float,
                verbose: bool = True) -> int:
    """The --sample-mesh side mode (ref: DensifyPointCloud.cpp:383-397):
    load a mesh and export an area-weighted surface sampling as a point
    cloud.  ``f_sample`` > 0 is a sampling density (points per unit
    area, Mesh::SamplePoints(REAL) Mesh.cpp:3455-3461); < 0 is a total
    point count (Mesh::SamplePoints(unsigned), :3444-3454).  Returns the
    number of points written."""
    verts, faces = load_mesh_any(input_path)
    a, b, c = (verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]])
    area = float(0.5 * np.linalg.norm(np.cross(b - a, c - a),
                                      axis=1).sum())
    if f_sample > 0:
        n_pts = int(np.ceil(area * f_sample))
    else:
        n_pts = int(round(-f_sample))
    n_pts = max(n_pts, 1)
    pts, nrm = sample_points(verts, faces, n_pts)
    write_ply_points(out_path, pts, nrm)
    if verbose:
        print(f"[densify] sampled mesh ({len(faces)} faces, area "
              f"{area:.3g}) -> {n_pts} points -> {out_path}")
    return n_pts


def find_label_masks(scene: SceneMVS, images_dir: str,
                     masks_dir: Optional[str] = None
                     ) -> List[Optional[str]]:
    """Per-image coloured label images of ``--project-labels`` (ref: the
    coloredMaskName convention ``<image-stem>_l_colored.png`` beside the
    image, DensifyPointCloud.cpp:418-424); ``masks_dir`` is looked in
    first (``<stem>_l_colored.png``, then ``<stem>.png``)."""
    paths: List[Optional[str]] = []
    for im in scene.images:
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand = []
        if masks_dir:
            cand += [os.path.join(masks_dir, stem + "_l_colored.png"),
                     os.path.join(masks_dir, stem + ".png")]
        cand.append(os.path.join(images_dir, stem + "_l_colored.png"))
        paths.append(next((c for c in cand if os.path.exists(c)), None))
    return paths


def estimate_point_labels(scene: SceneMVS,
                          label_paths: List[Optional[str]]) -> np.ndarray:
    """Each point's colour from the label image of its closest view (the
    least depth among the point's views that have a label image), sampled
    at the point's projection (the EstimatePointLabels analog, ref:
    frame_main/libs/MVS/DepthMap.cpp:2165-2217), vectorised over the
    cloud on the host.  Returns (P, 3) uint8 BGR colours, white where no
    view has a label image or the projection falls outside."""
    pts = scene.points.astype(np.float64)
    counts = scene.point_view_counts.astype(np.int64)
    ids = scene.point_view_ids.astype(np.int64)
    n_img = len(scene.images)
    pt_of = np.repeat(np.arange(len(pts)), counts)             # (T,)
    labels = []
    sizes = np.zeros((n_img, 2), np.int64)
    for i, p in enumerate(label_paths):
        if p is None:
            labels.append(None)
            continue
        img = load_image(p)
        labels.append(np.clip(img * 255.0, 0, 255).astype(np.uint8))
        sizes[i] = img.shape[:2]
    Rs = np.zeros((n_img, 3, 3))
    Cs = np.zeros((n_img, 3))
    Ks = np.zeros((n_img, 3, 3))
    for i in range(n_img):
        Rs[i], Cs[i] = scene.pose_of(i)
        if labels[i] is not None:
            Ks[i] = scene.intrinsics_of(i, int(sizes[i][1]),
                                        int(sizes[i][0]))
    # each (point, view) pair's depth; the least per point wins
    Xc = np.einsum("tij,tj->ti", Rs[ids], pts[pt_of] - Cs[ids])  # (T, 3)
    depth = np.where(Xc[:, 2] > 0, Xc[:, 2], np.inf)
    has_lbl = np.array([lbl is not None for lbl in labels])[ids]
    depth = np.where(has_lbl, depth, np.inf)
    order = np.lexsort((depth, pt_of))
    first = np.searchsorted(pt_of[order], np.arange(len(pts)))
    best_t = order[np.clip(first, 0, len(order) - 1)]          # (P,)
    colors = np.full((len(pts), 3), 255, np.uint8)
    best_view = ids[best_t]
    best_ok = np.isfinite(depth[best_t]) & (counts > 0)
    for i in range(n_img):
        if labels[i] is None:
            continue
        sel = best_ok & (best_view == i)
        if not sel.any():
            continue
        uvw = np.einsum("ij,pj->pi", Ks[i], Xc[best_t[sel]])
        x = uvw[:, 0] / np.maximum(uvw[:, 2], 1e-12)
        y = uvw[:, 1] / np.maximum(uvw[:, 2], 1e-12)
        h_i, w_i = int(sizes[i][0]), int(sizes[i][1])
        xi = np.clip(np.round(x).astype(np.int64), 0, w_i - 1)
        yi = np.clip(np.round(y).astype(np.int64), 0, h_i - 1)
        inside = (x >= -0.5) & (x < w_i - 0.5) & (y >= -0.5) \
            & (y < h_i - 0.5)
        rgb = labels[i][yi, xi]
        colors[np.nonzero(sel)[0][inside]] = rgb[inside][:, ::-1]  # BGR
    return colors


def project_labels(scene_path: str, images_dir: str, out_base: str,
                   masks_dir: Optional[str] = None,
                   verbose: bool = True) -> dict:
    """The ProjectLabels side mode (ref: DensifyPointCloud.cpp:416-433):
    colour the scene's points from per-image coloured label images and
    save ``<out_base>_labelled.mvs`` and ``.ply``.  Host work only."""
    scene = read_mvs(scene_path)
    label_paths = find_label_masks(scene, images_dir, masks_dir)
    n_found = sum(p is not None for p in label_paths)
    colors = estimate_point_labels(scene, label_paths)
    scene.point_colors = colors
    write_mvs(out_base + "_labelled.mvs", scene)
    write_ply_points(out_base + "_labelled.ply", scene.points,
                     colors=colors[:, ::-1])            # PLY wants RGB
    if verbose:
        print(f"[densify] projected labels from {n_found}/"
              f"{len(scene.images)} label images -> "
              f"{out_base}_labelled.mvs/.ply")
    return {"n_points": len(scene.points), "n_label_images": n_found,
            "colors": colors}


def build_scene_tensors(scene: SceneMVS, images_gray: List[np.ndarray],
                        cfg: DenseConfig,
                        flows: Optional[torch.Tensor] = None,
                        semantic: Optional[np.ndarray] = None,
                        device="cuda") -> SceneTensors:
    """Scene tensors on ``device`` from a host scene (uniform image
    sizes): cameras, neighbours (covisibility top-k), depth ranges, the
    sparse seeds, splatted or, with ``init_triangulate``, interpolated
    over a Delaunay triangulation (``dense/init_tri.py``), and the
    semantic labels when given."""
    dev = resolve_device(device)
    n = len(scene.images)
    h, w = images_gray[0].shape
    Ks, Rs, Cs = [], [], []
    for i in range(n):
        R, C = scene.pose_of(i)
        Ks.append(scene.intrinsics_of(i, w, h))
        Rs.append(R)
        Cs.append(C)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    cams = Camera(K=f32(np.stack(Ks)), R=f32(np.stack(Rs)),
                  C=f32(np.stack(Cs)))
    score = pair_scores(scene.points, scene.point_view_counts,
                        scene.point_view_ids, np.stack(Cs), n,
                        cfg.optim_angle, cfg.min_angle, cfg.max_angle)
    v = min(cfg.geo_max_neighbors, max(n - 1, 1))
    nbr_idx, nbr_valid = select_neighbors(score, v,
                                          cfg.view_min_score_ratio)
    d_ranges = np.stack([
        depth_range_from_points(scene.points, scene.point_view_counts,
                                scene.point_view_ids, Rs[i], Cs[i], i)
        for i in range(n)])
    cams_np = [(Ks[i], Rs[i], Cs[i]) for i in range(n)]
    if cfg.init_triangulate:
        # ref: InitDepthMap initTriangulate=1 -> TriangulatePoints2DepthMap
        seeds = scene_triangulated_seeds(
            scene.points, scene.point_view_counts, scene.point_view_ids,
            cams_np, n, h, w, add_corners=cfg.add_corners)
    else:
        seeds = splat_sparse_depths(scene.points, scene.point_view_counts,
                                    scene.point_view_ids, cams_np, n, h, w)
    return SceneTensors(
        gray=f32(np.stack(images_gray)), cams=cams,
        nbr_idx=torch.as_tensor(nbr_idx, dtype=torch.int64, device=dev),
        nbr_valid=torch.as_tensor(nbr_valid, device=dev),
        d_min=f32(d_ranges[:, 0]), d_max=f32(d_ranges[:, 1]),
        seed_depth=f32(seeds), flows=flows,
        semantic=(None if semantic is None else torch.as_tensor(
            semantic, dtype=torch.int64, device=dev)))


def _load_images(scene: SceneMVS, images_dir: str, cfg: DenseConfig):
    """Gray (H, W) and colour (H, W, 3) float32 images at the working
    resolution."""
    grays, colors = [], []
    scale = None
    for im in scene.images:
        name = im.name
        path = name if os.path.isabs(name) else os.path.join(
            images_dir, os.path.basename(name))
        img = load_image(path)
        if scale is None:
            scale = compute_resolution_scale(img.shape[1], img.shape[0],
                                             cfg.resolution_level,
                                             cfg.max_resolution,
                                             cfg.min_resolution)
        img = resize_image(img, scale)
        if img.ndim == 3:
            colors.append(img)
            # BT.601 luminance, as the reference's cv2 IMREAD_GRAYSCALE
            grays.append(to_gray(img).astype(np.float32))
        else:
            colors.append(np.repeat(img[..., None], 3, -1))
            grays.append(img)
    return grays, colors


def densify(scene_path: str, images_dir: str, out_dir: str,
            cfg: Optional[DenseConfig] = None, verbose: bool = True,
            resume: bool = True,
            filter_point_cloud: Optional[int] = None,
            masks_dir: Optional[str] = None,
            fusion_mode: int = 0,
            priors_dir: Optional[str] = None,
            device="cuda", init: Optional[SceneState] = None) -> Dict:
    """Full densification of a `.mvs` scene; returns summary stats.

    ``resume``: when every per-view ``depth%04d.dmap`` already exists in
    the output, estimation is skipped and the maps are loaded (ref:
    SceneDensify.cpp:3865-3880).  ``filter_point_cloud``: run the
    visibility filter on the fused cloud with this threshold.
    ``fusion_mode`` (ref: DensifyPointCloud.cpp:154, :436-441): 0 =
    PatchMatch depth maps + fusion; 1 = depth maps only; -2 / -1 the same
    with SGM stereo maps (``dense/sgm.sgm_scene``).  ``device``:
    where the tensors live ("cuda" by default; "cpu" must be asked for).
    ``init`` replaces the random initial state (as in ``estimate_scene``).
    ``masks_dir``: where semantic masks are looked for (with
    ``use_semantic``; ``find_scene_masks``); ``priors_dir``: external
    prior maps (``load_prior_maps``).  Either starts the planar-prior
    pass.  Every stage is timed into ``utils.profiling``'s report.
    """
    cfg = cfg or DenseConfig()
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = read_mvs(scene_path)
    n = len(scene.images)
    with stage_timer("densify.load_images", log=verbose):
        grays, colors = _load_images(scene, images_dir, cfg)
    h, w = grays[0].shape

    flows = None
    if cfg.use_optical_flow:
        from hcmvs_tpu_torch.dense.flow import scene_flows
        with stage_timer("densify.flows", block_on=dev, log=verbose):
            centers = np.stack([scene.pose_of(i)[1] for i in range(n)])
            score = pair_scores(scene.points, scene.point_view_counts,
                                scene.point_view_ids, centers, n)
            nbr1, _ = select_neighbors(score, 1)
            flows = scene_flows(torch.as_tensor(np.stack(grays),
                                                device=dev), nbr1)

    # masks only under use_semantic (the reference's final stage runs
    # --use-semantic 1 with mask files, data/frame_main/resize1/run.py)
    semantic = None
    mask_paths = (find_scene_masks(scene, images_dir, masks_dir)
                  if cfg.use_semantic else None)
    if mask_paths is not None:
        with stage_timer("densify.masks", log=verbose):
            semantic = load_scene_masks(mask_paths, (h, w))
        if verbose:
            print(f"[densify] semantic masks: "
                  f"{sum(p is not None for p in mask_paths)}/{n} images, "
                  f"{int(semantic.max()) + 1} labels")
    with stage_timer("densify.scene_tensors", block_on=dev, log=verbose):
        tensors = build_scene_tensors(scene, grays, cfg, flows,
                                      semantic=semantic, device=dev)
        ext = (None if priors_dir is None
               else load_prior_maps(priors_dir, scene, (h, w)))
        if ext is not None:
            tensors = dataclasses.replace(
                tensors, ext_prior_depth=torch.as_tensor(ext, device=dev))
    if ext is not None and verbose:
        print(f"[densify] external prior maps: "
              f"{int((ext.reshape(n, -1) > 0).any(1).sum())}/{n} views")
    dmap_dir = os.path.join(out_dir, "depthmap")
    dmap_path = lambda i: os.path.join(dmap_dir, f"depth{i:04d}.dmap")  # noqa: E731
    t0 = time.time()
    if resume and all(os.path.exists(dmap_path(i)) for i in range(n)):
        # per-image resumability: all maps exist, skip estimation
        with stage_timer("densify.read_dmap", block_on=dev, log=verbose):
            loaded = [read_dmap(dmap_path(i)) for i in range(n)]

            def stack(arrs):
                return torch.as_tensor(np.stack(arrs), device=dev)

            depth = stack([d.depth for d in loaded])
            normal = stack([np.moveaxis(d.normal, -1, 0) for d in loaded])
            conf = stack([d.conf for d in loaded])
    elif fusion_mode < 0:
        # SGM stereo path (ref: SceneDensify.cpp:3899-3911 sgm.Match
        # dispatch when nFusionMode -1/-2)
        from hcmvs_tpu_torch.dense.sgm import sgm_scene
        with stage_timer("densify.sgm", block_on=dev, log=verbose):
            depth, normal, conf = sgm_scene(tensors)
    else:
        with stage_timer("densify.estimate", block_on=dev, log=verbose):
            gen = torch.Generator(device=dev).manual_seed(0)
            state = estimate_scene(gen, tensors, cfg, verbose=verbose,
                                   init=init)
            depth, normal, conf = finalize(state, cfg)
    wall = time.time() - t0

    # per-view .dmap artifacts (the stage-handoff format; ref:
    # SceneDensify.cpp:3984-3992)
    os.makedirs(dmap_dir, exist_ok=True)
    depth_np = depth.cpu().numpy()
    normal_np = normal.cpu().numpy()
    conf_np = conf.cpu().numpy()
    nbr_np = tensors.nbr_idx.cpu().numpy()
    if verbose:
        # jet-coloured debug maps (the reference's verbosity-gated dumps)
        with stage_timer("densify.write_depth_png", log=verbose):
            for i in range(n):
                save_depth_png(os.path.join(dmap_dir, f"depth{i:04d}.png"),
                               depth_np[i])
    with stage_timer("densify.write_dmap", log=verbose):
        for i in range(n):
            R, C = scene.pose_of(i)
            write_dmap(dmap_path(i), DepthMapData(
                depth=depth_np[i], normal=np.moveaxis(normal_np[i], 0, -1),
                conf=conf_np[i], K=scene.intrinsics_of(i, w, h), R=R, C=C,
                d_min=float(tensors.d_min[i]), d_max=float(tensors.d_max[i]),
                image_size=(w, h), image_name=scene.images[i].name,
                view_ids=[i] + [int(j) for j in nbr_np[i]]))
    stats = {"n_views": n, "wall_s": wall, "views_per_s": n / wall,
             "n_points": 0, "valid_frac": float((depth_np > 0).mean()),
             "depth": depth_np, "normal": normal_np, "conf": conf_np}
    if abs(fusion_mode) == 1:
        # export-only mode stops after the .dmap artifacts (ref: the
        # ABS(nFusionMode)==1 early exit, DensifyPointCloud.cpp:436-441)
        return stats

    priority = np.argsort(np.argsort(
        -tensors.nbr_valid.cpu().numpy().sum(1))).astype(np.float32)
    with stage_timer("densify.fuse", block_on=dev, log=verbose):
        fused = fuse_point_cloud(
            depth, normal, conf, tensors.cams, tensors.nbr_idx,
            tensors.nbr_valid, priority, cfg,
            colors=torch.as_tensor(np.stack(colors), device=dev),
            with_colors=cfg.estimate_colors > 0)
    with stage_timer("densify.compact", block_on=dev, log=verbose):
        cloud = compact_point_cloud(fused, nbr_idx=tensors.nbr_idx,
                                    confs=conf)
    del fused
    if filter_point_cloud is not None and len(cloud["points"]):
        from hcmvs_tpu_torch.dense.point_filter import filter_point_cloud \
            as fpc
        with stage_timer("densify.point_filter", log=verbose):
            keep = fpc(cloud["points"], np.ones(len(cloud["points"]),
                                                np.int32),
                       cloud["owner_view"], tensors.cams, (h, w),
                       th_remove=filter_point_cloud)
        # the ragged view lists filter through their points
        ragged_keep = np.repeat(keep, cloud["view_counts"])
        cloud["view_ids"] = cloud["view_ids"][ragged_keep]
        cloud["view_confs"] = cloud["view_confs"][ragged_keep]
        for k in ("points", "normals", "colors", "weights", "support",
                  "owner_view", "view_counts"):
            cloud[k] = cloud[k][keep]
    with stage_timer("densify.write_ply", log=verbose):
        col_u8 = np.clip(cloud["colors"] * 255, 0, 255).astype(np.uint8)
        write_ply_points(os.path.join(out_dir, "scene_dense.ply"),
                         cloud["points"], cloud["normals"], colors=col_u8)
    # dense scene with full per-point view lists: owner view first, then
    # every agreeing neighbour with its sampled confidence
    with stage_timer("densify.write_mvs", log=verbose):
        write_mvs(os.path.join(out_dir, "scene_dense.mvs"), SceneMVS(
            platforms=scene.platforms, images=scene.images,
            points=cloud["points"].astype(np.float32),
            point_view_counts=cloud["view_counts"].astype(np.int32),
            point_view_ids=cloud["view_ids"].astype(np.uint32),
            point_view_confs=cloud["view_confs"].astype(np.float32),
            point_normals=cloud["normals"].astype(np.float32)))
    stats["n_points"] = len(cloud["points"])
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="DensifyPointCloud equivalent (PyTorch/CUDA)")
    ap.add_argument("--input-file", required=True)
    ap.add_argument("--images-dir", default=None)
    ap.add_argument("-w", "--working-dir", default="mvs_out")
    ap.add_argument("--flags", nargs="*", default=[],
                    help="reference-style flag=value pairs, e.g. "
                         "resolution-level=2 n-EstimationIters=3")
    ap.add_argument("--filter-point-cloud", type=int, default=None,
                    help="visibility-filter threshold (ref: negative "
                         "values, e.g. -1)")
    ap.add_argument("--fusion-mode", type=int, default=0,
                    help="0 depth-maps & fusion, 1 export depth-maps only, "
                         "-2 / -1 the same from SGM stereo maps (ref: "
                         "DensifyPointCloud.cpp:154)")
    ap.add_argument("--no-resume", action="store_true",
                    help="re-estimate even if depth*.dmap files exist")
    ap.add_argument("--masks-dir", default=None,
                    help="directory of per-image semantic masks "
                         "(<image-stem>.png); with use-semantic=1 they "
                         "feed the RANSAC planar priors (ref: Image "
                         "maskName + GenerateDepthPrior)")
    ap.add_argument("--priors-dir", default=None,
                    help="directory of externally produced prior depth "
                         "maps (depth%%04d.dmap or <image-stem>.dmap), "
                         "merged per pixel with the superpixel prior "
                         "(ref: GenerateFinalPrior, "
                         "SceneDensify.cpp:1079-1161)")
    ap.add_argument("--export-viewer", action="store_true",
                    help="also write scene_dense.html, an offline "
                         "WebGL viewer of the dense cloud")
    ap.add_argument("--sample-mesh", type=float, default=0.0,
                    help="side mode: sample the --input-file mesh (.ply / "
                         ".obj), > 0 points per unit area, < 0 a point "
                         "count, into scene_sampled.ply")
    ap.add_argument("--project-labels", action="store_true",
                    help="side mode (ref: DensifyPointCloud.cpp:416-433): "
                         "colour the scene's points from per-image "
                         "'<stem>_l_colored.png' label images (or "
                         "--masks-dir) and save *_labelled.mvs/.ply")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must "
                         "be asked for)")
    args = ap.parse_args(argv)
    if args.sample_mesh != 0.0:
        os.makedirs(args.working_dir, exist_ok=True)
        n = sample_mesh(args.input_file,
                        os.path.join(args.working_dir, "scene_sampled.ply"),
                        args.sample_mesh)
        print({"mode": "sample-mesh", "n_points": n})
        return {"mode": "sample-mesh", "n_points": n}
    flags = dict(f.split("=", 1) for f in args.flags)
    cfg = config_from_cli_flags(flags)
    images_dir = args.images_dir or os.path.dirname(args.input_file)
    if args.project_labels:
        os.makedirs(args.working_dir, exist_ok=True)
        stats = project_labels(args.input_file, images_dir,
                               os.path.join(args.working_dir, "scene"),
                               masks_dir=args.masks_dir)
        print({"mode": "project-labels",
               **{k: v for k, v in stats.items() if k != "colors"}})
        return stats
    stats = densify(args.input_file, images_dir, args.working_dir, cfg,
                    resume=not args.no_resume,
                    filter_point_cloud=args.filter_point_cloud,
                    masks_dir=args.masks_dir,
                    fusion_mode=args.fusion_mode,
                    priors_dir=args.priors_dir, device=args.device)
    if args.export_viewer:
        from hcmvs_tpu_torch.io.ply import read_ply
        from hcmvs_tpu_torch.io.viewer import export_viewer_html
        verts, extras = read_ply(os.path.join(args.working_dir,
                                              "scene_dense.ply"))
        export_viewer_html(os.path.join(args.working_dir,
                                        "scene_dense.html"),
                           verts, colors=extras.get("colors"))
    print({k: v for k, v in stats.items()
           if k not in ("depth", "normal", "conf")})
    log_report()
    return stats


if __name__ == "__main__":
    main()
