"""End-to-end pipeline driver: photos -> SfM -> dense -> mesh -> texture
(PyTorch port of ``hcmvs_tpu/pipeline/mvgmvs.py``).

The analog of the reference's MvgMvsPipeline.py orchestration (ref:
frame_main/MvgMvsPipeline.py:180-229 -- OpenMVG SfM steps 0-9, then
DensifyPointCloud / ReconstructMesh / TextureMesh), in memory, with the
`.mvs` / PLY / OBJ artifacts written at the stage boundaries:

    python -m hcmvs_tpu_torch.pipeline.mvgmvs photos/ out/ \\
        [--preset SEQUENTIAL|GLOBAL] [--focal-px F] [--no-distortion] \\
        [--no-mesh] [--flags resolution-level=0 ...] [--device cpu]

writes ``out/scene.mvs`` (poses, sparse points), ``scene_dense.ply`` and,
unless ``--no-mesh``, ``scene_mesh.ply`` and ``scene_textured.{obj,mtl,
png}``.  Everything runs on the card unless ``device="cpu"`` is asked for
(without a card that request is required).  The photos must be PNG or
binary PNM (the port decodes no JPEG; ``io/images.py``); their EXIF
(``eXIf`` chunk) seeds the focal length.  ``fusion_mode`` -1/-2 takes the
SGM stereo maps (``dense/sgm.py``) in place of PatchMatch.

Random draws: the SfM RANSACs take their samples from ``sampler``
(``sfm.two_view.Sampler``; a generator seeded with 0 by default), the
dense stage from a ``torch.Generator`` seeded with 0.  Stages are timed
into ``utils.profiling``'s report: the ``sfm.*`` stages, ``photos.load``,
``photos.distortion``, ``photos.undistort``, ``dense.scene_tensors``,
``dense.estimate`` (``dense.sgm`` in the SGM modes), ``dense.fuse``,
``mesh.reconstruct``,
``mesh.texture``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from hcmvs_tpu_torch.core.config import DenseConfig, config_from_cli_flags
from hcmvs_tpu_torch.io.mvs import write_mvs
from hcmvs_tpu_torch.io.ply import write_ply_mesh, write_ply_points
from hcmvs_tpu_torch.pipeline.densify import resolve_device
from hcmvs_tpu_torch.sfm.incremental import (SfMConfig, incremental_sfm,
                                             sfm_to_scene)
from hcmvs_tpu_torch.sfm.two_view import Sampler
from hcmvs_tpu_torch.utils.profiling import stage_timer


def _run_sfm(grays, K, sfm_cfg, preset, verbose, sampler, dev):
    if preset.upper() == "GLOBAL":
        from hcmvs_tpu_torch.sfm.global_sfm import global_sfm
        return global_sfm(grays, K, sfm_cfg, verbose=verbose,
                          sampler=sampler, device=dev)
    return incremental_sfm(grays, K, sfm_cfg, verbose=verbose,
                           sampler=sampler, device=dev)


def run_pipeline(images: List[np.ndarray], K: np.ndarray, out_dir: str,
                 sfm_cfg: Optional[SfMConfig] = None,
                 dense_cfg: Optional[DenseConfig] = None,
                 with_mesh: bool = True, with_texture: bool = True,
                 preset: str = "SEQUENTIAL", fusion_mode: int = 0,
                 verbose: bool = True, sampler: Optional[Sampler] = None,
                 device="cuda") -> Dict:
    """The full reconstruction from grayscale images + intrinsics.

    ``preset``: "SEQUENTIAL" (incremental SfM) or "GLOBAL" (rotation +
    translation averaging), the reference's presets (ref:
    MvgMvsPipeline.py:116-122)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    dense_cfg = dense_cfg or DenseConfig()
    h, w = images[0].shape[:2]
    result = _run_sfm(images, K, sfm_cfg, preset, verbose, sampler, dev)
    names = [f"im{i:04d}" for i in range(len(images))]
    scene = sfm_to_scene(result, K, names, w, h)
    write_mvs(os.path.join(out_dir, "scene.mvs"), scene)
    return _dense_mesh_texture(result, scene, images, K, out_dir,
                               dense_cfg, with_mesh, with_texture, verbose,
                               dev, fusion_mode)


def _dense_mesh_texture(result, scene, images, K, out_dir, dense_cfg,
                        with_mesh, with_texture, verbose, dev,
                        fusion_mode: int = 0) -> Dict:
    """Steps 10-13 from a finished SfM result: PatchMatch (SGM for a
    negative ``fusion_mode``) over the registered views at the images'
    size, fusion, then the mesh and its
    texture (the JAX package's defaults: clean-up with components of >= 10
    faces, the gray images as texture)."""
    from hcmvs_tpu_torch.dense.fusion import (compact_point_cloud,
                                              fuse_point_cloud)
    from hcmvs_tpu_torch.dense.scene_driver import estimate_scene, finalize
    from hcmvs_tpu_torch.pipeline.densify import build_scene_tensors
    reg = sorted(result.poses)
    grays = [images[i] for i in reg]
    with stage_timer("dense.scene_tensors", block_on=dev):
        tensors = build_scene_tensors(scene, grays, dense_cfg, device=dev)
    if fusion_mode < 0:
        from hcmvs_tpu_torch.dense.sgm import sgm_scene
        with stage_timer("dense.sgm", block_on=dev):
            depth, normal, conf = sgm_scene(tensors)
    else:
        with stage_timer("dense.estimate", block_on=dev):
            gen = torch.Generator(device=dev).manual_seed(0)
            state = estimate_scene(gen, tensors, dense_cfg, verbose=verbose)
            depth, normal, conf = finalize(state, dense_cfg)
    with stage_timer("dense.fuse", block_on=dev):
        priority = torch.arange(len(reg), dtype=torch.float32, device=dev)
        fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                                 tensors.nbr_idx, tensors.nbr_valid,
                                 priority, dense_cfg)
        cloud = compact_point_cloud(fused)
        del fused
    write_ply_points(os.path.join(out_dir, "scene_dense.ply"),
                     cloud["points"], cloud["normals"])
    out = {"sfm": result, "cloud": cloud, "depth": depth.cpu().numpy()}

    if with_mesh and len(cloud["points"]) >= 50:
        from hcmvs_tpu_torch.mesh.delaunay import reconstruct_mesh
        from hcmvs_tpu_torch.mesh.mesh_ops import clean_mesh
        centers = np.stack([result.poses[i][1] for i in reg])
        with stage_timer("mesh.reconstruct"):
            mesh = reconstruct_mesh(cloud["points"], centers,
                                    cloud["owner_view"].astype(np.int64))
            mv, mf = clean_mesh(mesh.vertices, mesh.faces,
                                min_component_faces=10)
        write_ply_mesh(os.path.join(out_dir, "scene_mesh.ply"), mv, mf)
        out["mesh"] = (mv, mf)

        if with_texture and len(mf) > 0:
            from hcmvs_tpu_torch.mesh.texture import (texture_mesh,
                                                      write_textured_obj)
            Ks = np.tile(K[None], (len(reg), 1, 1))
            Rs = np.stack([result.poses[i][0] for i in reg])
            with stage_timer("mesh.texture", block_on=dev):
                tm = texture_mesh(mv, mf, grays, Ks, Rs, centers, device=dev)
            write_textured_obj(os.path.join(out_dir, "scene_textured.obj"),
                               tm)
            out["textured"] = tm
    return out


def run_pipeline_photos(images_dir: str, out_dir: str,
                        K: Optional[np.ndarray] = None,
                        sfm_cfg: Optional[SfMConfig] = None,
                        dense_cfg: Optional[DenseConfig] = None,
                        with_mesh: bool = True, with_texture: bool = True,
                        preset: str = "SEQUENTIAL", fusion_mode: int = 0,
                        estimate_distortion: bool = True,
                        verbose: bool = True,
                        sampler: Optional[Sampler] = None,
                        device="cuda") -> Dict:
    """The full reconstruction from a directory of photographs, no K
    needed: the EXIF focal bootstrap + sensor-width DB (ref:
    MvgMvsPipeline.py:181-183), SfM on the raw photos, radial distortion
    estimated jointly with the bundle (sfm/distortion.py) and the images
    undistorted before the MVS stages, as OpenMVG undistorts at `.mvs`
    export (ref: MvgMvsPipeline.py:208-210)."""
    from hcmvs_tpu_torch.io.exif import scene_intrinsics_from_photos
    from hcmvs_tpu_torch.io.images import list_images, load_image, to_gray
    from hcmvs_tpu_torch.sfm.distortion import (refine_with_distortion,
                                                undistort_image)
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    paths = list_images(images_dir)
    if len(paths) < 2:
        raise ValueError(f"need >= 2 images in {images_dir}, "
                         f"found {len(paths)}")
    with stage_timer("photos.load"):
        imgs = [load_image(p) for p in paths]
    grays = [to_gray(im).astype(np.float32) if im.ndim == 3 else im
             for im in imgs]
    h, w = grays[0].shape
    if K is None:
        K, src = scene_intrinsics_from_photos(
            paths, [w] * len(paths), [h] * len(paths))
        if verbose:
            print(f"[photos] intrinsics bootstrap ({src}): "
                  f"f = {K[0, 0]:.1f}px")

    # SfM on the raw (possibly distorted) photos
    result = _run_sfm(grays, K, sfm_cfg, preset, verbose, sampler, dev)
    k = np.zeros(3, np.float32)
    rms_unrefined = result.reproj_rms
    if estimate_distortion:
        with stage_timer("photos.distortion", block_on=dev):
            result, k = refine_with_distortion(result, K, verbose=verbose,
                                               device=dev)
        if verbose:
            print(f"[photos] radial distortion k = {k}, "
                  f"rms {result.reproj_rms:.3f}px")
        if np.abs(k).max() > 1e-4:
            # undistort the working images so the MVS stages see pinhole
            # cameras (the reference's undistorted-export contract)
            with stage_timer("photos.undistort", block_on=dev):
                grays = [undistort_image(g, K, k, device=dev)
                         for g in grays]

    names = [os.path.basename(p) for p in paths]
    scene = sfm_to_scene(result, K, names, w, h)
    write_mvs(os.path.join(out_dir, "scene.mvs"), scene)
    out = _dense_mesh_texture(result, scene, grays, K, out_dir,
                              dense_cfg or DenseConfig(), with_mesh,
                              with_texture, verbose, dev, fusion_mode)
    out["K"] = K
    out["distortion"] = k
    out["rms_unrefined"] = rms_unrefined
    return out


def main(argv=None) -> Dict:
    """The images-directory CLI; returns ``run_pipeline_photos``'s
    outputs."""
    ap = argparse.ArgumentParser(
        description="images-directory reconstruction pipeline "
                    "(MvgMvsPipeline.py equivalent: EXIF intrinsics, "
                    "SfM + radial distortion, dense, mesh, texture)")
    ap.add_argument("images_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--preset", default="SEQUENTIAL",
                    choices=["SEQUENTIAL", "GLOBAL"])
    ap.add_argument("--fusion-mode", type=int, default=0)
    ap.add_argument("--focal-px", type=float, default=None,
                    help="override the EXIF focal bootstrap")
    ap.add_argument("--no-distortion", action="store_true",
                    help="skip radial-distortion estimation")
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--flags", nargs="*", default=[],
                    help="reference-style dense flag=value pairs")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must "
                         "be asked for)")
    args = ap.parse_args(argv)
    dense_cfg = config_from_cli_flags(
        dict(f.split("=", 1) for f in args.flags))
    K = None
    if args.focal_px is not None:
        from hcmvs_tpu_torch.io.images import list_images, load_image
        im0 = load_image(list_images(args.images_dir)[0])
        h, w = im0.shape[:2]
        K = np.array([[args.focal_px, 0, w / 2.0],
                      [0, args.focal_px, h / 2.0], [0, 0, 1.0]])
    out = run_pipeline_photos(
        args.images_dir, args.out_dir, K=K, dense_cfg=dense_cfg,
        preset=args.preset, fusion_mode=args.fusion_mode,
        with_mesh=not args.no_mesh, with_texture=not args.no_mesh,
        estimate_distortion=not args.no_distortion, device=args.device)
    print({"n_cams": len(out["sfm"].poses),
           "n_points": len(out["cloud"]["points"]),
           "rms_px": out["sfm"].reproj_rms,
           "distortion": list(map(float, out["distortion"]))})
    return out


if __name__ == "__main__":
    main()
