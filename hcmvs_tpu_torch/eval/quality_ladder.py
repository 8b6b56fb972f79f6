"""Quality-vs-resolution ladder (PyTorch port of
``hcmvs_tpu/eval/quality_ladder.py``): view 0's depth accuracy after every
external iteration on the ridge scene at a chosen size, focal length and
set of schedule knobs.

    python -m hcmvs_tpu_torch.eval.quality_ladder --h 960 --w 1280 --fx 1200

It prints one JSON line per external iteration (``acc2pct`` / ``acc1pct``:
the share of view 0's pixels with a depth, among those with ground truth,
within 2% / 1% of it; ``wall`` its seconds, the device synchronised), one
after each mid-schedule filter, and a final line after the confidence
threshold (``valid``: the kept share of view 0).  The scene is
``make_ridge_scene`` (seed 0, spacing 0.25), each view's first three other
views as neighbours, the depth range from the ground truth.  The flags are
the JAX package's, with ``--device`` (default ``cuda``) in place of
``--cpu``; ``--cfg`` takes a JSON dict of further ``DenseConfig`` fields
(``'{"volume_streaming": true}'``, ``'{"view_spread": 1}'``, ...), applied
last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hcmvs_tpu_torch.eval.quality_ladder",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--fx", type=float, default=180.0)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--ext", type=int, default=3)
    ap.add_argument("--photo2geo", type=int, default=1)
    ap.add_argument("--adapt-hw", type=int, default=5)
    ap.add_argument("--patch-hw", type=int, default=3)
    ap.add_argument("--patch-step", type=int, default=2)
    ap.add_argument("--explore-step", type=int, default=4)
    ap.add_argument("--random-iters", type=int, default=3)
    ap.add_argument("--optimize", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--geo-backend", default="auto")
    ap.add_argument("--exact-backend", default="auto")
    ap.add_argument("--volume-planes", type=int, default=128)
    ap.add_argument("--cfg", default="",
                    help="JSON dict of extra DenseConfig field overrides "
                         "(applied last)")
    return ap


def ladder_scene(h: int, w: int, fx: float, n_views: int, device):
    """(RidgeScene, SceneTensors): the ladder's ridge scene on ``device``,
    the first min(3, n_views - 1) other views as each view's neighbours,
    d_min / d_max 0.7 / 1.4 times the ground truth's extremes.  The blob
    texture (1,200 exp a pixel) is summed on ``device`` when it is a card
    (the same blobs; the card's float64 exp), in numpy otherwise (the JAX
    package's images bit for bit)."""
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.utils.synth import blob_texture_fn, make_ridge_scene
    on_card = torch.device(device).type == "cuda"
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views, spacing=0.25, fx=fx,
                          texture_fn=blob_texture_fn(
                              np.random.default_rng(0),
                              device=device if on_card else None))
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(device)
    v = min(3, n_views - 1)
    nbr = [[j for j in range(n_views) if j != i][:v] for i in range(n_views)]
    zs = sc.depth_gt[sc.depth_gt > 0]
    scene = SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]
                         ).to(device),
        cams=cams, nbr_idx=torch.tensor(nbr, device=device),
        nbr_valid=torch.ones(n_views, v, dtype=torch.bool, device=device),
        d_min=torch.full((n_views,), float(zs.min()) * 0.7,
                         dtype=torch.float32, device=device),
        d_max=torch.full((n_views,), float(zs.max()) * 1.4,
                         dtype=torch.float32, device=device))
    return sc, scene


def ladder_cfg(args):
    from hcmvs_tpu_torch.core.config import DenseConfig
    cfg = DenseConfig(adapt_half_window=args.adapt_hw,
                      patch_half_window=args.patch_hw,
                      patch_step=args.patch_step,
                      explore_patch_step=args.explore_step,
                      estimation_iters=args.iters,
                      estimation_iters_external=args.ext,
                      photo2geo=args.photo2geo,
                      random_iters=args.random_iters,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=0, optimize=args.optimize,
                      geo_backend=args.geo_backend,
                      exact_backend=args.exact_backend,
                      volume_planes=args.volume_planes)
    if args.cfg:
        cfg = cfg.replace(**json.loads(args.cfg))
    return cfg


def accuracy(depth0: np.ndarray, gt: np.ndarray):
    """(acc2pct, acc1pct) of a depth map against the ground truth, over
    the pixels where both are positive."""
    valid = (depth0 > 0) & (gt > 0)
    rel = np.abs(depth0 - gt) / np.maximum(gt, 1e-9)
    n = max(int(valid.sum()), 1)
    return (float(((rel < 0.02) & valid).sum() / n),
            float(((rel < 0.01) & valid).sum() / n))


def run(argv: Optional[List[str]] = None, emit=print) -> List[dict]:
    """Run the ladder; each record is passed to ``emit`` as a JSON line and
    returned (the final record also carries view 0's depth map as
    ``depth0``, not printed)."""
    from hcmvs_tpu_torch.dense.scene_driver import (attach_volumes, finalize,
                                                    init_scene_state,
                                                    optimize_maps, phase_cfg,
                                                    scene_sweeps)
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    from hcmvs_tpu_torch.utils.profiling import synchronize
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    sc, scene = ladder_scene(args.h, args.w, args.fx, args.views, dev)
    cfg = ladder_cfg(args)
    records = []

    def out(rec):
        records.append(rec)
        emit(json.dumps({k: v for k, v in rec.items() if k != "depth0"}))

    def acc_of(depth):
        return accuracy(depth[0].cpu().numpy(), sc.depth_gt)

    gen = torch.Generator(device=dev).manual_seed(0)
    t00 = time.perf_counter()
    state = init_scene_state(gen, scene)
    scene = attach_volumes(scene, cfg)
    n_ext = cfg.estimation_iters_external
    for it_ext in range(n_ext):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        t0 = time.perf_counter()
        state = scene_sweeps(state, scene,
                             phase_cfg(cfg, phase, it_ext == n_ext - 1),
                             phase, cfg.estimation_iters, phase >= 1, gen)
        synchronize(dev)
        wall = time.perf_counter() - t0
        a2, a1 = acc_of(state.depth)
        out({"it_ext": it_ext, "phase": phase, "acc2pct": round(a2, 4),
             "acc1pct": round(a1, 4), "wall": round(wall, 1)})
        if cfg.optimize and it_ext in (1, 2):
            state = optimize_maps(state, scene, cfg)
            a2, a1 = acc_of(state.depth)
            out({"it_ext": it_ext, "stage": "optimize",
                 "acc2pct": round(a2, 4), "acc1pct": round(a1, 4)})
    depth, _, _ = finalize(state, cfg)
    synchronize(dev)
    a2, a1 = acc_of(depth)
    d0 = depth[0].cpu().numpy()
    out({"final": True, "acc2pct": round(a2, 4), "acc1pct": round(a1, 4),
         "valid": round(float((d0 > 0).mean()), 3),
         "size": f"{args.w}x{args.h}", "fx": args.fx,
         "total_wall": round(time.perf_counter() - t00, 1), "depth0": d0})
    return records


def main(argv: Optional[List[str]] = None) -> int:
    run(argv, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
