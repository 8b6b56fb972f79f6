"""Entry points: one sweep step of the dense stage and the
multi-process dry run (PyTorch port of the JAX package's
``__graft_entry__.py``), and the bench's workload (``bench._build``).

    python -m hcmvs_tpu_torch.entry --dryrun 2 [--device cpu]

``entry()`` returns (fn, example args): a photometric and a geometric
``scene_sweeps`` pass on a 4-view 96x128 plane scene.  ``dryrun_multichip``
runs one full step of the schedule (two sweeps a phase, the filter,
fusion) on the (view, tile) mesh over ``n`` processes
(``parallel.mh_check``; two row bands a view when ``n`` is even and at
least 4, as the JAX package's dry run) and holds it against one process:
the maps, ``keep`` and points must be bit-equal.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense.scene_driver import (SceneTensors,
                                                attach_volumes,
                                                init_scene_state,
                                                scene_sweeps,
                                                view_generators)
from hcmvs_tpu_torch.utils.synth import make_plane_scene


def build_scene(n_views: int, h: int, w: int, device="cuda",
                rng_seed: int = 0, n_nbr: int = 3,
                fx: Optional[float] = None) -> SceneTensors:
    """The plane scene of ``n_views`` views, each with the next
    min(``n_nbr``, n_views - 1) views as neighbours (the JAX package's
    ``__graft_entry__._build_scene``; ``bench._build`` at 3), its focal
    length ``make_plane_scene``'s unless ``fx`` is given.  On a card the
    texture's sines run there (seconds of numpy at 1280x960 a view)."""
    on_card = torch.device(device).type == "cuda"
    sc = make_plane_scene(np.random.default_rng(rng_seed), h=h, w=w,
                          n_views=n_views,
                          texture_device=device if on_card else None,
                          **({} if fx is None else {"fx": fx}))
    v = min(n_nbr, n_views - 1)
    nbr = [[j for j in range(n_views) if j != i][:v] for i in range(n_views)]
    return SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]
                         ).to(device),
        cams=Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                      for f in "KRC")).to(device),
        nbr_idx=torch.tensor(nbr, device=device),
        nbr_valid=torch.ones((n_views, v), dtype=torch.bool, device=device),
        d_min=torch.full((n_views,), sc.d_min, device=device),
        d_max=torch.full((n_views,), sc.d_max, device=device))


def bench_cfg() -> DenseConfig:
    """``bench._build``'s config (2 sweeps a phase, 4 random steps)."""
    return DenseConfig(adapt_half_window=5, patch_half_window=3,
                       patch_step=2, estimation_iters=2, random_iters=4,
                       use_optical_flow=0, use_geo_consistency=1,
                       use_part_consistency=1)


def entry(device="cuda"):
    """(fn, example_args): one batched PatchMatch sweep step on the
    multi-view dense model (photometric + geometric phases, the scene's
    tables attached); ``fn`` draws from per-view generators of its own,
    so two calls agree."""
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3, patch_step=2,
                      estimation_iters=1, random_iters=2,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=1)
    scene = attach_volumes(build_scene(n_views=4, h=96, w=128,
                                       device=device), cfg)
    state = init_scene_state(view_generators(0, 4, device), scene)

    def fn(state, scene):
        gens = view_generators(1, scene.gray.shape[0], scene.gray.device)
        state = scene_sweeps(state, scene, cfg, 0, 1, False, gens)
        return scene_sweeps(state, scene, cfg, 1, 1, True, gens)

    return fn, (state, scene)


# the dry run's config (__graft_entry__.py:82-86): tables of 256 planes
# (the per-plane build and B at D = 256), the rect engine, 2 sweeps a
# phase, 8 or more images
DRYRUN_OVERRIDES = {"volume_planes": 256}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 900.0) -> dict:
    """One full step of the schedule (a photometric and a geometric pass
    of two sweeps, ``optimize_maps``, fusion) on max(2n, 8) 64x96 images
    on the (n / n_tile, n_tile) mesh of ``n_devices`` processes, n_tile 2
    when ``n_devices`` is even and at least 4, else 1
    (``__graft_entry__.py:68-70``), held against one process: every map,
    ``keep`` and every point must be bit-equal (the mesh adds no
    reduction across views, and the row bands compute what the whole
    view does at their rows; see ``parallel.sharding``).  On CUDA the
    processes use NCCL when there is a card for each, else Gloo on the
    shared card.  Returns process 0's report; raises if a process fails
    or the maps differ."""
    from hcmvs_tpu_torch.parallel import mh_check
    dev = torch.device(device)
    n_imgs = max(2 * n_devices, 8)
    n_tile = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    outs = mh_check.launch(n_devices, [
        "--device", dev.type, "--dist-backend", backend, "--views",
        str(n_imgs), "--h", "64", "--w", "96", "--nbrs", "3", "--iters",
        "2", "--backend", "volume", "--n-tile", str(n_tile), "--cfg",
        json.dumps(DRYRUN_OVERRIDES)], timeout=timeout)
    rep = next(r for r in mh_check.parse_lines(outs) if r["rank"] == 0)
    if not rep["equal"]:
        raise AssertionError(f"dryrun_multichip: the mesh differs from one "
                             f"process: {rep}")
    n_view, n_tile = rep["mesh"]
    print(f"[dryrun_multichip] mesh=({n_view}x{n_tile}) images={n_imgs} "
          f"backend={rep['dist_backend']} fused_points={rep['kept']} "
          f"depth_mismatch={rep['depth_mismatch']:.4f} "
          f"keep_agree={rep['keep_agree']:.4f} OK", flush=True)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=2, metavar="N",
                    help="processes of the dry run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
