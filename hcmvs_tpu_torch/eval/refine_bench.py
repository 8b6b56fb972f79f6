"""Mesh-refinement benchmark: the raster ZNCC-gradient step at the
reference's size class (640x480, 8 views) (PyTorch port of
``hcmvs_tpu/eval/refine_bench.py``; ref: SceneRefineCUDA.cpp:62-1944,
the reference's only GPU code).

    python -m hcmvs_tpu_torch.eval.refine_bench            # the card
    python -m hcmvs_tpu_torch.eval.refine_bench --cpu --iters 2

Prints one JSON line: seconds per ``mesh.refine.raster_refine_grad``
call (the device part of a refine iteration, device synchronised; the
least of ``--iters``) and per host rasterization pass of every view
(``mesh_ops.rasterize_attributes``, once per scale in the refine loop).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_case(h=480, w=640, n_views=8, grid=96, noise=0.01, seed=0,
               texture_device=None):
    """Ridge scene + a noisy surface mesh to refine: the ground-truth
    view-0 depth grid triangulated at ``grid`` rows, vertices jittered
    along the view ray (what refinement must undo).  numpy only, the JAX
    package's arithmetic: the same arguments give the same arrays.  With
    ``texture_device`` the images' texture sums run on that device
    (``synth.blob_texture_fn``; a minute of numpy at 640x480 becomes a
    fraction of a second on the card, the exps' last bits the device's)."""
    from hcmvs_tpu_torch.utils.synth import blob_texture_fn, make_ridge_scene
    rng = np.random.default_rng(seed)
    tex = (None if texture_device is None
           else blob_texture_fn(rng, device=texture_device))
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=180.0 * w / 192.0, texture_fn=tex)
    K = sc.cameras[0].K.numpy()
    # regular grid over view 0, backprojected at GT depth
    gy = np.linspace(4, h - 5, grid)
    gx = np.linspace(4, w - 5, int(grid * w / h))
    vv, uu = np.meshgrid(gy, gx, indexing="ij")
    d = sc.depth_gt[vv.astype(int), uu.astype(int)]
    rays = np.linalg.inv(K) @ np.stack(
        [uu.ravel(), vv.ravel(), np.ones(uu.size)])
    V = (rays * d.ravel()).T
    n_gy, n_gx = vv.shape
    faces = []
    for r in range(n_gy - 1):
        for c in range(n_gx - 1):
            a = r * n_gx + c
            faces.append([a, a + 1, a + n_gx])
            faces.append([a + 1, a + n_gx + 1, a + n_gx])
    faces = np.asarray(faces, np.int32)
    V_noisy = V * (1.0 + rng.normal(0, noise, (len(V), 1)))
    imgs = np.stack([im for im in sc.images]).astype(np.float32)
    Ks = np.stack([c.K.numpy() for c in sc.cameras])
    Rs = np.stack([c.R.numpy() for c in sc.cameras])
    Cs = np.stack([c.C.numpy() for c in sc.cameras])
    pairs = np.asarray([[0, i] for i in range(1, n_views)]
                       + [[i, 0] for i in range(1, n_views)], np.int32)
    return sc, V, V_noisy, faces, imgs, Ks, Rs, Cs, pairs


def run(h: int = 480, w: int = 640, n_views: int = 8, iters: int = 3,
        device="cuda") -> dict:
    """The host rasterization of every view and ``iters`` timed gradient
    calls (after one untimed first call) on ``device``, on the
    ``build_case`` of this size (its texture made on the card when
    ``device`` is one)."""
    import torch
    from hcmvs_tpu_torch.mesh.mesh_ops import rasterize_attributes
    from hcmvs_tpu_torch.mesh.refine import RasterRefine, ScaleRasters
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    from hcmvs_tpu_torch.utils.profiling import synchronize
    dev = resolve_device(device)
    _sc, _V_gt, V0, faces, imgs, Ks, Rs, Cs, pairs = build_case(
        h, w, n_views, texture_device=dev if dev.type == "cuda" else None)
    t0 = time.perf_counter()
    out = [rasterize_attributes(V0.astype(np.float64), faces, Ks[i], Rs[i],
                                Cs[i], h, w) for i in range(len(imgs))]
    t_raster = time.perf_counter() - t0
    dep, fid, bar = (np.stack(a) for a in zip(*out))
    rr = RasterRefine(faces, imgs, Ks, Rs, Cs, pairs, len(V0), dev)
    rasters = ScaleRasters(torch.as_tensor(fid, device=dev).long(),
                           torch.as_tensor(bar, device=dev),
                           torch.as_tensor(dep.astype(np.float32),
                                           device=dev), len(faces))
    V = torch.as_tensor(V0, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    g, _ = rr.grad(V, rasters)
    synchronize(dev)
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        g, _ = rr.grad(V, rasters)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("refine_bench: non-finite gradient")
    return {"metric": "mesh_refine_grad_iteration", "grad_s": min(times),
            "first_exec_s": t_first, "host_raster_s_per_scale": t_raster,
            "size": f"{w}x{h}", "views": n_views, "pairs": int(len(pairs)),
            "verts": int(len(V0)), "faces": int(len(faces)),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    out = run(args.h, args.w, args.views, args.iters,
              "cpu" if args.cpu else "cuda")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
