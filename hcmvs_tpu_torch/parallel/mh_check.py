"""Multi-process value check of the (view, tile) mesh (PyTorch port of
``hcmvs_tpu/parallel/mh_check.py``).

One process a rank; ``launch`` starts them (a ``file://`` rendezvous in
a temporary directory; ``Launch`` holds them at a gate until its
``wait``, so that their start-up overlaps other work), ``torchrun
--nproc-per-node N -m
hcmvs_tpu_torch.parallel.mh_check`` does, or by hand:

    python -m hcmvs_tpu_torch.parallel.mh_check --process-id 0 \\
        --num-processes 2 --init-method file:///tmp/rdv --device cpu &
    python -m hcmvs_tpu_torch.parallel.mh_check --process-id 1 \\
        --num-processes 2 --init-method file:///tmp/rdv --device cpu

An 8-view plane scene (32x48, 2 neighbours by default) runs a
photometric and a geometric ``scene_sweeps`` pass, the mid-pipeline
cross-view filter and depth-map fusion on the (view, tile) mesh over the
processes (``parallel.sharding``; ``--n-tile`` row bands a view, 1 by
default: the view axis alone): the geometric phase's neighbour reads, the
filter and fusion read maps gathered across them, and under the tile
axis every half-sweep ends with the halo exchange of the bands' edge
rows.  Process 0
then reruns the same schedule in one process with the same per-view
generators and compares: depth, normal and cost maps and the fused
``keep`` and points must be equal.  It prints ``MHCHECK OK`` (exit 0) or
``MHCHECK FAIL`` (exit 1) on every process, with ``depth_mismatch`` (the
share of depth pixels that differ), ``keep_agree`` and ``pt_diff``.

``--cfg`` (JSON DenseConfig overrides, repeatable) runs several configs
one after another; each prints an ``MHJSON`` line per process (walls,
launches per kernel and by output shape, peak memory, collective
seconds, calls and bytes by collective: ``parallel.halo``, the halo
exchange, ``parallel.all_gather``, the rest).

Two more stages can follow in the same processes, in this order (each
``MHJSON`` line names its ``stage``: "dense", "bench" or "ba"):
``--bench-reps N`` times N runs of the sharded schedule of
``--bench-cfg`` (JSON overrides, none by default) on ``--bench-views``
views with ``--bench-iters`` sweeps a phase (the dense stage's by
default), the first of them held against one process as above
(``MHBENCH``; ``eval.scaling`` reads it).  ``--ba-size C P``
(``eval.ba_bench``'s problem) or ``--ba-problem NPZ`` checks sharded
bundle adjustment: points split over the processes
(``sharding.shard_ba``), the LM run of ``sharding.run_ba``, the points
gathered (after one untimed step); process 0 reruns ``sfm.ba.run_ba`` in
one process, and the cost must agree within rel 1e-3 and the points
within rtol 1e-3 / atol 1e-4 (the camera sums add in another order, so
not bit for bit).  Without ``--cfg`` the dense stage runs only when
neither of the others is asked for, with no overrides.  Each line also
has its stage's seconds, set-up and one-process rerun included
(``stage_s``).  ``--device``
is ``cuda`` by default: ranks on a one-card machine share the card and
must name ``--dist-backend gloo`` (NCCL refuses two ranks on one card).
On ``cpu``, ``--ranks-per-process`` gives each process several shards
(the JAX check's ``--devices-per-process``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

BACKENDS = {
    # the port's direct bilinear scoring and direct geo gathers (what the
    # JAX package's "auto" takes on its CPU)
    "direct": {"exact_backend": "bilinear", "geo_backend": "direct"},
    # exact scoring through the sigma tables and the rect engine
    "volume": {"exact_backend": "volume", "geo_backend": "rect"},
}


def base_cfg(backend: str, overrides: Optional[dict] = None,
             iters: int = 1):
    """The JAX check's config on route ``backend``, with ``overrides``."""
    from hcmvs_tpu_torch.core.config import DenseConfig
    return DenseConfig(adapt_half_window=3, patch_half_window=3,
                       patch_step=2, estimation_iters=iters, random_iters=1,
                       use_optical_flow=0, use_geo_consistency=1,
                       use_part_consistency=0,
                       **BACKENDS[backend]).replace(**(overrides or {}))


def run_schedule(scene, cfg, seed: int, mesh=None, n_iters: int = 1):
    """Init, a photometric and a geometric ``scene_sweeps`` pass of
    ``n_iters`` sweeps, ``optimize_maps`` and fusion, every view drawing
    from its own generator: one process's schedule, or with ``mesh`` the
    mesh's (``parallel.sharding``).  Returns (state, fused)."""
    import torch
    from hcmvs_tpu_torch.dense import fusion
    from hcmvs_tpu_torch.dense import scene_driver as SD
    from hcmvs_tpu_torch.parallel import sharding as P
    n = scene.gray.shape[0]
    gens = SD.view_generators(seed, n, scene.gray.device)
    st = SD.init_scene_state(gens, scene)
    prio = torch.arange(n, dtype=torch.float32)
    if mesh is None:
        scene = SD.attach_volumes(scene, cfg)
        st = SD.scene_sweeps(st, scene, cfg, 0, n_iters, False, gens)
        st = SD.scene_sweeps(st, scene, cfg, 1, n_iters, True, gens)
        st = SD.optimize_maps(st, scene, cfg)
        fused = fusion.fuse_point_cloud(
            st.depth, st.normal, torch.clamp_min(1.0 - st.cost, 0.01),
            scene.cams, scene.nbr_idx, scene.nbr_valid, prio, cfg)
        return st, fused
    scene, st = P.shard_scene(scene, st, mesh, cfg)
    st = P.scene_sweeps(st, scene, cfg, 0, n_iters, False, gens, mesh)
    st = P.scene_sweeps(st, scene, cfg, 1, n_iters, True, gens, mesh)
    st = P.optimize_maps(st, scene, cfg, mesh)
    fused = P.fuse_point_cloud(
        st.depth, st.normal, torch.clamp_min(1.0 - st.cost, 0.01),
        scene.cams, scene.nbr_idx, scene.nbr_valid, prio, cfg, mesh)
    return st, fused


def compare(st, fused, st_ref, fused_ref) -> dict:
    """How far the view-axis run is from one process's: the shares of
    depth / normal / cost pixels that differ, of ``keep`` that agrees,
    and the largest difference of a point both keep; ``equal`` when
    every map, ``keep`` and every point are bit-equal."""
    import torch

    def differ(a, b):
        return float((a != b).float().mean())

    keep, keep_ref = fused["keep"], fused_ref["keep"]
    both = (keep & keep_ref)[:, None].expand_as(fused["points"])
    pt_diff = (float((fused["points"] - fused_ref["points"])[both].abs()
                     .max()) if both.any() else 0.0)
    out = {"depth_mismatch": differ(st.depth, st_ref.depth),
           "normal_mismatch": differ(st.normal, st_ref.normal),
           "cost_mismatch": differ(st.cost, st_ref.cost),
           "keep_agree": float((keep == keep_ref).float().mean()),
           "pt_diff": pt_diff, "kept": int(keep.sum())}
    out["equal"] = bool(
        torch.equal(st.depth, st_ref.depth)
        and torch.equal(st.normal, st_ref.normal)
        and torch.equal(st.cost, st_ref.cost) and torch.equal(keep, keep_ref)
        and all(torch.equal(fused[k], fused_ref[k]) for k in fused))
    return out


BA_RTOL, BA_ATOL = 1e-3, 1e-4
SEED = 0              # of the per-view generators


def ba_arrays(args) -> dict:
    """The BA problem's arrays: ``eval.ba_bench``'s at ``--ba-size``, or
    those of the ``--ba-problem`` file (the keys of
    ``ba_bench.make_problem_arrays``)."""
    import numpy as np
    from hcmvs_tpu_torch.eval.ba_bench import make_problem_arrays
    if args.ba_size:
        return make_problem_arrays(*args.ba_size)
    with np.load(args.ba_problem) as f:
        a = {k: f[k] for k in f.files}
    a["n_points"] = len(a["points"])
    return a


def check_ba(args, mesh, dev) -> dict:
    """The sharded LM run against one process's (on process 0)."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch.parallel import distributed as D
    from hcmvs_tpu_torch.parallel import sharding as P
    from hcmvs_tpu_torch.sfm import ba
    from hcmvs_tpu_torch.sfm.ba import BAState, build_problem, run_ba
    from hcmvs_tpu_torch.utils import profiling
    a = ba_arrays(args)
    problem = build_problem(a["K"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
                            a["n_points"], a["fixed_cams"], device=dev)
    state = BAState(*(torch.as_tensor(np.asarray(a[k]), device=dev)
                      for k in ("rvecs", "tvecs", "points")))
    n_pts = state.points.shape[0]
    local_p, local_s = P.shard_ba(problem, state, mesh)
    # one untimed step first: the device's first use of each operation
    ba.ba_step(local_p, local_s, 1e-3, cam_reduce=D.sum_in_rank_order)
    profiling.reset_report()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    out, cost = P.run_ba(local_p, local_s, mesh, n_iters=args.ba_iters)
    points = P.gather_points(out.points, n_pts, mesh)
    _sync(dev)
    rep = profiling.report()
    line = {"rank": mesh.rank, "world": mesh.world, "stage": "ba",
            "dist_backend": torch.distributed.get_backend(),
            "device": str(dev), "cams": int(state.rvecs.shape[0]),
            "points": n_pts, "observations": len(a["obs_cam"]),
            "local_observations": int(local_p.obs_cam.shape[0]),
            "iters": args.ba_iters, "wall_s": time.perf_counter() - t0,
            "cost": cost,
            "collective_s": sum(v["total_s"] for k, v in rep.items()
                                if k.startswith("parallel.")),
            "collectives": sum(v["calls"] for k, v in rep.items()
                               if k.startswith("parallel.")),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}
    if mesh.rank == 0:
        ba.ba_step(problem, state, 1e-3)
        _sync(dev)
        t0 = time.perf_counter()
        ref, ref_cost = run_ba(problem, state, n_iters=args.ba_iters)
        _sync(dev)
        line["one_process_wall_s"] = time.perf_counter() - t0
        line["one_process_cost"] = ref_cost
        line["cost_rel"] = abs(cost - ref_cost) / max(abs(ref_cost), 1e-30)
        err = (points - ref.points).abs()
        line["pt_diff"] = float(err.max())
        line["within"] = bool(
            abs(cost - ref_cost) <= BA_ATOL + BA_RTOL * abs(ref_cost)
            and bool((err <= BA_ATOL + BA_RTOL * ref.points.abs()).all()))
        if args.ba_out:
            np.savez(args.ba_out, points=points.cpu().numpy(),
                     rvecs=out.rvecs.cpu().numpy(),
                     tvecs=out.tvecs.cpu().numpy(), cost=cost,
                     one_process_points=ref.points.cpu().numpy(),
                     one_process_cost=ref_cost)
    return line


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (file:///path or tcp://host:port);"
                         " default tcp://localhost:PORT")
    ap.add_argument("--port", type=int, default=9911)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dist-backend", default=None,
                    choices=["gloo", "nccl"],
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--ranks-per-process", type=int, default=1,
                    help="mesh shards a process (cpu only)")
    ap.add_argument("--n-tile", type=int, default=1,
                    help="row bands a view (the tile axis of the mesh)")
    ap.add_argument("--backend", default="direct", choices=list(BACKENDS))
    ap.add_argument("--cfg", action="append", default=None,
                    help="JSON DenseConfig overrides; repeat to run "
                         "several configs")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--w", type=int, default=48)
    ap.add_argument("--nbrs", type=int, default=2)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--iters", type=int, default=1,
                    help="sweeps a phase")
    ap.add_argument("--ba-size", type=int, nargs=2, default=None,
                    metavar=("CAMS", "POINTS"),
                    help="check sharded BA on eval.ba_bench's problem")
    ap.add_argument("--ba-problem", default=None,
                    help="check sharded BA on the problem of this .npz")
    ap.add_argument("--ba-iters", type=int, default=8)
    ap.add_argument("--ba-out", default=None,
                    help="process 0 writes the sharded and one-process "
                         "results here (.npz)")
    ap.add_argument("--start-after", default=None,
                    help="wait until this file exists before joining the "
                         "group (a launcher starts the processes ahead of "
                         "their turn)")
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="then time N runs of the sharded schedule of "
                         "--bench-cfg and print an MHBENCH line")
    ap.add_argument("--bench-cfg", default="{}",
                    help="JSON DenseConfig overrides of the timed runs")
    ap.add_argument("--bench-views", type=int, default=None,
                    help="views of the timed runs (default --views)")
    ap.add_argument("--bench-iters", type=int, default=None,
                    help="sweeps a phase of the timed runs (default "
                         "--iters)")
    args = ap.parse_args(argv)
    if args.ranks_per_process != 1 and args.device != "cpu":
        ap.error("--ranks-per-process is for --device cpu")

    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.entry import build_scene
    from hcmvs_tpu_torch.parallel import distributed as D
    while args.start_after and not os.path.exists(args.start_after):
        time.sleep(0.05)
    if args.device == "cpu":
        torch.set_num_threads(1)        # processes share the host's cores
    elif not torch.cuda.is_available():
        raise SystemExit("mh_check: no CUDA device (pass --device cpu)")
    if args.init_method is None and "RANK" in os.environ:   # torchrun
        D.initialize(backend=args.dist_backend, device=args.device)
    else:
        D.initialize(args.init_method or f"localhost:{args.port}",
                     args.num_processes, args.process_id, args.dist_backend,
                     args.device)
    dev = D.local_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kernels.library()
    mesh = D.global_mesh(n_tile=args.n_tile, device=dev,
                         shards_per_process=args.ranks_per_process)
    rank = D.world()[0]
    ba = bool(args.ba_size or args.ba_problem)
    cfgs = args.cfg or ([] if ba or args.bench_reps else ["{}"])
    ok = True
    dense = []
    scenes = {}

    def scene_of(n_views):
        if n_views not in scenes:
            scenes[n_views] = build_scene(n_views, args.h, args.w, dev,
                                          n_nbr=args.nbrs, fx=args.fx)
        return scenes[n_views]

    def stage(run, verdict):
        """Runs one stage, prints its line with its seconds (set-up and
        the one-process rerun included) and returns it."""
        nonlocal ok
        t0 = time.perf_counter()
        line = run()
        line["stage_s"] = time.perf_counter() - t0
        print("MHJSON " + json.dumps(line), flush=True)
        ok = _agreed(line.get(verdict, 0), dev) and ok
        return line

    for text in cfgs:
        dense.append(stage(lambda: run_config(
            scene_of(args.views), text, args.iters, args, mesh, dev),
            "equal"))
    if args.bench_reps:
        stage(lambda: run_config(
            scene_of(args.bench_views or args.views), args.bench_cfg,
            args.bench_iters or args.iters, args, mesh, dev,
            args.bench_reps), "equal")
    scenes.clear()
    if ba:
        line = stage(lambda: check_ba(args, mesh, dev), "within")
    said = f"[p{rank}] MHCHECK {'OK' if ok else 'FAIL'}"
    if rank == 0 and dense:
        last = dense[-1]
        said += (f" depth_mismatch={last['depth_mismatch']:.4f} "
                 f"keep_agree={last['keep_agree']:.4f} "
                 f"pt_diff={last['pt_diff']:.2e} kept={last['kept']}")
    if rank == 0 and ba:
        said += (f" ba cost_rel={line['cost_rel']:.2e} "
                 f"pt_diff={line['pt_diff']:.2e}")
    print(said, flush=True)
    D.shutdown()
    return 0 if ok else 1


def _agreed(verdict, dev) -> bool:
    """Process 0's verdict (0 or 1), the same on every process."""
    import torch
    from hcmvs_tpu_torch.parallel import distributed as D
    t = torch.tensor([int(verdict)], dtype=torch.int64)
    return bool(D.replicated(t.to(dev)).cpu()[0])


def run_config(scene, text: str, iters: int, args, mesh, dev,
               bench_reps: int = 0) -> dict:
    """The sharded schedule of config ``text`` (JSON overrides of route
    ``args.backend``) on ``scene`` (launches counted around it alone),
    with ``bench_reps`` timed as that many runs, this one the first
    (``MHBENCH``), then on process 0 the same schedule in one process,
    compared; returns this process's ``MHJSON`` line."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.dense.bands import halo_rows
    from hcmvs_tpu_torch.kernels.shapes import launch_shapes
    from hcmvs_tpu_torch.parallel import distributed as D
    from hcmvs_tpu_torch.parallel import sharding as P
    from hcmvs_tpu_torch.utils import profiling
    rank, world = D.world()
    backend = torch.distributed.get_backend()
    n_views = scene.gray.shape[0]
    cfg = base_cfg(args.backend, json.loads(text), iters)
    kernels.reset_launches()
    profiling.reset_report()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    with launch_shapes() as shapes:
        st, fused = run_schedule(scene, cfg, SEED, mesh, iters)
        _sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    rep = profiling.report()
    bands = P.scene_bands(mesh, args.h, cfg) if mesh.n_tile > 1 else None
    line = {"rank": rank, "world": world,
            "stage": "bench" if bench_reps else "dense",
            "dist_backend": backend, "device": str(dev),
            "cfg": json.loads(text), "mesh": [mesh.n_view, mesh.n_tile],
            "views": list(mesh.sweep_views(n_views)),
            "bands": [[bands[b].start, bands[b].stop]
                      for b in mesh.tile_bands()] if bands else None,
            "halo_rows": halo_rows(cfg) if bands else None,
            "wall_s": wall, "launches": launches,
            "launches_by_shape": {k: dict(v) for k, v in shapes.items()},
            "collective_s": sum(v["total_s"] for k, v in rep.items()
                                if k.startswith("parallel.")),
            "collectives": sum(v["calls"] for k, v in rep.items()
                               if k.startswith("parallel.")),
            "by_collective": {k: {"calls": v["calls"], "s": v["total_s"],
                                  "bytes": v.get("bytes")}
                              for k, v in rep.items()
                              if k.startswith("parallel.")},
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}
    if bench_reps:
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(bench_reps - 1):
            run_schedule(scene, cfg, SEED, mesh, iters)
            _sync(dev)
        line["bench_wall_s"] = (wall + time.perf_counter() - t0) / bench_reps
        print(f"MHBENCH wall_s={line['bench_wall_s']:.6f} "
              f"reps={bench_reps} procs={world}", flush=True)
    if rank == 0:
        t0 = time.perf_counter()
        st_ref, fused_ref = run_schedule(scene, cfg, SEED, None, iters)
        _sync(dev)
        line["one_process_wall_s"] = time.perf_counter() - t0
        line.update(compare(st, fused, st_ref, fused_ref))
        del st_ref, fused_ref
    del st, fused
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


class Launch:
    """``mh_check`` (``args`` after the rendezvous ones) as
    ``n_processes`` processes joined through a ``file://`` rendezvous in
    a temporary directory (under ``workdir`` if given), started ahead of
    their turn: they load Python and PyTorch, then wait at a gate until
    ``wait`` opens it, so their start-up overlaps whatever runs
    meanwhile.  A CUDA run's kernels are built here first, so that the
    processes do not build them side by side."""

    def __init__(self, n_processes: int, args: List[str],
                 workdir: Optional[str] = None, env: Optional[dict] = None):
        if "cpu" not in args:
            from hcmvs_tpu_torch import kernels
            kernels.build()
        repo = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        self._tmp = tempfile.TemporaryDirectory(prefix="mh_check_",
                                                dir=workdir)
        tmp = Path(self._tmp.name)
        self.gate = tmp / "go"
        self.logs = [tmp / f"rank{r}.log" for r in range(n_processes)]
        self.procs = []
        try:
            for r in range(n_processes):
                with self.logs[r].open("w") as fh:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "hcmvs_tpu_torch.parallel.mh_check",
                         "--process-id", str(r), "--num-processes",
                         str(n_processes), "--init-method",
                         (tmp / "rendezvous").as_uri(), "--start-after",
                         str(self.gate), *args],
                        stdout=fh, stderr=subprocess.STDOUT, env=env,
                        cwd=repo))
        except BaseException:
            self.close()
            raise

    def wait(self, timeout: float = 600.0) -> List[str]:
        """Opens the gate and returns each process's output in rank
        order; raises, with the outputs, as soon as one process fails or
        when ``timeout`` seconds pass.  Every process is ended before this
        returns."""
        try:
            self.gate.touch()
            t_end = time.monotonic() + timeout
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs)
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() > t_end:
                    break
                time.sleep(0.2)
            self._end()
            outs = [log.read_text() for log in self.logs]
        finally:
            self.close()
        rcs = [p.returncode for p in self.procs]
        if any(rcs):
            raise RuntimeError(f"mh_check: return codes {rcs}\n" + "\n".join(
                f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
        return outs

    def _end(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def close(self) -> None:
        """Ends every process and removes the launch's directory."""
        self._end()
        self._tmp.cleanup()


def launch(n_processes: int, args: List[str], timeout: float = 600.0,
           workdir: Optional[str] = None, env: Optional[dict] = None
           ) -> List[str]:
    """``Launch`` and its ``wait``: each process's output in rank
    order."""
    return Launch(n_processes, args, workdir, env).wait(timeout)


def parse_lines(outs: List[str], tag: str = "MHJSON") -> List[dict]:
    """The JSON lines of ``launch``'s outputs tagged ``tag``."""
    return [json.loads(line[len(tag) + 1:]) for out in outs
            for line in out.splitlines() if line.startswith(tag + " ")]


if __name__ == "__main__":
    sys.exit(main())
