"""Scaling of the view axis over processes (PyTorch port of
``hcmvs_tpu/eval/scaling.py``).

``run`` times the ``parallel.mh_check`` schedule (a photometric and a
geometric pass of two sweeps, the filter, fusion) on an 8-view scene over
1, 2, 4 and 8 Gloo processes on the host CPU, one thread each: the
counterpart of the JAX module's virtual devices.  Processes share the
host's cores, so the ideal ratio is near 1 / k on k cores and near 1 once
they are oversubscribed; a blow-up flags collective overhead.
``run_multiprocess`` times the same schedule over two processes on
``device`` (default the card: two processes sharing it over Gloo when
there is one card, NCCL across two cards when there are two) and runs
its value check, in a launch of its own or, given the line, in one that
also ran other stages (``bench_stage_args``).

    python -m hcmvs_tpu_torch.eval.scaling [--multiprocess] [--device cpu]

Prints one JSON line with the JAX module's keys: ``wall_s_{k}dev`` and
``ratio_{k}dev`` (k processes), and with ``--multiprocess``
``wall_s_2proc_{r}dev`` (r view shards a process) and ``value_check``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from hcmvs_tpu_torch.parallel import mh_check

# the JAX module's schedule: 8 views, 2 sweeps a phase, 2 random steps
N_VIEWS = 8
_ITERS = 2
_CFG = {"random_iters": 2}


def _scene(h: int, w: int, nbrs: int, backend: str, fx=None) -> list:
    return (["--h", str(h), "--w", str(w), "--nbrs", str(nbrs), "--backend",
             backend] + ([] if fx is None else ["--fx", str(fx)]))


def bench_stage_args(reps: int, n_views: int = N_VIEWS) -> list:
    """``mh_check``'s arguments of the timed stage: ``reps`` runs of the
    JAX module's schedule on ``n_views`` views; the scene's size,
    neighbours and route are the launch's own."""
    return ["--bench-views", str(n_views), "--bench-iters", str(_ITERS),
            "--bench-cfg", json.dumps(_CFG), "--bench-reps", str(reps)]


def bench_line(lines) -> dict:
    """Process 0's ``MHJSON`` line of the timed stage among ``lines``
    (``mh_check.parse_lines``)."""
    return next(r for r in lines if r["rank"] == 0 and r["stage"] == "bench")


def _bench(n_proc: int, args: list, timeout: float) -> dict:
    outs = mh_check.launch(n_proc, args, timeout=timeout)
    return bench_line(mh_check.parse_lines(outs))


def run(h: int = 64, w: int = 96, n_views: int = N_VIEWS, n_reps: int = 3,
        ranks=(1, 2, 4, 8), timeout: float = 900.0) -> dict:
    """Seconds a schedule over each process count in ``ranks`` that
    divides ``n_views``, on the CPU, and the ratios to one process."""
    results = {}
    for k in ranks:
        if n_views % k:
            continue
        rep = _bench(k, ["--device", "cpu", *_scene(h, w, 3, "direct"),
                         *bench_stage_args(n_reps, n_views)], timeout)
        results[k] = rep["bench_wall_s"]
    report = {f"wall_s_{k}dev": v for k, v in results.items()}
    if 1 in results:
        report.update({f"ratio_{k}dev": v / results[1]
                       for k, v in results.items()})
    return report


def run_multiprocess(reps: int = 5, timeout: float = 900.0,
                     device: str = "cuda", h: int = 32, w: int = 48,
                     nbrs: int = 3, backend: str = "direct",
                     fx: Optional[float] = None,
                     line: Optional[dict] = None) -> dict:
    """The schedule over two processes on ``device`` (on the CPU with
    four view shards each, as the JAX module's 2 x 4 devices) on the
    8-view scene of ``h`` x ``w`` (the JAX module's 32x48 by default) on
    route ``backend``: process 0's seconds a run and its value check
    against one process.  ``line``: process 0's timed-stage line
    (``bench_line``) of a two-process launch on ``device`` that ran
    ``bench_stage_args`` with these scene arguments, taken instead of a
    launch of its own."""
    if line is None:
        import torch
        args = ["--device", device]
        if device == "cpu":
            args += ["--ranks-per-process", "4"]
        else:
            args += ["--dist-backend",
                     "nccl" if torch.cuda.device_count() >= 2 else "gloo"]
        line = _bench(2, [*args, *_scene(h, w, nbrs, backend, fx),
                          *bench_stage_args(reps)], timeout)
    shards = line["mesh"][0] * line["mesh"][1] // line["world"]
    return {f"wall_s_2proc_{shards}dev": line["bench_wall_s"],
            "value_check": "OK" if line["equal"] else "FAIL",
            "dist_backend": line["dist_backend"], "device": line["device"],
            "size": f"{w}x{h}", "nbrs": nbrs, "backend": backend}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multiprocess", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of --multiprocess (run() is the CPU's)")
    args = ap.parse_args(argv)
    out = run()
    if args.multiprocess:
        out.update(run_multiprocess(device=args.device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
