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
its value check.

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

# the JAX module's config: 2 sweeps a phase, 2 random steps
_ARGS = ("--iters", "2", "--cfg", json.dumps({"random_iters": 2}))


def _scene(h: int, w: int, nbrs: int, backend: str, fx=None) -> list:
    return (["--h", str(h), "--w", str(w), "--nbrs", str(nbrs), "--backend",
             backend, *_ARGS] + ([] if fx is None else ["--fx", str(fx)]))


def _bench(n_proc: int, args: list, reps: int, timeout: float) -> dict:
    outs = mh_check.launch(n_proc, [*args, "--bench-reps", str(reps)],
                           timeout=timeout)
    return next(r for r in mh_check.parse_lines(outs) if r["rank"] == 0)


def run(h: int = 64, w: int = 96, n_views: int = 8, n_reps: int = 3,
        ranks=(1, 2, 4, 8), timeout: float = 900.0) -> dict:
    """Seconds a schedule over each process count in ``ranks`` that
    divides ``n_views``, on the CPU, and the ratios to one process."""
    results = {}
    for k in ranks:
        if n_views % k:
            continue
        rep = _bench(k, ["--device", "cpu", "--views", str(n_views),
                         *_scene(h, w, 3, "direct")], n_reps, timeout)
        results[k] = rep["bench_wall_s"]
    report = {f"wall_s_{k}dev": v for k, v in results.items()}
    if 1 in results:
        report.update({f"ratio_{k}dev": v / results[1]
                       for k, v in results.items()})
    return report


def run_multiprocess(reps: int = 5, timeout: float = 900.0,
                     device: str = "cuda", h: int = 32, w: int = 48,
                     nbrs: int = 3, backend: str = "direct",
                     fx: Optional[float] = None) -> dict:
    """The schedule over two processes on ``device`` (on the CPU with
    four view shards each, as the JAX module's 2 x 4 devices) on the
    8-view scene of ``h`` x ``w`` (the JAX module's 32x48 by default) on
    route ``backend``: process 0's seconds a run and its value check
    against one process."""
    import torch
    args = ["--device", device]
    shards = 1
    if device == "cpu":
        shards = 4
        args += ["--ranks-per-process", str(shards)]
    else:
        args += ["--dist-backend",
                 "nccl" if torch.cuda.device_count() >= 2 else "gloo"]
    rep = _bench(2, [*args, *_scene(h, w, nbrs, backend, fx)], reps,
                 timeout)
    return {f"wall_s_2proc_{shards}dev": rep["bench_wall_s"],
            "value_check": "OK" if rep["equal"] else "FAIL",
            "dist_backend": rep["dist_backend"], "device": rep["device"],
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
