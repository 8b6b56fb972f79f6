"""The host CPU's rate on the bench's workload (PyTorch port of
``hcmvs_tpu/eval/cpu_anchor.py``): the denominator a card's views/s is
compared with.

The reference cannot be built here (BUILD_REFERENCE_LOG.md), so the
closest measurement is the port's own dense stage on the host CPU at the
bench's workload (``bench._build``, rebuilt in ``entry.bench_cfg`` /
``entry.build_scene``: 4 views, 3 neighbours, 2 sweeps x 2 phases, a
round of a photometric and a geometric ``scene_sweeps`` pass), through
the kernels' plain versions (the CPU route of every kernel).

    python -m hcmvs_tpu_torch.eval.cpu_anchor [--sizes 240x320,480x640]

Prints one JSON line per size:
    {"metric": "cpu_views_per_s", "h":..., "w":..., "value":...,
     "round_s":..., "n_threads":..., "unit": ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="240x320,480x640",
                    help="comma list of HxW")
    ap.add_argument("--n-views", type=int, default=4)
    ap.add_argument("--v-nbr", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from hcmvs_tpu_torch.dense.scene_driver import (attach_volumes,
                                                    init_scene_state,
                                                    phase_cfg, scene_sweeps,
                                                    view_generators)
    from hcmvs_tpu_torch.entry import bench_cfg, build_scene

    n_threads = torch.get_num_threads()
    lines = []
    for size in args.sizes.split(","):
        h, w = (int(t) for t in size.split("x"))
        cfg = bench_cfg()
        scene = attach_volumes(build_scene(args.n_views, h, w, "cpu",
                                           n_nbr=args.v_nbr), cfg)
        gens = view_generators(0, args.n_views, "cpu")
        state = init_scene_state(gens, scene)

        def one_round(st):
            st = scene_sweeps(st, scene, phase_cfg(cfg, 0), 0,
                              cfg.estimation_iters, False, gens)
            return scene_sweeps(st, scene, phase_cfg(cfg, 1, True), 1,
                                cfg.estimation_iters, True, gens)

        state = one_round(state)            # warm-up
        per_round = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            state = one_round(state)
            per_round.append(time.perf_counter() - t0)
        elapsed = min(per_round)
        line = {"metric": "cpu_views_per_s", "h": h, "w": w,
                "value": args.n_views / elapsed, "round_s": elapsed,
                "n_threads": n_threads,
                "unit": f"views/s ({w}x{h}, {args.v_nbr} nbrs, 2 sweeps x "
                        f"2 phases, PyTorch CPU, {n_threads} threads)"}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
