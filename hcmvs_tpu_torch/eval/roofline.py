"""Roofline accounting of one bench round on the H100 (PyTorch port of
``hcmvs_tpu/eval/roofline.py``, against the card's ceilings instead of
the v5e's).

For each stage of one bench round (``bench._build``'s workload, rebuilt
in ``entry``: the sigma-table build, the photometric pass of 2 sweeps,
the geometric pass of 2 sweeps): its span on the card (CUDA events
around it, the least of ``--rounds``), the analytic work (table entries
written, table lookups, rect lookups, the least bytes), and the least
time the card could take for that work: the larger of its bytes over
the memory rate and its operations over the float32 rate.  ``share`` is
that least time over the span.  The stages run the kernels (A builds,
B and C look up), but each span also holds the stage's PyTorch ops and
the host's gaps between launches, so the share is the stage's, not a
kernel's.

    python -m hcmvs_tpu_torch.eval.roofline           # the card
    python -m hcmvs_tpu_torch.eval.roofline --cpu --h 48 --w 64
    python -m hcmvs_tpu_torch.eval.roofline --batch-candidates

``--batch-candidates`` scores the propagation candidates as one stack
(``DenseConfig.batch_candidates``) instead of one after another.

With ``--cpu`` the spans are host seconds of the plain versions and no
share is given (a CPU run gives no device metric).  Prints one JSON
report.

The card's ceilings live here (``chip_smoke.py`` imports them for its
kernel bounds): NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

# device memory rate and float32 rate outside the tensor cores (the
# kernels' integer work is counted at the same rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per output element of each kernel (from its source: index
# arithmetic, clamps, decode, lerp, encode; kernel E per offset, its exp
# counted as one)
OPS_PER_ELEMENT = {"rect_build": 25, "volume_lookup": 10, "rect_lookup": 15,
                   "volume_lookup_multi": 10, "zncc_warped": 20}


def least_seconds(n_bytes: float, n_ops: float):
    """(seconds, "bytes" or "operations"): the larger of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _stage(seconds: float, n_bytes: float, n_ops: float, on_card: bool,
           **work) -> dict:
    least, by = least_seconds(n_bytes, n_ops)
    return {"seconds": seconds, **work, "bytes": n_bytes, "ops": n_ops,
            "least_s": least, "bound_by": by,
            "share": least / seconds if on_card else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--nbrs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch-candidates", action="store_true",
                    help="score the propagation candidates as one stack "
                         "(one cost call, no loop over candidates)")
    args = ap.parse_args(argv)

    import torch
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.patchmatch import propagation_offsets
    from hcmvs_tpu_torch.dense.scene_driver import (_build_scene_volumes,
                                                    init_scene_state,
                                                    phase_cfg, scene_sweeps,
                                                    view_generators)
    from hcmvs_tpu_torch.entry import bench_cfg, build_scene
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    dev = resolve_device("cpu" if args.cpu else "cuda")
    on_card = dev.type == "cuda"
    n, h, w, v = args.views, args.h, args.w, args.nbrs
    cfg = bench_cfg().replace(batch_candidates=args.batch_candidates)
    scene = build_scene(n, h, w, dev, n_nbr=v)

    def timed(fn):
        """(least seconds over the rounds, last output): CUDA events on
        the card, the host clock on the CPU."""
        best, out = float("inf"), None
        for _ in range(args.rounds):
            if on_card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                a.record()
                out = fn()
                b.record()
                torch.cuda.synchronize(dev)
                best = min(best, a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                out = fn()
                best = min(best, time.perf_counter() - t0)
        return best, out

    report = {"w": w, "h": h, "views": n, "nbrs": v,
              "batch_candidates": args.batch_candidates,
              "platform": (torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
              "clock": "cuda_events" if on_card else "host",
              "ceilings": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                           "f32_ops_per_s": F32_OPS_PER_S}}

    # stage 1: the sigma tables (kernel A on the rect build)
    t_build, vols = timed(lambda: _build_scene_volumes(scene, cfg))
    entries = int(vols.tab.numel())
    tab_bytes = sum(x.numel() * x.element_size() for x in vols)
    src_bytes = n * v * h * w * scene.gray.element_size()
    report["table_build"] = _stage(
        t_build, tab_bytes + src_bytes,
        entries * OPS_PER_ELEMENT["rect_build"], on_card, entries=entries)
    scene_v = dataclasses.replace(scene, vols=vols)
    d_planes = vols.tab.shape[-1]
    gens = view_generators(0, n, dev)
    state = init_scene_state(gens, scene_v)
    iters = cfg.estimation_iters
    n_prop = len(propagation_offsets(cfg))

    # stage 2: photometric sweeps (kernel B)
    p_cfg = phase_cfg(cfg, 0)
    n_patch = len(S.patch_offsets(p_cfg))
    n_cand = 1 + n_prop + p_cfg.random_iters
    t_photo, st = timed(lambda: scene_sweeps(state, scene_v, p_cfg, 0, iters,
                                             False, gens))
    lookups = n * v * h * w * n_patch * n_cand * iters
    # every sweep reads each table at least once
    report["photometric"] = _stage(
        t_photo, n * v * h * w * d_planes * 2 * iters,
        lookups * OPS_PER_ELEMENT["volume_lookup"], on_card,
        candidates_per_px=n_cand, patch_taps=n_patch, table_lookups=lookups)

    # stage 3: geometric sweeps (kernels B and C)
    g_cfg = phase_cfg(cfg, 1, True)
    n_patch_g = len(S.patch_offsets(g_cfg))
    n_cand_g = 1 + n_prop + g_cfg.random_iters
    t_geo, _ = timed(lambda: scene_sweeps(st, scene_v, g_cfg, 1, iters,
                                          True, gens))
    lookups_g = n * v * h * w * n_patch_g * n_cand_g * iters
    rect = n * v * h * w * n_cand_g * iters
    report["geometric"] = _stage(
        t_geo, n * v * h * w * d_planes * 2 * iters,
        lookups_g * OPS_PER_ELEMENT["volume_lookup"]
        + rect * OPS_PER_ELEMENT["rect_lookup"], on_card,
        candidates_per_px=n_cand_g, patch_taps=n_patch_g,
        table_lookups=lookups_g, rect_lookups=rect)

    # the round: the two passes and a share of the build (tables are
    # built once a stage of 4 external x 3 sweeps; a round runs 2 x 2)
    build_share = t_build * (2 * iters) / 12.0
    round_s = t_photo + t_geo
    report["round"] = {"seconds": round_s, "build_share_s": build_share,
                       "views_per_s": n / (round_s + build_share)}
    for k in ("table_build", "photometric", "geometric"):
        report[k]["share_of_round"] = report[k]["seconds"] / (
            round_s + t_build)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
