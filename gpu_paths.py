#!/usr/bin/env python3
"""Two paths of the port that no phase of ``chip_smoke.py`` runs, run on
the card on demand (no JAX; it uses chip_smoke.py's scenes and helpers,
beside it):

    python3 gpu_paths.py [batched] [hierarchy]

- ``batched``: ``refine_batched=True`` (every random-refinement scale
  scored together through kernel D) on chip_smoke's hybrid,
  candidate-batched slice (phases 6-7: the plane scene at 1280x960, 4
  views x 3 neighbours), beside the default refinement on the same scene:
  view 0's depth accuracy, the launches of each run (kernel B takes no
  part with ``refine_batched``: D scores every scale), and both runs'
  maps against the plain versions on the card.
- ``hierarchy``: ``pipeline.hierarchy.main`` with ``--masks-dir`` on
  chip_smoke's hierarchy scene (phase 10: four 2560x1920 ridge PNGs,
  DenseConfig() with its flags), each view's 16-bit face mask in a
  directory of its own under the image's name, beside the same run
  without masks: every stage's view 0 accuracy and launches, the prior
  passes, the final view 0 accuracy.

Prints a JSON line per path; exits non-zero if a run fails its checks
(non-finite maps, a kernel of the path never launched, no prior pass
with masks).
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def batched() -> dict:
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    dev = torch.device("cuda", 0)
    sc, scene = cs.make_scene(dev)
    base = cs.slice_cfg().replace(score_mode="hybrid",
                                  candidate_kernel="on")
    out, failed = {}, []
    for name, cfg in (("default", base),
                      ("refine_batched", base.replace(refine_batched=True))):
        kernels.reset_launches()
        depth, keep, _rep, sec = cs.run_path(scene, cfg, dev, name)
        launches = dict(kernels.launches)
        with kernels.plain_versions():
            depth_p, _, _, _ = cs.run_path(scene, cfg, dev, name + " plain")
        agree = float((np.abs(depth - depth_p)
                       <= 0.01 * np.abs(depth_p)).mean())
        out[name] = {"seconds": sec, "launches": launches,
                     "depth_acc_2pct": cs.depth_acc_2pct(depth[0],
                                                         sc.depth_gt),
                     "kept": float(keep.mean()), "plain_agree_1pct": agree}
        # with refine_batched every refinement scale is scored through
        # kernel D, so kernel B (the one-candidate lookups of the default
        # refinement) has nothing left to do on this path
        path = [k for k in cs.HYBRID_KERNELS
                if not (cfg.refine_batched and k == "volume_lookup")]
        if min(launches[k] for k in path) <= 0:
            failed.append(f"{name}: a kernel never launched: {launches}")
    return out, failed


def hierarchy() -> dict:
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import hierarchy as hier
    from hcmvs_tpu_torch.utils import profiling
    from hcmvs_tpu_torch.utils.synth import (RIDGE_MASK_LABELS,
                                             write_ridge_scene)
    from hcmvs_tpu_torch.io.images import write_png
    root = Path(tempfile.mkdtemp(prefix="_gpu_paths_", dir=ROOT))
    out, failed = {}, []
    try:
        sc = cs.hierarchy_scene(*cs.HIER_IMAGE_HW)
        scene_path, img_dir = write_ridge_scene(
            str(root), sc, png_filter=cs.DENSIFY_PNG_FILTER)
        masks_dir = root / "masks"
        masks_dir.mkdir()
        labels = np.asarray(RIDGE_MASK_LABELS, np.uint16)
        for i, face in enumerate(sc.faces):
            write_png(str(masks_dir / f"im{i:04d}.png"), labels[face])
        gts = {}
        for name, extra in (("no_masks", []),
                            ("masks_dir", ["--masks-dir", str(masks_dir)])):
            profiling.reset_report()
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with cs.stage_records() as records:
                t0 = time.perf_counter()
                hier.main(["--input-file", scene_path, "--images-dir",
                           img_dir, "-w", str(root / name), *extra,
                           "--flags", *cs.HIER_FLAGS])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            rep = profiling.report()
            stages = []
            for rec in records:
                if rec["hw"] not in gts:
                    gts[rec["hw"]] = cs.hierarchy_scene(
                        *rec["hw"], textured=False).depth_gt
                stages.append({"hw": rec["hw"], "launches": rec["launches"],
                               "depth_acc_2pct": cs.depth_acc_2pct(
                                   rec["depth0"], gts[rec["hw"]])})
            priors = rep.get("stage.priors", {}).get("calls", 0)
            out[name] = {"seconds": seconds, "stages": stages,
                         "prior_passes": priors,
                         "launches": dict(kernels.launches),
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30}
            if not all(np.isfinite(r["depth0"]).all() for r in records):
                failed.append(f"{name}: non-finite depth")
            if min(kernels.launches[k] for k in cs.EXACT_KERNELS) <= 0:
                failed.append(f"{name}: a kernel never launched")
            if name == "masks_dir" and priors <= 0:
                failed.append("masks_dir: the prior pass never ran")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, failed


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gpu_paths: no CUDA device", file=sys.stderr)
        return 1
    cs.log(f"[device] {cs.smi_line()}")
    failed = []
    for name in argv or ["batched", "hierarchy"]:
        out, f = {"batched": batched, "hierarchy": hierarchy}[name]()
        cs.log(json.dumps({name: out}, default=float))
        failed += f
    for f in failed:
        print(f"gpu_paths: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
