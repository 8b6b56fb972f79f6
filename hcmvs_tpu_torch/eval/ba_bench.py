"""BA scalability benchmark: 200 cameras / 200k points / ~1M observations
(PyTorch port of ``hcmvs_tpu/eval/ba_bench.py``).

The reference delegates BA to Ceres inside OpenMVG
(ref: frame_main/MvgMvsPipeline.py:190-192 openMVG_main_IncrementalSfM);
its problems reach hundreds of cameras and millions of observations.  This
harness times the matrix-free Schur + PCG solver (sfm/ba.py) at that size:
one LM trial step (device synchronised) and the 8-iteration LM run.

    python -m hcmvs_tpu_torch.eval.ba_bench [--device cpu]

``make_problem_arrays`` is numpy only and draws exactly what the JAX
package's ``make_problem`` draws, so both packages get the same problem.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_problem_arrays(n_cams: int = 200, n_pts: int = 200_000,
                        obs_per_pt: int = 5, seed: int = 0,
                        noise_px: float = 0.5, init_pt_noise: float = 0.02,
                        init_cam_noise: float = 0.002) -> dict:
    """Synthetic city-block scene as numpy arrays: cameras on a ring
    looking inward, points in the interior, each point seen by
    ``obs_per_pt`` nearby cameras; the initial state perturbed."""
    from hcmvs_tpu_torch.sfm.ba import rotation_to_rvec
    rng = np.random.default_rng(seed)
    # cameras on a circle of radius 6, looking at the origin
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    C = np.stack([6 * np.cos(ang), 6 * np.sin(ang),
                  rng.normal(0, 0.2, n_cams)], axis=1)
    fwd = -C / np.linalg.norm(C, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (n_cams, 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up2 = np.cross(right, fwd)
    R = np.stack([right, -up2, fwd], axis=1)          # world->cam rows
    X = rng.uniform(-2.5, 2.5, (n_pts, 3))
    K = np.array([[800.0, 0, 640], [0, 800.0, 480], [0, 0, 1]], np.float32)

    # each point observed by obs_per_pt cameras nearest its azimuth
    pt_ang = np.arctan2(X[:, 1], X[:, 0])
    base = np.round(pt_ang / (2 * np.pi) * n_cams).astype(int)
    offs = np.arange(obs_per_pt) - obs_per_pt // 2
    obs_cam = ((base[:, None] + offs[None]) % n_cams).reshape(-1)
    obs_pt = np.repeat(np.arange(n_pts), obs_per_pt)

    Xc = np.einsum("mij,mj->mi", R[obs_cam], X[obs_pt] - C[obs_cam])
    uv = (Xc[:, :2] / Xc[:, 2:]) * K[0, 0] + np.array([K[0, 2], K[1, 2]])
    ok = Xc[:, 2] > 0.5
    obs_cam, obs_pt, uv = obs_cam[ok], obs_pt[ok], uv[ok]
    uv = uv + rng.normal(0, noise_px, uv.shape)

    rvecs = np.stack([rotation_to_rvec(R[i]) for i in range(n_cams)])
    rvecs = rvecs + rng.normal(0, init_cam_noise, rvecs.shape)
    rvecs[:2] = np.stack([rotation_to_rvec(R[i]) for i in range(2)])
    tvecs = -np.einsum("mij,mj->mi", R, C)
    tvecs[2:] += rng.normal(0, init_cam_noise * 10, tvecs[2:].shape)
    pts0 = X + rng.normal(0, init_pt_noise, X.shape)
    return {"K": np.tile(K[None], (n_cams, 1, 1)), "obs_cam": obs_cam,
            "obs_pt": obs_pt, "obs_uv": uv, "n_points": n_pts,
            "fixed_cams": [i < 2 for i in range(n_cams)],
            "rvecs": rvecs.astype(np.float32),
            "tvecs": tvecs.astype(np.float32),
            "points": pts0.astype(np.float32)}


def make_problem(n_cams: int = 200, n_pts: int = 200_000, device="cuda",
                 **kw):
    """(BAProblem, BAState, number of observations) on ``device``."""
    import torch
    from hcmvs_tpu_torch.sfm.ba import BAState, build_problem
    a = make_problem_arrays(n_cams, n_pts, **kw)
    problem = build_problem(a["K"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
                            a["n_points"], a["fixed_cams"], device=device)
    state = BAState(*(torch.as_tensor(a[k], device=device)
                      for k in ("rvecs", "tvecs", "points")))
    return problem, state, len(a["obs_cam"])


def run(n_cams: int = 200, n_pts: int = 200_000, n_iters: int = 8,
        device="cuda", cg_iters: int = 0) -> dict:
    """One LM trial step timed warm (device synchronised) and the
    ``n_iters`` LM run; returns the rms before and after, the per-step
    seconds and the final state."""
    from hcmvs_tpu_torch.pipeline.densify import resolve_device
    from hcmvs_tpu_torch.sfm.ba import ba_cost, ba_step, run_ba
    from hcmvs_tpu_torch.utils.profiling import synchronize
    dev = resolve_device(device)
    problem, state, m = make_problem(n_cams, n_pts, device=dev)
    c0 = float(ba_cost(problem, state))
    _ = ba_step(problem, state, np.float32(1e-3), cg_iters=cg_iters)
    synchronize(dev)
    t0 = time.perf_counter()
    _ = ba_step(problem, state, np.float32(1e-3), cg_iters=cg_iters)
    synchronize(dev)
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, cost = run_ba(problem, state, n_iters=n_iters, cg_iters=cg_iters)
    synchronize(dev)
    total_s = time.perf_counter() - t0
    return {"cams": n_cams, "points": n_pts, "observations": m,
            "step_seconds": step_s, "iters": n_iters,
            "total_seconds": total_s,
            "cg_iters": cg_iters or min(16, 6 * n_cams),
            "rms_px_before": (c0 / m) ** 0.5,
            "rms_px_after": (cost / m) ** 0.5,
            "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cams", type=int, default=200)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu must "
                         "be asked for)")
    args = ap.parse_args(argv)
    out = run(args.cams, args.points, args.iters, args.device)
    print(json.dumps({"metric": "ba_iteration_time",
                      **{k: v for k, v in out.items() if k != "state"}}))
    return out


if __name__ == "__main__":
    main()
