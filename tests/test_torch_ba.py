"""PyTorch port vs the JAX package: bundle adjustment and pose evaluation.

Inputs are numpy arrays from seeds (``eval.ba_bench``'s synthetic ring of
cameras at small sizes, the JAX suite's own BA scenes); JAX runs on the
CPU.

Tolerances.  ``rodrigues`` within 1e-6 and the inverse round trip within
1e-4 rad (the JAX test's bound; the inverse of a rounded identity is the
zero rotation in the port, NaN in the JAX package, a fault repaired);
``build_problem``'s order equal;
``ba_cost`` within 1e-5 relative (float32 sums of 10^3-10^4 terms); one
``ba_step`` within 1e-4 relative + 1e-5 absolute on the new state, both on
the dense solver (12 cameras) and on the PCG solver (30 cameras,
``solver="auto"``), measured 1e-6 absolute; ``run_ba`` for 5 iterations
with the final rms within 1e-3 px.  The CG solver against
``jax.scipy.sparse.linalg.cg`` within 1e-5 relative.  The fixed-order sums
(CUDA's path, forced here) give the same step as ``index_add_`` within
1e-6.  ``pose_eval``: ``umeyama_align`` / ``ate`` within 1e-12 (the same
numpy code), ``structure_from_known_poses`` within 1e-3 px.

Run as a script, ``PYTHONPATH=. python tests/test_torch_ba.py C P
[jax|port]`` runs ``eval.ba_bench`` of one or both packages at C cameras
and P points (200 and 200000 is the benchmark's size) on the CPU and
prints the rms before and after 8 LM iterations and the seconds per step.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.eval import ba_bench as jbench
from hcmvs_tpu.eval import pose_eval as jpose
from hcmvs_tpu.sfm import ba as jba

from hcmvs_tpu_torch.convert import (ba_problem_from_numpy,
                                     ba_state_from_numpy)
from hcmvs_tpu_torch.eval import ba_bench as tbench
from hcmvs_tpu_torch.eval import pose_eval as tpose
from hcmvs_tpu_torch.sfm import ba as tba

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _problem(n_cams, n_pts):
    """The JAX package's bench problem and the port's copy of it."""
    problem, state, m = jbench.make_problem(n_cams=n_cams, n_pts=n_pts,
                                            obs_per_pt=4, seed=1)
    return (problem, state, m, ba_problem_from_numpy(problem, CPU),
            ba_state_from_numpy(state, CPU))


def _state_close(t, j, rtol=1e-4, atol=1e-5):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_rodrigues_and_inverse():
    rng = np.random.default_rng(4)
    rv = rng.normal(0, 0.5, (6, 3)).astype(np.float32)
    R_t = tba.rodrigues(torch.from_numpy(rv)).numpy()
    for k in range(len(rv)):
        R_j = np.asarray(jba.rodrigues(jnp.asarray(rv[k])))
        np.testing.assert_allclose(R_t[k], R_j, atol=1e-6)
        np.testing.assert_allclose(tba.rotation_to_rvec(R_t[k]), rv[k],
                                   atol=1e-4)
    np.testing.assert_allclose(tba.rodrigues(torch.zeros(3)).numpy(),
                               np.eye(3), atol=1e-6)
    # the half-turn branch, and the same host code as the JAX package
    for rv in (np.array([np.pi - 1e-4, 0.0, 0.0]),
               np.array([0.3, -2.9, 0.8]), np.array([1e-9, 0.0, 0.0])):
        R = np.asarray(jba.rodrigues(jnp.asarray(rv, jnp.float32)),
                       np.float64)
        np.testing.assert_array_equal(tba.rotation_to_rvec(R),
                                      jba.rotation_to_rvec(R))


def test_rotation_to_rvec_of_a_rounded_identity():
    """R0 @ R0.T (global SfM's gauge camera) is exactly symmetric with a
    trace that can round below 3: the JAX package returns NaN for it (its
    0 / 0), the port the zero rotation."""
    rng = np.random.default_rng(0)
    n_nan = 0
    for _ in range(50):
        R0 = np.asarray(jba.rodrigues(jnp.asarray(rng.normal(0, 0.3, 3),
                                                  jnp.float32)), np.float64)
        R = R0 @ R0.T
        with np.errstate(invalid="ignore"):
            n_nan += int(np.isnan(jba.rotation_to_rvec(R)).any())
        rv = tba.rotation_to_rvec(R)
        assert np.isfinite(rv).all() and np.abs(rv).max() < 1e-6
    assert n_nan > 0


def test_build_problem_order_and_fields():
    a = tbench.make_problem_arrays(20, 300, obs_per_pt=4, seed=2)
    jp = jba.build_problem(a["K"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
                           a["n_points"], a["fixed_cams"],
                           dist=[-0.1, 0.01, 0.0])
    tp = tba.build_problem(a["K"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
                           a["n_points"], a["fixed_cams"],
                           dist=[-0.1, 0.01, 0.0], device=CPU)
    for f in tba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_bench_problem_is_the_jax_package_s():
    problem, state, m, tp, ts = _problem(30, 1500)
    a = tbench.make_problem_arrays(30, 1500, obs_per_pt=4, seed=1)
    assert len(a["obs_cam"]) == m
    order = np.argsort(a["obs_pt"], kind="stable")
    np.testing.assert_array_equal(np.asarray(problem.obs_cam),
                                  a["obs_cam"][order])
    np.testing.assert_array_equal(np.asarray(problem.obs_uv),
                                  a["obs_uv"][order].astype(np.float32))
    for f in ("rvecs", "tvecs", "points"):
        np.testing.assert_array_equal(np.asarray(getattr(state, f)), a[f])


@pytest.mark.parametrize("dist", [None, (-0.12, 0.02, 0.0)])
def test_ba_cost_matches(dist):
    problem, state, m, tp, ts = _problem(12, 400)
    if dist is not None:
        problem = problem._replace(dist=jnp.asarray(dist, jnp.float32))
        tp = tp._replace(dist=torch.tensor(dist, dtype=torch.float32))
    cj = float(jba.ba_cost(problem, state))
    ct = float(tba.ba_cost(tp, ts))
    assert abs(ct - cj) <= 1e-5 * cj, (ct, cj)


@pytest.mark.parametrize("n_cams,n_pts,solver", [(12, 400, "dense"),
                                                 (30, 1500, "cg")])
def test_ba_step_matches(n_cams, n_pts, solver):
    """solver="auto": dense at 12 cameras, PCG at 30."""
    problem, state, m, tp, ts = _problem(n_cams, n_pts)
    sj = jba.ba_step(problem, state, jnp.float32(1e-3))
    st = tba.ba_step(tp, ts, np.float32(1e-3))
    moved = max(float(np.abs(np.asarray(b) - a.numpy()).max())
                for a, b in zip(ts, sj))
    assert moved > 1e-3                   # a real step was taken
    _state_close(st, sj)


def test_fixed_order_sums_give_the_same_step(monkeypatch):
    """CUDA's path (rows sorted by target, segment_reduce) forced on the
    CPU gives the index_add_ step."""
    _, _, _, tp, ts = _problem(30, 1500)
    ref = tba.ba_step(tp, ts, np.float32(1e-3))
    monkeypatch.setattr(tba, "FixedSum",
                        functools.partial(tba.FixedSum, fixed_order=True))
    fixed = tba.ba_step(tp, ts, np.float32(1e-3))
    _state_close(fixed, ref, rtol=0, atol=1e-6)


def test_conjugate_gradient_matches_jax_cg():
    rng = np.random.default_rng(5)
    n = 24
    A = rng.normal(size=(n, n))
    A = (A @ A.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    Minv = np.diag(1.0 / np.diag(A)).astype(np.float32)
    for maxiter in (3, 16):
        xj, _ = jax.scipy.sparse.linalg.cg(
            lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
            M=lambda x: jnp.asarray(Minv) @ x, tol=1e-6, maxiter=maxiter)
        xt = tba.conjugate_gradient(
            lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b),
            lambda x: torch.from_numpy(Minv) @ x, tol=1e-6, maxiter=maxiter)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                                   atol=1e-6)


def test_run_ba_matches():
    problem, state, m, tp, ts = _problem(30, 1500)
    _, cj = jba.run_ba(problem, state, n_iters=5)
    _, ct = tba.run_ba(tp, ts, n_iters=5)
    rms_j, rms_t = np.sqrt(cj / m), np.sqrt(ct / m)
    assert rms_t < 1.0
    assert abs(rms_t - rms_j) < 1e-3, (rms_t, rms_j)


def test_pose_eval_matches():
    rng = np.random.default_rng(7)
    gt = rng.normal(size=(6, 3))
    est = 0.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3
    est = est + rng.normal(0, 0.01, est.shape)
    for a, b in zip(tpose.umeyama_align(est, gt),
                    jpose.umeyama_align(est, gt)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    ta, ja = tpose.ate(est, gt), jpose.ate(est, gt)
    assert ta.keys() == ja.keys()
    for k in ta:
        assert abs(ta[k] - ja[k]) < 1e-12


def test_structure_from_known_poses_matches():
    """The JAX suite's BA scene (tests/test_sfm.py) as an SfM result whose
    poses are frozen; the points are perturbed."""
    rng = np.random.default_rng(3)
    fx = 400.0
    K = np.array([[fx, 0, 160], [0, fx, 120], [0, 0, 1]])
    X = rng.uniform(-1, 1, (60, 3)) + [0, 0, 5.0]
    poses, track_obs, keypoints = {}, [[] for _ in range(60)], []
    for c in range(4):
        R = np.asarray(jba.rodrigues(jnp.asarray(rng.normal(0, 0.03, 3),
                                                 jnp.float32)), np.float64)
        C = np.array([c * 0.4 - 0.6, 0.0, 0.0])
        poses[c] = (R, C)
        uv = (X - C) @ R.T @ K.T
        keypoints.append((uv[:, :2] / uv[:, 2:]
                          + rng.normal(0, 0.5, (60, 2))).astype(np.float32))
        for p in range(60):
            track_obs[p].append((c, p))
    from hcmvs_tpu.sfm.incremental import SfMResult
    res = SfMResult(poses=poses, track_obs=track_obs, keypoints=keypoints,
                    points=X + rng.normal(0, 0.05, X.shape))
    rj = jpose.structure_from_known_poses(res, K)
    rt = tpose.structure_from_known_poses(res, K, device=CPU)
    assert rt < 1.0
    assert abs(rt - rj) < 1e-3, (rt, rj)


def _bench(n_cams: int, n_pts: int, which: str) -> dict:
    """One package's ba_bench at a size on the CPU: rms before / after 8
    LM iterations, seconds per step and in all (unrounded)."""
    import time
    if which == "port":
        out = tbench.run(n_cams, n_pts, 8, device=CPU)
        return {"package": "port", **{k: v for k, v in out.items()
                                      if k != "state"}}
    problem, state, m = jbench.make_problem(n_cams, n_pts)
    c0 = float(jba.ba_cost(problem, state))
    _ = jba.ba_step(problem, state, jnp.float32(1e-3))
    float(np.asarray(_.points[0, 0]))
    t0 = time.perf_counter()
    trial = jba.ba_step(problem, state, jnp.float32(1e-3))
    float(np.asarray(trial.points[0, 0]))
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cost = jba.run_ba(problem, state, n_iters=8)
    return {"package": "jax", "cams": n_cams, "points": n_pts,
            "observations": m, "step_seconds": step_s,
            "total_seconds": time.perf_counter() - t0,
            "rms_px_before": (c0 / m) ** 0.5,
            "rms_px_after": (cost / m) ** 0.5}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    c, p = int(sys.argv[1]), int(sys.argv[2])
    for which in sys.argv[3:] or ["jax", "port"]:
        print(_bench(c, p, which), flush=True)
