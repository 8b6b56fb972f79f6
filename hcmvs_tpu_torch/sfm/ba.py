"""Bundle adjustment: LM with a matrix-free Schur complement + PCG (PyTorch
port of ``hcmvs_tpu/sfm/ba.py``).

Replaces the incremental BA inside OpenMVG (ref: MvgMvsPipeline.py:190-192
openMVG_main_IncrementalSfM, which uses Ceres on CPU):

- Per-observation reprojection Jacobians come from ``torch.func.jacfwd``
  of the single-observation residual, vmapped over all observations at
  once (the same forward-mode derivatives as the JAX package's
  ``jax.jacfwd``); everything is O(M) in the observation count.
- The point blocks (3x3) are eliminated analytically.  The reduced camera
  system S = U + lam*diag - W V^-1 W^T is never materialized: S @ x is
  three segment-sum passes over the observations (camera-gather ->
  point-reduce -> camera-reduce).
- The reduced system is solved with block-Jacobi-preconditioned CG on the
  matrix-free operator (Ceres' ITERATIVE_SCHUR + SCHUR_JACOBI analog),
  with ``jax.scipy.sparse.linalg.cg``'s recurrences and stopping rule.
  Small problems (C <= 24) instead materialize S by applying the operator
  to the 6C identity basis and solve directly.

Sums in a fixed order: on CUDA every segment sum (``ops.segments.
FixedSum``) reduces each target's rows in one fixed order, so two runs of
the LM loop, whose accept/reject and the incremental SfM around it
amplify the last bits of a sum, give equal states.  On the CPU the sums
are ``index_add_`` in row order, as XLA's scatter.  Observations are
sorted by point (``build_problem``), as in the JAX package.

Sharded (``parallel.sharding.shard_ba``): a process holds a block of the
points and their observations; ``cam_reduce`` sums each camera-side
partial (U, bc, the right-hand side, the Schur product's back term, the
preconditioner's blocks, the cost) over the processes, and every process
then solves the same camera system.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.ops.segments import FixedSum


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation.

    Smooth (autodiff-safe) formulation: R = I + sinc(t) K + c(t) K^2 with
    the *unnormalized* skew -- the normalized-axis form has a NaN gradient
    at rvec = 0.  (Reductions keep their dimension: under
    ``torch.func.jacfwd`` a 0-dim tensor plus a Python float is promoted
    to float64.)"""
    t2 = torch.sum(rvec ** 2, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(t2 + 1e-16)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (t2 + 1e-16)
    z = torch.zeros_like(rvec[..., 0])
    K = torch.stack([z, -rvec[..., 2], rvec[..., 1],
                     rvec[..., 2], z, -rvec[..., 0],
                     -rvec[..., 1], rvec[..., 0], z], dim=-1)
    K = K.reshape(rvec.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a * K + b * (K @ K)


def rotation_to_rvec(R: np.ndarray) -> np.ndarray:
    """Host-side inverse Rodrigues (stable across the full angle range).

    Near theta = pi (half-turns) the antisymmetric-part formula collapses;
    there the axis comes from the dominant column of R + I instead, with
    signs disambiguated by the antisymmetric part."""
    R = np.asarray(R)
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        return np.zeros(3)
    anti = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    na = np.linalg.norm(anti)
    # branch on cos_t, not theta: arccos amplifies float noise near -1
    if cos_t > -0.999:
        # a symmetric R here is the identity whose trace rounded below 3
        # (R0 @ R0.T, global SfM's gauge camera): the JAX package divides
        # 0 by 0 there and returns NaN
        if na == 0.0:
            return np.zeros(3)
        return anti / na * theta
    A = R + np.eye(3)
    k = int(np.argmax(np.diag(A)))
    axis = A[:, k]
    axis = axis / np.linalg.norm(axis)
    if np.dot(axis, anti) < 0:
        axis = -axis
    theta = np.pi - np.arcsin(np.clip(na / 2.0, 0.0, 1.0))
    return axis * theta


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` that, like ``jnp.linalg.solve``, returns the
    LU solve's inf / nan for a singular system instead of raising."""
    return torch.linalg.solve_ex(A, b).result


def inv(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv`` without the raise on a singular matrix (see
    ``solve``)."""
    return torch.linalg.inv_ex(A).inverse


class BAProblem(NamedTuple):
    """BA problem (host-assembled, tensors on the run's device)."""

    K: torch.Tensor            # (C, 3, 3) fixed intrinsics
    obs_cam: torch.Tensor      # (M,) int64
    obs_pt: torch.Tensor       # (M,) int64, sorted
    obs_uv: torch.Tensor       # (M, 2)
    obs_valid: torch.Tensor    # (M,) bool
    fixed_cams: torch.Tensor   # (C,) bool -- gauge fixing
    dist: torch.Tensor         # (3,) shared Brown radial k1..k3 applied to
                               # the predicted projection (zeros = pinhole)


class BAState(NamedTuple):
    rvecs: torch.Tensor        # (C, 3)
    tvecs: torch.Tensor        # (C, 3)  (world->cam: X_c = R X + t)
    points: torch.Tensor       # (P, 3)


def build_problem(K, obs_cam, obs_pt, obs_uv, n_points, fixed_cams,
                  dist=None, device="cuda") -> BAProblem:
    """Host-side assembly, observations stably sorted by point id (the
    point-side sums then run over contiguous rows).  ``dist``: optional
    (3,) Brown radial coefficients held fixed during the pose/point solve;
    with it set, ``obs_uv`` must be the raw distorted pixel observations.
    """
    del n_points
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_uv = np.asarray(obs_uv, np.float32)
    order = np.argsort(obs_pt, kind="stable")
    obs_cam, obs_pt, obs_uv = obs_cam[order], obs_pt[order], obs_uv[order]
    dev = torch.device(device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return BAProblem(
        K=t(np.asarray(K, np.float32), torch.float32),
        obs_cam=t(obs_cam, torch.int64), obs_pt=t(obs_pt, torch.int64),
        obs_uv=t(obs_uv, torch.float32),
        obs_valid=torch.ones(len(obs_cam), dtype=torch.bool, device=dev),
        fixed_cams=t(np.asarray(fixed_cams, bool), torch.bool),
        dist=(torch.zeros(3, dtype=torch.float32, device=dev) if dist is None
              else t(np.asarray(dist, np.float32), torch.float32)))


def _residual_one(K, dist, cam6, X, uv):
    """One observation's (2,) reprojection residual (pixels); every
    intermediate keeps a dimension (see ``rodrigues``)."""
    R = rodrigues(cam6[:3])
    Xc = R @ X + cam6[3:]
    z = torch.where(torch.abs(Xc[2:]) < 1e-9, 1e-9, Xc[2:])
    xn0 = Xc[0:1] / z
    xn1 = Xc[1:2] / z
    # Brown radial distortion of the prediction (dist == 0 -> identity)
    r2 = xn0 * xn0 + xn1 * xn1
    fac = 1.0 + r2 * (dist[0:1] + r2 * (dist[1:2] + r2 * dist[2:3]))
    xn0 = xn0 * fac
    xn1 = xn1 * fac
    u = K[0, 0:1] * xn0 + K[0, 1:2] * xn1 + K[0, 2:3]
    v = K[1, 1:2] * xn1 + K[1, 2:3]
    return torch.cat([u, v]) - uv


_residuals = torch.func.vmap(_residual_one, in_dims=(0, None, 0, 0, 0))
_jacobians = torch.func.vmap(
    torch.func.jacfwd(_residual_one, argnums=(2, 3)),
    in_dims=(0, None, 0, 0, 0))


def _obs_inputs(problem: BAProblem, state: BAState):
    cam6 = torch.cat([state.rvecs, state.tvecs], dim=1)[problem.obs_cam]
    return (problem.K[problem.obs_cam], problem.dist, cam6,
            state.points[problem.obs_pt], problem.obs_uv)


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    r = torch.sqrt(torch.clamp_min(r2, 1e-18))
    return torch.where(r <= delta, 1.0, delta / r)


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def ba_cost(problem: BAProblem, state: BAState,
            huber_delta: float = 4.0,
            cam_reduce: Reduce = None) -> torch.Tensor:
    """Huber cost over the valid observations (a device scalar), summed
    over the processes by ``cam_reduce`` when the problem is sharded."""
    r = _residuals(*_obs_inputs(problem, state))
    r2 = torch.sum(r ** 2, dim=-1)
    rho = torch.where(torch.sqrt(r2) <= huber_delta, r2,
                      2 * huber_delta * torch.sqrt(r2) - huber_delta ** 2)
    cost = torch.sum(rho * problem.obs_valid)
    if cam_reduce is None:
        return cost
    return cam_reduce(cost.reshape(1))[0]


def conjugate_gradient(A, b: torch.Tensor, M, tol: float,
                       maxiter: int) -> torch.Tensor:
    """Preconditioned CG from x0 = 0 with ``jax.scipy.sparse.linalg.cg``'s
    recurrences and stopping rule: stop when |r|^2 <= tol^2 |b|^2 or after
    ``maxiter`` iterations (the check reads the device once an
    iteration)."""
    atol2 = float(tol * tol * torch.sum(b * b))
    x = torch.zeros_like(b)
    r = b - A(x)
    z = M(r)
    p = z
    gamma = torch.sum(r * z)
    for _ in range(maxiter):
        if float(torch.sum(r * r)) <= atol2:
            break
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = torch.sum(r * z)
        beta = gamma_new / gamma
        p = z + beta * p
        gamma = gamma_new
    return x


def ba_step(problem: BAProblem, state: BAState, lam: float,
            huber_delta: float = 4.0, solver: str = "auto",
            cg_iters: int = 0, cam_reduce: Reduce = None) -> BAState:
    """One damped Gauss-Newton step via Schur elimination of the points.

    ``solver``: "cg" = block-Jacobi-preconditioned CG on the matrix-free
    reduced operator; "dense" = materialize S through the operator and
    solve exactly; "auto" = dense when C <= 24 else cg.  ``cam_reduce``:
    the sum over processes of a camera-side partial (a sharded problem,
    ``parallel.sharding.shard_ba``); none for a whole problem.
    """
    red = _identity if cam_reduce is None else cam_reduce
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    if solver == "auto":
        solver = "dense" if C <= 24 else "cg"
    dev = state.points.device
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    obs_cam, obs_pt = problem.obs_cam, problem.obs_pt
    cam_sum = FixedSum(obs_cam, C)
    pt_sum = FixedSum(obs_pt, P)

    inputs = _obs_inputs(problem, state)
    r = _residuals(*inputs)                              # (M, 2)
    Jc, Jp = _jacobians(*inputs)                         # (M,2,6) (M,2,3)
    w = _huber_weight(torch.sum(r ** 2, -1), huber_delta)
    w = w * problem.obs_valid
    # zero out fixed cameras' jacobians (gauge)
    free = ~problem.fixed_cams[obs_cam]
    Jc = Jc * free[:, None, None]

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    U = red(cam_sum.sum(torch.einsum("mri,mrj->mij", wJc, Jc)))  # (C,6,6)
    V = pt_sum.sum(torch.einsum("mri,mrj->mij", wJp, Jp))       # (P, 3, 3)
    Wm = torch.einsum("mri,mrj->mij", wJc, Jp)                  # (M, 6, 3)
    bc = -red(cam_sum.sum(torch.einsum("mri,mr->mi", wJc, r)))  # (C, 6)
    bp = -pt_sum.sum(torch.einsum("mri,mr->mi", wJp, r))        # (P, 3)

    # damp + invert point blocks (LM: scale-aware diagonal damping)
    diagV = torch.clamp_min(torch.diagonal(V, dim1=-2, dim2=-1), 1e-6)
    V = V + lam * torch.diag_embed(diagV)
    eye3 = torch.eye(3, dtype=V.dtype, device=dev)
    V_inv = inv(V + 1e-9 * eye3[None])

    # LM-damped camera blocks; fixed cameras become identity rows
    fixed = problem.fixed_cams
    diagU = torch.diagonal(U, dim1=-2, dim2=-1)
    U_damp = U + lam * torch.diag_embed(torch.clamp_min(diagU, 1e-6))

    def schur_apply(x):                   # x (..., C, 6) -> (..., C, 6)
        """S @ x matrix-free: S = U' - W V^-1 W^T with identity rows for
        fixed cameras.  Three O(M) passes; a camera never observes a point
        twice, so no same-pair corrections are needed."""
        x_free = torch.where(fixed[:, None], 0.0, x)
        ux = torch.einsum("cij,...cj->...ci", U_damp, x_free)
        y = torch.einsum("mij,...mi->...mj", Wm, x_free[..., obs_cam, :])
        s = pt_sum.sum(y, dim=-2)                                # (..., P, 3)
        z = torch.einsum("pij,...pj->...pi", V_inv, s)
        back = red(cam_sum.sum(
            torch.einsum("mij,...mj->...mi", Wm, z[..., obs_pt, :]), dim=-2))
        out = ux - back
        return torch.where(fixed[:, None], x, out)

    # rhs_c' = bc - sum_m W_m (V^-1 bp)[pt_m]
    vb = torch.einsum("pij,pj->pi", V_inv, bp)
    rhs_c = bc - red(cam_sum.sum(torch.einsum("mij,mj->mi", Wm,
                                               vb[obs_pt])))
    rhs_c = torch.where(fixed[:, None], 0.0, rhs_c)

    if solver == "dense":
        # exact: materialize S by applying the operator to the 6C basis
        basis = torch.eye(6 * C, dtype=torch.float32,
                          device=dev).reshape(6 * C, C, 6)
        Sd = schur_apply(basis).reshape(6 * C, 6 * C).T
        eye = torch.eye(6 * C, dtype=torch.float32, device=dev)
        dc = solve(Sd + 1e-9 * eye,
                                rhs_c.reshape(-1)).reshape(C, 6)
    else:
        # block-Jacobi preconditioner: diagonal blocks of S are
        # U' - sum_{m in c} W_m V^-1 W_m^T (each point seen once per cam)
        WVW = torch.einsum("mij,mjk,mlk->mil", Wm, V_inv[obs_pt], Wm)
        D = U_damp - red(cam_sum.sum(WVW))                       # (C, 6, 6)
        eye6 = torch.eye(6, dtype=torch.float32, device=dev)
        D = torch.where(fixed[:, None, None], eye6[None], D)
        D_inv = inv(D + 1e-8 * eye6[None])

        def precond(x):
            return torch.einsum("cij,cj->ci", D_inv, x)

        # the JAX package's budget (hcmvs_tpu/sfm/ba.py: the preconditioner
        # is strong enough that tol never triggers and maxiter is the real
        # control; LM's accept/reject protects a truncated step)
        n_cg = cg_iters if cg_iters else min(16, 6 * C)
        dc = conjugate_gradient(schur_apply, rhs_c, precond, tol=1e-6,
                                maxiter=n_cg)

    # back-substitute points: dp_j = V^-1 (bp - sum_i W_ij^T dc_i)
    Wt_dc = torch.einsum("mij,mi->mj", Wm, dc[obs_cam])
    acc = pt_sum.sum(Wt_dc)
    dp = torch.einsum("pij,pj->pi", V_inv, bp - acc)
    return BAState(rvecs=state.rvecs + dc[:, :3],
                   tvecs=state.tvecs + dc[:, 3:],
                   points=state.points + dp)


def run_ba(problem: BAProblem, state: BAState, n_iters: int = 20,
           init_lambda: float = 1e-3, verbose: bool = False,
           cg_iters: int = 0,
           cam_reduce: Reduce = None) -> Tuple[BAState, float]:
    """The LM loop (on the host; each trial step reads its cost back);
    ``cam_reduce`` as in ``ba_step``."""
    lam = init_lambda
    cost = float(ba_cost(problem, state, cam_reduce=cam_reduce))
    for it in range(n_iters):
        trial = ba_step(problem, state, np.float32(lam), cg_iters=cg_iters,
                        cam_reduce=cam_reduce)
        new_cost = float(ba_cost(problem, trial, cam_reduce=cam_reduce))
        if new_cost < cost:
            state = trial
            cost = new_cost
            lam = max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if verbose:
            print(f"[ba] iter {it} cost {cost:.4f} lam {lam:.1e}")
        if lam >= 1e4:
            break
    return state, cost
