"""Surface reconstruction: Delaunay tetrahedralization + s-t graph cut
(port of ``hcmvs_tpu/mesh/delaunay.py``, a numpy copy: host code in both
packages, on the port's native max-flow).

The TPU-native answer to the reference's CGAL + IBFS pipeline
(ref: frame_main/libs/MVS/SceneReconstruct.cpp:768 Scene::ReconstructMesh —
3D Delaunay, visibility-ray capacity accumulation, IBFS max-flow, facet
extraction).  This stage is the one genuinely host-bound part of the
framework (irregular, pointer-heavy — SURVEY §7 hard part #2); the design
keeps the heavy regular work (ray sampling) vectorized:

- Delaunay via scipy.spatial (Qhull), like the reference's CGAL.
- Visibility: every (point, camera) observation casts a ray; sample points
  along all rays at once and batch-locate them with ``find_simplex`` — the
  vectorized replacement for the reference's per-ray tetra walking.
- Free-space votes flow to the source, behind-the-point votes to the sink,
  inter-tetra facets get a smoothness capacity; min-cut via the native
  BK-style solver (hcmvs_tpu_torch/native/maxflow.cpp — the IBFS analog);
  a failed build raises.  scipy's integer max-flow, the plain version,
  runs only when asked for (``maxflow_solver="scipy"``).
- The surface is the set of facets separating free from full tetrahedra,
  oriented toward free space.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import Delaunay

from hcmvs_tpu_torch import native


class SurfaceMesh(NamedTuple):
    vertices: np.ndarray   # (V, 3) float32
    faces: np.ndarray      # (F, 3) int32, oriented toward free space


def reconstruct_mesh(points: np.ndarray, cam_centers: np.ndarray,
                     point_cam: np.ndarray,
                     n_ray_samples: int = 8,
                     alpha_vis: float = 1.0,
                     lambda_smooth: float = 0.2,
                     behind_scale: float = 0.01,
                     obs_pt: np.ndarray = None,
                     obs_cam: np.ndarray = None,
                     obs_weight: np.ndarray = None,
                     max_edge_factor: float = 8.0,
                     maxflow_solver: str = "native") -> SurfaceMesh:
    """Reconstruct a surface from an oriented point cloud with visibility.

    Args:
      points: (N, 3) fused cloud.
      cam_centers: (C, 3) camera centers.
      point_cam: (N,) index of the (owner) camera that saw each point.
      n_ray_samples: samples along each visibility ray.
      alpha_vis: vote weight per observation.
      lambda_smooth: facet smoothness capacity.
      behind_scale: how far behind the point the full-space vote lands,
        as a fraction of the camera-point distance.
      obs_pt/obs_cam/obs_weight: optional FULL observation lists — one
        entry per (point, supporting view) pair, with an optional
        per-observation vote weight (the reference accumulates every
        view's ray per point, weighted by Conf2Weight —
        SceneReconstruct.cpp ray votes + SceneDensify.cpp:3265-3495).
        When given they replace the owner-only ``point_cam`` rays.
      max_edge_factor: drop cut facets whose longest edge exceeds this
        multiple of the median point spacing — the 1-2%% of giant
        slab-spanning slivers that survive the cut on open scenes
        dominate any area-weighted metric/rendering (the reference's
        distInsert spacing + kQual facet-quality gating play this role;
        measured on the ridge fused cloud: median sample-to-surface
        0.293 -> 0.010 while keeping 97%% of faces).  0 disables.
      maxflow_solver: "native" (``native.maxflow``) or "scipy" (the
        plain version, ``native.maxflow_scipy``).

    Returns a SurfaceMesh (vertices are the input points).
    """
    solve = {"native": native.maxflow,
             "scipy": native.maxflow_scipy}.get(maxflow_solver)
    if solve is None:
        raise ValueError(f"unknown max-flow solver {maxflow_solver!r}")
    points = np.asarray(points, np.float64)
    n = len(points)
    if n < 5:
        raise ValueError("need at least 5 points")
    tri = Delaunay(points)
    nt = tri.nsimplex

    # ---- visibility votes ----
    # local scale: median nearest-neighbor spacing (the analog of the
    # reference's distInsert spacing); votes must bracket the surface at
    # this scale or thin structures (the common case — surfaces!) receive
    # no evidence, since the tetrahedralization only spans the point slab
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    d_nn, _ = tree.query(points, k=2)
    h = max(np.median(d_nn[:, 1]), 1e-9)

    if obs_pt is None:
        obs_pt = np.arange(n)
        obs_cam = np.asarray(point_cam)
    obs_pt = np.asarray(obs_pt)
    m = len(obs_pt)
    w_obs = (np.ones(m) if obs_weight is None
             else np.asarray(obs_weight, np.float64))
    pts_obs = points[obs_pt]                            # (M, 3)
    cams = cam_centers[np.asarray(obs_cam)]             # (M, 3)
    ray = pts_obs - cams
    dist = np.linalg.norm(ray, axis=1, keepdims=True)
    dir_ = ray / np.maximum(dist, 1e-12)
    # free-space samples: coarse fractions along the ray (empty space the
    # ray crosses before reaching the surface slab)
    t_frac = np.linspace(0.2, 0.9, max(n_ray_samples - 3, 1))
    coarse = (cams[None, :, :] * (1 - t_frac[:, None, None])
              + pts_obs[None, :, :] * t_frac[:, None, None])
    free_tets = tri.find_simplex(coarse.reshape(-1, 3))
    free_tets = free_tets.reshape(len(coarse), m)

    s_cap = np.zeros(nt)
    t_cap = np.zeros(nt)
    for k in range(len(coarse)):
        valid = free_tets[k] >= 0
        np.add.at(s_cap, free_tets[k][valid],
                  alpha_vis * w_obs[valid] / len(coarse))
        # de-duplicate per ray is skipped: repeated hits of the same tetra
        # along one ray just weight long traversals higher, which mimics
        # the reference's per-facet crossing accumulation

    # sink/source votes on the single incident cell the ray enters just
    # behind / just in front of each point — the reference's t-edge
    # placement (SceneReconstruct.cpp ray-vote accumulation).  Centroid
    # heuristics cancel for slab slivers (a cell is "behind" its top
    # vertex and "in front of" its bottom vertex); barycentric containment
    # of p +- eps*dir inside the incident cells does not.
    tet_pts = tri.simplices                              # (nt, 4)
    centroids = points[tet_pts].mean(1)                  # (nt, 3)
    eps = 0.05 * h
    behind_q = pts_obs + dir_ * eps                      # (M, 3) per-obs
    front_q = pts_obs - dir_ * eps
    inc_tet = np.repeat(np.arange(nt), 4)
    inc_pt = tet_pts.reshape(-1)
    # barycentric test: q inside tetra iff all coords of the affine solve
    # are >= -tol
    v0 = points[tet_pts[inc_tet, 0]]
    M = (points[tet_pts[inc_tet]][:, 1:, :]
         - v0[:, None, :]).transpose(0, 2, 1)            # (I, 3, 3)
    Minv_ok = np.abs(np.linalg.det(M)) > 1e-18
    M_safe = np.where(Minv_ok[:, None, None], M,
                      np.eye(3)[None])
    Minv = np.linalg.inv(M_safe)

    # expand incidences per observation: each (tet, vertex-point) pair
    # votes once per observation of that point (join by point id)
    order = np.argsort(obs_pt, kind="stable")
    counts = np.bincount(obs_pt, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rep = counts[inc_pt]                                 # obs per incidence
    inc_exp = np.repeat(np.arange(len(inc_pt)), rep)
    grp_off = np.concatenate([[0], np.cumsum(rep)])[:-1]
    pos = np.arange(rep.sum()) - np.repeat(grp_off, rep)
    obs_rows = order[starts[inc_pt[inc_exp]] + pos]      # (E,)

    def _vote(q_pts, cap_arr, chunk=2_000_000):
        for lo in range(0, len(inc_exp), chunk):
            sl = slice(lo, lo + chunk)
            ie = inc_exp[sl]
            orow = obs_rows[sl]
            rhs = q_pts[orow] - v0[ie]
            bary = np.einsum("nij,nj->ni", Minv[ie], rhs)
            b0 = 1.0 - bary.sum(1)
            tol = -1e-9
            inside = (Minv_ok[ie] & (bary >= tol).all(1) & (b0 >= tol))
            np.add.at(cap_arr, inc_tet[ie[inside]],
                      alpha_vis * w_obs[orow[inside]])

    _vote(behind_q, t_cap)
    _vote(front_q, s_cap)

    # ---- graph construction + min-cut ----
    # nodes: tetras; terminal caps from the visibility votes; pairwise
    # smoothness on shared facets (each unordered pair emitted once)
    neigh = tri.neighbors                                # (nt, 4)
    ti = np.repeat(np.arange(nt), 4)
    tj = neigh.reshape(-1)
    ok = (tj >= 0) & (ti < tj)
    ti, tj = ti[ok], tj[ok]
    cap_pair = np.full(len(ti), lambda_smooth, np.float32)
    # NOTE: no blanket hull->free bias (the reference's kInf hull weights
    # suit closed objects scanned from all sides); for open surfaces the
    # far-side hull must be allowed to stay "full" or the cut oscillates
    # to the back of the point slab.
    _, free_side = solve(nt, ti.astype(np.int32),
                                  tj.astype(np.int32), cap_pair, cap_pair,
                                  s_cap.astype(np.float32),
                                  t_cap.astype(np.float32))
    labels = np.concatenate([free_side, [False, False]])  # True = free

    # ---- extract the cut surface ----
    faces = []
    tet_pts = tri.simplices                              # (nt, 4)
    for f_local in range(4):
        # facet opposite to vertex f_local; neighbor across it
        nb = neigh[:, f_local]
        cur_free = labels[:nt]
        nb_free = np.where(nb >= 0, labels[np.maximum(nb, 0)], True)
        # surface where current is full and neighbor is free
        is_surf = (~cur_free) & nb_free
        tets = np.nonzero(is_surf)[0]
        if len(tets) == 0:
            continue
        verts_idx = np.array([k for k in range(4) if k != f_local])
        tri_faces = tet_pts[tets][:, verts_idx]
        # orient toward free space: the facet normal should point at the
        # free neighbor's centroid (fall back to away-from-opposite-vertex
        # on the hull, where there is no neighbor)
        a = points[tri_faces[:, 0]]
        b = points[tri_faces[:, 1]]
        c = points[tri_faces[:, 2]]
        nrm = np.cross(b - a, c - a)
        face_centroid = (a + b + c) / 3
        nb_t = neigh[tets, f_local]
        has_nb = nb_t >= 0
        tgt = np.where(has_nb[:, None],
                       centroids[np.maximum(nb_t, 0)],
                       2 * face_centroid - points[tet_pts[tets, f_local]])
        flip = np.sum(nrm * (tgt - face_centroid), axis=1) < 0
        tri_faces[flip] = tri_faces[flip][:, [0, 2, 1]]
        faces.append(tri_faces)

    faces = (np.concatenate(faces).astype(np.int32) if faces
             else np.zeros((0, 3), np.int32))
    if max_edge_factor > 0 and len(faces):
        tri_v = points[faces]
        elen = np.linalg.norm(
            np.stack([tri_v[:, 0] - tri_v[:, 1],
                      tri_v[:, 1] - tri_v[:, 2],
                      tri_v[:, 2] - tri_v[:, 0]]), axis=-1).max(0)
        faces = faces[elen <= max_edge_factor * h]
    return SurfaceMesh(vertices=points.astype(np.float32), faces=faces)
