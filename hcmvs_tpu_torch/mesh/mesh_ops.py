"""Mesh cleaning / decimation / smoothing (port of
``hcmvs_tpu/mesh/mesh_ops.py``, a numpy copy: host code in both packages).

Replaces the reference's VCG-based Mesh::Clean stack
(ref: frame_main/libs/MVS/Mesh.cpp:955 Clean — decimate, remove spurious
components/spikes, close holes, smooth — and :3005 Decimate, :2824
Subdivide, :3444 SamplePoints, :3532 TRasterMesh): numpy implementations
of the full Mesh-class surface the pipeline invokes — clean/decimate/
close-holes/smooth plus subdivision, non-manifold repair, area-weighted
surface sampling, and z-buffer depth rasterization.

The rasterizers run on the port's native rasterizer
(``hcmvs_tpu_torch/native/raster.cpp``, the JAX package's source); their
numpy scanline versions are the plain versions, reached only with
``backend="numpy"``.  A failed native build raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hcmvs_tpu_torch import native


def remove_small_components(vertices: np.ndarray, faces: np.ndarray,
                            min_faces: int = 20
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop connected components with fewer than ``min_faces`` faces
    (ref: Mesh::Clean fRemoveSpurious)."""
    if len(faces) == 0:
        return vertices, faces
    # union-find over faces connected via shared edges
    parent = np.arange(len(faces))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    edge_map = {}
    for f_idx, f in enumerate(faces):
        for k in range(3):
            e = (min(f[k], f[(k + 1) % 3]), max(f[k], f[(k + 1) % 3]))
            if e in edge_map:
                a, b = find(edge_map[e]), find(f_idx)
                if a != b:
                    parent[a] = b
            else:
                edge_map[e] = f_idx

    roots = np.array([find(i) for i in range(len(faces))])
    _, inv, counts = np.unique(roots, return_inverse=True,
                               return_counts=True)
    keep = counts[inv] >= min_faces
    faces = faces[keep]
    return _compact(vertices, faces)


def _compact(vertices: np.ndarray, faces: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop unreferenced vertices and reindex faces."""
    if len(faces) == 0:
        return np.zeros((0, 3), vertices.dtype), faces
    used = np.unique(faces)
    remap = np.full(len(vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces].astype(faces.dtype)


def decimate_mesh_qem(vertices: np.ndarray, faces: np.ndarray,
                      target_ratio: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric-error-metric edge-collapse decimation (ref:
    Mesh::Decimate, Mesh.cpp:3005 — the reference's VCG
    tri::Simplification uses the same Garland-Heckbert quadrics).

    Heap-driven: per-vertex plane quadrics accumulate incident-face
    planes; each collapse places the merged vertex at the quadric-optimal
    position (midpoint fallback on singular quadrics) and skips collapses
    that flip incident face normals.  Host-side (pointer-chasing is the
    one workload that does not map to the TPU; same call as the
    reference's CPU/VCG stage).
    """
    import heapq
    nv = len(vertices)
    if len(faces) == 0 or target_ratio >= 1.0:
        return vertices, faces
    n_target = max(4, int(nv * target_ratio))
    V = vertices.astype(np.float64).copy()
    # per-vertex quadrics from incident face planes
    a = V[faces[:, 0]]
    b = V[faces[:, 1]]
    c = V[faces[:, 2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    d = -np.einsum("ij,ij->i", n, a)
    p = np.concatenate([n, d[:, None]], 1)               # (F, 4)
    Kf = np.einsum("fi,fj->fij", p, p)                   # (F, 4, 4)
    Q = np.zeros((nv, 4, 4))
    for k in range(3):
        np.add.at(Q, faces[:, k], Kf)
    # adjacency
    neigh = [set() for _ in range(nv)]
    vert_faces = [set() for _ in range(nv)]
    for fi, f in enumerate(faces):
        for k in range(3):
            neigh[f[k]].add(int(f[(k + 1) % 3]))
            neigh[f[k]].add(int(f[(k + 2) % 3]))
            vert_faces[f[k]].add(fi)
    F = faces.astype(np.int64).copy()
    alive_f = np.ones(len(F), bool)
    alive_v = np.ones(nv, bool)
    version = np.zeros(nv, np.int64)

    def collapse_cost(u, w):
        Quw = Q[u] + Q[w]
        A = Quw.copy()
        A[3] = [0, 0, 0, 1]
        try:
            x = np.linalg.solve(A, [0, 0, 0, 1])[:3]
            if not np.isfinite(x).all():
                raise np.linalg.LinAlgError
        except np.linalg.LinAlgError:
            x = 0.5 * (V[u] + V[w])
        h = np.append(x, 1.0)
        return float(h @ Quw @ h), x

    heap = []
    for u in range(nv):
        for w in neigh[u]:
            if u < w:
                cost, x = collapse_cost(u, w)
                heapq.heappush(heap, (cost, u, w, int(version[u]),
                                      int(version[w]), tuple(x)))
    n_alive = nv
    while n_alive > n_target and heap:
        cost, u, w, vu, vw, x = heapq.heappop(heap)
        if not (alive_v[u] and alive_v[w]) or version[u] != vu \
                or version[w] != vw or w not in neigh[u]:
            continue
        x = np.asarray(x)
        # reject collapses that flip any surviving incident face
        flip = False
        for fi in (vert_faces[u] | vert_faces[w]):
            if not alive_f[fi]:
                continue
            f = F[fi]
            if u in f and w in f:
                continue                      # face dies with the edge
            tri = V[f].copy()
            n0 = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            tri[list(f).index(u if u in f else w)] = x
            n1 = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            if n0 @ n1 <= 0:
                flip = True
                break
        if flip:
            continue
        # merge w into u at x
        V[u] = x
        Q[u] = Q[u] + Q[w]
        alive_v[w] = False
        n_alive -= 1
        for fi in list(vert_faces[w]):
            if not alive_f[fi]:
                continue
            f = F[fi]
            if u in f:
                alive_f[fi] = False
                continue
            F[fi] = np.where(f == w, u, f)
            vert_faces[u].add(fi)
        neigh[w].discard(u)
        neigh[u].discard(w)
        for t in neigh[w]:
            neigh[t].discard(w)
            if t != u:
                neigh[t].add(u)
                neigh[u].add(t)
        neigh[w] = set()
        version[u] += 1
        for t in neigh[u]:
            cost, xx = collapse_cost(u, t)
            uu, ww = (u, t) if u < t else (t, u)
            heapq.heappush(heap, (cost, uu, ww, int(version[uu]),
                                  int(version[ww]), tuple(xx)))
    new_f = F[alive_f]
    ok = ((new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
          & (new_f[:, 0] != new_f[:, 2]))
    return _compact(V.astype(vertices.dtype),
                    new_f[ok].astype(faces.dtype))


def decimate_mesh(vertices: np.ndarray, faces: np.ndarray,
                  target_ratio: float = 0.5,
                  method: str = "qem",
                  qem_budget: int = 20_000
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decimation to ~``target_ratio`` of the vertices (ref:
    Mesh::Decimate / Clean fDecimate).  ``method``: "qem" (the
    reference's VCG-quality quadric edge collapse — exact on planar
    regions, preserves sharp features; default) or "cluster" (grid
    vertex clustering, O(n)).  Meshes above ``qem_budget`` vertices are
    first clustered down to the budget, then QEM-collapsed — bounds the
    host-side heap work while keeping feature-aware placement for the
    final collapses."""
    if len(faces) == 0 or target_ratio >= 1.0:
        return vertices, faces
    if method == "qem":
        n_target = max(4, int(len(vertices) * target_ratio))
        if len(vertices) > qem_budget:
            if n_target >= qem_budget:
                method = "cluster"   # QEM would start below its target
            else:
                vertices, faces = decimate_mesh(
                    vertices, faces, qem_budget / len(vertices),
                    method="cluster")
        if method == "qem":
            return decimate_mesh_qem(vertices, faces,
                                     n_target / max(len(vertices), 1))
    n_target = max(4, int(len(vertices) * target_ratio))
    # robust bbox: isolated outliers must not dilute the grid resolution
    # over the main surface (they collapse into the clamped edge cells)
    bb_min = np.quantile(vertices, 0.05, axis=0)
    bb_max = np.quantile(vertices, 0.95, axis=0)
    extent = np.maximum(bb_max - bb_min, 1e-9)
    # choose a grid with about n_target occupied cells
    cells_per_axis = max(2, int(np.ceil(n_target ** (1 / 3) * 1.5)))
    cell = extent / cells_per_axis
    keys = np.floor((vertices - bb_min) / cell).astype(np.int64)
    keys = np.clip(keys, -1, cells_per_axis + 1)
    keys = (keys[:, 0] * (cells_per_axis + 3) + keys[:, 1]) \
        * (cells_per_axis + 3) + keys[:, 2]
    uniq, inv = np.unique(keys, return_inverse=True)
    # new vertex = centroid of cluster
    new_v = np.zeros((len(uniq), 3))
    cnt = np.zeros(len(uniq))
    np.add.at(new_v, inv, vertices)
    np.add.at(cnt, inv, 1)
    new_v /= cnt[:, None]
    new_f = inv[faces]
    # drop degenerate faces
    ok = ((new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
          & (new_f[:, 0] != new_f[:, 2]))
    new_f = new_f[ok]
    # drop duplicate faces (ignoring winding-preserving rotations)
    key = np.sort(new_f, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    new_f = new_f[np.sort(first)]
    return _compact(new_v.astype(vertices.dtype),
                    new_f.astype(faces.dtype))


def close_holes(vertices: np.ndarray, faces: np.ndarray,
                max_hole_size: int = 30) -> np.ndarray:
    """Close boundary loops with up to ``max_hole_size`` edges by fanning
    around the loop centroid (ref: Mesh::CloseHole/CloseHoleQuality,
    frame_main/libs/MVS/Mesh.cpp:3156-3187; apps default --close-holes 30).

    Returns ``(vertices, faces)`` — one centroid vertex is appended per
    closed hole with more than 3 boundary edges.  Note: the outer boundary
    of an open mesh is itself a loop; it is left open when longer than
    ``max_hole_size``.
    """
    # boundary edges: appear in exactly one face (directed convention:
    # faces wind consistently, so each boundary edge appears once as (a,b))
    count = {}
    for face in faces:
        for k in range(3):
            a, b = int(face[k]), int(face[(k + 1) % 3])
            e = (min(a, b), max(a, b))
            count[e] = count.get(e, 0) + 1
    nxt = {}
    for face in faces:
        for k in range(3):
            a, b = int(face[k]), int(face[(k + 1) % 3])
            if count[(min(a, b), max(a, b))] == 1:
                # boundary half-edge of the hole winds opposite the face
                nxt[b] = a
    new_faces = []
    new_verts = []
    visited = set()
    for start in list(nxt.keys()):
        if start in visited or start not in nxt:
            continue
        loop = [start]
        visited.add(start)
        cur = nxt[start]
        ok = True
        while cur != start:
            if cur in visited or cur not in nxt or \
                    len(loop) > max_hole_size:
                ok = False
                break
            loop.append(cur)
            visited.add(cur)
            cur = nxt[cur]
        if not ok or len(loop) < 3:
            continue
        if len(loop) == 3:
            new_faces.append([loop[0], loop[1], loop[2]])
        else:
            cid = len(vertices) + len(new_verts)
            new_verts.append(vertices[loop].mean(0))
            for k in range(len(loop)):
                new_faces.append([loop[k], loop[(k + 1) % len(loop)], cid])
    if not new_faces:
        return vertices, faces
    verts_out = (np.concatenate([vertices, np.asarray(new_verts,
                                                      vertices.dtype)])
                 if new_verts else vertices)
    return verts_out, np.concatenate(
        [faces, np.asarray(new_faces, faces.dtype)])


def laplacian_smooth(vertices: np.ndarray, faces: np.ndarray,
                     n_iters: int = 2, lam: float = 0.5) -> np.ndarray:
    """Uniform-weight Laplacian smoothing (ref: Clean's final smooth
    pass)."""
    if len(faces) == 0:
        return vertices
    v = vertices.astype(np.float64).copy()
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    for _ in range(n_iters):
        acc = np.zeros_like(v)
        cnt = np.zeros(len(v))
        np.add.at(acc, edges[:, 0], v[edges[:, 1]])
        np.add.at(acc, edges[:, 1], v[edges[:, 0]])
        np.add.at(cnt, edges[:, 0], 1)
        np.add.at(cnt, edges[:, 1], 1)
        has = cnt > 0
        v[has] = v[has] * (1 - lam) + lam * acc[has] / cnt[has, None]
    return v.astype(vertices.dtype)


def clean_mesh(vertices: np.ndarray, faces: np.ndarray,
               decimate: float = 1.0, min_component_faces: int = 20,
               smooth_iters: int = 2, max_hole_size: int = 30
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The Clean pipeline the apps run (ref: ReconstructMesh.cpp:278 —
    decimate, remove-spurious, close-holes 30, smooth 2)."""
    if decimate < 1.0:
        vertices, faces = decimate_mesh(vertices, faces, decimate)
    vertices, faces = remove_small_components(vertices, faces,
                                              min_component_faces)
    if max_hole_size > 0:
        vertices, faces = close_holes(vertices, faces, max_hole_size)
    if smooth_iters > 0:
        vertices = laplacian_smooth(vertices, faces, smooth_iters)
    return vertices, faces


def compute_vertex_normals(vertices: np.ndarray,
                           faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    n = np.zeros_like(vertices, dtype=np.float64)
    if len(faces):
        a = vertices[faces[:, 0]]
        b = vertices[faces[:, 1]]
        c = vertices[faces[:, 2]]
        fn = np.cross(b - a, c - a)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


def subdivide(vertices: np.ndarray, faces: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint (1-to-4) subdivision (ref: Mesh::Subdivide,
    frame_main/libs/MVS/Mesh.cpp:2824)."""
    edge_mid = {}
    verts = list(np.asarray(vertices, np.float64))

    def mid(a, b):
        e = (min(a, b), max(a, b))
        if e not in edge_mid:
            edge_mid[e] = len(verts)
            verts.append((vertices[a] + vertices[b]) * 0.5)
        return edge_mid[e]

    out = []
    for a, b, c in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return (np.asarray(verts, vertices.dtype),
            np.asarray(out, faces.dtype))


def fix_non_manifold(vertices: np.ndarray, faces: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop degenerate/duplicate faces and the extra faces of non-manifold
    edges (> 2 incident faces), keeping the two largest-area ones
    (ref: Mesh::FixNonManifold, Mesh.cpp:436,715 — the reference
    duplicates vertices instead; dropping is the conservative variant)."""
    faces = np.asarray(faces)
    keep = np.ones(len(faces), bool)
    # degenerate (repeated vertex) faces
    keep &= ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
             & (faces[:, 0] != faces[:, 2]))
    # duplicate faces (same vertex set)
    seen = set()
    for i, f in enumerate(faces):
        key = tuple(sorted(map(int, f)))
        if key in seen:
            keep[i] = False
        seen.add(key)
    # non-manifold edges
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    edge_faces = {}
    for i, f in enumerate(faces):
        if not keep[i]:
            continue
        for k in range(3):
            e = (min(f[k], f[(k + 1) % 3]), max(f[k], f[(k + 1) % 3]))
            edge_faces.setdefault(e, []).append(i)
    for e, fl in edge_faces.items():
        if len(fl) > 2:
            order = sorted(fl, key=lambda i: -area[i])
            for i in order[2:]:
                keep[i] = False
    return _compact(vertices, faces[keep])


def sample_points(vertices: np.ndarray, faces: np.ndarray,
                  n_points: int, rng=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform area-weighted surface sampling (ref: Mesh::SamplePoints,
    Mesh.cpp:3444-3462 — the --sample-mesh mode).  Returns (points,
    normals)."""
    rng = rng or np.random.default_rng(0)
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    nrm = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(nrm, axis=1)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                           1e-12)
    p = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(faces), n_points, p=p)
    r1 = np.sqrt(rng.random(n_points))
    r2 = rng.random(n_points)
    u = 1 - r1
    v = r1 * (1 - r2)
    w = r1 * r2
    pts = (u[:, None] * a[fi] + v[:, None] * b[fi] + w[:, None] * c[fi])
    return pts.astype(np.float32), nrm[fi].astype(np.float32)


def rasterize_depth(vertices: np.ndarray, faces: np.ndarray,
                    K: np.ndarray, R: np.ndarray, C: np.ndarray,
                    h: int, w: int, backend: str = "native") -> np.ndarray:
    """Z-buffer mesh rasterization into a depth map (ref: TRasterMesh /
    Mesh::Project, Mesh.cpp:3532-3586 — used for mesh-initialized dense
    passes and occlusion handling).  ``backend="native"``: the native
    rasterizer's first pass; ``"numpy"``: the plain version, a host-side
    scanline over per-face bounding boxes, vectorized within each face
    (equal depths)."""
    if backend == "native":
        return native.rasterize(vertices, faces, K, R, C, h, w,
                                with_attrs=False)[0]
    if backend != "numpy":
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    depth = np.full((h, w), np.inf)
    Xc = (vertices - C) @ R.T
    z = Xc[:, 2]
    uvw = Xc @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uvw[:, :2] / uvw[:, 2:3]
    for f in faces:
        if (z[f] <= 0).any():
            continue
        tri = uv[f]
        lo = np.floor(tri.min(0)).astype(int)
        hi = np.ceil(tri.max(0)).astype(int) + 1
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [w, h])
        if (hi <= lo).any():
            continue
        xs, ys = np.meshgrid(np.arange(lo[0], hi[0]),
                             np.arange(lo[1], hi[1]))
        p = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
        # barycentric in image space
        t = tri[1:] - tri[0]
        det = t[0, 0] * t[1, 1] - t[0, 1] * t[1, 0]
        if abs(det) < 1e-12:
            continue
        rel = p - tri[0]
        l1 = (rel[:, 0] * t[1, 1] - rel[:, 1] * t[1, 0]) / det
        l2 = (-rel[:, 0] * t[0, 1] + rel[:, 1] * t[0, 0]) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        iz = l0 / z[f[0]] + l1 / z[f[1]] + l2 / z[f[2]]
        d = 1.0 / np.maximum(iz, 1e-12)
        px = p[inside].astype(int)
        dv = d[inside]
        flat = px[:, 1] * w + px[:, 0]
        cur = depth.reshape(-1)
        np.minimum.at(cur, flat, dv)
    depth[~np.isfinite(depth)] = 0.0
    return depth.astype(np.float32)


def rasterize_attributes(vertices: np.ndarray, faces: np.ndarray,
                         K: np.ndarray, R: np.ndarray, C: np.ndarray,
                         h: int, w: int, backend: str = "native"):
    """Z-buffer rasterization with per-pixel face ids + barycentrics
    (ref: TRasterMesh, Mesh.cpp:3532-3586 — the projection/visibility
    maps the CUDA refine kernels consume, SceneRefineCUDA.cpp:62-1944).

    Returns (depth (H, W) f32, face_id (H, W) i32 with -1 = empty,
    bary (H, W, 3) f32).  Two scanline passes: depth z-buffer, then
    winner attribution (d == z-buffer within eps).  ``backend="native"``
    runs the native C++ rasterizer (native/raster.cpp); ``"numpy"`` the
    plain version below, its semantics spec (equal depths and face ids,
    barycentrics within 1e-6).
    """
    if backend == "native":
        return native.rasterize(vertices, faces, K, R, C, h, w,
                                with_attrs=True)
    if backend != "numpy":
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    depth = rasterize_depth(vertices, faces, K, R, C, h, w,
                            backend="numpy")
    face_id = np.full((h, w), -1, np.int32)
    bary = np.zeros((h, w, 3), np.float32)
    Xc = (vertices - C) @ R.T
    z = Xc[:, 2]
    uvw = Xc @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uvw[:, :2] / uvw[:, 2:3]
    for fi, f in enumerate(faces):
        if (z[f] <= 0).any():
            continue
        tri = uv[f]
        lo = np.floor(tri.min(0)).astype(int)
        hi = np.ceil(tri.max(0)).astype(int) + 1
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [w, h])
        if (hi <= lo).any():
            continue
        xs, ys = np.meshgrid(np.arange(lo[0], hi[0]),
                             np.arange(lo[1], hi[1]))
        p = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
        t = tri[1:] - tri[0]
        det = t[0, 0] * t[1, 1] - t[0, 1] * t[1, 0]
        if abs(det) < 1e-12:
            continue
        rel = p - tri[0]
        l1 = (rel[:, 0] * t[1, 1] - rel[:, 1] * t[1, 0]) / det
        l2 = (-rel[:, 0] * t[0, 1] + rel[:, 1] * t[0, 0]) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        if not inside.any():
            continue
        iz = l0 / z[f[0]] + l1 / z[f[1]] + l2 / z[f[2]]
        d = 1.0 / np.maximum(iz, 1e-12)
        px = p[inside].astype(int)
        dv = d[inside]
        win = np.abs(depth[px[:, 1], px[:, 0]] - dv) \
            <= 1e-4 * np.maximum(dv, 1e-9)
        if not win.any():
            continue
        px = px[win]
        face_id[px[:, 1], px[:, 0]] = fi
        # perspective-correct barycentrics (weights on 1/z interpolation)
        li = np.stack([l0[inside][win] / z[f[0]],
                       l1[inside][win] / z[f[1]],
                       l2[inside][win] / z[f[2]]], 1)
        li = li / li.sum(1, keepdims=True)
        bary[px[:, 1], px[:, 0]] = li
    return depth, face_id, bary
