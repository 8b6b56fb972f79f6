"""Mesh texturing: face-view labeling, atlas packing, OBJ/MTL export
(port of ``hcmvs_tpu/mesh/texture.py``).

Replaces the reference's SceneTexture pipeline
(ref: frame_main/libs/MVS/SceneTexture.cpp:1972 Scene::TextureMesh —
face-per-view MRF labeling solved with LBP, outlier rejection, seam
leveling, RectsBinPack atlas packing):

- Per-face data terms (projected area x viewing angle x in-bounds) are
  computed as one vectorized pass per view.
- The Potts MRF is solved by loopy belief propagation (default) or
  TRW-S-style reweighted message passing, both on the device in PyTorch
  (``label_faces_lbp``, ``label_faces_trws``), or by ICM sweeps on the
  host (``label_faces``).
- Charts (connected same-label face groups) are MaxRects-packed into a
  single texture atlas (ref: RectsBinPack.cpp), colors sampled from the
  winning view, with global (per-chart offsets) and local (seam-band)
  seam leveling.

Everything but the message passing is host code, a numpy copy of the JAX
package's.  The port has no OpenCV: a chart larger than the atlas is
shrunk by ``io.images.resize_linear`` (cv2.resize's INTER_LINEAR
arithmetic for uint8) and the atlas is written by
``io.images.write_png``.  The per-face Python loops (``_face_adjacency``,
``_charts``' union-find, the per-chart UV loop) are the JAX package's;
``texture_mesh`` times its parts as ``texture.quality`` / ``.outliers``
/ ``.labels`` / ``.charts`` / ``.leveling`` / ``.packing``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.io.images import resize_linear, write_png
from hcmvs_tpu_torch.utils.profiling import stage_timer


class TexturedMesh(NamedTuple):
    vertices: np.ndarray      # (V, 3)
    faces: np.ndarray         # (F, 3)
    uvs: np.ndarray           # (F, 3, 2) per-corner atlas UVs in [0, 1]
    atlas: np.ndarray         # (A, A, 3) uint8
    labels: np.ndarray        # (F,) winning view per face (-1 = none)
    utilization: float = 0.0  # packed-area fraction of the atlas


class MaxRectsPacker:
    """MaxRects bin packing, best-short-side-fit heuristic
    (ref: frame_main/libs/MVS/RectsBinPack.{h,cpp} MaxRectsBinPack —
    the reference's default texture-atlas packer).

    Keeps the list of maximal free rectangles; each insert picks the free
    rect minimizing the leftover short side (then the long side; the first
    in the list on a tie), splits every free rect the placement
    intersects (into its left, right, top and bottom remainders, in the
    list's order), and prunes every rect contained in another.  The list
    is an (n, 4) array and each step one array operation: the JAX
    package's per-rect Python loops (its pruning is quadratic) took tens
    of seconds for the thousands of charts of a 1280x960 mesh, and give
    the same placements.
    """

    def __init__(self, width: int, height: int):
        self.w = width
        self.h = height
        self.free = np.array([[0, 0, width, height]], np.int64)
        self.used_area = 0

    def insert(self, rw: int, rh: int):
        """Place a rw x rh rect; returns (x, y) or None if it won't fit."""
        f = self.free
        fit = np.flatnonzero((f[:, 2] >= rw) & (f[:, 3] >= rh))
        if len(fit) == 0:
            return None
        dw, dh = f[fit, 2] - rw, f[fit, 3] - rh
        short, longl = np.minimum(dw, dh), np.maximum(dw, dh)
        best = short == short.min()
        best &= longl == longl[best].min()
        x, y = (int(v) for v in f[fit[np.argmax(best)], :2])
        fx, fy, fw, fh = f.T
        overlap = ~((x >= fx + fw) | (x + rw <= fx)
                    | (y >= fy + fh) | (y + rh <= fy))
        pieces = np.stack([
            f,
            np.stack([fx, fy, x - fx, fh], 1),                    # left
            np.stack([np.full_like(fx, x + rw), fy, fx + fw - x - rw,
                      fh], 1),                                    # right
            np.stack([fx, fy, fw, y - fy], 1),                    # top
            np.stack([fx, np.full_like(fy, y + rh), fw,
                      fy + fh - y - rh], 1)], 1)                  # bottom
        keep = np.stack([~overlap, overlap & (x > fx),
                         overlap & (x + rw < fx + fw), overlap & (y > fy),
                         overlap & (y + rh < fy + fh)], 1)
        new = pieces[keep]                     # row-major: the list order
        x0, y0 = new[:, 0], new[:, 1]
        x1, y1 = x0 + new[:, 2], y0 + new[:, 3]
        # inside[i, j]: rect i lies within rect j
        inside = ((x0[:, None] >= x0) & (y0[:, None] >= y0)
                  & (x1[:, None] <= x1) & (y1[:, None] <= y1))
        np.fill_diagonal(inside, False)
        self.free = new[~inside.any(1)]
        self.used_area += rw * rh
        return x, y


def _project_np(K, R, C, X):
    Xc = (X - C) @ R.T
    z = Xc[:, 2]
    uv = Xc @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uv[:, :2] / uv[:, 2:3]
    return uv, z


def face_view_quality(vertices: np.ndarray, faces: np.ndarray,
                      Ks: np.ndarray, Rs: np.ndarray, Cs: np.ndarray,
                      image_sizes: List[Tuple[int, int]]) -> np.ndarray:
    """(F, N) per-face per-view quality (0 = unusable).

    Quality = projected triangle area x facing term, zero when any corner
    projects outside the image or the face is back-facing (ref:
    SceneTexture.cpp data-cost construction).
    """
    n_views = len(Ks)
    f = len(faces)
    qual = np.zeros((f, n_views), np.float32)
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    face_n = np.cross(b - a, c - a)
    face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True),
                         1e-12)
    centroid = (a + b + c) / 3
    for v in range(n_views):
        w, h = image_sizes[v]
        uvs = []
        zs = []
        inb = np.ones(f, bool)
        for corner in (a, b, c):
            uv, z = _project_np(Ks[v], Rs[v], Cs[v], corner)
            uvs.append(uv)
            zs.append(z)
            inb &= ((uv[:, 0] >= 0) & (uv[:, 0] <= w - 1)
                    & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1) & (z > 0))
        # projected area
        e1 = uvs[1] - uvs[0]
        e2 = uvs[2] - uvs[0]
        area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        view_dir = centroid - Cs[v]
        view_dir /= np.maximum(np.linalg.norm(view_dir, axis=1,
                                              keepdims=True), 1e-12)
        facing = -np.sum(face_n * view_dir, axis=1)
        qual[:, v] = np.where(inb & (facing > 0.05), area * facing, 0.0)
    return qual


def _face_adjacency(faces: np.ndarray):
    """Padded face adjacency (F, D) with -1 fill + reverse slot index."""
    f = len(faces)
    edge_map = {}
    adj = [[] for _ in range(f)]
    for f_idx, face in enumerate(faces):
        for k in range(3):
            e = (min(face[k], face[(k + 1) % 3]),
                 max(face[k], face[(k + 1) % 3]))
            if e in edge_map:
                o = edge_map[e]
                adj[f_idx].append(o)
                adj[o].append(f_idx)
            else:
                edge_map[e] = f_idx
    max_deg = max((len(x) for x in adj), default=1)
    adj_arr = np.full((f, max_deg), -1, np.int32)
    for i, lst in enumerate(adj):
        adj_arr[i, :len(lst)] = lst
    # rev[f, d] = slot d' such that adj[adj[f, d], d'] == f
    rev = np.zeros((f, max_deg), np.int32)
    for i in range(f):
        for d, g in enumerate(adj_arr[i]):
            if g >= 0:
                rev[i, d] = int(np.nonzero(adj_arr[g] == i)[0][0])
    return adj_arr, rev


class _Messages:
    """The padded face adjacency on the device, for synchronous min-sum
    message passing: ``data`` (F, L) float32 unary costs (-quality / max,
    1e6 where a view is unusable), and the flat slot indices through
    which each valid slot (f, d)'s message reaches slot (adj[f, d],
    rev[f, d]) (one non-zero contributor a slot, so the sum does not
    depend on the order)."""

    def __init__(self, faces: np.ndarray, quality: np.ndarray, device):
        adj_arr, rev = _face_adjacency(faces)
        self.f, self.d_max = adj_arr.shape
        self.n_views = quality.shape[1]
        big = 1e6
        data = np.where(quality > 0, -quality / max(quality.max(), 1e-9),
                        big)
        self.data = torch.as_tensor(np.asarray(data, np.float32),
                                    device=device)
        valid = adj_arr >= 0
        self.deg = valid.sum(1)
        self.src = torch.as_tensor(np.nonzero(valid.reshape(-1))[0],
                                   device=device)
        self.dst = torch.as_tensor(
            (adj_arr * self.d_max + rev)[valid].astype(np.int64),
            device=device)

    def deliver(self, m_out: torch.Tensor) -> torch.Tensor:
        """M_new[adj[f, d], rev[f, d]] = m_out[f, d] over valid slots."""
        flat = m_out.reshape(-1, self.n_views)
        out = torch.zeros_like(flat).index_add_(0, self.dst, flat[self.src])
        return out.reshape(m_out.shape)

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.f, self.d_max, self.n_views),
                           dtype=torch.float32, device=self.data.device)

    def labels(self, M: torch.Tensor, quality: np.ndarray) -> np.ndarray:
        labels = torch.argmin(self.data + M.sum(1), dim=1).cpu().numpy()
        labels = labels.astype(np.int64)
        labels[quality.max(1) <= 0] = -1
        return labels


def label_faces_lbp(faces: np.ndarray, quality: np.ndarray,
                    smooth_weight: float = 0.3,
                    n_iters: int = 20, device="cuda") -> np.ndarray:
    """Potts-MRF face labeling via min-sum loopy belief propagation —
    the reference's default solver (ref: SceneTexture.cpp:65-88 LBP /
    frame_main/libs/Math/LBP.h), as synchronous message passing over the
    padded face adjacency on ``device``."""
    f, n_views = quality.shape
    if f == 0:
        return np.full(0, -1, np.int64)
    msg = _Messages(faces, quality, torch.device(device))
    lam = smooth_weight
    M = msg.zeros()
    for _ in range(n_iters):
        h = msg.data + M.sum(1)                           # (F, L) beliefs
        hx = h[:, None, :] - M                            # exclude sender
        m_out = torch.minimum(hx, hx.amin(-1, keepdim=True) + lam)
        m_out = m_out - m_out.amin(-1, keepdim=True)
        M = msg.deliver(m_out)
    return msg.labels(M, quality)


def labeling_energy(faces: np.ndarray, quality: np.ndarray,
                    labels: np.ndarray,
                    smooth_weight: float = 0.3) -> float:
    """Potts energy of a face labeling (data + smoothness), for
    cross-solver selection; uses the same normalized data term as the
    solvers."""
    big = 1e6
    data = np.where(quality > 0, -quality / max(quality.max(), 1e-9), big)
    sel = np.where(labels >= 0, labels, 0)
    e = float(np.where(labels >= 0,
                       data[np.arange(len(labels)), sel], 0.0).sum())
    adj_arr, _ = _face_adjacency(faces)
    li = labels[:, None]
    lj = np.where(adj_arr >= 0, labels[np.maximum(adj_arr, 0)], -9)
    disagree = (adj_arr >= 0) & (lj != li) & (li >= 0) & (lj >= 0)
    return e + 0.5 * smooth_weight * float(disagree.sum())


def label_faces_trws(faces: np.ndarray, quality: np.ndarray,
                     smooth_weight: float = 0.3,
                     n_iters: int = 40, device="cuda") -> np.ndarray:
    """Potts-MRF face labeling via tree-reweighted message passing — the
    reference's OPTIONAL TRW-S texturing solver (ref: the TRWS/LBP
    dispatch in SceneTexture.cpp:65-88, Math/TRWS/MRFEnergy.h).

    As the JAX package: Kolmogorov's sequential node order is replaced
    by damped synchronous sweeps with uniform edge-appearance reweighting
    gamma_i = 1/deg_i, every message updated at once on ``device``.  The
    result is kept only if its Potts energy beats the LBP labeling
    (labeling_energy), so the option can never regress the default."""
    f, n_views = quality.shape
    if f == 0:
        return np.full(0, -1, np.int64)
    msg = _Messages(faces, quality, torch.device(device))
    lam = smooth_weight
    gamma = torch.as_tensor((1.0 / np.maximum(msg.deg, 1)).astype(
        np.float32), device=msg.data.device)
    M = msg.zeros()
    for _ in range(n_iters):
        b = msg.data + M.sum(1)                          # (F, L) beliefs
        # tree-reweighted reparameterization: each edge sees only a
        # gamma_i share of the node belief, minus its own message
        hx = gamma[:, None, None] * b[:, None, :] - M
        m_out = torch.minimum(hx, hx.amin(-1, keepdim=True) + lam)
        m_out = m_out - m_out.amin(-1, keepdim=True)
        M = 0.5 * M + 0.5 * msg.deliver(m_out)           # damped
    labels = msg.labels(M, quality)
    lbp = label_faces_lbp(faces, quality, smooth_weight, device=device)
    if (labeling_energy(faces, quality, lbp, smooth_weight)
            < labeling_energy(faces, quality, labels, smooth_weight)):
        return lbp
    return labels


def reject_outlier_views(vertices: np.ndarray, faces: np.ndarray,
                         quality: np.ndarray, images: List[np.ndarray],
                         Ks, Rs, Cs, threshold: float = 6e-2) -> np.ndarray:
    """Zero the quality of (face, view) pairs whose observed color is an
    outlier against the face's cross-view median (ref: SceneTexture.cpp
    face-texture outlier rejection, --outlier-threshold 6e-2): occluders
    and specular views stop winning the labeling."""
    fq = quality.copy()
    n_views = quality.shape[1]
    cent = vertices[faces].mean(1)
    cols = np.full((len(faces), n_views), np.nan)
    for v in range(n_views):
        uv, z = _project_np(Ks[v], Rs[v], Cs[v], cent)
        img = images[v]
        h, w = img.shape[:2]
        ok = (quality[:, v] > 0) & (z > 0)
        x = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
        y = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
        c = img[y, x]
        if c.ndim == 2:
            c = c.mean(-1)
        if img.dtype == np.uint8:
            c = c / 255.0
        cols[:, v] = np.where(ok, c, np.nan)
    n_obs = (~np.isnan(cols)).sum(1)
    med = np.nanmedian(np.where(np.isnan(cols), np.nan, cols), axis=1)
    dev = np.abs(cols - med[:, None])
    with np.errstate(invalid="ignore"):
        out = dev > threshold
    # a median over < 3 observations cannot identify an outlier (with 2,
    # both views deviate from their midpoint equally)
    out[n_obs < 3] = False
    fq[np.nan_to_num(out, nan=False).astype(bool)] = 0.0
    return fq


def label_faces(faces: np.ndarray, quality: np.ndarray,
                smooth_weight: float = 0.3, n_iters: int = 8) -> np.ndarray:
    """Potts-MRF face labeling via vectorized ICM sweeps (the cheap
    fallback; label_faces_lbp is the reference-default LBP solver)."""
    f, n_views = quality.shape
    labels = np.argmax(quality, axis=1)
    labels[quality.max(1) <= 0] = -1
    if f == 0:
        return labels
    # face adjacency via shared edges
    edge_map = {}
    adj = [[] for _ in range(f)]
    for f_idx, face in enumerate(faces):
        for k in range(3):
            e = (min(face[k], face[(k + 1) % 3]),
                 max(face[k], face[(k + 1) % 3]))
            if e in edge_map:
                o = edge_map[e]
                adj[f_idx].append(o)
                adj[o].append(f_idx)
            else:
                edge_map[e] = f_idx
    max_deg = max((len(x) for x in adj), default=0)
    adj_arr = np.full((f, max_deg), -1, np.int64)
    for i, lst in enumerate(adj):
        adj_arr[i, :len(lst)] = lst

    data = -quality / max(quality.max(), 1e-9)     # lower is better
    scale = np.abs(data).mean() + 1e-9
    for _ in range(n_iters):
        nb_labels = np.where(adj_arr >= 0, labels[np.maximum(adj_arr, 0)],
                             -2)
        # cost per candidate label: data + potts disagreement with nbrs
        disagree = (nb_labels[:, :, None]
                    != np.arange(n_views)[None, None, :])
        valid_nb = (adj_arr >= 0)[:, :, None]
        potts = (disagree & valid_nb).sum(1) * smooth_weight * scale
        cost = data + potts
        cost[quality <= 0] = 1e9
        new_labels = np.argmin(cost, axis=1)
        new_labels[quality.max(1) <= 0] = -1
        if (new_labels == labels).all():
            break
        labels = new_labels
    return labels


def _charts(faces: np.ndarray, labels: np.ndarray) -> List[np.ndarray]:
    """Connected components of same-label faces."""
    f = len(faces)
    edge_map = {}
    parent = np.arange(f)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for f_idx, face in enumerate(faces):
        for k in range(3):
            e = (min(face[k], face[(k + 1) % 3]),
                 max(face[k], face[(k + 1) % 3]))
            if e in edge_map:
                o = edge_map[e]
                if labels[o] == labels[f_idx] and labels[f_idx] >= 0:
                    a, b = find(o), find(f_idx)
                    if a != b:
                        parent[a] = b
            else:
                edge_map[e] = f_idx
    roots = np.array([find(i) for i in range(f)])
    charts = []
    for r in np.unique(roots):
        members = np.nonzero(roots == r)[0]
        if labels[members[0]] >= 0:
            charts.append(members)
    return charts


def _sample_color(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-pixel colors at (M, 2) uv; (M, 3) float in the image's
    native scale, out-of-bounds clamped."""
    h, w = img.shape[:2]
    x = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
    y = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
    c = img[y, x]
    if c.ndim == 1:
        c = np.repeat(c[:, None], 3, 1)
    return c.astype(np.float64)


def global_seam_leveling(vertices: np.ndarray, faces: np.ndarray,
                         labels: np.ndarray, charts: List[np.ndarray],
                         images: List[np.ndarray], Ks, Rs, Cs,
                         reg: float = 1e-3) -> np.ndarray:
    """Per-chart additive color offsets that minimize seam discontinuity
    (ref: SceneTexture.cpp global seam leveling — the reference solves
    per-vertex offsets; per-chart constants capture the dominant
    exposure/white-balance difference between views and keep the system
    tiny).  Returns (n_charts, 3) offsets in the images' native scale.
    """
    n_charts = len(charts)
    chart_of_face = np.full(len(faces), -1)
    for ci, members in enumerate(charts):
        chart_of_face[members] = ci
    # seam edges: mesh edges shared by faces of different charts
    edge_face = {}
    pair_diffs = {}
    for f_idx, face in enumerate(faces):
        ca = chart_of_face[f_idx]
        if ca < 0:
            continue
        for k in range(3):
            a, b = face[k], face[(k + 1) % 3]
            e = (min(a, b), max(a, b))
            if e in edge_face:
                o = edge_face[e]
                cb = chart_of_face[o]
                if cb >= 0 and cb != ca:
                    key = (min(ca, cb), max(ca, cb))
                    pair_diffs.setdefault(key, []).extend(e)
            else:
                edge_face[e] = f_idx
    if not pair_diffs:
        return np.zeros((n_charts, 3))
    # least squares: o_a - o_b = -(col_a - col_b) at each seam, per channel
    rows, rhs = [], []
    for (ca, cb), vids in pair_diffs.items():
        vids = np.unique(vids)
        va = labels[charts[ca][0]]
        vb = labels[charts[cb][0]]
        uva, za = _project_np(Ks[va], Rs[va], Cs[va], vertices[vids])
        uvb, zb = _project_np(Ks[vb], Rs[vb], Cs[vb], vertices[vids])
        col_a = _sample_color(images[va], uva)
        col_b = _sample_color(images[vb], uvb)
        d = (col_a - col_b).mean(0)
        r = np.zeros(n_charts)
        r[ca], r[cb] = 1.0, -1.0
        rows.append(r)
        rhs.append(-d)
    A = np.asarray(rows)
    B = np.asarray(rhs)                       # (E, 3)
    AtA = A.T @ A + reg * np.eye(n_charts)
    return np.linalg.solve(AtA, A.T @ B)      # (n_charts, 3)


def local_seam_corrections(vertices: np.ndarray, faces: np.ndarray,
                           labels: np.ndarray, charts: List[np.ndarray],
                           offsets: np.ndarray,
                           images: List[np.ndarray], Ks, Rs, Cs):
    """Per-chart seam-vertex color corrections for LOCAL seam leveling
    (ref: SceneTexture.cpp local seam leveling — after the global solve,
    the residual color difference at each seam vertex is split between
    the two charts and diffused into each chart's interior).

    Returns per-chart lists of (uv (2,), correction (3,)) in the chart's
    source-view pixel coordinates.
    """
    chart_of_face = np.full(len(faces), -1)
    for ci, members in enumerate(charts):
        chart_of_face[members] = ci
    per_chart: List[list] = [[] for _ in charts]
    edge_face = {}
    for f_idx, face in enumerate(faces):
        ca = chart_of_face[f_idx]
        for k in range(3):
            a, b = face[k], face[(k + 1) % 3]
            e = (min(a, b), max(a, b))
            if e not in edge_face:
                edge_face[e] = f_idx
                continue
            o = edge_face[e]
            cb = chart_of_face[o]
            ca2 = chart_of_face[f_idx]
            if ca2 < 0 or cb < 0 or ca2 == cb:
                continue
            va = labels[charts[ca2][0]]
            vb = labels[charts[cb][0]]
            pts = vertices[list(e)]
            uva, _ = _project_np(Ks[va], Rs[va], Cs[va], pts)
            uvb, _ = _project_np(Ks[vb], Rs[vb], Cs[vb], pts)
            col_a = _sample_color(images[va], uva) + offsets[ca2]
            col_b = _sample_color(images[vb], uvb) + offsets[cb]
            resid = col_b - col_a                    # (2, 3)
            for vi in range(2):
                per_chart[ca2].append((uva[vi], 0.5 * resid[vi]))
                per_chart[cb].append((uvb[vi], -0.5 * resid[vi]))
    return per_chart


def _apply_local_leveling(patch: np.ndarray, lo: np.ndarray,
                          seam_pts: list, tau: float) -> np.ndarray:
    """Add a smoothly-decaying seam correction field to a chart patch:
    Shepard (inverse-exponential-distance) interpolation of the seam
    corrections — the banded diffusion of the reference's local leveling
    without a per-chart Poisson solve."""
    if not seam_pts:
        return patch
    h, w = patch.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    acc = np.zeros((h, w, 3))
    wsum = np.zeros((h, w))
    for uv, corr in seam_pts:
        d = np.hypot(xs - (uv[0] - lo[0]), ys - (uv[1] - lo[1]))
        wgt = np.exp(-d / max(tau, 1.0))
        acc += wgt[..., None] * corr
        wsum += wgt
    corr_field = acc / np.maximum(wsum, 1e-9)[..., None]
    # fade the field away from the seams (local leveling only corrects a
    # band; far pixels already match after the global solve)
    fade = np.clip(wsum / np.maximum(wsum.max(), 1e-9) * 4.0, 0.0, 1.0)
    return patch + corr_field * fade[..., None]


def texture_mesh(vertices: np.ndarray, faces: np.ndarray,
                 images: List[np.ndarray], Ks: np.ndarray, Rs: np.ndarray,
                 Cs: np.ndarray, atlas_size: int = 1024,
                 padding: int = 2, seam_leveling: bool = True,
                 local_leveling: bool = True,
                 packer: str = "maxrects",
                 solver: str = "lbp", device="cuda") -> TexturedMesh:
    """Full texturing pass: outlier-reject -> MRF label -> charts ->
    global + local seam leveling -> MaxRects atlas packing
    (ref: Scene::TextureMesh, SceneTexture.cpp:1972 + RectsBinPack.cpp;
    ``packer`` = "maxrects" (reference default) | "shelf";
    ``solver`` = "lbp" (reference default) | "trws" | "icm" — the
    labeling-solver option of SceneTexture.cpp:65-88; LBP and TRW-S run
    on ``device``)."""
    image_sizes = [(im.shape[1], im.shape[0]) for im in images]
    with stage_timer("texture.quality"):
        qual = face_view_quality(vertices, faces, Ks, Rs, Cs, image_sizes)
    with stage_timer("texture.outliers"):
        qual = reject_outlier_views(vertices, faces, qual, images, Ks, Rs,
                                    Cs)
    with stage_timer("texture.labels"):
        if solver == "icm":
            labels = label_faces(faces, qual)
        else:
            label_fn = {"lbp": label_faces_lbp,
                        "trws": label_faces_trws}[solver]
            labels = label_fn(faces, qual, device=device)
    with stage_timer("texture.charts"):
        charts = _charts(faces, labels)
    with stage_timer("texture.leveling"):
        offsets = (global_seam_leveling(vertices, faces, labels, charts,
                                        images, Ks, Rs, Cs)
                   if seam_leveling and charts else
                   np.zeros((len(charts), 3)))
        seam_pts = (local_seam_corrections(vertices, faces, labels, charts,
                                           offsets, images, Ks, Rs, Cs)
                    if seam_leveling and local_leveling and charts else
                    [[] for _ in charts])
    with stage_timer("texture.packing"):
        atlas, uvs, placed_area = _pack_atlas(
            vertices, faces, images, Ks, Rs, Cs, labels, charts, offsets,
            seam_pts, image_sizes, atlas_size, padding, packer)
    return TexturedMesh(vertices=vertices.astype(np.float32),
                        faces=faces.astype(np.int32), uvs=uvs,
                        atlas=atlas, labels=labels,
                        utilization=placed_area / float(atlas_size ** 2))


def _pack_atlas(vertices, faces, images, Ks, Rs, Cs, labels, charts,
                offsets, seam_pts, image_sizes, atlas_size, padding,
                packer):
    """Cut each chart's patch from its view, level it, pack it into the
    atlas and set its faces' UVs; returns (atlas, uvs, placed area)."""
    atlas = np.zeros((atlas_size, atlas_size, 3), np.uint8)
    uvs = np.zeros((len(faces), 3, 2), np.float32)

    # compute each chart's projected bbox in its view
    chart_info = []
    for members in charts:
        v_idx = labels[members[0]]
        verts = np.unique(faces[members])
        uv, _ = _project_np(Ks[v_idx], Rs[v_idx], Cs[v_idx],
                            vertices[verts])
        lo = np.floor(uv.min(0)).astype(int)
        hi = np.ceil(uv.max(0)).astype(int) + 1
        w_img, h_img = image_sizes[v_idx]
        lo = np.clip(lo, 0, [w_img - 1, h_img - 1])
        hi = np.clip(hi, 1, [w_img, h_img])
        chart_info.append((members, v_idx, lo, hi))

    # pack charts, largest first
    order = sorted(range(len(chart_info)),
                   key=lambda i: -((chart_info[i][3][1]
                                    - chart_info[i][2][1])
                                   * (chart_info[i][3][0]
                                      - chart_info[i][2][0])))
    rects = MaxRectsPacker(atlas_size, atlas_size)
    x_cur = padding
    y_cur = padding
    shelf_h = 0
    placed_area = 0
    for ci in order:
        members, v_idx, lo, hi = chart_info[ci]
        cw = hi[0] - lo[0]
        ch = hi[1] - lo[1]
        # downscale chart if larger than the atlas
        scale = min(1.0, (atlas_size - 2 * padding) / max(cw, ch, 1))
        sw = max(1, int(cw * scale))
        sh = max(1, int(ch * scale))
        if packer == "maxrects":
            pos = rects.insert(sw + padding, sh + padding)
            if pos is None:
                continue   # atlas full: faces keep uv 0 (degraded)
            x_cur, y_cur = pos[0] + padding // 2, pos[1] + padding // 2
        else:
            if x_cur + sw + padding > atlas_size:
                x_cur = padding
                y_cur += shelf_h + padding
                shelf_h = 0
            if y_cur + sh + padding > atlas_size:
                continue
        img = images[v_idx]
        patch = img[lo[1]:hi[1], lo[0]:hi[0]]
        if patch.ndim == 2:
            patch = np.repeat(patch[..., None], 3, -1)
        # seam leveling: per-chart global offset + local seam-band field
        patch = patch.astype(np.float64) + offsets[ci]
        patch = _apply_local_leveling(patch, lo, seam_pts[ci],
                                      tau=0.15 * max(cw, ch))
        if img.dtype != np.uint8:
            patch = patch * 255
        patch = np.clip(patch, 0, 255).astype(np.uint8)
        if scale != 1.0:
            patch = resize_linear(patch, sh, sw)
        atlas[y_cur:y_cur + sh, x_cur:x_cur + sw] = patch[:sh, :sw]
        placed_area += sw * sh
        # per-corner uvs
        for f_idx in members:
            uv_f, _ = _project_np(Ks[v_idx], Rs[v_idx], Cs[v_idx],
                                  vertices[faces[f_idx]])
            rel = (uv_f - lo) * scale
            uvs[f_idx, :, 0] = (x_cur + rel[:, 0]) / atlas_size
            uvs[f_idx, :, 1] = 1.0 - (y_cur + rel[:, 1]) / atlas_size
        if packer != "maxrects":
            x_cur += sw + padding
            shelf_h = max(shelf_h, sh)
    return atlas, uvs, placed_area


def write_textured_obj(path: str, tm: TexturedMesh) -> None:
    """OBJ + MTL + PNG atlas (ref: Mesh OBJ export, libs/IO/OBJ.cpp)."""
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    write_png(base + ".png", tm.atlas)
    with open(base + ".mtl", "w") as f:
        f.write(f"newmtl textured\nKa 1 1 1\nKd 1 1 1\n"
                f"map_Kd {name}.png\n")
    with open(path, "w") as f:
        f.write(f"mtllib {name}.mtl\nusemtl textured\n")
        for v in tm.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fi in range(len(tm.faces)):
            for c in range(3):
                u, vv = tm.uvs[fi, c]
                f.write(f"vt {u} {vv}\n")
        for fi, face in enumerate(tm.faces):
            t = 3 * fi
            f.write(f"f {face[0]+1}/{t+1} {face[1]+1}/{t+2} "
                    f"{face[2]+1}/{t+3}\n")
