"""Variational mesh refinement: photometric vertex optimization (PyTorch
port of ``hcmvs_tpu/mesh/refine.py``).

(ref: frame_main/libs/MVS/SceneRefine.cpp:79-192 MeshRefine / :1300
Scene::RefineMesh and the CUDA twin SceneRefineCUDA.cpp:62-1944.)  The
vertex array lives on the device across iterations.  Once per scale it
goes to the host for the native z-buffer rasterization
(``mesh_ops.rasterize_attributes``, the TRasterMesh analog) and the
vertex normals; the face ids, barycentrics and depths go back up once.

- ``gradient_mode="raster"`` (default): every pixel covered by a face
  warps its surface point into the pair's other view, takes the windowed
  ZNCC residual's gradient along the face normal, and scatters it onto
  the face's vertices with its barycentrics (``raster_refine_grad``).
- ``gradient_mode="fd"``: a per-vertex finite-difference line search
  along the normal on 5x5 patches (``refine_step``).

A uniform Laplacian stands in for the rigidity / elasticity term and the
displacement scale shrinks by ``scale_step`` per scale.

Kept from the JAX package, so the parity tests can reproduce it:
- ``_box_sum`` and the central-difference image gradients use ``roll``,
  which wraps around the image border;
- each step is normalised by the 90th percentile of |gradient| over the
  vertices with ``wsum > 1`` (linear interpolation, the default of both
  ``jnp.percentile`` and ``torch.quantile``); here it is computed on the
  device without a host sync (``_masked_quantile``).

Sums in a fixed order: CUDA's ``index_add_`` adds in an order that
varies between runs, and refine feeds every iteration's sums into the
next positions, so two runs would drift apart.  On CUDA the pixel-to-
face, face-to-vertex and Laplacian edge sums sort their rows by target
once (the face ids are fixed within a scale, the faces for the whole
run) and reduce each target's rows in that order (``torch.
segment_reduce``); two runs give equal vertices.  On the CPU they keep
``index_add_`` in row order, which matches XLA's scatter; the two give
equal sums there (``FixedSum``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.ops.sampling import bilinear_sample_xy, nearest_sample_xy
from hcmvs_tpu_torch.ops.segments import FixedSum
from hcmvs_tpu_torch.utils.profiling import stage_timer


class Laplacian:
    """The uniform Laplacian over the mesh's directed edges (each face's
    three), as the JAX package's two scatters per term: neighbour sums
    ``acc`` and counts ``cnt``."""

    def __init__(self, edges: torch.Tensor, n_vertices: int):
        e0, e1 = edges[:, 0].long(), edges[:, 1].long()
        self.src = torch.cat([e1, e0])
        self.sum = FixedSum(torch.cat([e0, e1]), n_vertices)
        ones = torch.ones(len(self.src), 1, device=edges.device)
        self.cnt = self.sum.sum(ones)[:, 0]

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        acc = self.sum.sum(V[self.src])
        return acc / torch.clamp_min(self.cnt, 1.0)[:, None] - V


def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """(3F, 2) int32 directed edges, the faces' (0,1), (1,2), (2,0)."""
    return np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                           faces[:, [2, 0]]]).astype(np.int32)


def _project(K, R, C, X):
    """(V, 3) world -> (u, v, z) arrays."""
    Xc = (X - C) @ R.T
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = (K[0, 0] * Xc[:, 0] + K[0, 2] * Xc[:, 2]) / zs
    v = (K[1, 1] * Xc[:, 1] + K[1, 2] * Xc[:, 2]) / zs
    return u, v, z


_PATCH = [(float(dy), float(dx)) for dy in (-2, -1, 0, 1, 2)
          for dx in (-2, -1, 0, 1, 2)]


def _vertex_zncc(img_a, img_b, ua, va, ub, vb):
    """ZNCC between 5x5 patches at (ua, va) in img_a and (ub, vb) in
    img_b, per vertex."""
    n = len(_PATCH)
    sa = torch.zeros_like(ua)
    sb = torch.zeros_like(ua)
    saa = torch.zeros_like(ua)
    sbb = torch.zeros_like(ua)
    sab = torch.zeros_like(ua)
    ok_all = torch.ones_like(ua, dtype=torch.bool)
    for dy, dx in _PATCH:
        a, ok1 = bilinear_sample_xy(img_a, ua + dx, va + dy)
        b, ok2 = bilinear_sample_xy(img_b, ub + dx, vb + dy)
        sa = sa + a
        sb = sb + b
        saa = saa + a * a
        sbb = sbb + b * b
        sab = sab + a * b
        ok_all = ok_all & ok1 & ok2
    ma = sa / n
    mb = sb / n
    cov = sab / n - ma * mb
    var_a = torch.clamp_min(saa / n - ma * ma, 1e-10)
    var_b = torch.clamp_min(sbb / n - mb * mb, 1e-10)
    z = cov / torch.sqrt(var_a * var_b)
    return torch.where(ok_all, torch.clamp(z, -1, 1), 0.0)


def refine_step(vertices: torch.Tensor, normals: torch.Tensor,
                lap: Laplacian, images: torch.Tensor, Ks: torch.Tensor,
                Rs: torch.Tensor, Cs: torch.Tensor, pairs: np.ndarray,
                step: float, reg_weight: float = 0.2, n_iters: int = 5,
                raster_depth: Optional[torch.Tensor] = None,
                occl_tol: float = 0.01) -> torch.Tensor:
    """``n_iters`` along-normal gradient steps at one displacement scale.

    pairs: (P, 2) view indices of the photometric pairs to score.
    raster_depth: optional (N_views, H, W) z-buffered mesh depths — a
    vertex only collects gradient from views where its projected depth
    matches the rasterization within ``occl_tol`` (relative).
    """
    def visible(iv, u, v, z):
        ok = z > 0
        if raster_depth is not None:
            zr, okr = nearest_sample_xy(raster_depth[iv], torch.round(u),
                                        torch.round(v))
            # tolerance covers the finite-difference probe displacement
            # (the raster is of the unperturbed mesh) plus a relative band
            tol = 2.0 * step + occl_tol * torch.clamp_min(z, 1e-9)
            ok = ok & okr & (zr > 0) & (torch.abs(zr - z) < tol)
        return ok

    def photo_score(V):
        total = torch.zeros(V.shape[0], device=V.device)
        cnt = torch.zeros(V.shape[0], device=V.device)
        for ia, ib in pairs:
            ua, va, za = _project(Ks[ia], Rs[ia], Cs[ia], V)
            ub, vb, zb = _project(Ks[ib], Rs[ib], Cs[ib], V)
            z = _vertex_zncc(images[ia], images[ib], ua, va, ub, vb)
            vis = visible(ia, ua, va, za) & visible(ib, ub, vb, zb)
            total = total + torch.where(vis, z, 0.0)
            cnt = cnt + vis
        return total / torch.clamp_min(cnt, 1.0)

    V = vertices
    for _ in range(n_iters):
        # finite-difference photometric gradient along the normal
        sp = photo_score(V + normals * step)
        sm = photo_score(V - normals * step)
        g = (sp - sm) / 2.0                    # d zncc / d (normal offset)
        move = torch.clamp(g, -1.0, 1.0) * step
        V = V + normals * move[:, None]
        # Laplacian regularization (rigidity/elasticity analog)
        V = V + reg_weight * lap(V)
    return V


def _box_sum(a: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(H, W) separable (2r+1)^2 box sum via shifted adds (``roll``: the
    border wraps around, as in the JAX package)."""
    out = a
    for axis in (0, 1):
        acc = out
        for d in range(1, r + 1):
            acc = acc + torch.roll(out, d, axis) + torch.roll(out, -d, axis)
        out = acc
    return out


def image_gradients(images: torch.Tensor):
    """Central differences of (N, H, W) images along x and y, wrapping at
    the border (``roll``, as the JAX package)."""
    gx = (torch.roll(images, -1, 2) - torch.roll(images, 1, 2)) * 0.5
    gy = (torch.roll(images, -1, 1) - torch.roll(images, 1, 1)) * 0.5
    return gx, gy


class ScaleRasters:
    """One scale's rasterization of the mesh into every view, on the
    device: ``face_ids`` (N, H, W) int64 (-1 = empty), ``barys``
    (N, H, W, 3), ``depth`` (N, H, W); per view the covered pixels and a
    ``FixedSum`` of them onto the faces."""

    def __init__(self, face_ids: torch.Tensor, barys: torch.Tensor,
                 depth: torch.Tensor, n_faces: int,
                 fixed_order: Optional[bool] = None):
        self.face_ids, self.barys, self.depth = face_ids, barys, depth
        self.pixels: List[torch.Tensor] = []
        self.face_sums: List[FixedSum] = []
        for fid in face_ids:
            flat = fid.reshape(-1)
            pix = torch.nonzero(flat >= 0)[:, 0]
            self.pixels.append(pix)
            self.face_sums.append(FixedSum(flat[pix], n_faces, fixed_order))


class VertexSum:
    """The face-to-vertex sum of ``raster_refine_grad``: every pair's
    (F, 2) face sums of each face corner k onto ``faces[:, k]``, in the
    JAX package's order (pair, corner, face)."""

    def __init__(self, faces: torch.Tensor, n_vertices: int, n_pairs: int,
                 fixed_order: Optional[bool] = None):
        ids = faces.long().T.reshape(-1).repeat(n_pairs)
        self.sum = FixedSum(ids, n_vertices, fixed_order)

    def __call__(self, facc: torch.Tensor) -> torch.Tensor:
        """``facc`` (P, F, 6): per pair the face sums of g * b_k (k < 3)
        and vis * b_k; returns (V, 2) sums of (grad, wsum)."""
        rows = torch.stack([facc[:, :, :3], facc[:, :, 3:]], -1)  # P,F,3,2
        return self.sum.sum(rows.permute(0, 2, 1, 3).reshape(-1, 2))


def raster_refine_grad(V: torch.Tensor, faces: torch.Tensor,
                       rasters: ScaleRasters, images: torch.Tensor,
                       gx_all: torch.Tensor, gy_all: torch.Tensor,
                       Ks: torch.Tensor, Rs: torch.Tensor, Cs: torch.Tensor,
                       pairs: np.ndarray, vertex_sum: VertexSum,
                       occl_tol: float = 0.01
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel rasterized photometric ZNCC gradient, scattered onto
    vertices via barycentrics (ref: the SceneRefineCUDA.cpp:62-1944
    kernel list — image warp, windowed mean/var/cov/ZNCC, ZNCC gradient,
    photometric vertex gradient scatter).

    For each pair (A, B): every A-pixel covered by a face carries the
    point X(p) = sum_k bary_k V[face_k]; warping B onto A through X gives
    W; the per-pixel d(ZNCC)/d(along-normal displacement) follows the
    chain through B's image gradient and projection Jacobian, and is
    scatter-added to the face's vertices with barycentric weights.
    Returns (grad (Nv,), weight (Nv,)) — positive gradient = move along
    +normal improves photo-consistency.  Queues device work only (no
    host sync).
    """
    n_views, h, w = images.shape
    nf = faces.shape[0]
    # a device tensor, not a Python number: CUDA divides by a host scalar
    # as a multiply by its reciprocal, the CPU divides, and the windowed
    # ZNCC's normalised residual turns that last-bit difference into a
    # visible one where a window is nearly flat
    npx = torch.tensor(25.0, device=images.device)
    # per-face table (F, 12): 3 vertices + unit normal
    Vf = V[faces.long()]                                 # (F, 3, 3)
    nrm_f = torch.linalg.cross(Vf[:, 1] - Vf[:, 0], Vf[:, 2] - Vf[:, 0])
    nrm_f = nrm_f / torch.clamp_min(
        torch.linalg.vector_norm(nrm_f, dim=-1, keepdim=True), 1e-12)
    Pf = torch.cat([Vf.reshape(nf, 9), nrm_f], dim=1)
    # per view, the four channels a B-tap reads: image, raster depth, gx, gy
    packed = torch.stack([images, rasters.depth, gx_all, gy_all],
                         -1).reshape(n_views, h * w, 4)

    faccs = []
    for ia, ib in pairs:
        fid = rasters.face_ids[ia]                       # (H, W)
        covered = fid >= 0
        slab = Pf[torch.clamp_min(fid, 0)]               # (H, W, 12)
        s = slab.unbind(-1)
        b0, b1, b2 = rasters.barys[ia].unbind(-1)
        # current-surface point per pixel (tracks V as it moves)
        Xp0 = b0 * s[0] + b1 * s[3] + b2 * s[6]
        Xp1 = b0 * s[1] + b1 * s[4] + b2 * s[7]
        Xp2 = b0 * s[2] + b1 * s[5] + b2 * s[8]
        n0, n1, n2 = s[9], s[10], s[11]
        # project into B
        K, R, C = Ks[ib], Rs[ib], Cs[ib]
        d0 = Xp0 - C[0]
        d1 = Xp1 - C[1]
        d2 = Xp2 - C[2]
        Xc0 = R[0, 0] * d0 + R[0, 1] * d1 + R[0, 2] * d2
        Xc1 = R[1, 0] * d0 + R[1, 1] * d1 + R[1, 2] * d2
        zb = R[2, 0] * d0 + R[2, 1] * d1 + R[2, 2] * d2
        inv_zb = 1.0 / torch.where(torch.abs(zb) < 1e-9, 1e-9, zb)
        ub = (K[0, 0] * Xc0 + K[0, 2] * zb) * inv_zb
        vb = (K[1, 1] * Xc1 + K[1, 2] * zb) * inv_zb

        # the four B channels' bilinear taps
        okb = (ub >= 0) & (vb >= 0) & (ub <= w - 1) & (vb <= h - 1)
        x0c = torch.clamp(torch.floor(ub).to(torch.int64), 0, w - 2)
        y0c = torch.clamp(torch.floor(vb).to(torch.int64), 0, h - 2)
        # fractions from the CLIPPED corner: a pixel landing exactly on
        # the last column/row (ub == w-1, admitted by okb) clips its
        # corner to w-2 and must lerp with fx=1, not the unclipped 0
        fx = (ub - x0c)[..., None]
        fy = (vb - y0c)[..., None]
        base = y0c * w + x0c
        tabs = packed[ib]
        top = tabs[base] * (1 - fx) + tabs[base + 1] * fx
        bot = tabs[base + w] * (1 - fx) + tabs[base + w + 1] * fx
        Wimg, zraster, gxb, gyb = (top * (1 - fy) + bot * fy).unbind(-1)
        # occlusion in B: point must win B's z-buffer
        vis = (covered & okb & (zb > 0)
               & (torch.abs(zraster - zb) < occl_tol * zb + 1e-6))
        visf = vis.to(torch.float32)

        # windowed ZNCC between A's image and the warp (5x5 box)
        Ia = images[ia]
        nvis = torch.clamp_min(_box_sum(visf), 1.0)
        sA = _box_sum(Ia * visf) / nvis
        sW = _box_sum(Wimg * visf) / nvis
        Ac = (Ia - sA) * visf
        Wc = (Wimg - sW) * visf
        var_a = _box_sum(Ac * Ac) / npx
        var_w = _box_sum(Wc * Wc) / npx
        sig_a = torch.sqrt(torch.clamp_min(var_a, 1e-8))
        sig_w = torch.sqrt(torch.clamp_min(var_w, 1e-8))
        # normalized-residual gradient: minimizing the windowed NSSD
        # |Ac/sig_a - Wc/sig_w|^2 is ZNCC maximization (NSSD = 2 - 2 ZNCC)
        dz_dw = (Ac / sig_a - Wc / sig_w) / (npx * sig_w)
        # d W / d delta: B-image gradient dotted with the projection
        # Jacobian applied to the surface normal
        dn0 = R[0, 0] * n0 + R[0, 1] * n1 + R[0, 2] * n2
        dn1 = R[1, 0] * n0 + R[1, 1] * n1 + R[1, 2] * n2
        dn2 = R[2, 0] * n0 + R[2, 1] * n1 + R[2, 2] * n2
        du = (K[0, 0] * dn0 - (ub - K[0, 2]) * dn2) * inv_zb
        dv = (K[1, 1] * dn1 - (vb - K[1, 2]) * dn2) * inv_zb
        g_pix = dz_dw * (gxb * du + gyb * dv) * visf

        # the covered pixels' rows onto their faces (uncovered pixels
        # carry zeros in the JAX package's full-image scatter)
        vals = torch.stack([g_pix * b0, g_pix * b1, g_pix * b2,
                            visf * b0, visf * b1, visf * b2],
                           dim=-1).reshape(-1, 6)
        faccs.append(rasters.face_sums[ia].sum(vals[rasters.pixels[ia]]))
    sums = vertex_sum(torch.stack(faccs))
    return sums[:, 0], sums[:, 1]


def _masked_quantile(x: torch.Tensor, mask: torch.Tensor,
                     q: float) -> torch.Tensor:
    """``torch.quantile(x[mask], q)`` (linear interpolation) without a
    host sync: the masked-out values sort last as +inf and the count
    stays on the device.  NaN when nothing is masked in, as the JAX
    package's percentile of an empty array."""
    vals = torch.sort(torch.where(mask, x, torch.inf)).values
    n = mask.sum()
    pos = q * (n - 1).to(x.dtype)
    lo = torch.clamp(torch.floor(pos).long(), 0, x.numel() - 1)
    hi = torch.clamp(torch.ceil(pos).long(), 0, x.numel() - 1)
    out = torch.lerp(vals[lo], vals[hi], pos - lo.to(x.dtype))
    return torch.where(n > 0, out, torch.nan)


class RasterRefine:
    """The raster mode's state for one mesh's faces and one set of views:
    the images and their gradients, cameras and pairs on the device, and
    the sums (in a fixed order on CUDA, see ``FixedSum``)."""

    def __init__(self, faces: np.ndarray, images: np.ndarray,
                 Ks: np.ndarray, Rs: np.ndarray, Cs: np.ndarray,
                 pairs: np.ndarray, n_vertices: int, device):
        dev = torch.device(device)
        self.faces_np = faces
        self.cams_np = (Ks, Rs, Cs)
        self.pairs = [(int(a), int(b)) for a, b in np.asarray(pairs)]
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa
                                        device=dev)
        self.images = f32(images)
        self.Ks, self.Rs, self.Cs = f32(Ks), f32(Rs), f32(Cs)
        self.gx, self.gy = image_gradients(self.images)
        self.faces = torch.as_tensor(faces.astype(np.int64), device=dev)
        self.vertex_sum = VertexSum(self.faces, n_vertices, len(self.pairs))
        self.lap = Laplacian(torch.as_tensor(mesh_edges(faces), device=dev),
                             n_vertices)

    def rasterize(self, V_np: np.ndarray) -> ScaleRasters:
        """Rasterize the mesh at ``V_np`` into every view on the host
        (native) and upload the maps once."""
        from hcmvs_tpu_torch.mesh.mesh_ops import rasterize_attributes
        Ks, Rs, Cs = self.cams_np
        n, h, w = self.images.shape
        out = [rasterize_attributes(V_np.astype(np.float64), self.faces_np,
                                    Ks[i], Rs[i], Cs[i], h, w)
               for i in range(n)]
        dev = self.images.device
        depth, fid, bar = (torch.as_tensor(np.stack(a), device=dev)
                           for a in zip(*out))
        return ScaleRasters(fid.long(), bar, depth, len(self.faces_np))

    def grad(self, V: torch.Tensor, rasters: ScaleRasters):
        return raster_refine_grad(V, self.faces, rasters, self.images,
                                  self.gx, self.gy, self.Ks, self.Rs,
                                  self.Cs, self.pairs, self.vertex_sum)

    def step(self, V: torch.Tensor, normals: torch.Tensor,
             rasters: ScaleRasters, cap: float,
             reg_weight: float) -> torch.Tensor:
        """One raster iteration: the gradient, the annealed trust-region
        move along the normals, the Laplacian.  Queues device work only."""
        g, wsum = self.grad(V, rasters)
        gn = g / torch.clamp_min(wsum, 1e-6)
        # the raw ZNCC gradient has image-dependent magnitude, so
        # normalize by a robust quantile (linear in gn below the cap)
        q = _masked_quantile(torch.abs(gn), wsum > 1.0, 0.9) + 1e-12
        move = torch.clamp(gn / q * cap, -cap, cap)
        V = V + normals * move[:, None]
        # Laplacian regularization (rigidity/elasticity analog)
        return V + reg_weight * self.lap(V)


def refine_mesh(vertices: np.ndarray, faces: np.ndarray,
                images: np.ndarray, Ks: np.ndarray, Rs: np.ndarray,
                Cs: np.ndarray, pairs: np.ndarray,
                scales: int = 3, scale_step: float = 0.5,
                base_step: float = None, reg_weight: float = 0.2,
                iters_per_scale: int = 10,
                occlusion: bool = True,
                gradient_mode: str = "raster",
                device="cuda") -> np.ndarray:
    """Multi-scale driver (ref: RefineMesh.cpp --scales 3 --scale-step
    0.5): displacement scale shrinks by ``scale_step`` per level.

    ``gradient_mode``:
      "raster" (default) — per-pixel rasterized ZNCC gradients scattered
        onto vertices via barycentrics (the reference's CUDA kernel
        pipeline; sub-vertex-resolution photometric evidence).
      "fd" — per-vertex finite-difference along-normal line search.
    With ``occlusion`` the fd mode z-buffers the mesh into every view once
    per scale to mask occluded samples (the raster mode always does).
    Runs on ``device`` (the card unless the CPU is asked for); sums in a
    fixed order on CUDA, ``index_add_`` on the CPU.  Stage timers:
    ``refine.raster`` per scale, ``refine.grad`` per raster iteration
    (each synchronises the device once, where the percentile's host sync
    stood in the JAX package), ``refine.fd`` per fd scale.
    """
    from hcmvs_tpu_torch.mesh.mesh_ops import (compute_vertex_normals,
                                               rasterize_depth)
    if gradient_mode not in ("raster", "fd"):
        raise ValueError(f"unknown gradient mode {gradient_mode!r}")
    dev = torch.device(device)
    if base_step is None:
        # ~half the median edge length
        e = vertices[faces[:, 0]] - vertices[faces[:, 1]]
        base_step = 0.5 * float(np.median(np.linalg.norm(e, axis=1)))
    V = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    rr = RasterRefine(faces, images, Ks, Rs, Cs, pairs, len(V), dev)
    step = base_step
    for s in range(scales):
        V_np = V.cpu().numpy()
        normals = torch.as_tensor(compute_vertex_normals(V_np, faces),
                                  device=dev)
        if gradient_mode == "raster":
            with stage_timer("refine.raster", block_on=dev):
                rasters = rr.rasterize(V_np)
            for it in range(iters_per_scale):
                with stage_timer("refine.grad", block_on=dev):
                    V = rr.step(V, normals, rasters, step * (0.8 ** it),
                                reg_weight)
        else:
            raster = None
            if occlusion:
                h, w = rr.images.shape[1:]
                with stage_timer("refine.raster", block_on=dev):
                    raster = torch.as_tensor(np.stack([
                        rasterize_depth(V_np.astype(np.float64), faces,
                                        Ks[i], Rs[i], Cs[i], h, w)
                        for i in range(len(images))]), device=dev)
            with stage_timer("refine.fd", block_on=dev):
                V = refine_step(V, normals, rr.lap, rr.images, rr.Ks, rr.Rs,
                                rr.Cs, rr.pairs, step, reg_weight,
                                iters_per_scale, raster_depth=raster)
        step *= scale_step
    return V.cpu().numpy()
