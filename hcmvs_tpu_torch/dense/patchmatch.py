"""PatchMatch sweeps (PyTorch port of the main path of
``hcmvs_tpu/dense/patchmatch.py``).

Every pixel updates at once from the previous full state (Jacobi; or one
checkerboard parity per call with ``sweep_mode="redblack"``).  Candidates
are the current hypothesis, plane propagation from the HC-MVS cross
pattern (ref: DepthMap.cpp:1064-1274) and the annealed random refinement
ladder (ref: DepthMap.cpp:384, :1441-1501).  Each candidate's full cost is
computed, and the winner taken by argmin (the carry-free scan of the JAX
package, written as a loop).  With ``candidate_kernel="on"`` the
photometric term of all propagation candidates comes from one batched
table lookup per view (``_batched_best``); with ``batch_candidates``
(and the candidate kernel off) the incumbent is scored alone and every
propagation candidate in one ``compute_cost`` call on the (K, H, W)
stack (the JAX package's ``vmap`` of the cost, the axis written out),
the winner the first minimum over [incumbent, candidates].
``refine_batched`` perturbs the post-propagation best at every
refinement scale and scores the set together instead of one scale after
another.

With ``view_spread`` (and neighbour maps attached) every neighbour's
hypothesis at the pixel's projection joins the propagation candidates,
after the cross-pattern ones (``score.view_spread_candidates``; ref:
OPTDENSE::viewspread, DepthMap.cpp:1504-1608).

Cross-scale channels (the hierarchical schedule's restore stages): a
prior depth map enters the cost in the geometric phase (``finish_cost``,
``score.prior_blend``), and ``half_sweep(..., inject=True)`` scores the
upsampled previous-stage hypothesis after the refinement, accepted with a
0.1 bonus against the incumbent's raw cost, the raw cost stored (ref:
restore/libs/MVS/DepthMap.cpp:1527-1549), in each refinement branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import score as S
from hcmvs_tpu_torch.dense.types import (PatchMatchState, Rows,
                                         ViewGeometry, face_camera_t,
                                         init_state, normalize3, pixel_rays,
                                         tangent_frame)
from hcmvs_tpu_torch.ops.sampling import pad_edge


@dataclasses.dataclass(frozen=True)
class ScoreContext:
    """Everything the cost function reads besides the hypothesis."""

    geom: ViewGeometry
    src_grays: torch.Tensor               # (V, H, W)
    stats: S.RefPatchStats
    hw: torch.Tensor                      # (H, W) adaptive half-window
    rays: torch.Tensor                    # (3, H, W)
    gra: torch.Tensor                     # (H, W) gradient map
    d_min: torch.Tensor                   # scalar
    d_max: torch.Tensor                   # scalar
    nbr_depth: Optional[torch.Tensor]     # (V, H, W) or None
    nbr_normal: Optional[torch.Tensor]    # (V, 3, H, W) or None
    vol: Optional[object] = None          # ops.volume.VolumeTables (V)
    vol_bounds: Optional[torch.Tensor] = None  # (V, P_pad, 128) u16
                                          # score.volume_bounds, once per
                                          # sweep call
    rect: Optional[object] = None         # ops.rect_gather.RectContext
    flow: Optional[torch.Tensor] = None   # (2, H, W) flow to neighbour 0
    prior_depth: Optional[torch.Tensor] = None    # (H, W), 0 = no prior
    inject_depth: Optional[torch.Tensor] = None   # (H, W) cross-scale
    inject_normal: Optional[torch.Tensor] = None  # (3, H, W) hypothesis
    rows: Optional[Rows] = None           # a row band's context: every
                                          # per-pixel field (and vol's and
                                          # rect's rows) holds these rows


def propagation_offsets(cfg: DenseConfig) -> list:
    """Static candidate offsets: the HC-MVS cross pattern
    (ref: DepthMap.cpp:1193-1199 — ±1 then ±(1+k*step) up to halfwin)."""
    dists = [1]
    d = 1 + cfg.propagate_step
    while d <= max(cfg.propagate_half_window, 1) + cfg.propagate_step - 1:
        dists.append(d)
        d += cfg.propagate_step
    offs = []
    for dist in dists:
        offs += [(0, dist), (0, -dist), (dist, 0), (-dist, 0)]
    return offs


def finish_cost(ctx: ScoreContext, ncc: torch.Tensor, bad: torch.Tensor,
                depth: torch.Tensor, normal: torch.Tensor,
                cur_depth_map: torch.Tensor, cur_normal_map: torch.Tensor,
                delta_c2pmax: torch.Tensor, cfg: DenseConfig,
                phase: int) -> torch.Tensor:
    """Smoothness bonus, geometric, local-smoothness and flow blends, view
    aggregation and the prior (ref: DepthMap.cpp:890-958, :987-1046).
    ``ncc``/``bad`` are (V, H, W), or (K, V, H, W) for a candidate stack
    (``depth`` (K, H, W), ``normal`` (K, 3, H, W)), which gives (K, H,
    W)."""
    bonus = S.smoothness_bonus(cur_depth_map, cur_normal_map, ctx.rays,
                               depth, normal, cfg)
    # thRobust placeholders of OOB/textureless views stay flat
    ncc = torch.where(bad, ncc, ncc * bonus.unsqueeze(-3))

    if phase >= 1 and cfg.use_geo_consistency and ctx.nbr_depth is not None:
        geo = S.geometric_scores(ctx.geom, depth, normal, ctx.rays,
                                 ctx.nbr_depth, ctx.nbr_normal, cfg,
                                 rect=ctx.rect, rows=ctx.rows)
        para_tapa, para_part = S.texture_weights(ctx.gra, cfg)
        gra_s = S.local_smoothness_score(cur_depth_map, cur_normal_map,
                                         ctx.rays, depth, normal, ctx.d_max,
                                         delta_c2pmax)
        per_view = (1.0 - para_tapa)[None] * ncc + para_tapa[None] * geo
        per_view = ((1.0 - para_part)[None] * per_view
                    + para_part[None] * gra_s.unsqueeze(-3))
    else:
        per_view = ncc

    if cfg.use_optical_flow and ctx.flow is not None:
        fs = S.flow_score(ctx.geom, depth, ctx.rays, ctx.flow, view_idx=0,
                          rows=ctx.rows)
        wt = cfg.photometric_flow
        per_view = torch.cat([
            ((1.0 - wt) * per_view[..., 0, :, :] + wt * fs).unsqueeze(-3),
            per_view[..., 1:, :, :]], dim=-3)
    agg = S.aggregate_scores(per_view, cfg)
    if phase >= 1 and ctx.prior_depth is not None:
        agg = S.prior_blend(agg, depth, ctx.prior_depth, cfg)
    return agg


def compute_cost(ctx: ScoreContext, depth: torch.Tensor,
                 normal: torch.Tensor, cur_depth_map: torch.Tensor,
                 cur_normal_map: torch.Tensor, delta_c2pmax: torch.Tensor,
                 cfg: DenseConfig, phase: int, offsets) -> torch.Tensor:
    """Aggregated per-pixel cost of a hypothesis field (H, W) -> (H, W),
    or of a candidate stack (K, H, W) -> (K, H, W) in one call (each
    kernel launched as for one field); ``phase`` 0 = photometric, 1 =
    geometric."""
    ncc, bad = S.score_photometric(ctx.geom, ctx.src_grays, ctx.stats,
                                   ctx.hw, depth, normal, ctx.rays,
                                   offsets, cfg, phase, vol=ctx.vol,
                                   rows=ctx.rows)
    return finish_cost(ctx, ncc, bad, depth, normal, cur_depth_map,
                       cur_normal_map, delta_c2pmax, cfg, phase)


def _propagate_from(state_depth: torch.Tensor, state_normal: torch.Tensor,
                    rays: torch.Tensor, dy: int, dx: int):
    """Plane-propagate the hypothesis at (y+dy, x+dx) to (y, x):
    d = (n_nbr . X_nbr) / (n_nbr . ray)  (ref: DepthMap.cpp:1277-1391)."""
    h, w = state_depth.shape
    pad = max(abs(dy), abs(dx))
    ys = slice(pad + dy, pad + dy + h)
    xs = slice(pad + dx, pad + dx + w)
    d_n = pad_edge(state_depth, pad)[ys, xs]
    n_n = pad_edge(state_normal, pad)[:, ys, xs]
    r_n = pad_edge(rays, pad)[:, ys, xs]
    num = (n_n[0] * r_n[0] + n_n[1] * r_n[1] + n_n[2] * r_n[2]) * d_n
    den = n_n[0] * rays[0] + n_n[1] * rays[1] + n_n[2] * rays[2]
    d_prop = num / torch.where(den.abs() < 1e-9, 1e-9, den)
    return d_prop, n_n


class PerturbDraws(NamedTuple):
    """The random numbers one ``_perturb`` step consumes, each (H, W)."""

    u: torch.Tensor        # depth jitter, uniform in [-1, 1)
    t1_ang: torch.Tensor   # tilt angles, uniform in [-a1, a1) and
    t2_ang: torch.Tensor   # [-a2, a2) at this step's scale


def _perturb_draws(gen: torch.Generator, h: int, w: int, scale: float,
                   cfg: DenseConfig, device) -> PerturbDraws:
    def uniform(half):
        u = torch.rand((h, w), generator=gen, device=device,
                       dtype=torch.float32)
        return (2.0 * u - 1.0) * half
    return PerturbDraws(
        u=uniform(1.0),
        t1_ang=uniform(math.radians(cfg.random_angle1_range) * scale),
        t2_ang=uniform(math.radians(cfg.random_angle2_range) * scale))


def _step_draws(gen: torch.Generator, h: int, w: int, scale: float,
                cfg: DenseConfig, device,
                rows: Optional[Rows] = None) -> PerturbDraws:
    """``_perturb_draws`` of a field of ``h`` rows; with ``rows`` (a row
    band's) the whole image's fields are drawn and the band's rows kept,
    so a band draws what the whole view draws there."""
    if rows is None:
        return _perturb_draws(gen, h, w, scale, cfg, device)
    draws = _perturb_draws(gen, rows.height, w, scale, cfg, device)
    return PerturbDraws(*(x[rows.start:rows.start + h] for x in draws))


def _perturb(draws: PerturbDraws, depth: torch.Tensor, normal: torch.Tensor,
             rays: torch.Tensor, scale: float, cfg: DenseConfig):
    """Random plane perturbation at one refinement scale (ref:
    DepthMap.cpp:1441-1501): multiplicative depth jitter and a tilt of the
    normal by two annealed angles in its tangent frame."""
    d_new = depth * (1.0 + cfg.random_depth_ratio * 8.0 * scale * draws.u)
    t1_ang, t2_ang = draws.t1_ang, draws.t2_ang
    n = (normal[0], normal[1], normal[2])
    t1, t2 = tangent_frame(n)
    tt1 = torch.tan(t1_ang)
    tt2 = torch.tan(t2_ang)
    n_new = normalize3(tuple(n[i] + t1[i] * tt1 + t2[i] * tt2
                             for i in range(3)))
    return d_new, torch.stack(face_camera_t(n_new, (rays[0], rays[1],
                                                    rays[2])))


def _select_by_index(stack: torch.Tensor, k_star: torch.Tensor
                     ) -> torch.Tensor:
    """stack[k_star[p], ..., p] for a (K, H, W) or (K, C, H, W) stack."""
    idx = k_star[None]
    if stack.dim() == 4:
        idx = idx[:, None].expand(1, stack.shape[1], *k_star.shape)
    return torch.gather(stack, 0, idx)[0]


def _batched_best(ctx: ScoreContext, cd: torch.Tensor, cn: torch.Tensor,
                  cv: torch.Tensor, init_cost: Optional[torch.Tensor],
                  cur_d: torch.Tensor, cur_n: torch.Tensor,
                  delta_c2pmax: torch.Tensor, cfg: DenseConfig, phase: int,
                  offsets, biases=None):
    """Score a (K, ...) candidate stack with its photometric term from one
    batched lookup per view (kernel D) and fold to (best cost, best
    index).  The fold starts from ``init_cost`` (inf when None) with index
    -1, which callers read as "keep the incumbent"; a candidate wins only
    with a strictly lower cost, so ties keep the earlier one.  ``biases``
    (K floats) are acceptance bonuses: candidate k wins when its cost less
    its bias beats the running best, and its raw cost is kept."""
    ncc_all, bad_all = S.photometric_scores_volume_batched(
        ctx.geom, ctx.vol, ctx.stats, ctx.hw, cd, cn, ctx.rays, offsets,
        cfg, bounds_all=ctx.vol_bounds)
    bc = (torch.full_like(cur_d, float("inf")) if init_cost is None
          else init_cost)
    bk = torch.full(cur_d.shape, -1, dtype=torch.int64, device=cur_d.device)
    for k in range(cd.shape[0]):
        c_k = finish_cost(ctx, ncc_all[k], bad_all[k], cd[k], cn[k], cur_d,
                          cur_n, delta_c2pmax, cfg, phase)
        c_k = torch.where(cv[k], c_k, float("inf"))
        better = (c_k - (biases[k] if biases else 0.0)) < bc
        bc = torch.where(better, c_k, bc)
        bk = torch.where(better, k, bk)
    return bc, bk


def propagation_candidates(ctx: ScoreContext, cur_d: torch.Tensor,
                           cur_n: torch.Tensor, prop_offsets: list,
                           cfg: DenseConfig):
    """The propagation stack (depths (1 + K, H, W), normals (1 + K, 3, H,
    W), validity (1 + K, H, W)): the current state first, then the cross
    pattern's plane propagations and, with ``view_spread`` (and neighbour
    maps attached), each neighbour's hypothesis at this pixel's
    projection turned to face the camera, each valid inside the depth
    window."""
    lo_ok, hi_ok = ctx.d_min * 0.8, ctx.d_max * 1.2
    cand_d, cand_n, cand_v = [cur_d], [cur_n], [torch.ones_like(cur_d,
                                                                dtype=bool)]
    for dy, dx in prop_offsets:
        d_p, n_p = _propagate_from(cur_d, cur_n, ctx.rays, dy, dx)
        cand_d.append(d_p)
        cand_n.append(n_p)
        cand_v.append((d_p >= lo_ok) & (d_p <= hi_ok))
    if cfg.view_spread and ctx.nbr_depth is not None:
        vs_d, vs_n, vs_ok = S.view_spread_candidates(
            ctx.geom, cur_d, ctx.rays, ctx.nbr_depth, ctx.nbr_normal,
            rect=ctx.rect)
        for v in range(vs_d.shape[0]):
            cand_d.append(vs_d[v])
            cand_n.append(torch.stack(face_camera_t(
                (vs_n[v, 0], vs_n[v, 1], vs_n[v, 2]),
                (ctx.rays[0], ctx.rays[1], ctx.rays[2]))))
            cand_v.append(vs_ok[v] & (vs_d[v] >= lo_ok)
                          & (vs_d[v] <= hi_ok))
    return torch.stack(cand_d), torch.stack(cand_n), torch.stack(cand_v)


def c2p_max(depth: torch.Tensor, normal: torch.Tensor,
            rays: torch.Tensor) -> torch.Tensor:
    """The largest camera-to-plane distance |(n . ray) d| of a state:
    the local-smoothness term's scale (a max over the whole view)."""
    return ((normal[0] * rays[0] + normal[1] * rays[1]
             + normal[2] * rays[2]) * depth).abs().amax()


def half_sweep(state: PatchMatchState, ctx: ScoreContext, cfg: DenseConfig,
               phase: int, parity: int, offsets, prop_offsets: list,
               gen: torch.Generator, inject: bool = False,
               delta_c2pmax: Optional[torch.Tensor] = None
               ) -> PatchMatchState:
    """One sweep: with ``sweep_mode == "jacobi"`` every pixel updates from
    the previous full state; with "redblack" only pixels with
    (y + x) % 2 == parity do (y the image row).  ``gen`` drives the
    random refinement.  ``inject`` scores the context's cross-scale
    hypothesis too.  A row band's sweep (``ctx.rows``) takes
    ``delta_c2pmax``, ``c2p_max`` of the whole view's state; its rows
    within the stencils' reach of the band's edges come out wrong and
    are the caller's to replace."""
    h, w = state.depth.shape
    if delta_c2pmax is None:
        if ctx.rows is not None:
            raise ValueError("a row band's sweep needs the whole view's "
                             "delta_c2pmax")
        delta_c2pmax = c2p_max(state.depth, state.normal, ctx.rays)
    cur_d, cur_n = state.depth, state.normal
    lo_ok, hi_ok = ctx.d_min * 0.8, ctx.d_max * 1.2
    # the batched path serves the phases that score through the tables
    use_batch = (S.use_candidate_batch(cfg) and ctx.vol is not None
                 and S.exact_scoring(cfg, phase))

    def cost_of(d, n):
        return compute_cost(ctx, d, n, cur_d, cur_n, delta_c2pmax, cfg,
                            phase, offsets)

    # propagation: the current state is candidate 0
    cd, cn, cv = propagation_candidates(ctx, cur_d, cur_n, prop_offsets,
                                        cfg)
    if use_batch:
        bc, k = _batched_best(ctx, cd, cn, cv, None, cur_d, cur_n,
                              delta_c2pmax, cfg, phase, offsets)
        k = torch.clamp_min(k, 0)
    else:
        if cfg.batch_candidates:
            # the incumbent alone, then the K candidates in one cost call
            costs = torch.cat([cost_of(cur_d, cur_n)[None],
                               torch.where(cv[1:], cost_of(cd[1:], cn[1:]),
                                           float("inf"))])
        else:
            costs = torch.stack([torch.where(v_c, cost_of(d_c, n_c),
                                             float("inf"))
                                 for d_c, n_c, v_c in zip(cd, cn, cv)])
        k = torch.argmin(costs, dim=0)
        bc = costs.amin(dim=0)
    bd = _select_by_index(cd, k)
    bn = _select_by_index(cn, k)

    # cross-scale hypothesis: the upsampled previous-stage maps, turned to
    # face the camera, inside the depth window
    inj = None
    if inject and ctx.inject_depth is not None:
        d_i = ctx.inject_depth
        n_i = torch.stack(face_camera_t(
            (ctx.inject_normal[0], ctx.inject_normal[1],
             ctx.inject_normal[2]), (ctx.rays[0], ctx.rays[1], ctx.rays[2])))
        inj = (d_i, n_i, (d_i > 0) & (d_i >= lo_ok) & (d_i <= hi_ok))

    # annealed random refinement
    if cfg.refine_batched:
        # every scale perturbs the post-propagation best; the set (with the
        # injected hypothesis and its 0.1 bonus) is scored together and the
        # winner kept if it beats the incumbent
        r_d, r_n, r_v, r_b = [], [], [], []
        for r in range(cfg.random_iters):
            scale = 0.5 ** r
            draws = _step_draws(gen, h, w, scale, cfg, cur_d.device,
                                ctx.rows)
            d_r, n_r = _perturb(draws, bd, bn, ctx.rays, scale, cfg)
            r_d.append(d_r)
            r_n.append(n_r)
            r_v.append((d_r >= lo_ok) & (d_r <= hi_ok))
            r_b.append(0.0)
        if inj is not None:
            r_d.append(inj[0])
            r_n.append(inj[1])
            r_v.append(inj[2])
            r_b.append(0.1)
        if r_d:
            rd, rn = torch.stack(r_d), torch.stack(r_n)
            if use_batch:
                bc, k2 = _batched_best(ctx, rd, rn, torch.stack(r_v), bc,
                                       cur_d, cur_n, delta_c2pmax, cfg,
                                       phase, offsets, biases=r_b)
                upd = k2 >= 0
                k2 = torch.clamp_min(k2, 0)
                bd = torch.where(upd, _select_by_index(rd, k2), bd)
                bn = torch.where(upd[None], _select_by_index(rn, k2), bn)
            else:
                raw = torch.stack([bc] + [
                    torch.where(v_r, cost_of(d_r, n_r), float("inf"))
                    for d_r, n_r, v_r in zip(r_d, r_n, r_v)])
                eff = torch.cat([raw[:1], raw[1:] - torch.tensor(
                    r_b, device=raw.device)[:, None, None]])
                k2 = torch.argmin(eff, dim=0)
                bd = _select_by_index(torch.cat([bd[None], rd]), k2)
                bn = _select_by_index(torch.cat([bn[None], rn]), k2)
                bc = _select_by_index(raw, k2)
    else:
        # each step perturbs the running best and is accepted against it
        for r in range(cfg.random_iters):
            scale = 0.5 ** r
            draws = _step_draws(gen, h, w, scale, cfg, cur_d.device,
                                ctx.rows)
            d_r, n_r = _perturb(draws, bd, bn, ctx.rays, scale, cfg)
            valid = (d_r >= lo_ok) & (d_r <= hi_ok)
            c = torch.where(valid, cost_of(d_r, n_r), float("inf"))
            better = c < bc
            bd = torch.where(better, d_r, bd)
            bn = torch.where(better[None], n_r, bn)
            bc = torch.where(better, c, bc)
        if inj is not None:
            d_i, n_i, ok_i = inj
            c_i = torch.where(ok_i, cost_of(d_i, n_i), float("inf"))
            better = (c_i - 0.1) < bc
            bd = torch.where(better, d_i, bd)
            bn = torch.where(better[None], n_i, bn)
            bc = torch.where(better, c_i, bc)

    if cfg.sweep_mode == "jacobi":
        return PatchMatchState(depth=bd, normal=bn, cost=bc)
    r0 = 0 if ctx.rows is None else ctx.rows.start
    yy, xx = torch.meshgrid(torch.arange(r0, r0 + h, device=bd.device),
                            torch.arange(w, device=bd.device), indexing="ij")
    mask = ((yy + xx) % 2) == parity
    return PatchMatchState(depth=torch.where(mask, bd, state.depth),
                           normal=torch.where(mask[None], bn, state.normal),
                           cost=torch.where(mask, bc, state.cost))


def run_sweeps(state: PatchMatchState, ctx: ScoreContext, cfg: DenseConfig,
               phase: int, n_iters: int,
               gen: torch.Generator) -> PatchMatchState:
    """``n_iters`` full sweeps (two checkerboard half sweeps each with
    ``sweep_mode="redblack"``) at a fixed phase."""
    offsets = S.patch_offsets(cfg)
    prop_offsets = propagation_offsets(cfg)
    for _ in range(n_iters):
        state = half_sweep(state, ctx, cfg, phase, 0, offsets, prop_offsets,
                           gen)
        if cfg.sweep_mode != "jacobi":
            state = half_sweep(state, ctx, cfg, phase, 1, offsets,
                               prop_offsets, gen)
    return state


def make_context(geom: ViewGeometry, ref_gray: torch.Tensor,
                 src_grays: torch.Tensor, d_min, d_max, cfg: DenseConfig,
                 flow: Optional[torch.Tensor] = None,
                 prior_depth: Optional[torch.Tensor] = None,
                 nbr_depth: Optional[torch.Tensor] = None,
                 nbr_normal: Optional[torch.Tensor] = None) -> ScoreContext:
    """The ScoreContext of one reference view (``ref_gray`` (H, W)) against
    its sources (``src_grays`` (V, H, W), ``geom`` their geometry).  The
    sigma tables are built here where the config scores through them
    (``score.use_volume_tables``: "auto" on every device), and, with
    neighbour maps given, the rect context where the geo term or view
    spread reads them through the rect engine."""
    from hcmvs_tpu_torch.ops.gradients import sobel_magnitude
    from hcmvs_tpu_torch.ops.rect_gather import (build_rect_context,
                                                 pack_depth_normals)
    from hcmvs_tpu_torch.ops.volume import build_tables, use_rect_volume_build
    h, w = ref_gray.shape
    dev = ref_gray.device
    d_min = torch.as_tensor(d_min, dtype=torch.float32, device=dev)
    d_max = torch.as_tensor(d_max, dtype=torch.float32, device=dev)
    gra = sobel_magnitude(ref_gray)
    hw = S.halfwin_map(gra, cfg)
    stats = S.ref_patch_stats(ref_gray, hw, S.patch_offsets(cfg))
    rays = pixel_rays(geom.K_inv_ref, h, w)
    vol = vb = rect = None
    if S.use_volume_tables(cfg):
        vol = build_tables(geom, src_grays, d_min, d_max, cfg)
        if S.use_candidate_batch(cfg) and S.packed_lookup(vol):
            vb = S.volume_bounds(vol, use_rect_volume_build(cfg, h, w))
    if (nbr_depth is not None and S.use_rect_backend(cfg, h, w)
            and (cfg.use_geo_consistency or cfg.view_spread)):
        rect = build_rect_context(geom, pack_depth_normals(nbr_depth,
                                                           nbr_normal))
    return ScoreContext(
        geom=geom, src_grays=src_grays, stats=stats, hw=hw, rays=rays,
        gra=gra, d_min=d_min, d_max=d_max, nbr_depth=nbr_depth,
        nbr_normal=nbr_normal, vol=vol, vol_bounds=vb, rect=rect, flow=flow,
        prior_depth=prior_depth)


def estimate_depth_map(gen: torch.Generator, geom: ViewGeometry,
                       ref_gray: torch.Tensor, src_grays: torch.Tensor,
                       d_min, d_max, cfg: DenseConfig,
                       init: Optional[PatchMatchState] = None,
                       **ctx_kwargs) -> PatchMatchState:
    """Single-view estimation (ref: DepthMapsData::EstimateDepthMap,
    SceneDensify.cpp:758-1072): ``estimation_iters`` sweeps per external
    iteration, the geometric phase from external iteration ``photo2geo``
    on.  ``gen`` drives the random init (unless ``init`` is given) and
    the refinement; ``ctx_kwargs`` go to ``make_context`` (flow, prior,
    neighbour maps)."""
    ctx = make_context(geom, ref_gray, src_grays, d_min, d_max, cfg,
                       **ctx_kwargs)
    state = init if init is not None else init_state(gen, ctx.rays,
                                                     ctx.d_min, ctx.d_max)
    for it_ext in range(cfg.estimation_iters_external):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        state = run_sweeps(state, ctx, cfg, phase, cfg.estimation_iters, gen)
    return state


def confidence_from_cost(state: PatchMatchState, cfg: DenseConfig) -> tuple:
    """Final thresholding (ref: EndDepthMapTmp, SceneDensify.cpp:688-744):
    (depth, normal, conf), depth and conf 0 where the cost is above
    ``ncc_threshold_keep``, conf = 1 - cost elsewhere."""
    keep = state.cost <= cfg.ncc_threshold_keep
    depth = torch.where(keep, state.depth, 0.0)
    conf = torch.where(keep, torch.clamp_min(1.0 - state.cost, 0.0), 0.0)
    return depth, state.normal, conf
