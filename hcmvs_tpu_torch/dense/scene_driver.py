"""Scene-level dense driver (PyTorch port of the main path of
``hcmvs_tpu/dense/scene_driver.py``).

Schedule (ref: SceneDensify.cpp:3684-3713, :3914-3958):
  build the sigma tables of every (view, neighbour) pair once per stage
  (with ``volume_streaming``: view i's tables inside its own sweep, so
  only one view's tables are ever live)
  for it_ext in range(estimation_iters_external):
      phase = geometric if it_ext >= photo2geo else photometric
      neighbour maps <- snapshot of all views' current state
      run ``estimation_iters`` sweeps on every view
      if it_ext in {1, 2} and cfg.optimize: cross-view filter + gap fill
  final: confidence threshold (``finalize``)

Views are processed one after another.  The cross-scale channels of the
hierarchical schedule's restore stages act as in the JAX package: an
attached ``prior_depth`` enters the geometric phase's cost, and attached
``inject_depth`` / ``inject_normal`` are scored in the last sweep of the
last external iteration (``cross_scale_inject``).  With semantic masks
under ``use_semantic`` (or ``self_priors``), or an external prior channel
(``ext_prior_depth``), the planar-prior pass (``dense/priors.py``) runs
once, before external iteration max(n - 2, 1), and its maps become the
prior (ref: GenerateDepthPrior at it_external == n - 2,
SceneDensify.cpp:983-1031).  ``scene_sweeps`` can sweep
a chunk of the views (``view_start``, ``view_chunk``) against the
full-scene snapshot it is given; ``sweep_in_chunks`` chains such chunks
over a scene, every view exactly once.  The random init and refinement
draw from one generator in view order, or from a list with one generator
a view (``view_generators``): then a view's draws do not depend on which
other views the same process sweeps, which is what lets the view axis
(``hcmvs_tpu_torch.parallel.sharding``) split the views over processes
and still give one process's maps.  Every stage of ``estimate_scene``
is timed into ``utils.profiling``'s report, the device synchronised at its
end; streamed table builds are timed inside their sweep stage and apart,
as ``estimate.tables.streamed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.core.config import DenseConfig, window_cfg_for_width
from hcmvs_tpu_torch.dense import score as S
from hcmvs_tpu_torch.dense.bands import Band, HaloExchange
from hcmvs_tpu_torch.dense.fusion import (cross_view_filter, gap_interpolate,
                                          gap_repropagate)
from hcmvs_tpu_torch.dense.patchmatch import (ScoreContext, c2p_max,
                                              half_sweep,
                                              propagation_offsets)
from hcmvs_tpu_torch.dense.priors import (generate_priors,
                                          hyps_from_probability,
                                          merge_final_prior, ransac_draws)
from hcmvs_tpu_torch.dense.types import (PatchMatchState, init_state,
                                         make_view_geometry, pixel_rays)
from hcmvs_tpu_torch.ops.gradients import sobel_magnitude
from hcmvs_tpu_torch.ops.rect_gather import (build_rect_context,
                                             pack_depth_normals, rect_rows)
from hcmvs_tpu_torch.ops.volume import (VolumeTables, build_tables,
                                        table_rows, use_rect_volume_build)
from hcmvs_tpu_torch.utils.profiling import stage_timer


@dataclasses.dataclass(frozen=True)
class SceneTensors:
    """Batched scene on one device: everything static across sweeps."""

    gray: torch.Tensor        # (N, H, W)
    cams: Camera              # batched (N)
    nbr_idx: torch.Tensor     # (N, V) int64 neighbour image indices
    nbr_valid: torch.Tensor   # (N, V)
    d_min: torch.Tensor       # (N,)
    d_max: torch.Tensor       # (N,)
    seed_depth: Optional[torch.Tensor] = None      # (N, H, W) sparse init
    flows: Optional[torch.Tensor] = None           # (N, 2, H, W) ref->best
                                                   # neighbour (dense/flow)
    prior_depth: Optional[torch.Tensor] = None     # (N, H, W) cross-scale
                                                   # prior (0 = none)
    ext_prior_depth: Optional[torch.Tensor] = None  # (N, H, W) external
                                    # prior maps (--priors-dir, the
                                    # meanshift channel), merged by
                                    # compute_scene_priors
    semantic: Optional[torch.Tensor] = None        # (N, H, W) int64 mask
                                                   # labels
    inject_depth: Optional[torch.Tensor] = None    # (N, H, W) cross-scale
    inject_normal: Optional[torch.Tensor] = None   # (N, 3, H, W) hypothesis
    vols: Optional[VolumeTables] = None  # leading (N, V) dims; built once
                                         # per stage by attach_volumes
    vols_first: int = 0     # the view of vols' first row (a process's
                            # block of views under the view axis)
    vols_rows: Optional[Tuple[int, int]] = None  # the image rows [lo, hi)
                            # vols holds (None: all; under the tile axis
                            # the union of a process's band windows)


@dataclasses.dataclass(frozen=True)
class SceneState:
    depth: torch.Tensor    # (N, H, W)
    normal: torch.Tensor   # (N, 3, H, W)
    cost: torch.Tensor     # (N, H, W)


def want_prior_pass(scene: SceneTensors, cfg: DenseConfig) -> bool:
    """Whether the superpixel/semantic prior pass runs: with masks under
    ``use_semantic`` (SLIC self-priors without masks only when
    ``self_priors`` forces them: they cost 0.21 depth accuracy on
    wide-FOV geometry in the JAX package's ablation, BASELINE.md r4), or
    with an external prior channel."""
    return ((cfg.use_semantic and (scene.semantic is not None
                                   or bool(cfg.self_priors)))
            or scene.ext_prior_depth is not None)


def _stats_rows(stats: S.RefPatchStats, r0: int, r1: int
                ) -> S.RefPatchStats:
    """Image rows [r0, r1) of a view's patch statistics (the padded
    reference keeps its pad rows around them: real rows inside the
    image); the statistics themselves for all rows."""
    if (r0, r1) == (0, stats.tm.shape[0]):
        return stats
    pad = (stats.ref_pad.shape[-1] - stats.tm.shape[-1]) // 2
    return S.RefPatchStats(
        tm=stats.tm[r0:r1].clone(), norm_sq0=stats.norm_sq0[r0:r1].clone(),
        sum_w=stats.sum_w[r0:r1].clone(),
        ref_pad=stats.ref_pad[r0:r1 + 2 * pad].clone(),
        wts=stats.wts[:, r0:r1].contiguous())


def _per_view_context(scene: SceneTensors, i: int,
                      nbr_depth: Optional[torch.Tensor],
                      nbr_normal: Optional[torch.Tensor],
                      cfg: DenseConfig,
                      band: Optional[Band] = None) -> ScoreContext:
    """The ScoreContext of view ``i``: its slice of the attached tables,
    or, with ``volume_streaming`` and none attached, its tables built here
    (by the gate of ``ops.volume.use_rect_volume_build``).  ``band`` (a
    ``dense.bands.Band``): the context of the band's window rows, every
    per-pixel field cut from the whole view's (so its values are the
    whole view's) and the tables those of the window's rows (cut from
    the attached ones, or built here when streamed); the neighbour images
    and maps stay whole."""
    nbr = scene.nbr_idx[i]
    geom = make_view_geometry(scene.cams[i], scene.cams[nbr])
    h, w = scene.gray.shape[1:]
    gra = sobel_magnitude(scene.gray[i])
    hw = S.halfwin_map(gra, cfg)
    stats = S.ref_patch_stats(scene.gray[i], hw, S.patch_offsets(cfg))
    rays = pixel_rays(geom.K_inv_ref, h, w)
    band = None if band is None or band.whole else band
    r0, r1 = (0, h) if band is None else (band.lo, band.hi)
    if band is not None:
        gra, hw, rays = (x[..., r0:r1, :].clone() for x in (gra, hw, rays))
        stats = _stats_rows(stats, r0, r1)
    if scene.vols is not None:
        vol_i = table_rows(
            VolumeTables(*(x[i - scene.vols_first] for x in scene.vols)),
            scene.vols_rows or (0, h), (r0, r1), w,
            use_rect_volume_build(cfg, h, w))
    elif cfg.volume_streaming and S.use_volume_tables(cfg):
        with stage_timer("estimate.tables.streamed",
                         block_on=scene.gray.device):
            vol_i = build_tables(geom, scene.gray[nbr], scene.d_min[i],
                                 scene.d_max[i], cfg,
                                 None if band is None else (r0, r1))
    else:
        vol_i = None
    # kernel D's bounds panels depend only on the tables: once per call
    vb = (S.volume_bounds(vol_i, use_rect_volume_build(cfg, h, w))
          if vol_i is not None and S.use_candidate_batch(cfg)
          and S.packed_lookup(vol_i) else None)

    def view(x):
        return None if x is None else x[i][..., r0:r1, :]

    return ScoreContext(
        geom=geom, src_grays=scene.gray[nbr], stats=stats, hw=hw,
        rays=rays, gra=gra, d_min=scene.d_min[i], d_max=scene.d_max[i],
        nbr_depth=nbr_depth, nbr_normal=nbr_normal, vol=vol_i,
        vol_bounds=vb, flow=view(scene.flows),
        prior_depth=view(scene.prior_depth),
        inject_depth=view(scene.inject_depth),
        inject_normal=view(scene.inject_normal),
        rows=None if band is None else band.rows)


Generators = Union[torch.Generator, Sequence[torch.Generator]]


def view_generator(seed: int, view: int, device) -> torch.Generator:
    """View ``view``'s generator of the random init and refinement,
    seeded from (seed, view) alone (the JAX package keeps one key a view,
    ``fold_in(key, view)``); the entropy has three words, so it never
    meets ``prior_generator``'s."""
    state = np.random.SeedSequence([seed, view, 1]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2 ** 63 - 1))


def view_generators(seed: int, n_views: int, device) -> list:
    """``view_generator`` of every view of a scene, in view order."""
    return [view_generator(seed, i, device) for i in range(n_views)]


def _gen_of(gen: Generators, view: int) -> torch.Generator:
    """The generator view ``view`` draws from: its own from a per-view
    list, else the one shared generator."""
    return gen if isinstance(gen, torch.Generator) else gen[view]


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def scene_sweeps(state: SceneState, scene: SceneTensors, cfg: DenseConfig,
                 phase: int, n_iters: int, use_nbr: bool,
                 gen: Generators, inject: bool = False,
                 view_start: int = 0, view_chunk: int = 0,
                 exchange: Optional[HaloExchange] = None) -> SceneState:
    """``n_iters`` sweeps on every view.  Neighbour depth/normal snapshots
    are taken once at entry.  Within a full-sampling call all but the last
    inner sweep may use the coarse explore sampling (see
    ``explore_until_last``).  With ``inject`` (set by the caller at the
    last external iteration when cross-scale maps are attached) the last
    inner sweep scores the upsampled previous-stage hypothesis with a 0.1
    bonus (ref: restore/libs/MVS/DepthMap.cpp:1527-1549).  ``gen`` is
    one generator, drawn from in view order, or a per-view list
    (``view_generators``).

    ``view_chunk`` > 0 sweeps only views ``[view_start, min(view_start +
    view_chunk, N))`` against the full-scene snapshot ``state``, and
    returns the other views as they were: a short last chunk sweeps its
    own views, each once.  (The JAX package's unclamped index writes the
    wrong contexts over the last views there; see ROADMAP.)

    ``exchange`` (the tile axis, ``dense.bands``): sweep this process's
    row bands of each view (``exchange.group[exchange.me]``) one after
    another, each half-sweep followed by the exchange, and return those
    bands' own rows swept, the other rows as they were (the caller puts
    the bands together).  Each band draws from a copy of its view's
    generator, which ends where a whole view's sweep would leave it."""
    inject = inject and scene.inject_depth is not None
    offsets = S.patch_offsets(cfg)
    prop_offsets = propagation_offsets(cfg)
    split = bool(cfg.explore_until_last and cfg.explore_patch_step
                 and cfg.patch_step != cfg.explore_patch_step
                 and n_iters > 1)
    cfg_x = (cfg.replace(patch_step=cfg.explore_patch_step) if split
             else cfg)
    offsets_x = S.patch_offsets(cfg_x)
    depth0, normal0 = state.depth, state.normal
    n_views, h, w = state.depth.shape
    use_rect = (use_nbr and bool(cfg.use_geo_consistency or cfg.view_spread)
                and S.use_rect_backend(cfg, h, w))
    parities = (0,) if cfg.sweep_mode == "jacobi" else (0, 1)
    if view_chunk:
        if not 0 <= view_start < n_views:
            raise ValueError(f"view_start {view_start} outside the scene's "
                             f"{n_views} views")
        views = range(view_start, min(view_start + view_chunk, n_views))
    else:
        views = range(n_views)
    own = ([Band(0, h, 0, h, h)] if exchange is None else
           [exchange.bands[b] for b in exchange.group[exchange.me]])

    depth, normal, cost = (list(torch.unbind(x)) for x in
                           (state.depth, state.normal, state.cost))
    for i in views:
        if use_nbr:
            nbr_depth = depth0[scene.nbr_idx[i]]
            nbr_normal = normal0[scene.nbr_idx[i]]
        else:
            nbr_depth = nbr_normal = None
        # warp the frozen neighbour snapshot into the per-pair rect
        # frames once per call, for the whole view (its frame fits the
        # whole image's corners)
        rect = (build_rect_context(make_view_geometry(
            scene.cams[i], scene.cams[scene.nbr_idx[i]]),
            pack_depth_normals(nbr_depth, nbr_normal)) if use_rect else None)
        stats_x = (S.ref_patch_stats(scene.gray[i], S.halfwin_map(
            sobel_magnitude(scene.gray[i]), cfg), offsets_x)
            if split else None)
        ctxs, ctxs_x = [], []
        for b in own:
            ctx = (None if b.empty else _per_view_context(
                scene, i, nbr_depth, nbr_normal, cfg, b))
            if rect is not None and ctx is not None:
                ctx = dataclasses.replace(ctx, rect=rect_rows(rect, b.lo,
                                                              b.hi))
            ctxs.append(ctx)
            ctxs_x.append(dataclasses.replace(ctx, stats=_stats_rows(
                stats_x, b.lo, b.hi)) if split and ctx is not None else ctx)
        del rect, stats_x
        g0 = _gen_of(gen, i)
        gens = [g0] if len(own) == 1 else [_clone_generator(g0)
                                           for _ in own]
        wins = [PatchMatchState(depth=b.window(depth[i]),
                                normal=b.window(normal[i]),
                                cost=b.window(cost[i])) for b in own]
        dmax = (None if exchange is None else c2p_max(
            depth[i], normal[i], pixel_rays(scene.cams[i].K_inv, h, w)))
        steps = ([(cfg_x, ctxs_x, offsets_x, False)] * (n_iters - 1)
                 + [(cfg, ctxs, offsets, inject)])
        for c_, ctxs_, off_, inj in steps:
            for parity in parities:
                wins = [win if ctx is None else half_sweep(
                    win, ctx, c_, phase, parity, off_, prop_offsets, g,
                    inject=inj, delta_c2pmax=dmax)
                    for win, ctx, g in zip(wins, ctxs_, gens)]
                if exchange is not None:
                    wins, dmax = exchange(wins, [
                        None if b.empty else c2p_max(
                            b.own(win.depth), b.own(win.normal),
                            b.own(ctx.rays))
                        for b, win, ctx in zip(own, wins, ctxs_)])
        if exchange is None:
            depth[i], normal[i], cost[i] = (wins[0].depth, wins[0].normal,
                                            wins[0].cost)
        else:
            depth[i], normal[i], cost[i] = (x.clone() for x in
                                            (depth[i], normal[i], cost[i]))
            for b, win in zip(own, wins):
                depth[i][b.start:b.stop] = b.own(win.depth)
                normal[i][:, b.start:b.stop] = b.own(win.normal)
                cost[i][b.start:b.stop] = b.own(win.cost)
            swept = [g for b, g in zip(own, gens) if not b.empty]
            if len(gens) > 1 and swept:
                g0.set_state(swept[0].get_state())
        # a streamed view's tables go before the next view's are built
        del ctxs, ctxs_x, wins
    return SceneState(depth=torch.stack(depth), normal=torch.stack(normal),
                      cost=torch.stack(cost))


def sweep_in_chunks(state: SceneState, scene: SceneTensors,
                    cfg: DenseConfig, phase: int, n_iters: int,
                    use_nbr: bool, gen: Generators, view_chunk: int,
                    inject: bool = False) -> SceneState:
    """``scene_sweeps`` over the scene in chunks of ``view_chunk`` views
    (the last one may be short), each against the same entry snapshot
    ``state``, the swept views merged: the maps of one unchunked call, in
    calls of bounded length."""
    n = state.depth.shape[0]
    depth, normal, cost = state.depth, state.normal, state.cost
    for start in range(0, n, view_chunk):
        part = scene_sweeps(state, scene, cfg, phase, n_iters, use_nbr, gen,
                            inject=inject, view_start=start,
                            view_chunk=view_chunk)
        sl = slice(start, min(start + view_chunk, n))
        depth = torch.cat([depth[:sl.start], part.depth[sl],
                           depth[sl.stop:]])
        normal = torch.cat([normal[:sl.start], part.normal[sl],
                            normal[sl.stop:]])
        cost = torch.cat([cost[:sl.start], part.cost[sl], cost[sl.stop:]])
    return SceneState(depth=depth, normal=normal, cost=cost)


def init_scene_state(gen: Generators, scene: SceneTensors
                     ) -> SceneState:
    """Random init of every view, optionally seeded by sparse depths;
    ``gen`` as in ``scene_sweeps``."""
    n, h, w = scene.gray.shape
    sts = []
    for i in range(n):
        rays = pixel_rays(scene.cams[i].K_inv, h, w)
        st = init_state(_gen_of(gen, i), rays, scene.d_min[i],
                        scene.d_max[i])
        if scene.seed_depth is not None:
            seed = scene.seed_depth[i]
            st = dataclasses.replace(
                st, depth=torch.where(seed > 0, seed, st.depth))
        sts.append(st)
    return SceneState(depth=torch.stack([s.depth for s in sts]),
                      normal=torch.stack([s.normal for s in sts]),
                      cost=torch.stack([s.cost for s in sts]))


def _build_scene_volumes(scene: SceneTensors, cfg: DenseConfig,
                         views: Optional[range] = None,
                         row_range: Optional[Tuple[int, int]] = None
                         ) -> VolumeTables:
    """The tables of every view (of ``views``, a block of them, if
    given), by the build ``cfg`` routes to, stacked to (N, V, ...);
    ``row_range``: of those image rows alone (a row band's window)."""
    outs = []
    for i in (range(scene.gray.shape[0]) if views is None else views):
        nbr = scene.nbr_idx[i]
        geom = make_view_geometry(scene.cams[i], scene.cams[nbr])
        outs.append(build_tables(geom, scene.gray[nbr], scene.d_min[i],
                                 scene.d_max[i], cfg, row_range))
    return VolumeTables(*(torch.stack(xs) for xs in zip(*outs)))


def attach_volumes(scene: SceneTensors, cfg: DenseConfig) -> SceneTensors:
    """Build the exact-scoring sigma tables (once per stage: they depend
    only on images, geometry and depth range); none for "warped" or
    direct scoring, which never read them, and none with
    ``volume_streaming``, which builds each view's inside its sweep."""
    if (scene.vols is not None or not S.use_volume_tables(cfg)
            or cfg.volume_streaming):
        return scene
    return dataclasses.replace(scene, vols=_build_scene_volumes(scene, cfg))


def phase_cfg(cfg: DenseConfig, phase: int,
              is_final: bool = False) -> DenseConfig:
    """Every external iteration except the final one uses the coarse
    patch sampling (cfg.explore_patch_step)."""
    del phase
    if not is_final and cfg.explore_patch_step:
        return cfg.replace(patch_step=cfg.explore_patch_step)
    return cfg


def estimate_scene(gen: Generators, scene: SceneTensors,
                   cfg: DenseConfig, verbose: bool = False,
                   init: Optional[SceneState] = None,
                   replace_prior: bool = False) -> SceneState:
    """Full multi-view estimation with the HC-MVS external schedule.

    ``gen`` drives the random init and refinement (on the scene's
    device): one generator, or one a view (``view_generators``); ``init``
    replaces the random init.  The planar-prior pass
    (``want_prior_pass``) runs before external iteration max(n - 2, 1)
    when no prior is attached; with ``replace_prior`` (a hierarchy
    stage's schedule, as the JAX package's ``_run_stage``) it runs even
    then, and its maps replace the attached (cross-scale) prior.  The
    stages are timed into ``utils.profiling``'s report (device
    synchronised at each end): ``estimate.tables``,
    ``estimate.sweeps.ext{i}.phase{p}`` per external iteration,
    ``estimate.optimize.ext{i}`` per filter pass, and the prior pass as
    ``estimate.priors`` (``stage.priors`` with ``replace_prior``).
    """
    cfg = window_cfg_for_width(cfg, scene.gray.shape[2])
    n_ext = cfg.estimation_iters_external
    dev = scene.gray.device
    state = init if init is not None else init_scene_state(gen, scene)
    with stage_timer("estimate.tables", block_on=dev):
        scene = attach_volumes(scene, cfg)
    for it_ext in range(n_ext):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        # the planar priors, computed one iteration before the last, feed
        # the final sweeps (ref: GenerateDepthPrior at it_external == n-2,
        # SceneDensify.cpp:983-1031); an external channel alone also
        # starts the pass (GenerateFinalPrior, :1079-1161)
        if (want_prior_pass(scene, cfg) and it_ext == max(n_ext - 2, 1)
                and (replace_prior or scene.prior_depth is None)):
            with stage_timer("stage.priors" if replace_prior
                             else "estimate.priors", block_on=dev):
                scene = compute_scene_priors(
                    state, dataclasses.replace(scene, prior_depth=None),
                    cfg=cfg, with_super=cfg.use_semantic and (
                        scene.semantic is not None
                        or bool(cfg.self_priors)))
        inject = (bool(cfg.cross_scale_inject) and it_ext == n_ext - 1
                  and scene.inject_depth is not None)
        with stage_timer(f"estimate.sweeps.ext{it_ext}.phase{phase}",
                         block_on=dev):
            state = scene_sweeps(state, scene,
                                 phase_cfg(cfg, phase, it_ext == n_ext - 1),
                                 phase, cfg.estimation_iters, phase >= 1,
                                 gen, inject=inject)
        if cfg.optimize and it_ext in (1, 2):
            with stage_timer(f"estimate.optimize.ext{it_ext}", block_on=dev):
                state = optimize_maps(state, scene, cfg)
        if verbose:
            print(f"[dense] it_ext={it_ext} phase={phase} "
                  f"mean_cost={float(state.cost.mean()):.4f}")
    return state


def prior_generator(view: int, device) -> torch.Generator:
    """View ``view``'s generator of the prior pass's RANSAC draws, seeded
    from (7, view) alone (7: the JAX package's ``PRNGKey(7)``)."""
    seed = np.random.SeedSequence([7, view]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(seed[0]) & (2 ** 63 - 1))


def _priors_batched(gray: torch.Tensor, depth: torch.Tensor,
                    semantic: Optional[torch.Tensor], n_semantic: int,
                    cfg: Optional[DenseConfig] = None,
                    draws: Optional[list] = None,
                    views: Optional[range] = None) -> torch.Tensor:
    """``generate_priors`` of every view (of ``views`` if given): (N, H, W)
    prior depths, one row a view.  The
    RANSAC draws of view i come from ``prior_generator(i)`` unless
    ``draws`` gives each view's (anchor, offsets).  The fransac* knobs of
    ``cfg`` set every prior-plane threshold (ref: DensifyPointCloud.cpp:
    195-198 -> SceneDensify.cpp:1350-1375)."""
    kw = {}
    if cfg is not None:
        kw = dict(epsilon_mul=cfg.ransac_epsilon_mul,
                  min_points_div=cfg.ransac_min_points_div,
                  probability=cfg.ransac_probability)
    n, h, w = gray.shape
    outs = []
    for i in (range(n) if views is None else views):
        view_draws = None
        if semantic is not None:
            view_draws = (draws[i] if draws is not None else ransac_draws(
                prior_generator(i, gray.device), h, w,
                hyps_from_probability(kw.get("probability", 0.005))))
        outs.append(generate_priors(
            gray[i], depth[i],
            semantic=None if semantic is None else semantic[i],
            n_semantic_labels=n_semantic if semantic is not None else 0,
            draws=view_draws, **kw))
    return torch.stack(outs)


def compute_scene_priors(state: SceneState, scene: SceneTensors,
                         with_super: bool = True,
                         cfg: Optional[DenseConfig] = None,
                         draws: Optional[list] = None,
                         views: Optional[range] = None) -> SceneTensors:
    """The scene with per-view planar-prior depth maps attached as
    ``prior_depth`` (with RANSAC planes per mask region where masks are
    attached: nUseSemantic).  An external channel (``ext_prior_depth``,
    the --priors-dir maps) merges in per pixel as GenerateFinalPrior
    merges it: external wins where nonzero, the superpixel/semantic prior
    fills the rest (ref: SceneDensify.cpp:1079-1161).
    ``with_super=False`` skips the superpixel pass and attaches the
    external channel alone.  ``draws``: see ``_priors_batched``.
    ``views``: compute the priors of these views only (a process's block
    under the view axis) and attach them as a (len(views), H, W) block;
    the caller gathers the blocks."""
    ext = scene.ext_prior_depth
    if ext is not None and views is not None:
        ext = ext[views.start:views.stop]
    if with_super:
        n_sem = (int(scene.semantic.max()) + 1
                 if scene.semantic is not None else 0)
        priors = _priors_batched(scene.gray, state.depth, scene.semantic,
                                 n_sem, cfg, draws, views)
        if ext is not None:
            priors = merge_final_prior(ext, priors)
    else:
        priors = ext
    return dataclasses.replace(scene, prior_depth=priors)


def optimize_maps(state: SceneState, scene: SceneTensors,
                  cfg: DenseConfig,
                  views: Optional[range] = None) -> SceneState:
    """Mid-schedule filter: cross-view consistency and the two
    GapInterpolation phases (ref: EVT_OPTIMIZEDEPTHMAP at it_ext in
    {1, 2}, SceneDensify.cpp:3929-3958): row/column interpolation of the
    fused maps (:2295-2785), gradient-guided re-propagation over the
    remaining holes (:2791-2983), then the copy-back of valid fused pixels
    (:2988-2998).  Unfilled pixels keep their hypothesis so PatchMatch can
    re-score them.  ``views``: filter only these views (a process's block
    under the view axis), against all views' maps; the others come back
    as they were."""
    conf = torch.clamp_min(1.0 - state.cost, 0.01)
    views = range(state.depth.shape[0]) if views is None else views
    filt, fused, _ = cross_view_filter(
        state.depth, state.normal, conf, scene.cams, scene.nbr_idx,
        scene.nbr_valid, cfg, views)
    depth_fuse = torch.where(filt > 0, fused, 0.0)
    h, w = depth_fuse.shape[1:]
    outs = []
    for k, i in enumerate(views):
        gra = sobel_magnitude(scene.gray[i])
        d, c, nrm = gap_interpolate(depth_fuse[k], conf[i], cfg, gra=gra,
                                    normal=state.normal[i])
        rays = pixel_rays(scene.cams[i].K_inv, h, w)
        outs.append(gap_repropagate(d, nrm, state.depth[i], state.normal[i],
                                    c, gra, rays, cfg))
    sl = slice(views.start, views.stop)
    depth2 = torch.stack([o[0] for o in outs])
    normal2 = torch.stack([o[1] for o in outs])
    # copy-back: valid fused pixels win; holes revert to the hypothesis
    depth = state.depth.clone()
    normal = state.normal.clone()
    depth[sl] = torch.where(depth2 > 0, depth2, state.depth[sl])
    normal[sl] = torch.where((depth2 > 0)[:, None], normal2,
                             state.normal[sl])
    return SceneState(depth=depth, normal=normal, cost=state.cost)


def finalize(state: SceneState, cfg: DenseConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold on the final cost (ref: EndDepthMapTmp,
    SceneDensify.cpp:688-744): returns (depth, normal, conf)."""
    keep = state.cost <= cfg.ncc_threshold_keep
    depth = torch.where(keep, state.depth, 0.0)
    conf = torch.where(keep, torch.clamp_min(1.0 - state.cost, 0.0), 0.0)
    return depth, state.normal, conf


def splat_sparse_depths(points: np.ndarray, view_counts: np.ndarray,
                        view_ids: np.ndarray, cams_np: list,
                        n_images: int, h: int, w: int,
                        radius: int = 1) -> np.ndarray:
    """Host-side (numpy): project sparse points into each view and splat
    their depths into (N, H, W) seed maps (0 elsewhere); the first point
    to reach a pixel keeps it."""
    seed = np.zeros((n_images, h, w), np.float32)
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        for i in ids:
            K, R, C = cams_np[i]
            Xc = R @ (points[p] - C)
            if Xc[2] <= 0:
                continue
            uv = K @ Xc
            x = int(round(uv[0] / uv[2]))
            y = int(round(uv[1] / uv[2]))
            if 0 <= x < w and 0 <= y < h:
                y0, y1 = max(0, y - radius), min(h, y + radius + 1)
                x0, x1 = max(0, x - radius), min(w, x + radius + 1)
                region = seed[i, y0:y1, x0:x1]
                region[region == 0] = Xc[2]
    return seed
