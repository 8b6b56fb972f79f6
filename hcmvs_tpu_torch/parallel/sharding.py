"""The (view, tile) mesh of the dense stage and sharded bundle
adjustment (PyTorch port of ``hcmvs_tpu/parallel/sharding.py``).

The reference has no distributed backend: pthread pools inside a process
and files between stages (SURVEY §2.4, run.sh).  The JAX package lays the
scene over a (view, tile) mesh and lets GSPMD insert the collectives.
Here the same schedule runs on every process of a ``torch.distributed``
group.  The mesh has ``n_view * n_tile`` shards, laid out view-major in
process order as the JAX package's ``global_mesh``: shard s is row band
s % n_tile of view block s // n_tile.

- ``view`` axis: the scene's views split into ``n_view`` contiguous
  blocks, as JAX lays out a sharded leading axis (ceil(N / n_view) views
  a block, the last one shorter).  The sweeps of a block's views read
  the whole entry snapshot; then an all-gather (``distributed.fetch``)
  makes the maps whole on every process before the next step reads
  them.  Each view's work depends only on the snapshot it reads and its
  own generator (``scene_driver.view_generators``), and no sum crosses
  views, so the sharded maps are bit-equal to one process's.
- ``tile`` axis: every view's pixel rows split into ``n_tile`` bands of
  whole 8-row tile rows (``dense.bands``: ceil(tile rows / n_tile) a
  band; more bands than tile rows raise ValueError).  A band's sweep
  holds its rows and a halo of ``bands.halo_rows`` rows either side
  (the propagation radius, +-5 rows at ``DenseConfig()``, plus the patch
  radius, +-7, which the table routes' index fields and the warped
  route's padded sources reach; the smoothness terms reach +-2; rounded
  up to whole tile rows); its tables are built for those rows alone
  (kernel A on their tiles; the rect setup and the rect engine's fields
  are the whole view's, cut).  After every half-sweep the bands' edge
  rows of depth and normal, and each band's max of the local-smoothness
  scale ``delta_c2pmax`` (a max over the whole view, exact under any
  split), are all-gathered inside the tile group (``parallel.halo``);
  after the last one the bands are put together, then the view axis's
  all-gather runs.  A band's draws are the whole view's, cut, so the
  maps are bit-equal to one process's here too.
- The steps outside the sweeps (``optimize_maps``: gap fills along whole
  rows and columns; the priors: superpixels and RANSAC per view;
  fusion) and bundle adjustment run on the mesh flattened to
  ``n_view * n_tile`` view shards (``blocks``), as the JAX package's
  ``P(("view", "tile"))``: no new collective.

A process may hold several shards (the counterpart of the JAX package's
several devices a process): a process's shards are a run of whole tile
groups (all bands of some view blocks) or a run of bands of one block;
it sweeps its bands one after another with the halo exchange in memory.

Bundle adjustment (``shard_ba``, ``run_ba``): points are split into
contiguous blocks over the processes, each observation goes with its
point; the point blocks stay local, the camera-side sums are partial per
process and summed in rank order (``distributed.sum_in_rank_order``), and
every process solves the same (C, 6, 6) camera system: the distributed
Schur complement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import fusion
from hcmvs_tpu_torch.dense import scene_driver as SD
from hcmvs_tpu_torch.dense.bands import (Band, HaloExchange, halo_rows,
                                         row_bands)
from hcmvs_tpu_torch.dense.scene_driver import SceneState, SceneTensors
from hcmvs_tpu_torch.parallel import distributed as D
from hcmvs_tpu_torch.sfm import ba
from hcmvs_tpu_torch.utils.profiling import stage_timer

@dataclasses.dataclass
class ViewMesh:
    """A (view, tile) mesh: ``n_view * n_tile`` shards over the ``world``
    processes of the group (``n_view * n_tile // world`` consecutive
    shards a process), this process ``rank`` on ``device``;
    ``tile_group`` is the process group of this process's tile group
    when it spans several processes."""

    n_view: int
    n_tile: int
    rank: int
    world: int
    device: torch.device
    device_mesh: Optional[object] = None    # torch's DeviceMesh, if any
    tile_group: Optional[object] = None

    @property
    def shards_per_process(self) -> int:
        return self.n_view * self.n_tile // self.world

    @property
    def tile_procs(self) -> int:
        """The processes of a tile group (one view block's bands)."""
        return max(1, self.n_tile // self.shards_per_process)

    def blocks(self, n: int) -> List[range]:
        """Each process's contiguous block of ``n`` items (views, points)
        on the mesh flattened to ``n_view * n_tile`` shards: the union of
        its shards, ceil(n / shards) items a shard, the last ones
        shorter (the view axis's blocks when ``n_tile`` is 1)."""
        per = -(-n // (self.n_view * self.n_tile))
        per_proc = self.shards_per_process
        return [range(min(p * per_proc * per, n),
                      min((p + 1) * per_proc * per, n))
                for p in range(self.world)]

    def own(self, n: int) -> range:
        return self.blocks(n)[self.rank]

    def sweep_views(self, n: int, rank: Optional[int] = None) -> range:
        """The views process ``rank`` (this one by default) sweeps: the
        union of the view blocks of its shards (ceil(n / n_view) views a
        block)."""
        rank = self.rank if rank is None else rank
        per = -(-n // self.n_view)
        spp = self.shards_per_process
        first = rank * spp // self.n_tile
        last = ((rank + 1) * spp - 1) // self.n_tile
        return range(min(first * per, n), min((last + 1) * per, n))

    def sweep_blocks(self, n: int) -> List[range]:
        """Each process's part in putting the swept views together: its
        ``sweep_views`` if it is the first process of its tile group,
        else none."""
        out = []
        for p in range(self.world):
            v = self.sweep_views(n, p)
            out.append(v if p % self.tile_procs == 0
                       else range(v.stop, v.stop))
        return out

    def tile_bands(self, rank: Optional[int] = None) -> List[int]:
        """The row bands process ``rank`` sweeps of each of its views."""
        rank = self.rank if rank is None else rank
        spp = self.shards_per_process
        if spp >= self.n_tile:
            return list(range(self.n_tile))
        return [s % self.n_tile for s in range(rank * spp, (rank + 1) * spp)]

    def tile_peers(self) -> List[int]:
        """The processes of this process's tile group, in process order."""
        first = self.rank - self.rank % self.tile_procs
        return list(range(first, first + self.tile_procs))


def make_device_mesh(n_view: Optional[int] = None, n_tile: int = 1,
                     device=None) -> ViewMesh:
    """The (view, tile) mesh of ``n_view * n_tile`` shards over this
    process group (one process without a group); ``n_view`` defaults to
    the group's size over ``n_tile``.  The shards must split evenly over
    the processes, and a process's shards must be whole tile groups or
    bands of one view block (``n_tile`` a multiple of the shards a
    process, or the other way round); else ValueError."""
    rank, world = D.world()
    if n_tile < 1:
        raise ValueError(f"n_tile={n_tile}: need at least one band")
    n_view = max(world // n_tile, 1) if n_view is None else n_view
    shards = n_view * n_tile
    if n_view < 1 or shards % world:
        raise ValueError(f"{n_view} x {n_tile} shards over {world} "
                         f"processes: need a positive multiple")
    spp = shards // world
    if spp % n_tile and n_tile % spp:
        raise ValueError(f"{spp} shards a process split the {n_tile} bands "
                         f"of a view block unevenly")
    device = torch.device(device if device is not None else "cpu")
    return ViewMesh(n_view=n_view, n_tile=n_tile, rank=rank, world=world,
                    device=device)


def scene_shardings(mesh: ViewMesh, n_views: int) -> List[range]:
    """Which views each process owns on the flattened mesh: contiguous
    blocks, in process order, as the JAX package lays out (N, ...)
    arrays over ("view", "tile")."""
    return mesh.blocks(n_views)


def scene_bands(mesh: ViewMesh, h: int, cfg: DenseConfig) -> List[Band]:
    """The row bands of an ``h``-row view under ``mesh`` and ``cfg``'s
    stencils."""
    return row_bands(h, mesh.n_tile, halo_rows(cfg))


def shard_scene(scene: SceneTensors, state: SceneState, mesh: ViewMesh,
                cfg: Optional[DenseConfig] = None
                ) -> Tuple[SceneTensors, SceneState]:
    """This process's part of a scene.  Every view's image and camera
    stay (a sweep reads its neighbours' images; the JAX package's GSPMD
    gathers them), and so do the small per-view fields the sweeps index by
    view (neighbour lists, depth ranges, seeds); the sigma tables, a
    view's large field, are built here for the views this process sweeps
    only, and under the tile axis for the rows of its bands' windows
    only, once (``vols_rows``; a band's sweep cuts its window's from
    them; ``cfg`` routes the build; none without ``cfg``, with
    streaming, or for a route that reads no tables).  The state is the
    whole entry snapshot, the same on every process."""
    if (cfg is None or scene.vols is not None
            or not SD.S.use_volume_tables(cfg) or cfg.volume_streaming):
        return scene, state
    n, h = scene.gray.shape[:2]
    views = mesh.sweep_views(n)
    every = scene_bands(mesh, h, cfg)
    bands = [every[b] for b in mesh.tile_bands() if not every[b].empty]
    if not len(views) or not bands:
        return scene, state
    span = (min(b.lo for b in bands), max(b.hi for b in bands))
    return dataclasses.replace(
        scene, vols=SD._build_scene_volumes(
            scene, cfg, views, None if span == (0, h) else span),
        vols_first=views.start, vols_rows=span), state


def gather_state(state: SceneState, mesh: ViewMesh,
                 blocks: Optional[List[range]] = None) -> SceneState:
    """The maps of every process's own views (``blocks``, by default the
    flattened mesh's), made whole (depth, normal and cost all-gathered
    in view order)."""
    blocks = mesh.blocks(state.depth.shape[0]) if blocks is None else blocks
    own = blocks[mesh.rank]

    def whole(x):
        return D.fetch(x[own.start:own.stop], blocks)

    return SceneState(depth=whole(state.depth), normal=whole(state.normal),
                      cost=whole(state.cost))


def scene_sweeps(state: SceneState, scene: SceneTensors, cfg: DenseConfig,
                 phase: int, n_iters: int, use_nbr: bool,
                 gen: SD.Generators, mesh: ViewMesh, inject: bool = False,
                 view_chunk: int = 0) -> SceneState:
    """``scene_driver.scene_sweeps`` over the views this process sweeps
    (in chunks of ``view_chunk`` if given), against the whole entry
    snapshot, then the maps gathered.  Under the tile axis it sweeps its
    bands of each of those views, with the halo exchange, and the bands
    are put together inside the tile group before the views are
    gathered.  ``gen`` must be a per-view list (a shared generator would
    draw in another order on each process)."""
    if isinstance(gen, torch.Generator):
        raise ValueError("the view axis needs one generator a view "
                         "(scene_driver.view_generators)")
    n, h = state.depth.shape[:2]
    own = mesh.sweep_views(n)
    bands = scene_bands(mesh, h, cfg)
    exchange = (_halo_exchange(mesh, bands, cfg) if mesh.n_tile > 1
                else None)
    chunk = view_chunk or max(len(own), 1)
    out = state
    for start in range(own.start, own.stop, chunk):
        part = SD.scene_sweeps(state, scene, cfg, phase, n_iters, use_nbr,
                               gen, inject=inject, view_start=start,
                               view_chunk=min(chunk, own.stop - start),
                               exchange=exchange)
        out = _merge(out, part, range(start, min(start + chunk, own.stop)))
    out = _gather_bands(out, mesh, own, bands)
    return gather_state(out, mesh, mesh.sweep_blocks(n))


def _halo_exchange(mesh: ViewMesh, bands: List[Band],
                   cfg: DenseConfig) -> HaloExchange:
    """The halo exchange of this process's bands: in memory when its
    tile group is its own, else an all-gather in the tile group."""
    if mesh.tile_procs == 1:
        return HaloExchange(bands, halo_rows(cfg), [mesh.tile_bands()])
    peers = mesh.tile_peers()
    return HaloExchange(
        bands, halo_rows(cfg), [mesh.tile_bands(p) for p in peers],
        peers.index(mesh.rank),
        lambda x: D.gather_in_group(x, mesh.tile_group, len(peers)))


def _gather_bands(state: SceneState, mesh: ViewMesh, views: range,
                  bands: List[Band]) -> SceneState:
    """The swept views' maps made whole inside the tile group: each
    process's bands' rows (a contiguous run) all-gathered and put in
    place.  A no-op when this process swept every band."""
    if mesh.tile_procs == 1 or not len(views):
        return state
    peers = mesh.tile_peers()
    runs = []
    for p in peers:
        bs = [bands[b] for b in mesh.tile_bands(p)]
        runs.append((bs[0].start, bs[-1].stop))
    longest = max(r1 - r0 for r0, r1 in runs)
    sl = slice(views.start, views.stop)
    fields = torch.cat([state.depth[sl, None], state.normal[sl],
                        state.cost[sl, None]], dim=1)     # (V, 5, H, W)
    r0, r1 = runs[peers.index(mesh.rank)]
    send = torch.nn.functional.pad(fields[:, :, r0:r1],
                                   (0, 0, 0, longest - (r1 - r0)))
    with stage_timer("parallel.all_gather", block_on=send.device):
        parts = D.gather_in_group(send.contiguous(), mesh.tile_group,
                                  len(peers))
    for (a, z), part in zip(runs, parts):
        fields[:, :, a:z] = part[:, :, :z - a]
    depth, normal, cost = (x.clone() for x in
                           (state.depth, state.normal, state.cost))
    depth[sl], normal[sl], cost[sl] = fields[:, 0], fields[:, 1:4], \
        fields[:, 4]
    return SceneState(depth=depth, normal=normal, cost=cost)


def _merge(state: SceneState, part: SceneState, views: range) -> SceneState:
    sl = slice(views.start, views.stop)

    def put(a, b):
        a = a.clone()
        a[sl] = b[sl]
        return a

    return SceneState(depth=put(state.depth, part.depth),
                      normal=put(state.normal, part.normal),
                      cost=put(state.cost, part.cost))


def optimize_maps(state: SceneState, scene: SceneTensors, cfg: DenseConfig,
                  mesh: ViewMesh) -> SceneState:
    """``scene_driver.optimize_maps`` (the cross-view filter and the gap
    fills) of this process's views against every view's maps, then the
    maps gathered."""
    own = mesh.own(state.depth.shape[0])
    return gather_state(SD.optimize_maps(state, scene, cfg, own), mesh)


def compute_scene_priors(state: SceneState, scene: SceneTensors,
                         mesh: ViewMesh, with_super: bool = True,
                         cfg: Optional[DenseConfig] = None) -> SceneTensors:
    """``scene_driver.compute_scene_priors`` of this process's views, the
    prior maps gathered (each view's RANSAC draws come from its own
    ``prior_generator``)."""
    n = state.depth.shape[0]
    blocks = mesh.blocks(n)
    part = SD.compute_scene_priors(state, scene, with_super, cfg,
                                   views=blocks[mesh.rank])
    if part.prior_depth is None:
        return part
    return dataclasses.replace(part, prior_depth=D.fetch(
        part.prior_depth, blocks))


def fuse_point_cloud(depths, normals, confs, cams, nbr_idx, nbr_valid,
                     priority, cfg: DenseConfig, mesh: ViewMesh,
                     colors=None, with_colors: bool = False) -> dict:
    """``fusion.fuse_point_cloud`` of this process's views against every
    view's maps, each per-pixel field gathered in view order."""
    blocks = mesh.blocks(depths.shape[0])
    part = fusion.fuse_point_cloud(depths, normals, confs, cams, nbr_idx,
                                   nbr_valid, priority, cfg, colors,
                                   with_colors, views=blocks[mesh.rank])
    return {k: D.fetch(v, blocks) for k, v in part.items()}


# --- bundle adjustment ------------------------------------------------------

def shard_ba(problem: ba.BAProblem, state: ba.BAState, mesh: ViewMesh
             ) -> Tuple[ba.BAProblem, ba.BAState]:
    """This process's part of a BA problem: its contiguous block of points
    and every observation of them (observations are sorted by point, so
    they are a contiguous run), point ids renumbered from 0; cameras,
    intrinsics and distortion whole (the camera system is solved the same
    on every process)."""
    pts = mesh.own(state.points.shape[0])
    obs_pt = problem.obs_pt
    lo = int(torch.searchsorted(obs_pt, pts.start))
    hi = int(torch.searchsorted(obs_pt, pts.stop))
    local = ba.BAProblem(
        K=problem.K, obs_cam=problem.obs_cam[lo:hi],
        obs_pt=obs_pt[lo:hi] - pts.start, obs_uv=problem.obs_uv[lo:hi],
        obs_valid=problem.obs_valid[lo:hi], fixed_cams=problem.fixed_cams,
        dist=problem.dist)
    return local, state._replace(points=state.points[pts.start:pts.stop])


def run_ba(problem: ba.BAProblem, state: ba.BAState, mesh: ViewMesh,
           n_iters: int = 20, init_lambda: float = 1e-3,
           cg_iters: int = 0) -> Tuple[ba.BAState, float]:
    """``sfm.ba.run_ba`` on a sharded problem (``shard_ba``): the camera
    sums of every step and the cost summed over processes in rank order,
    so every process takes the same accept/reject decisions and camera
    steps.  Returns this process's state (its points) and the cost."""
    return ba.run_ba(problem, state, n_iters, init_lambda,
                     cg_iters=cg_iters, cam_reduce=D.sum_in_rank_order)


def gather_points(points: torch.Tensor, n_points: int,
                  mesh: ViewMesh) -> torch.Tensor:
    """Every process's block of BA points made whole, in point order."""
    return D.fetch(points, mesh.blocks(n_points))

