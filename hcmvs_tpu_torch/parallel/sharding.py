"""The view axis of the dense stage and sharded bundle adjustment
(PyTorch port of ``hcmvs_tpu/parallel/sharding.py``).

The reference has no distributed backend: pthread pools inside a process
and files between stages (SURVEY §2.4, run.sh).  The JAX package lays the
scene over a (view, tile) mesh and lets GSPMD insert the collectives.
Here the same schedule runs on every process of a ``torch.distributed``
group, each sweeping its own block of views:

- ``view`` axis: the scene's views split into contiguous blocks, one a
  process, as JAX lays out a sharded leading axis (ceil(N / n) views a
  block, the last one shorter).  A process sweeps, filters, computes the
  priors of and fuses its own views against maps of all views, then an
  all-gather (``distributed.fetch``) makes the maps whole on
  every process before the next step reads them.  Each view's work
  depends only on the snapshot it reads and its own generator
  (``scene_driver.view_generators``), and no sum crosses views, so the
  sharded maps are bit-equal to one process's.
- ``tile`` axis (image rows split over processes, halo exchanges after
  each half-sweep): not ported; ``make_device_mesh(n_tile > 1)`` raises.

``make_device_mesh(n_view)`` may give a process several view shards (the
counterpart of the JAX package's several devices a process): they are
swept one after another, and the process's block is their union.

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
from hcmvs_tpu_torch.dense.scene_driver import SceneState, SceneTensors
from hcmvs_tpu_torch.parallel import distributed as D
from hcmvs_tpu_torch.sfm import ba

TILE_AXIS_ITEM = ("ROADMAP.md, Queue 1: the tile axis (row bands of every "
                  "per-pixel field, a halo exchange after each half-sweep, "
                  "the rect build's rows cut by band)")


@dataclasses.dataclass
class ViewMesh:
    """A (view, tile) mesh: ``n_view`` view shards over the ``world``
    processes of the group (``n_view // world`` consecutive shards a
    process), this process ``rank`` on ``device``."""

    n_view: int
    n_tile: int
    rank: int
    world: int
    device: torch.device
    device_mesh: Optional[object] = None    # torch's DeviceMesh, if any

    def blocks(self, n: int) -> List[range]:
        """Each process's contiguous block of ``n`` items (views,
        points): the union of its shards, ceil(n / n_view) items a
        shard, the last ones shorter."""
        per = -(-n // self.n_view)
        per_proc = self.n_view // self.world
        return [range(min(p * per_proc * per, n),
                      min((p + 1) * per_proc * per, n))
                for p in range(self.world)]

    def own(self, n: int) -> range:
        return self.blocks(n)[self.rank]


def make_device_mesh(n_view: Optional[int] = None, n_tile: int = 1,
                     device=None) -> ViewMesh:
    """The (view, tile) mesh of ``n_view`` view shards over this process
    group (one process without a group); ``n_view`` defaults to the
    group's size and must be a multiple of it.  ``n_tile`` > 1 raises
    NotImplementedError: the tile axis is not ported."""
    if n_tile != 1:
        raise NotImplementedError(
            f"n_tile={n_tile}: the tile axis is not ported ({TILE_AXIS_ITEM})")
    rank, world = D.world()
    n_view = world if n_view is None else n_view
    if n_view < 1 or n_view % world:
        raise ValueError(f"{n_view} view shards over {world} processes: "
                         f"need a positive multiple")
    device = torch.device(device if device is not None else "cpu")
    return ViewMesh(n_view=n_view, n_tile=n_tile, rank=rank, world=world,
                    device=device)


def scene_shardings(mesh: ViewMesh, n_views: int) -> List[range]:
    """Which views each process owns: contiguous blocks, in process
    order, as the JAX package's view axis lays out (N, ...) arrays."""
    return mesh.blocks(n_views)


def shard_scene(scene: SceneTensors, state: SceneState, mesh: ViewMesh,
                cfg: Optional[DenseConfig] = None
                ) -> Tuple[SceneTensors, SceneState]:
    """This process's part of a scene.  Every view's image and camera
    stay (a sweep reads its neighbours' images; the JAX package's GSPMD
    gathers them), and so do the small per-view fields the sweeps index by
    view (neighbour lists, depth ranges, seeds); the sigma tables, a
    view's large field, are built here for this process's views only
    (``cfg`` routes the build; none without ``cfg``, with streaming, or
    for a route that reads no tables).  The state is the whole entry
    snapshot, the same on every process."""
    if cfg is not None and scene.vols is None:
        own = mesh.own(scene.gray.shape[0])
        if (SD.S.use_volume_tables(cfg) and not cfg.volume_streaming
                and len(own)):
            scene = dataclasses.replace(
                scene, vols=SD._build_scene_volumes(scene, cfg, own),
                vols_first=own.start)
    return scene, state


def gather_state(state: SceneState, mesh: ViewMesh) -> SceneState:
    """The maps of every process's own views, made whole (depth, normal
    and cost all-gathered in view order)."""
    blocks = mesh.blocks(state.depth.shape[0])
    own = blocks[mesh.rank]

    def whole(x):
        return D.fetch(x[own.start:own.stop], blocks)

    return SceneState(depth=whole(state.depth), normal=whole(state.normal),
                      cost=whole(state.cost))


def scene_sweeps(state: SceneState, scene: SceneTensors, cfg: DenseConfig,
                 phase: int, n_iters: int, use_nbr: bool,
                 gen: SD.Generators, mesh: ViewMesh, inject: bool = False,
                 view_chunk: int = 0) -> SceneState:
    """``scene_driver.scene_sweeps`` over this process's views (in chunks
    of ``view_chunk`` if given), against the whole entry snapshot, then
    the maps gathered.  ``gen`` must be a per-view list (a shared
    generator would draw in another order on each process)."""
    if isinstance(gen, torch.Generator):
        raise ValueError("the view axis needs one generator a view "
                         "(scene_driver.view_generators)")
    own = mesh.own(state.depth.shape[0])
    chunk = view_chunk or max(len(own), 1)
    out = state
    for start in range(own.start, own.stop, chunk):
        part = SD.scene_sweeps(state, scene, cfg, phase, n_iters, use_nbr,
                               gen, inject=inject, view_start=start,
                               view_chunk=min(chunk, own.stop - start))
        out = _merge(out, part, range(start, min(start + chunk, own.stop)))
    return gather_state(out, mesh)


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

