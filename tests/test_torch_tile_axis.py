"""The tile axis of the port's (view, tile) mesh on the CPU: every view's
pixel rows split into bands, a halo exchange after every half-sweep
(``hcmvs_tpu_torch.dense.bands``, ``parallel.sharding``).

- In one process, the band form of the sweeps (a photometric and a
  geometric pass) at 2 and 3 bands equals the whole view's, bit for bit,
  on every route: the direct backends, tables of 128 planes through the
  rect build, 256 through the per-plane build, the hybrid
  candidate-batched path, view spread, streamed tables and red-black
  sweeps; on tests/test_sharding.py's scene (8 views, 32x48, 2
  neighbours: 4 tile rows, so the third of 3 bands is empty) and at 44
  rows (a partial last tile row).
- One launch of 4 processes over Gloo, mesh (2 x 2), every route in the
  same processes: sweeps, filter and fusion equal to one process; the
  halo exchange moves the bands' edge rows after each half-sweep and
  nothing else (red-black sweeps double its calls, not the all-gathers).
  Sharded BA on the (2 x 2) mesh within rel 1e-3 / atol 1e-4 of one
  process.
- The JAX package's (4, 2) mesh on the same scene (rect build and
  engine): the port's (4 x 2) run in one process is bit-equal to its
  whole-view run and within 0.03 of JAX's depth accuracy (one seed; the
  random streams differ).

The two 4-process launches start in threads when the module's first test
runs, and the one-process tests run meanwhile.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JDenseConfig
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.parallel.sharding import make_device_mesh as jmesh
from hcmvs_tpu.parallel.sharding import shard_scene as jshard
from hcmvs_tpu.utils import synth as jsynth

from hcmvs_tpu_torch.core.config import DenseConfig
from hcmvs_tpu_torch.dense import bands as B
from hcmvs_tpu_torch.dense import score as S
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.entry import build_scene
from hcmvs_tpu_torch.ops import volume as vol
from hcmvs_tpu_torch.parallel import distributed as D
from hcmvs_tpu_torch.parallel import mh_check as M
from hcmvs_tpu_torch.parallel import sharding as P
from hcmvs_tpu_torch.utils import profiling

torch.set_num_threads(1)
N_VIEWS, H, W, NBR = 8, 32, 48, 2
TIMEOUT = 240
VOLUME = {"exact_backend": "volume", "geo_backend": "rect"}
# mh_check --cfg overrides of its direct base config
ROUTES = {
    "direct": {},
    "volume-rect": dict(VOLUME, volume_build="rect"),
    "planes256": dict(VOLUME, volume_planes=256),
    "hybrid-batched": dict(VOLUME, score_mode="hybrid",
                           candidate_kernel="on"),
}
ONE_PROCESS_ROUTES = dict(ROUTES, **{
    "view-spread": {"view_spread": 1},
    "streaming": dict(VOLUME, volume_streaming=True),
    "redblack": dict(VOLUME, sweep_mode="redblack"),
})
REDBLACK = {"sweep_mode": "redblack"}     # the direct route's, launched
SWEPT = range(0, 1)        # the views the one-process band sweeps cover


def _fields(st):
    return (st.depth, st.normal, st.cost)


@pytest.fixture(scope="module", autouse=True)
def launches(tmp_path_factory):
    """The module's two launches of 4 processes over Gloo, mesh (2 x 2),
    started at once: the dense schedule on every route (and red-black
    sweeps) one after another in the same processes, and sharded BA
    (tests/test_torch_parallel.py's problem).  Yields their futures."""
    from test_torch_parallel import _ba_problem
    tmp = tmp_path_factory.mktemp("tile")
    dense = ["--device", "cpu", "--n-tile", "2"]
    for over in list(ROUTES.values()) + [REDBLACK]:
        dense += ["--cfg", json.dumps(over)]
    np.savez(tmp / "ba.npz", **_ba_problem())
    ba = ["--device", "cpu", "--n-tile", "2", "--ba-problem",
          str(tmp / "ba.npz"), "--ba-iters", "5", "--ba-out",
          str(tmp / "out.npz")]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {"dense": pool.submit(M.launch, 4, dense, timeout=TIMEOUT,
                                    workdir=str(tmp)),
               "ba": pool.submit(M.launch, 4, ba, timeout=TIMEOUT,
                                 workdir=str(tmp)),
               "ba_out": tmp / "out.npz"}


@pytest.fixture(scope="module")
def scenes():
    return {h: build_scene(N_VIEWS, h, W, "cpu", n_nbr=NBR)
            for h in (H, 44)}


def _sweeps(scene, cfg, n_tile):
    """A photometric and a geometric pass over views SWEPT: whole views
    (``n_tile`` 0) or ``n_tile`` bands swept one after another with the
    exchange in memory (each band's tables cut from the whole view's)."""
    n, h = scene.gray.shape[:2]
    gens = tsd.view_generators(0, n, "cpu")
    st = tsd.init_scene_state(gens, scene)
    if S.use_volume_tables(cfg) and not cfg.volume_streaming:
        scene = dataclasses.replace(
            scene, vols=tsd._build_scene_volumes(scene, cfg, SWEPT))
    exchange = None
    if n_tile:
        bands = B.row_bands(h, n_tile, B.halo_rows(cfg))
        exchange = B.HaloExchange(bands, B.halo_rows(cfg),
                                  [list(range(n_tile))])
    for phase in (0, 1):
        st = tsd.scene_sweeps(st, scene, cfg, phase, 1, phase == 1, gens,
                              view_start=SWEPT.start, view_chunk=len(SWEPT),
                              exchange=exchange)
    return st


@pytest.mark.parametrize("route", list(ONE_PROCESS_ROUTES))
def test_band_sweeps_equal_the_whole_view(scenes, route):
    cfg = M.base_cfg("direct", ONE_PROCESS_ROUTES[route])
    cases = [(H, 2), (H, 3)]
    if route in ("direct", "hybrid-batched"):
        cases.append((44, 3))
    for h, n_tile in cases:
        whole = _sweeps(scenes[h], cfg, 0)
        profiling.reset_report()
        got = _sweeps(scenes[h], cfg, n_tile)
        for a, b in zip(_fields(got), _fields(whole)):
            assert torch.equal(a, b), (route, h, n_tile)
        # swept views changed, the others did not move
        assert not torch.equal(whole.depth[SWEPT.start],
                               tsd.init_scene_state(tsd.view_generators(
                                   0, N_VIEWS, "cpu"), scenes[h]).depth[0])
        # one exchange a half-sweep of a view: (2, 4, halo, W) edge rows
        # and a max for each band
        half = 2 if cfg.sweep_mode == "redblack" else 1
        halo = profiling.report()["parallel.halo"]
        assert halo["calls"] == 2 * half * len(SWEPT)
        assert halo["bytes"] == halo["calls"] * n_tile * 4 * (
            2 * 4 * B.halo_rows(cfg) * W + 1)


@pytest.mark.parametrize("route", ["volume-rect", "planes256"])
def test_window_tables_cut_from_a_wider_span(scenes, route):
    """A process holding several bands builds the tables of their
    windows' union once (``sharding.shard_scene``); each window's tables
    cut from them are the ones built for the window alone, at 44 rows (a
    partial last tile row)."""
    cfg = M.base_cfg("direct", ROUTES[route])
    scene, views = scenes[44], range(0, 2)
    rect = vol.use_rect_volume_build(cfg, 44, W)
    span = (8, 44)
    wide = tsd._build_scene_volumes(scene, cfg, views, span)
    for rows in ((8, 24), (16, 40), (24, 44), span):
        alone = tsd._build_scene_volumes(scene, cfg, views, rows)
        for i in views:
            cut = vol.table_rows(vol.VolumeTables(*(x[i] for x in wide)),
                                 span, rows, W, rect)
            for a, b in zip(cut, (x[i] for x in alone)):
                assert a.shape == b.shape and torch.equal(a, b), rows


def test_bands_and_the_mesh():
    bands = B.row_bands(44, 3, 8)
    assert [(b.start, b.stop, b.lo, b.hi) for b in bands] == [
        (0, 16, 0, 24), (16, 32, 8, 40), (32, 44, 24, 44)]
    assert [b.empty for b in B.row_bands(H, 3, 8)] == [False, False, True]
    with pytest.raises(ValueError, match="n_tile=5: an image of 32 rows "
                                         "has 4 tile rows"):
        B.row_bands(H, 5, 8)
    with pytest.raises(ValueError, match="tile rows"):
        P.scene_bands(P.make_device_mesh(1, 5), H, M.base_cfg("direct"))
    # the halo: propagation + patch radius on the table routes, the
    # refinement chain of the warped ones (bands module docstring)
    assert B.halo_rows(M.base_cfg("volume")) == 8
    assert B.halo_rows(M.base_cfg("volume", ROUTES["hybrid-batched"])) == 16
    assert B.halo_rows(DenseConfig()) == 8
    assert B.halo_rows(DenseConfig(score_mode="hybrid")) == 56
    # the tile axis no longer raises; view-major in process order
    mesh = P.make_device_mesh(2, n_tile=2)
    assert (mesh.n_view, mesh.n_tile, mesh.tile_procs) == (2, 2, 1)
    assert mesh.sweep_views(N_VIEWS) == range(0, 8)
    assert mesh.tile_bands() == [0, 1] and mesh.blocks(10) == [range(10)]
    one = D.global_mesh(n_tile=2, device="cpu")
    assert (one.n_view, one.n_tile, one.device_mesh) == (1, 2, None)
    # 4 processes of a (2 x 2) mesh, and 2 processes sharing each view
    # block's 4 bands
    for world, n_view, n_tile, views, bands_of, flat in (
            (4, 2, 2, [range(0, 4)] * 2 + [range(4, 8)] * 2,
             [[0], [1], [0], [1]], [0, 2, 4, 6]),
            (2, 1, 4, [range(0, 8)] * 2, [[0, 1], [2, 3]], [0, 4])):
        for r in range(world):
            m = P.ViewMesh(n_view=n_view, n_tile=n_tile, rank=r,
                           world=world, device=torch.device("cpu"))
            assert m.sweep_views(N_VIEWS) == views[r]
            assert m.tile_bands() == bands_of[r]
            assert m.own(N_VIEWS).start == flat[r]
        assert [len(b) for b in m.sweep_blocks(N_VIEWS)] == (
            [4, 0, 4, 0] if world == 4 else [8, 0])


def _accuracy(sc, depth):
    m = 3
    return float(np.mean([
        (np.abs(np.asarray(depth[i]) - gt) <= 0.02 * gt)[m:-m, m:-m].mean()
        for i, gt in enumerate(jsynth.plane_depth_of_view(sc, i)
                               for i in range(N_VIEWS))]))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 host devices "
                    "(tests/conftest.py sets them)")
def test_tile_axis_reaches_jax_mesh_accuracy(scenes):
    cfg = M.base_cfg("volume", {"volume_build": "rect"})
    scene = scenes[H]

    def port(mesh):
        gens = tsd.view_generators(0, N_VIEWS, "cpu")
        st = tsd.init_scene_state(gens, scene)
        if mesh is None:
            sc_ = tsd.attach_volumes(scene, cfg)
        else:
            sc_, _ = P.shard_scene(scene, st, mesh, cfg)
        for phase in (0, 1):
            st = (tsd.scene_sweeps(st, sc_, cfg, phase, 1, phase == 1, gens)
                  if mesh is None else
                  P.scene_sweeps(st, sc_, cfg, phase, 1, phase == 1, gens,
                                 mesh))
        return st

    banded = port(P.make_device_mesh(4, 2))
    whole = port(None)
    for a, b in zip(_fields(banded), _fields(whole)):
        assert torch.equal(a, b)

    sc = jsynth.make_plane_scene(np.random.default_rng(0), h=H, w=W,
                                 n_views=N_VIEWS)
    nbr = np.array([[j for j in range(N_VIEWS) if j != i][:NBR]
                    for i in range(N_VIEWS)], np.int32)
    jscene = jsd.SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=JCamera(K=jnp.stack([c.K for c in sc.cameras]),
                     R=jnp.stack([c.R for c in sc.cameras]),
                     C=jnp.stack([c.C for c in sc.cameras])),
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((N_VIEWS, NBR), bool),
        d_min=jnp.full((N_VIEWS,), sc.d_min, jnp.float32),
        d_max=jnp.full((N_VIEWS,), sc.d_max, jnp.float32))
    jcfg = JDenseConfig(adapt_half_window=3, patch_half_window=3,
                        patch_step=2, estimation_iters=1, random_iters=1,
                        use_optical_flow=0, use_geo_consistency=1,
                        use_part_consistency=0, geo_backend="rect",
                        volume_build="rect", exact_backend="volume")
    mesh = jmesh(n_view=4, n_tile=2)
    js, jst = jshard(jscene, jsd.init_scene_state(jax.random.PRNGKey(0),
                                                  jscene), mesh)
    with jax.set_mesh(mesh):
        jst = jsd.scene_sweeps(jst, js, jcfg, 0, 1, False)
        jst = jsd.scene_sweeps(jst, js, jcfg, 1, 1, True)
    j_acc, t_acc = _accuracy(sc, jst.depth), _accuracy(sc, banded.depth)
    assert abs(t_acc - j_acc) <= 0.03, (t_acc, j_acc)
    assert j_acc > 0.3


@pytest.fixture(scope="module")
def mesh_runs(launches):
    """Process 0's MHJSON lines of the dense launch, in config order."""
    outs = launches["dense"].result()
    assert all("MHCHECK OK" in o for o in outs), outs
    return [r for r in M.parse_lines(outs) if r["rank"] == 0]


@pytest.mark.parametrize("route", list(ROUTES))
def test_tile_axis_equals_one_process(mesh_runs, route):
    rep = mesh_runs[list(ROUTES).index(route)]
    assert rep["cfg"] == ROUTES[route]
    assert rep["world"] == 4 and rep["mesh"] == [2, 2]
    assert rep["views"] == [0, 1, 2, 3] and rep["bands"] == [[0, 16]]
    # sweeps, the filter and fusion: every map, keep and point
    assert rep["equal"], rep
    assert rep["depth_mismatch"] == 0 and rep["normal_mismatch"] == 0
    assert rep["cost_mismatch"] == 0 and rep["keep_agree"] == 1.0
    assert rep["pt_diff"] == 0 and rep["kept"] > 0
    # the halo exchange: one a half-sweep of each of the 4 views of a
    # phase, this process's band's edge rows and max
    halo = rep["by_collective"]["parallel.halo"]
    assert halo["calls"] == 2 * 4
    assert halo["bytes"] == halo["calls"] * 4 * (
        2 * 4 * rep["halo_rows"] * W + 1)


def test_the_halo_alone_moves_between_half_sweeps(mesh_runs):
    """Red-black sweeps run two half-sweeps where Jacobi runs one: twice
    the halo exchanges, the same all-gathers (the maps are gathered once
    a pass, not after each half-sweep)."""
    jacobi, redblack = mesh_runs[0], mesh_runs[-1]
    assert redblack["cfg"] == REDBLACK
    assert redblack["equal"], redblack
    by_j, by_r = jacobi["by_collective"], redblack["by_collective"]
    assert by_r["parallel.halo"]["calls"] == 2 * by_j["parallel.halo"][
        "calls"]
    assert by_r["parallel.all_gather"]["calls"] == by_j[
        "parallel.all_gather"]["calls"]


def test_sharded_ba_on_the_tile_mesh(launches):
    outs = launches["ba"].result()
    out = launches["ba_out"]
    rep = next(r for r in M.parse_lines(outs) if r["rank"] == 0)
    assert "MHCHECK OK" in outs[0] and rep["world"] == 4
    # points split over all 2 x 2 shards, as P(("view", "tile"))
    assert rep["local_observations"] == 4 * 16
    with np.load(out) as f:
        assert float(f["cost"]) == pytest.approx(
            float(f["one_process_cost"]), rel=1e-3, abs=1e-4)
        np.testing.assert_allclose(f["points"], f["one_process_points"],
                                   rtol=1e-3, atol=1e-4)
