"""The port's multi-process layer on the CPU: the view axis of the dense
stage, sharded bundle adjustment, the value check, the dry run and the
scaling harness (``hcmvs_tpu_torch.parallel``, ``entry``,
``eval.scaling``).

Processes are started by ``parallel.mh_check.launch``: Gloo, a
``file://`` rendezvous under the test's ``tmp_path`` (no port to collide
under xdist), one torch thread each, every wait bounded (a dead rank
fails the test, it does not hang it).

- Sweeps, filter and fusion under the view axis at 2 and 4 processes
  equal one process with the same per-view generators, bit for bit, on
  the direct route, the tables with the rect build and engine, and 256
  planes (the per-plane build): each view's work reads only the snapshot
  and its own generator, and no sum crosses views.  The scene is
  tests/test_sharding.py's ``_tiny_scene`` (8 views, 32x48, 2
  neighbours), rebuilt here and checked to be the one the processes run.
- Sharded BA (4 cameras, 64 points, as tests/test_sharding.py) within
  rel 1e-3 of one process and of the JAX package's ``run_ba`` (the
  camera sums add in another order: not bit for bit).
- The JAX package on the same scene: the port's sweeps with per-view
  generators reach the JAX sweeps' depth accuracy within 0.03 (mean of
  three seeds each: the streams differ, and one seed at this size
  spreads by ~0.02).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JDenseConfig
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.sfm import ba as jba
from hcmvs_tpu.utils import synth as jsynth

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.dense import fusion as tfusion
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.entry import build_scene
from hcmvs_tpu_torch.parallel import distributed as D
from hcmvs_tpu_torch.parallel import mh_check as M
from hcmvs_tpu_torch.parallel import sharding as P
from hcmvs_tpu_torch.sfm import ba as tba
from hcmvs_tpu_torch.utils.synth import make_plane_scene

torch.set_num_threads(1)
N_VIEWS, H, W, NBR = 8, 32, 48, 2
TIMEOUT = 240
# the routes, as mh_check --cfg overrides of its direct base config
ROUTES = {
    "direct": {},
    "volume-rect": {"exact_backend": "volume", "geo_backend": "rect",
                    "volume_build": "rect"},
    "planes256": {"exact_backend": "volume", "geo_backend": "rect",
                  "volume_planes": 256},
}


def _tiny_scene(n_views=N_VIEWS, h=H, w=W):
    """tests/test_sharding.py's scene, in the port."""
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    nbr = [[j for j in range(n_views) if j != i][:NBR]
           for i in range(n_views)]
    return tsd.SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]),
        cams=cams, nbr_idx=torch.tensor(nbr),
        nbr_valid=torch.ones((n_views, NBR), dtype=torch.bool),
        d_min=torch.full((n_views,), sc.d_min),
        d_max=torch.full((n_views,), sc.d_max))


def test_the_processes_run_the_tiny_scene():
    mine = _tiny_scene()
    theirs = build_scene(N_VIEWS, H, W, "cpu", n_nbr=NBR)
    for f in ("gray", "nbr_idx", "nbr_valid", "d_min", "d_max"):
        assert torch.equal(getattr(mine, f), getattr(theirs, f)), f
    for f in "KRC":
        assert torch.equal(getattr(mine.cams, f), getattr(theirs.cams, f))


@pytest.fixture(scope="module")
def view_axis_runs(tmp_path_factory):
    """Process 0's MHJSON lines of one launch per process count, every
    route one after another in the same processes."""
    cache = {}

    def get(n_proc):
        if n_proc not in cache:
            args = ["--device", "cpu"]
            for over in ROUTES.values():
                args += ["--cfg", json.dumps(over)]
            outs = M.launch(n_proc, args, timeout=TIMEOUT,
                            workdir=str(tmp_path_factory.mktemp("mh")))
            cache[n_proc] = [r for r in M.parse_lines(outs)
                             if r["rank"] == 0]
        return cache[n_proc]

    return get


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n_proc", [2, 4])
def test_view_axis_equals_one_process(view_axis_runs, n_proc, route):
    rep = view_axis_runs(n_proc)[list(ROUTES).index(route)]
    assert rep["cfg"] == ROUTES[route]
    assert rep["world"] == n_proc
    assert rep["views"] == list(range(N_VIEWS // n_proc))
    assert rep["collectives"] > 0
    # sweeps, the filter and fusion: every map, keep and point
    assert rep["equal"], rep
    assert rep["depth_mismatch"] == 0 and rep["normal_mismatch"] == 0
    assert rep["cost_mismatch"] == 0 and rep["keep_agree"] == 1.0
    assert rep["pt_diff"] == 0 and rep["kept"] > 0


def test_several_shards_a_process(tmp_path):
    """The counterpart of the JAX check's devices a process: 2 processes
    x 2 view shards."""
    outs = M.launch(2, ["--device", "cpu", "--ranks-per-process", "2"],
                    timeout=TIMEOUT, workdir=str(tmp_path))
    reps = M.parse_lines(outs)
    assert [r["views"] for r in reps] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert reps[0]["equal"]


def test_mh_check_prints_ok(tmp_path):
    outs = M.launch(2, ["--device", "cpu"], timeout=120,
                    workdir=str(tmp_path))
    assert "MHCHECK OK" in outs[0] and "MHCHECK OK" in outs[1], outs
    assert "depth_mismatch=0.0000 keep_agree=1.0000" in outs[0]


def _blocks_of(n, n_proc):
    """The view blocks of ``n_proc`` processes."""
    return P.scene_shardings(P.ViewMesh(
        n_view=n_proc, n_tile=1, rank=0, world=n_proc,
        device=torch.device("cpu")), n)


def _swept_state(scene, cfg):
    gens = tsd.view_generators(0, N_VIEWS, "cpu")
    st = tsd.init_scene_state(gens, scene)
    st = tsd.scene_sweeps(st, scene, cfg, 0, 1, False, gens)
    return tsd.scene_sweeps(st, scene, cfg, 1, 1, True, gens)


@pytest.mark.parametrize("step", ["optimize", "fusion", "priors"])
def test_view_blocks_equal_the_whole(step):
    """The sharded steps' premise, in one process: each block of views
    filtered / fused / given priors against every view's maps, the blocks
    put together, equals the whole scene's run."""
    scene = _tiny_scene()
    cfg = M.base_cfg("direct")
    st = _swept_state(scene, cfg)
    blocks = _blocks_of(N_VIEWS, 3)          # 3 / 3 / 2 views
    assert [len(b) for b in blocks] == [3, 3, 2]
    if step == "optimize":
        whole = tsd.optimize_maps(st, scene, cfg)
        for b in blocks:
            part = tsd.optimize_maps(st, scene, cfg, b)
            for f in ("depth", "normal", "cost"):
                assert torch.equal(getattr(part, f)[b.start:b.stop],
                                   getattr(whole, f)[b.start:b.stop])
    elif step == "fusion":
        conf = torch.clamp_min(1.0 - st.cost, 0.01)
        args = (st.depth, st.normal, conf, scene.cams, scene.nbr_idx,
                scene.nbr_valid, torch.arange(N_VIEWS, dtype=torch.float32),
                cfg)
        whole = tfusion.fuse_point_cloud(*args)
        parts = [tfusion.fuse_point_cloud(*args, views=b) for b in blocks]
        for k, v in whole.items():
            assert torch.equal(torch.cat([p[k] for p in parts]), v), k
    else:
        sem = torch.zeros((N_VIEWS, H, W), dtype=torch.int64)
        sem[:, :, W // 2:] = 1
        scene_s = tsd.dataclasses.replace(scene, semantic=sem)
        whole = tsd.compute_scene_priors(st, scene_s, cfg=cfg)
        parts = [tsd.compute_scene_priors(st, scene_s, cfg=cfg, views=b)
                 for b in blocks]
        assert torch.equal(torch.cat([p.prior_depth for p in parts]),
                           whole.prior_depth)
        assert (whole.prior_depth > 0).any()
        one = P.compute_scene_priors(st, scene_s, P.make_device_mesh(1),
                                     cfg=cfg)
        assert torch.equal(one.prior_depth, whole.prior_depth)


def test_view_axis_sweeps_in_chunks_in_one_process():
    """``sharding.scene_sweeps`` with ``view_chunk`` (chunks of 3 over a
    process's views, the last one short) equals one unchunked call."""
    scene = _tiny_scene()
    cfg = M.base_cfg("volume")
    scene_v = tsd.attach_volumes(scene, cfg)
    mesh = P.make_device_mesh(2)
    gens = tsd.view_generators(0, N_VIEWS, "cpu")
    st = tsd.init_scene_state(gens, scene)
    shard, _ = P.shard_scene(scene, st, mesh, cfg)
    assert shard.vols_first == 0 and shard.vols.tab.shape[0] == N_VIEWS
    got = P.scene_sweeps(st, shard, cfg, 0, 1, False, gens, mesh,
                         view_chunk=3)
    gens = tsd.view_generators(0, N_VIEWS, "cpu")
    st = tsd.init_scene_state(gens, scene)
    ref = tsd.scene_sweeps(st, scene_v, cfg, 0, 1, False, gens)
    for f in ("depth", "normal", "cost"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
    with pytest.raises(ValueError, match="one generator a view"):
        P.scene_sweeps(st, shard, cfg, 0, 1, False, torch.Generator(), mesh)


def test_view_generators_do_not_depend_on_other_views():
    """A view's draws come from its own generator: sweeping views 4-7
    alone gives what they get when views 0-3 are swept before them (with
    one shared generator they would not)."""
    scene = _tiny_scene()
    cfg = M.base_cfg("direct")

    def photometric(gen, **chunk):
        st = tsd.init_scene_state(gen, scene)
        return tsd.scene_sweeps(st, scene, cfg, 0, 1, False, gen, **chunk)

    def views_4_7(make_gen):
        alone = photometric(make_gen(), view_start=4, view_chunk=4)
        after = photometric(make_gen())
        return torch.equal(alone.depth[4:], after.depth[4:])

    assert views_4_7(lambda: tsd.view_generators(0, N_VIEWS, "cpu"))
    assert not views_4_7(lambda: torch.Generator().manual_seed(0))
    seeds = {tsd.view_generator(0, i, "cpu").initial_seed()
             for i in range(N_VIEWS)}
    seeds.add(tsd.prior_generator(0, "cpu").initial_seed())
    assert len(seeds) == N_VIEWS + 1


# --- bundle adjustment ------------------------------------------------------

K_TEST = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1.0]])


def _ba_problem(n_cams=4, n_pts=64, seed=3):
    """tests/test_sharding.py's problem: random structure seen by every
    camera, noisy pixels, perturbed points, camera 0 fixed."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.5, 1.5, (n_pts, 3)) * [1, 0.7, 0.5] + [0, 0, 5.0]
    obs_cam, obs_pt, obs_uv, Cs = [], [], [], []
    for c in range(n_cams):
        rv = torch.as_tensor(rng.normal(0, 0.02, 3), dtype=torch.float32)
        R = tba.rodrigues(rv).numpy().astype(np.float64)
        C = np.array([(c - n_cams / 2) * 0.5, 0.05 * c, 0.02 * c])
        uv = ((X - C) @ R.T) @ K_TEST.T
        uv = uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.4, (n_pts, 2))
        Cs.append(C)
        for p in range(n_pts):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(uv[p])
    pts0 = X + rng.normal(0, 0.02, X.shape)
    return {"K": np.tile(K_TEST[None], (n_cams, 1, 1)).astype(np.float32),
            "obs_cam": np.asarray(obs_cam), "obs_pt": np.asarray(obs_pt),
            "obs_uv": np.asarray(obs_uv, np.float32),
            "fixed_cams": np.arange(n_cams) == 0,
            "rvecs": np.zeros((n_cams, 3), np.float32),
            "tvecs": np.stack([-C for C in Cs]).astype(np.float32),
            "points": pts0.astype(np.float32)}


@pytest.mark.parametrize("n_proc", [2, 3])
def test_sharded_ba_matches_one_process_and_jax(tmp_path, n_proc):
    a = _ba_problem()
    path = tmp_path / "ba.npz"
    np.savez(path, **a)
    out = tmp_path / "out.npz"
    outs = M.launch(n_proc, ["--device", "cpu", "--ba-problem", str(path),
                             "--ba-iters", "5", "--ba-out", str(out)],
                    timeout=TIMEOUT, workdir=str(tmp_path))
    rep = next(r for r in M.parse_lines(outs) if r["rank"] == 0)
    assert "MHCHECK OK" in outs[0]
    assert rep["world"] == n_proc and rep["observations"] == 4 * 64
    with np.load(out) as f:
        cost, pts = float(f["cost"]), f["points"]
        ref_cost, ref_pts = float(f["one_process_cost"]), \
            f["one_process_points"]
    assert cost == pytest.approx(ref_cost, rel=1e-3, abs=1e-4)
    np.testing.assert_allclose(pts, ref_pts, rtol=1e-3, atol=1e-4)
    # the JAX package's single-device run on the same problem
    problem = jba.build_problem(a["K"], a["obs_cam"], a["obs_pt"],
                                a["obs_uv"], 64, fixed_cams=a["fixed_cams"])
    state = jba.BAState(rvecs=jnp.asarray(a["rvecs"]),
                        tvecs=jnp.asarray(a["tvecs"]),
                        points=jnp.asarray(a["points"]))
    j_state, j_cost = jba.run_ba(problem, state, n_iters=5)
    assert cost == pytest.approx(float(j_cost), rel=1e-3, abs=1e-4)
    np.testing.assert_allclose(pts, np.asarray(j_state.points), rtol=1e-3,
                               atol=1e-4)


def test_shard_ba_partitions_points_with_their_observations():
    a = _ba_problem(n_pts=10)
    problem = tba.build_problem(a["K"], a["obs_cam"], a["obs_pt"],
                                a["obs_uv"], 10, a["fixed_cams"],
                                device="cpu")
    state = tba.BAState(*(torch.from_numpy(a[k])
                          for k in ("rvecs", "tvecs", "points")))
    for n_proc in (1, 3):
        seen = 0
        for r, b in enumerate(_blocks_of(10, n_proc)):
            mesh = P.ViewMesh(n_view=n_proc, n_tile=1, rank=r,
                              world=n_proc, device=torch.device("cpu"))
            lp, ls = P.shard_ba(problem, state, mesh)
            assert torch.equal(ls.points, state.points[b.start:b.stop])
            assert int(lp.obs_pt.max()) < len(b)
            assert torch.equal(lp.obs_pt + b.start,
                               problem.obs_pt[seen:seen + len(lp.obs_pt)])
            seen += len(lp.obs_pt)
        assert seen == len(problem.obs_pt)


# --- the JAX package on the same scene --------------------------------------

def test_per_view_generator_sweeps_reach_jax_accuracy():
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
    gts = [jsynth.plane_depth_of_view(sc, i) for i in range(N_VIEWS)]

    def acc(depth):
        m = 3
        return float(np.mean([
            (np.abs(np.asarray(depth[i]) - gts[i])
             <= 0.02 * gts[i])[m:-m, m:-m].mean() for i in range(N_VIEWS)]))

    it = 2
    jcfg = JDenseConfig(adapt_half_window=3, patch_half_window=3,
                        patch_step=2, estimation_iters=it, random_iters=1,
                        use_optical_flow=0, use_geo_consistency=1,
                        use_part_consistency=0)
    tcfg = M.base_cfg("direct", iters=it)
    scene = _tiny_scene()
    j_acc, t_acc = [], []
    for seed in range(3):
        st = jsd.init_scene_state(jax.random.PRNGKey(seed), jscene)
        st = jsd.scene_sweeps(st, jscene, jcfg, 0, it, False)
        st = jsd.scene_sweeps(st, jscene, jcfg, 1, it, True)
        j_acc.append(acc(st.depth))
        gens = tsd.view_generators(seed, N_VIEWS, "cpu")
        ts = tsd.init_scene_state(gens, scene)
        ts = tsd.scene_sweeps(ts, scene, tcfg, 0, it, False, gens)
        ts = tsd.scene_sweeps(ts, scene, tcfg, 1, it, True, gens)
        t_acc.append(acc(ts.depth.numpy()))
    assert abs(np.mean(t_acc) - np.mean(j_acc)) <= 0.03, (t_acc, j_acc)
    assert np.mean(j_acc) > 0.4


# --- the dry run, scaling, the mesh -----------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n):
    from hcmvs_tpu_torch.entry import dryrun_multichip
    rep = dryrun_multichip(n, "cpu", timeout=TIMEOUT)
    assert rep["world"] == n and rep["equal"] and rep["kept"] > 0
    assert rep["cfg"] == {"volume_planes": 256}
    # two row bands a view from 4 processes on, as the JAX package's
    assert rep["mesh"] == ([2, 1] if n == 2 else [2, 2])


def test_scaling_run_returns_its_keys():
    from hcmvs_tpu_torch.eval import scaling
    out = scaling.run(h=32, w=48, n_reps=1, ranks=(1, 2), timeout=TIMEOUT)
    assert set(out) == {"wall_s_1dev", "wall_s_2dev", "ratio_1dev",
                        "ratio_2dev"}
    assert out["ratio_1dev"] == 1.0 and out["wall_s_2dev"] > 0


def test_dense_timed_and_ba_stages_in_one_launch(tmp_path):
    """A dense config, the scaling check's timed stage and sharded BA one
    after another in the same two processes (as chip_smoke.py's phase 28
    runs them on the card), each stage's lines tagged, and
    ``scaling.run_multiprocess`` reading the timed stage's line."""
    from hcmvs_tpu_torch.eval import scaling
    np.savez(tmp_path / "ba.npz", **_ba_problem())
    outs = M.launch(2, ["--device", "cpu", "--views", "4", "--cfg", "{}",
                        *scaling.bench_stage_args(1),
                        "--ba-problem", str(tmp_path / "ba.npz"),
                        "--ba-iters", "3"],
                    timeout=TIMEOUT, workdir=str(tmp_path))
    assert all("MHCHECK OK" in o for o in outs), outs
    assert "ba cost_rel=" in outs[0] and "MHBENCH" in outs[0]
    lines = M.parse_lines(outs)
    assert [(x["rank"], x["stage"]) for x in lines] == [
        (0, "dense"), (0, "bench"), (0, "ba"),
        (1, "dense"), (1, "bench"), (1, "ba")]
    dense, bench, ba = lines[:3]
    assert dense["equal"] and dense["views"] == [0, 1]
    assert bench["equal"] and bench["views"] == list(range(4))
    assert bench["cfg"] == {"random_iters": 2} and bench["bench_wall_s"] > 0
    assert ba["within"] and ba["dist_backend"] == "gloo"
    rep = scaling.run_multiprocess(device="cpu", h=H, w=W,
                                   line=scaling.bench_line(lines))
    assert rep["value_check"] == "OK" and rep["wall_s_2proc_1dev"] > 0
    assert rep["dist_backend"] == "gloo" and rep["size"] == f"{W}x{H}"


def test_started_processes_wait_at_the_gate(tmp_path):
    """``mh_check.Launch`` holds its processes at a gate, before they
    join the group, until ``wait``: their start-up can overlap other
    work."""
    started = M.Launch(2, ["--device", "cpu", "--views", "2", "--nbrs",
                           "1"], workdir=str(tmp_path))
    try:
        time.sleep(3.0)
        assert all(p.poll() is None for p in started.procs)
        assert not started.gate.exists()
        # none has joined the group: the rendezvous file is not made yet
        assert not list(started.gate.parent.glob("rendezvous*"))
    except BaseException:
        started.close()
        raise
    outs = started.wait(TIMEOUT)
    assert all("MHCHECK OK" in o for o in outs), outs
    assert all(p.poll() is not None for p in started.procs)
    assert not started.gate.parent.exists()


def test_scaling_run_multiprocess_on_the_cpu():
    """``scaling.run_multiprocess`` in a launch of its own: two processes
    of four view shards each, as the JAX module's 2 x 4 devices."""
    from hcmvs_tpu_torch.eval import scaling
    rep = scaling.run_multiprocess(reps=1, timeout=TIMEOUT, device="cpu")
    assert rep["value_check"] == "OK" and rep["wall_s_2proc_4dev"] > 0
    assert rep["device"] == "cpu" and rep["nbrs"] == 3


def test_one_process_needs_no_group(monkeypatch):
    for k in ("HCMVS_COORDINATOR", "HCMVS_NUM_PROCESSES", "HCMVS_PROCESS_ID",
              "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize() is False
    assert D.world() == (0, 1)
    mesh = D.global_mesh(device="cpu", shards_per_process=4)
    assert mesh.device_mesh is None
    assert mesh.blocks(10) == [range(0, 10)]
    assert P.make_device_mesh(4).blocks(10) == [range(0, 10)]
    # blocks as the JAX view axis lays out (N, ...): ceil(N / n) a shard
    assert _blocks_of(8, 4) == [range(0, 2), range(2, 4), range(4, 6),
                                range(6, 8)]
    assert _blocks_of(10, 4) == [range(0, 3), range(3, 6), range(6, 9),
                                 range(9, 10)]
    x = torch.arange(6.0)
    assert D.fetch(x, [range(0, 6)]) is x
    assert D.sum_in_rank_order(x) is x
