"""PyTorch port vs the JAX package: incremental SfM, the scene export and
the radial-distortion refinement, on the CPU (global SfM:
tests/test_torch_sfm.py, with these helpers).

Inputs are the JAX suite's own scenes (tests/test_incremental_sfm.py's
synthetic observations, its 4-view 144x192 ridge scene), made with numpy
from seeds.  Each RANSAC of the port gets the JAX run's own draws: inside
the test, the JAX package's ``ransac_essential`` / ``ransac_homography``
/ ``ransac_pnp`` (as ``sfm.incremental`` and ``sfm.global_sfm`` call them)
are wrapped to recompute ``jax.random.categorical`` on the key and the
padded mask they receive and record the indices; the port's ``sampler``
replays them in order.

Tolerances.  ``sfm_from_matches`` on well-conditioned matches (seed 12):
the same init pair and registration order, camera centres within 1e-3,
rms within 1e-3 px, the same tracks.
``incremental_sfm`` from the 144x192 images: the same keypoints and
matches, all 4 views registered in both, ATE within 0.005 of the JAX
run's (this low-parallax scene is ill-conditioned: the two runs' last
bits move its bundle visibly, measured 0.0037 apart).  ``sfm_to_scene``
equal, and read back equal through ``io/mvs``.  ``refine_with_distortion``:
k within 1e-3 of the JAX run's, rms within 1e-3 px.

Where the chains part: a minimal sample drawn with a repeated index (the
draws are with replacement) leaves its eight-point system a null space of
two dimensions, and which vector of it LAPACK (the port on the CPU), XLA
or cuSOLVER returns differs.  When such a hypothesis wins the
a-contrario ranking, the threshold and an inlier count change and, in
the init-pair choice, the whole chain: on the seed-11 observations the
JAX run starts from (1, 3), the port fed its draws from (3, 4) (ATE max
0.0174 where the JAX run's is within the JAX suite's 0.013).  With its own
generator the port starts from (1, 3) too, and both runs are held to the
JAX suite's bound.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.eval.pose_eval import ate
from hcmvs_tpu.sfm import distortion as jdist
from hcmvs_tpu.sfm import global_sfm as jglobal
from hcmvs_tpu.sfm import incremental as jinc
from hcmvs_tpu.sfm import pnp as jpnp
from hcmvs_tpu.sfm import two_view as jtv
from hcmvs_tpu.utils.synth import make_ridge_scene

from hcmvs_tpu_torch.convert import sfm_result_from_numpy
from hcmvs_tpu_torch.io.mvs import read_mvs, write_mvs
from hcmvs_tpu_torch.sfm import distortion as tdist
from hcmvs_tpu_torch.sfm import incremental as tinc

from test_incremental_sfm import K_TEST, _synthetic_observations

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

CPU = "cpu"
K_IMG = np.array([[180.0, 0, 96], [0, 180.0, 72], [0, 0, 1.0]])


def _recording(orig, m, n_default, n_kw, records):
    """``orig`` (a JAX RANSAC) that first records the draws it makes."""
    @functools.wraps(orig)
    def wrapped(key, a, b, valid, *args, **kw):
        idx = jax.random.categorical(key, jnp.where(valid, 0.0, -1e9),
                                     shape=(kw.get(n_kw, n_default), m))
        records.append(np.asarray(idx))
        return orig(key, a, b, valid, *args, **kw)
    return wrapped


@contextlib.contextmanager
def jax_draws():
    """Inside the block the JAX SfM drivers record their RANSAC draws;
    yields the list they append to."""
    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinc, "ransac_essential", _recording(
            jtv.ransac_essential, 8, 512, "n_hypotheses", records))
        mp.setattr(jtv, "ransac_homography", _recording(
            jtv.ransac_homography, 4, 256, "n_hyps", records))
        mp.setattr(jinc, "ransac_pnp", _recording(
            jpnp.ransac_pnp, 6, 1024, "n_hypotheses", records))
        mp.setattr(jglobal, "ransac_essential", _recording(
            jtv.ransac_essential, 8, 512, "n_hypotheses", records))
        yield records


class Replay:
    """The port's sampler replaying recorded draws in order.  With a
    ``fallback`` sampler, the first call the records do not fit (another
    sample shape, or an index outside the call's valid slots: the two
    chains have parted) and every later one go to the fallback; without
    one such a call fails."""

    def __init__(self, records, fallback=None):
        self.records = list(records)
        self.used = 0
        self.fallback = fallback
        self.parted = False

    def __call__(self, valid, n_hyp, m):
        idx = (torch.from_numpy(np.array(self.records[self.used])).long()
               if self.used < len(self.records) else None)
        fits = (idx is not None and idx.shape == (n_hyp, m)
                and bool(valid[idx].all()))
        if self.parted or not fits:
            assert self.fallback is not None, "the JAX run's draws do not fit"
            self.parted = True
            return self.fallback(valid, n_hyp, m)
        self.used += 1
        return idx


def _centres(result):
    return np.stack([result.poses[i][1] for i in sorted(result.poses)])


def _cfgs(**kw):
    return jinc.SfMConfig(**kw), tinc.SfMConfig(**kw)


def test_sfm_from_matches_with_jax_draws():
    xy, pm, gt_C, _ = _synthetic_observations(np.random.default_rng(12),
                                              mismatch_frac=0.15)
    jcfg, tcfg = _cfgs(min_matches=20, min_pnp_inliers=10, ba_every=2)
    with jax_draws() as records:
        rj = jinc.sfm_from_matches(xy, pm, K_TEST, len(xy), jcfg)
    replay = Replay(records)
    rt = tinc.sfm_from_matches(xy, pm, K_TEST, len(xy), tcfg,
                               sampler=replay, device=CPU)
    assert replay.used == len(records)
    # poses are inserted in registration order: init pair, then each view
    assert list(rt.poses) == list(rj.poses)
    assert len(rt.poses) == len(xy)
    assert np.abs(_centres(rt) - _centres(rj)).max() < 1e-3
    assert abs(rt.reproj_rms - rj.reproj_rms) < 1e-3
    assert len(rt.points) == len(rj.points)
    assert rt.track_obs == rj.track_obs


def test_sfm_from_matches_when_a_degenerate_sample_differs():
    """Seed 11 (the JAX suite's trajectory test): with JAX's draws the
    port starts from another init pair (module docstring; it draws from
    its own generator once the chains part, and registers every view);
    with its own generator it starts where the JAX run does, and both
    meet the JAX suite's bound."""
    xy, pm, gt_C, _ = _synthetic_observations(np.random.default_rng(11))
    jcfg, tcfg = _cfgs(min_matches=20, min_pnp_inliers=10, ba_every=2)
    with jax_draws() as records:
        rj = jinc.sfm_from_matches(xy, pm, K_TEST, len(xy), jcfg)
    replay = Replay(records, fallback=tinc.default_sampler(CPU))
    parted = tinc.sfm_from_matches(xy, pm, K_TEST, len(xy), tcfg,
                                   sampler=replay, device=CPU)
    assert list(rj.poses)[:2] == [1, 3] and list(parted.poses)[:2] == [3, 4]
    assert replay.parted
    assert len(parted.poses) == len(xy) and parted.reproj_rms < 1.0
    own = tinc.sfm_from_matches(xy, pm, K_TEST, len(xy), tcfg, device=CPU)
    assert list(own.poses)[:2] == [1, 3]
    for r in (rj, own):
        assert len(r.poses) == len(xy) and r.reproj_rms < 1.0
        assert ate(_centres(r), gt_C)["max"] < 0.013


@pytest.fixture(scope="module")
def image_runs():
    """tests/test_incremental_sfm.py's 4-view ridge scene through both
    packages' ``incremental_sfm`` (its config), the port replaying JAX's
    draws."""
    sc = make_ridge_scene(np.random.default_rng(7), h=144, w=192, n_views=4,
                          fx=180.0, z0=4.0, spacing=0.25)
    kw = dict(max_keypoints=512, min_matches=20, min_pnp_inliers=10,
              ba_every=2)
    jcfg, tcfg = _cfgs(**kw)
    with jax_draws() as records:
        rj = jinc.incremental_sfm(sc.images, K_IMG, jcfg)
    replay = Replay(records)
    rt = tinc.incremental_sfm(sc.images, K_IMG, tcfg, sampler=replay,
                              device=CPU)
    assert replay.used == len(records)
    return sc, rj, rt


def test_incremental_sfm_from_images(image_runs):
    sc, rj, rt = image_runs
    for a, b in zip(rt.keypoints, rj.keypoints):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)
    assert sorted(rt.poses) == sorted(rj.poses) == [0, 1, 2, 3]
    assert rt.reproj_rms < 1.0
    gt = np.stack([np.asarray(c.C) for c in sc.cameras])
    a_t, a_j = ate(_centres(rt), gt)["rmse"], ate(_centres(rj), gt)["rmse"]
    assert abs(a_t - a_j) < 0.005, (a_t, a_j)


def test_sfm_to_scene_matches_and_reads_back(image_runs, tmp_path):
    _, rj, _ = image_runs
    names = [f"im{i:04d}.png" for i in range(4)]
    sj = jinc.sfm_to_scene(rj, K_IMG, names, 192, 144)
    st = tinc.sfm_to_scene(sfm_result_from_numpy(rj), K_IMG, names, 192, 144)
    for f in ("points", "point_view_counts", "point_view_ids",
              "point_view_confs"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert [im.name for im in st.images] == [im.name for im in sj.images]
    path = os.path.join(tmp_path, "sfm.mvs")
    write_mvs(path, st)
    back = read_mvs(path)
    np.testing.assert_array_equal(back.points, st.points)
    np.testing.assert_array_equal(back.point_view_ids, st.point_view_ids)
    for i in range(len(st.images)):
        for a, b in zip(back.pose_of(i), sj.pose_of(i)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_array_equal(back.intrinsics_of(i, 192, 144),
                                      K_IMG)


def test_refine_with_distortion_matches():
    """An SfM result of the seed-12 observations whose keypoints went
    through k1 = -0.15: both packages' grid search + alternation from the
    same result."""
    xy, pm, gt_C, X = _synthetic_observations(np.random.default_rng(12),
                                              mismatch_frac=0.0)
    k_true = np.array([-0.15, 0.0, 0.0], np.float32)
    raw = [np.asarray(jdist.distort_points_px(
        jnp.asarray(x), jnp.asarray(K_TEST, jnp.float32),
        jnp.asarray(k_true))) for x in xy]
    jcfg, _ = _cfgs(min_matches=20, min_pnp_inliers=10, ba_every=2)
    with jax_draws():
        rj = jinc.sfm_from_matches(raw, pm, K_TEST, len(raw), jcfg)
    ref_j, k_j = jdist.refine_with_distortion(rj, K_TEST)
    ref_t, k_t = tdist.refine_with_distortion(sfm_result_from_numpy(rj),
                                              K_TEST, device=CPU)
    assert -0.25 < float(k_j[0]) < -0.08
    np.testing.assert_allclose(k_t, np.asarray(k_j), atol=1e-3)
    assert abs(ref_t.reproj_rms - ref_j.reproj_rms) < 1e-3
    assert ref_t.reproj_rms < rj.reproj_rms
