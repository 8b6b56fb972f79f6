"""PyTorch port vs the JAX package: the SfM building blocks on the CPU --
a-contrario thresholds, two-view geometry and its RANSACs, PnP, features,
matching and the radial distortion model -- and global SfM.

Inputs are the JAX suite's own (tests/test_sfm.py, test_distortion.py),
made with numpy from seeds; the RANSACs get JAX's draws (recomputed from
the key the JAX function receives, as ``jax.random.categorical`` draws
them inside it); JAX runs on the CPU.

Tolerances.  NFA tables, thresholds and log-NFA within 1e-6 relative;
eight-point E up to its sign, Sampson distances, ``recover_pose``,
``triangulate_midpoint`` and ``refine_pose`` within 1e-4 (float32 SVDs
and Gauss-Newton steps); ``ransac_essential`` / ``ransac_homography`` /
``ransac_pnp`` fed JAX's draws: equal inlier counts, R and t within 1e-4
(the realized a-contrario threshold within 1e-3 relative).
Features at 128x160: the same keypoint slots in the same order, xy within
1e-3 px, scores, scales and angles within 1e-5, descriptors of the valid
slots within 1e-4 (the masked slots at the border are never matched; the
JAX package's jitted detector samples them differently from its own
unjitted descriptor code); matches equal.  Distortion: the model and its
inverse within 1e-5, ``_fit_k`` within 1e-4, ``undistort_image`` within
1e-4 (max abs).  ``global_sfm_from_matches`` on tests/
test_incremental_sfm.py's synthetic observations (seed 12 and the JAX
suite's seed 5), JAX's draws replayed (tests/test_torch_incremental.py):
the same registered views and tracks, camera centres within 1e-3, rms
within 1e-3 px, ATE within 1e-3 of the JAX run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.sfm import acransac as jac
from hcmvs_tpu.eval.pose_eval import ate
from hcmvs_tpu.sfm import distortion as jdist
from hcmvs_tpu.sfm import global_sfm as jglobal
from hcmvs_tpu.sfm import features as jfeat
from hcmvs_tpu.sfm import matching as jmatch
from hcmvs_tpu.sfm import pnp as jpnp
from hcmvs_tpu.sfm import two_view as jtv
from hcmvs_tpu.sfm.ba import rodrigues

from hcmvs_tpu_torch.sfm import acransac as tac
from hcmvs_tpu_torch.sfm import distortion as tdist
from hcmvs_tpu_torch.sfm import features as tfeat
from hcmvs_tpu_torch.sfm import global_sfm as tglobal
from hcmvs_tpu_torch.sfm.incremental import SfMConfig
from hcmvs_tpu_torch.sfm import matching as tmatch
from hcmvs_tpu_torch.sfm import pnp as tpnp
from hcmvs_tpu_torch.sfm import two_view as ttv

from test_incremental_sfm import K_TEST as K_OBS
from test_incremental_sfm import _synthetic_observations
from test_sfm import _make_image, _synth_two_view
from test_torch_incremental import Replay, jax_draws

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _jax_draws(key, valid, n_hyp, m):
    return np.asarray(jax.random.categorical(
        key, jnp.where(jnp.asarray(valid), 0.0, -1e9), shape=(n_hyp, m)))


def _rot_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_nfa_tables_and_thresholds_match():
    for n, m in ((64, 8), (400, 8), (256, 6)):
        for a, b in zip(tac._log_comb_tables(n, m),
                        jac._log_comb_tables(n, m)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    d2 = []
    for sigma in (1e-4, 1e-3):
        d2.append(np.concatenate([rng.normal(0, sigma, 300) ** 2,
                                  rng.uniform(0.3, 1.0, 100) ** 2]))
    d2.append(rng.uniform(0.1, 1.0, 400) ** 2)
    d2 = np.stack(d2).astype(np.float32)
    valid = np.ones(400, bool)
    valid[-7:] = False
    j = jac.nfa_threshold_batch(jnp.asarray(d2), jnp.asarray(valid), m=8)
    t = tac.nfa_threshold_batch(_t(d2), _t(valid), m=8)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    one = tac.nfa_threshold(_t(d2[0]), _t(valid), m=8)
    jone = jac.nfa_threshold(jnp.asarray(d2[0]), jnp.asarray(valid), m=8)
    for a, b in zip(one, jone):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_two_view_geometry_matches():
    rng = np.random.default_rng(2)
    p0, p1, R_gt, t_gt, _ = _synth_two_view(rng, n=60, outlier_frac=0.0,
                                            noise=1e-3)
    idx = np.arange(8)
    Ej = np.asarray(jtv._eight_point(jnp.asarray(p0[idx]),
                                     jnp.asarray(p1[idx])))
    Et = ttv._eight_point(_t(p0[idx]), _t(p1[idx])).numpy()
    sign = np.sign(np.sum(Ej * Et))
    np.testing.assert_allclose(sign * Et, Ej, atol=1e-4)
    np.testing.assert_allclose(
        ttv.sampson_distance(_t(Ej), _t(p0), _t(p1)).numpy(),
        np.asarray(jtv.sampson_distance(jnp.asarray(Ej), jnp.asarray(p0),
                                        jnp.asarray(p1))),
        rtol=1e-4, atol=1e-10)
    inl = np.ones(60, bool)
    Rj, tj = jtv.recover_pose(jnp.asarray(Ej), jnp.asarray(p0),
                              jnp.asarray(p1), jnp.asarray(inl))
    Rt, tt = ttv.recover_pose(_t(Ej), _t(p0), _t(p1), _t(inl))
    assert _rot_err(Rt, Rj) < 1e-4 and _rot_err(tt, tj) < 1e-4
    Xj, zj = jtv.triangulate_midpoint(jnp.asarray(R_gt, jnp.float32),
                                      jnp.asarray(t_gt, jnp.float32),
                                      jnp.asarray(p0), jnp.asarray(p1))
    Xt, zt = ttv.triangulate_midpoint(_t(R_gt.astype(np.float32)),
                                      _t(t_gt.astype(np.float32)),
                                      _t(p0), _t(p1))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4)
    # refine from a perturbed start, with weights
    w = (np.arange(60) % 5 != 0)
    R0 = (np.asarray(rodrigues(jnp.asarray([0.01, -0.02, 0.005],
                                           jnp.float32))) @ R_gt
          ).astype(np.float32)
    t0 = (t_gt + [0.05, -0.02, 0.01]).astype(np.float32)
    Rj, tj = jtv.refine_pose(jnp.asarray(R0), jnp.asarray(t0),
                             jnp.asarray(p0), jnp.asarray(p1),
                             jnp.asarray(w))
    Rt, tt = ttv.refine_pose(_t(R0), _t(t0), _t(p0), _t(p1), _t(w))
    assert _rot_err(Rt, Rj) < 1e-4 and _rot_err(tt, tj) < 1e-4


@pytest.mark.parametrize("noise,adaptive", [(1e-3, True), (1e-3, False),
                                            (3e-3, True)])
def test_ransac_essential_with_jax_draws(noise, adaptive):
    rng = np.random.default_rng(1)
    p0, p1, R_gt, t_gt, n_out = _synth_two_view(rng, noise=noise)
    valid = np.ones(len(p0), bool)
    key = jax.random.PRNGKey(0)
    rj = jtv.ransac_essential(key, jnp.asarray(p0), jnp.asarray(p1),
                              jnp.asarray(valid), threshold=2e-5,
                              adaptive=adaptive)
    rt = ttv.ransac_essential(_t(_jax_draws(key, valid, 512, 8)), _t(p0),
                              _t(p1), _t(valid), threshold=2e-5,
                              adaptive=adaptive)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(rt.inliers.numpy(),
                                  np.asarray(rj.inliers))
    assert _rot_err(rt.R, rj.R) < 1e-4 and _rot_err(rt.t, rj.t) < 1e-4
    # the realized threshold is a sorted residual of one minimal-sample
    # model: 2.2e-4 relative apart at the 3e-3 noise level
    np.testing.assert_allclose(float(rt.threshold), float(rj.threshold),
                               rtol=1e-3)
    sign = np.sign(np.sum(rt.E.numpy() * np.asarray(rj.E)))
    np.testing.assert_allclose(sign * rt.E.numpy(), np.asarray(rj.E),
                               atol=1e-4)


def test_ransac_homography_with_jax_draws():
    """tests/test_sfm.py's AUTO model-selection scenes: a plane and a
    deep scene seen from two views."""
    rng = np.random.default_rng(0)
    n = 120
    t = np.array([0.4, 0.0, 0.0])
    planar = np.column_stack([rng.uniform(-1, 1, (n, 2)), np.full(n, 4.0)])
    deep = np.column_stack([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(3, 6, n)])
    valid = np.ones(n, bool)
    for X in (planar, deep):
        p0 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
        X1 = X + t
        p1 = (X1[:, :2] / X1[:, 2:3]).astype(np.float32)
        key = jax.random.PRNGKey(0)
        hj = jtv.ransac_homography(key, jnp.asarray(p0), jnp.asarray(p1),
                                   jnp.asarray(valid), 4e-5)
        ht = ttv.ransac_homography(_t(_jax_draws(key, valid, 256, 4)),
                                   _t(p0), _t(p1), _t(valid), 4e-5)
        assert int(ht.n_inliers) == int(hj.n_inliers)
        np.testing.assert_allclose(ht.H.numpy(), np.asarray(hj.H),
                                   atol=1e-4)


def test_ransac_pnp_with_jax_draws():
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (150, 3)) + [0, 0, 5.0]
    R = np.asarray(rodrigues(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t = np.array([0.3, -0.1, 0.2])
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (150, 2))
    uv[:20] = rng.uniform(-0.3, 0.3, (20, 2))          # outliers
    X, uv = X.astype(np.float32), uv.astype(np.float32)
    # padded as the incremental driver pads (valid slots first)
    Xp = np.concatenate([X, np.zeros((106, 3), np.float32)])
    uvp = np.concatenate([uv, np.zeros((106, 2), np.float32)])
    valid = np.arange(256) < 150
    key = jax.random.PRNGKey(3)
    pj = jpnp.ransac_pnp(key, jnp.asarray(Xp), jnp.asarray(uvp),
                         jnp.asarray(valid), 1e-5)
    idx = _jax_draws(key, valid, 1024, 6)
    assert idx.max() < 150
    pt = tpnp.ransac_pnp(_t(idx), _t(Xp), _t(uvp), _t(valid), 1e-5)
    assert int(pt.n_inliers) == int(pj.n_inliers) >= 120
    assert _rot_err(pt.R, pj.R) < 1e-4 and _rot_err(pt.t, pj.t) < 1e-4


def test_draw_samples_take_valid_slots_only():
    valid = torch.zeros(100, dtype=torch.bool)
    valid[10:30] = True
    g = torch.Generator().manual_seed(0)
    a = ttv.draw_samples(g, valid, 512, 8)
    assert a.shape == (512, 8) and a.dtype == torch.int64
    assert ((a >= 10) & (a < 30)).all()
    assert len(torch.unique(a)) == 20
    b = ttv.generator_sampler(torch.Generator().manual_seed(0))(valid, 512,
                                                                8)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def feature_pair():
    rng = np.random.default_rng(0)
    img = _make_image(rng)
    img_b = np.roll(np.roll(img, -5, 0), -8, 1)
    return img, img_b


@pytest.mark.parametrize("pyramid", [False, True])
def test_features_and_matches_match(feature_pair, pyramid):
    kw = dict(max_keypoints=256)
    if pyramid:
        jfn, tfn = (jfeat.detect_and_describe_pyramid,
                    tfeat.detect_and_describe_pyramid)
        kw["n_octaves"] = 3
    else:
        jfn, tfn = jfeat.detect_and_describe, tfeat.detect_and_describe
    kps = []
    for im in feature_pair:
        kj, kt = jfn(jnp.asarray(im), **kw), tfn(torch.from_numpy(im), **kw)
        sj, st = np.asarray(kj.score), kt.score.numpy()
        v = sj > 0
        assert v.sum() > 50
        np.testing.assert_array_equal(st > 0, v)
        np.testing.assert_allclose(kt.xy.numpy(), np.asarray(kj.xy),
                                   atol=1e-3)
        for f in ("score", "scale", "angle"):
            np.testing.assert_allclose(getattr(kt, f).numpy(),
                                       np.asarray(getattr(kj, f)),
                                       atol=1e-5, err_msg=f)
        np.testing.assert_allclose(kt.desc.numpy()[v],
                                   np.asarray(kj.desc)[v], atol=1e-4)
        kps.append((kj, kt))
    (ja, ta), (jb, tb) = kps
    mj = jmatch.match_descriptors(ja.desc, jb.desc, ja.score > 0,
                                  jb.score > 0)
    mt = tmatch.match_descriptors(ta.desc, tb.desc, ta.score > 0,
                                  tb.score > 0)
    mv = np.asarray(mj.valid)
    assert mv.sum() > 30
    np.testing.assert_array_equal(mt.valid.numpy(), mv)
    np.testing.assert_array_equal(mt.idx.numpy()[mv], np.asarray(mj.idx)[mv])


K_TEST = np.array([[180.0, 0, 96.0], [0, 180.0, 72.0], [0, 0, 1.0]])


def test_distortion_model_matches():
    rng = np.random.default_rng(0)
    k = np.array([-0.2, 0.03, 0.0], np.float32)
    xn = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    xd_j = jdist.distort_normalized(jnp.asarray(xn), jnp.asarray(k))
    xd_t = tdist.distort_normalized(_t(xn), _t(k))
    np.testing.assert_allclose(xd_t.numpy(), np.asarray(xd_j), atol=1e-6)
    np.testing.assert_allclose(
        tdist.undistort_normalized(xd_t, _t(k)).numpy(),
        np.asarray(jdist.undistort_normalized(xd_j, jnp.asarray(k))),
        atol=1e-5)
    uv = rng.uniform(0, 190, (200, 2)).astype(np.float32)
    Kf = K_TEST.astype(np.float32)
    for jf, tf in ((jdist.distort_points_px, tdist.distort_points_px),
                   (jdist.undistort_points_px, tdist.undistort_points_px)):
        np.testing.assert_allclose(
            tf(_t(uv), _t(Kf), _t(k)).numpy(),
            np.asarray(jf(jnp.asarray(uv), jnp.asarray(Kf), jnp.asarray(k))),
            atol=1e-3, rtol=1e-6)


def test_fit_k_matches():
    """tests/test_distortion.py's geometry-fixed GN half-step."""
    rng = np.random.default_rng(2)
    k_true = np.array([-0.18, 0.025, 0.0], np.float32)
    xn = rng.uniform(-0.55, 0.55, (800, 2)).astype(np.float32)
    xd = np.asarray(jdist.distort_normalized(jnp.asarray(xn),
                                             jnp.asarray(k_true)))
    xd = (xd + 1e-4 * rng.standard_normal(xd.shape)).astype(np.float32)
    valid = np.ones(800, bool)
    valid[::7] = False
    for n_coeffs in (1, 2, 3):
        kj = jdist._fit_k(jnp.asarray(xn), jnp.asarray(xd),
                          jnp.asarray(valid), jnp.zeros(3),
                          n_coeffs=n_coeffs)
        kt = tdist._fit_k(_t(xn), _t(xd), _t(valid), torch.zeros(3),
                          n_coeffs=n_coeffs)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
        assert (kt.numpy()[n_coeffs:] == 0).all()


@pytest.mark.parametrize("channels", [0, 3])
def test_undistort_image_matches(channels):
    rng = np.random.default_rng(1)
    shape = (144, 192) + ((channels,) if channels else ())
    img = rng.random(shape).astype(np.float32)
    k = np.array([-0.15, 0.02, 0.0], np.float32)
    rj = jdist.undistort_image(img, K_TEST, k)
    rt = tdist.undistort_image(img, K_TEST, k, device="cpu")
    assert rt.shape == rj.shape and rt.dtype == rj.dtype
    # the outside-the-input mask exactly, the samples within 1e-4
    np.testing.assert_array_equal(rt == 0, rj == 0)
    assert np.abs(rt - rj).max() <= 1e-4


@pytest.mark.parametrize("seed,mismatch", [(12, 0.15), (5, 0.03)])
def test_global_sfm_from_matches_with_jax_draws(seed, mismatch):
    xy, pm, gt_C, _ = _synthetic_observations(np.random.default_rng(seed),
                                              mismatch_frac=mismatch)
    with jax_draws() as records:
        rj = jglobal.global_sfm_from_matches(
            xy, pm, K_OBS, len(xy), jglobal.SfMConfig(min_matches=20))
    replay = Replay(records)
    rt = tglobal.global_sfm_from_matches(xy, pm, K_OBS, len(xy),
                                         SfMConfig(min_matches=20),
                                         sampler=replay, device="cpu")
    assert replay.used == len(records) == len(pm)
    assert sorted(rt.poses) == sorted(rj.poses) == list(range(len(xy)))
    cj = np.stack([rj.poses[i][1] for i in sorted(rj.poses)])
    ct = np.stack([rt.poses[i][1] for i in sorted(rt.poses)])
    assert np.abs(ct - cj).max() < 1e-3
    assert abs(rt.reproj_rms - rj.reproj_rms) < 1e-3
    assert rt.track_obs == rj.track_obs
    assert abs(ate(ct, gt_C)["max"] - ate(cj, gt_C)["max"]) < 1e-3
