"""PyTorch port vs the JAX package: the golden quality gate
(``eval/golden.py``) and the depth / normal map comparisons
(``eval/compare.py``).

``golden.run`` of both packages on the CPU at 96x128 with 5 views: the
smallest size at which the JAX package's SfM registers every view (at
72x96 it registers 2 of 5).  The SfM halves draw their own RANSAC samples,
so their numbers are bounded, not matched; the dense half runs from the
ground-truth poses.  Gates, as chip_smoke.py's phase 25 holds the card's
run: depth_acc_2pct within 0.03, cloud_dist within 25%, mesh_fscore within
0.05, registered equal, ate_rmse at most the JAX package's + 0.05 and
sfm_rms_px at most its + 0.1 px.  ``compare_depth_maps`` /
``compare_normal_maps``: equal on maps of one size, within 1e-6 where the
ground truth is resized (cv2's INTER_LINEAR in the JAX package, the
port's ``resize_linear``).  The mesh step: the JAX package reports -1.0
when it fails, the port raises.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 96, 128


@pytest.fixture(scope="module")
def runs():
    from hcmvs_tpu.eval import golden as jgolden
    from hcmvs_tpu_torch.eval import golden
    return (jgolden.run(h=H, w=W), golden.run(h=H, w=W, device="cpu"))


def test_golden_run_matches_jax(runs):
    ref, out = runs
    assert set(out) == set(ref)
    assert ref["registered"] == out["registered"] == 5
    assert abs(out["depth_acc_2pct"] - ref["depth_acc_2pct"]) <= 0.03
    assert abs(out["cloud_dist"] - ref["cloud_dist"]) <= 0.25 * ref[
        "cloud_dist"]
    assert abs(out["mesh_fscore"] - ref["mesh_fscore"]) <= 0.05
    assert out["ate_rmse"] <= ref["ate_rmse"] + 0.05
    assert out["sfm_rms_px"] <= ref["sfm_rms_px"] + 0.1
    assert abs(out["n_points"] - ref["n_points"]) <= 0.05 * ref["n_points"]


def test_mesh_step_raises_where_jax_reports_minus_one(runs, monkeypatch):
    """A graph cut that fails: the JAX package's run catches it and
    reports mesh_fscore -1.0 (its jitted steps are warm by now); the
    port's mesh step raises."""
    from hcmvs_tpu.eval import golden as jgolden
    from hcmvs_tpu.mesh import delaunay as jdelaunay
    from hcmvs_tpu_torch.eval import golden
    from hcmvs_tpu_torch.mesh import delaunay
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene

    def broken(*args, **kwargs):
        raise RuntimeError("graph cut failed")

    monkeypatch.setattr(jdelaunay, "reconstruct_mesh", broken)
    assert jgolden.run(h=H, w=W)["mesh_fscore"] == -1.0
    monkeypatch.setattr(delaunay, "reconstruct_mesh", broken)
    sc = make_ridge_scene(np.random.default_rng(0), h=H, w=W, n_views=5,
                          spacing=0.25, fx=180.0 * W / 192.0)
    pts = np.stack(np.meshgrid(np.linspace(-1, 1, 15),
                               np.linspace(-1, 1, 15), [4.0]),
                   -1).reshape(-1, 3)
    cloud = {"points": pts.astype(np.float32),
             "view_counts": np.ones(len(pts), np.int64),
             "view_ids": np.zeros(len(pts), np.int64),
             "view_confs": np.ones(len(pts), np.float32),
             "owner_view": np.zeros(len(pts), np.int64)}
    with pytest.raises(RuntimeError, match="graph cut failed"):
        golden.mesh_fscore(cloud, sc)


def test_compare_maps_match_jax():
    from hcmvs_tpu.eval import compare as jcompare
    from hcmvs_tpu_torch.eval import compare
    rng = np.random.default_rng(4)
    gt = rng.uniform(2, 6, (40, 56)).astype(np.float32)
    gt[:3] = 0
    est = (gt * rng.uniform(0.98, 1.02, gt.shape)).astype(np.float32)
    est[rng.random(gt.shape) < 0.1] = 0
    assert (compare.compare_depth_maps(est, gt, 0.01)
            == jcompare.compare_depth_maps(est, gt, 0.01))
    big = rng.uniform(2, 6, (60, 70)).astype(np.float32)
    a = compare.compare_depth_maps(est, big)
    b = jcompare.compare_depth_maps(est, big)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6), k
    n = rng.normal(size=(3, 40, 56)).astype(np.float32)
    n_gt = (n + 0.2 * rng.normal(size=n.shape)).astype(np.float32)
    assert (compare.compare_normal_maps(n, n_gt)
            == jcompare.compare_normal_maps(n, n_gt))
