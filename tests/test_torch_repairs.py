"""PyTorch port vs the JAX package: inputs the port once refused.

- A view that shares no sparse point with any other is paired with itself
  (``select_neighbors``); the zero-baseline pair has a singular
  rectification, whose inverse the port now takes without raising, as
  ``jnp.linalg.inv`` does.  ``estimate_scene`` with optimize, from the
  same (JAX) init, at 48x64 with 4 views of the plane scene, the last
  view isolated: every map finite, each view's kept share within 0.03 of
  the JAX package's, and the isolated view keeps nothing in either.
- ``--masks-dir`` is read only under ``use-semantic``, as in the JAX
  package: without it, densify runs and ignores the masks (with it they
  feed the planar priors: tests/test_torch_masks.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W, N = 48, 64, 4
SMALL = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, estimation_iters_external=3, random_iters=0,
             use_optical_flow=0, optimize=1, use_geo_consistency=1,
             use_part_consistency=0, resolution_level=0, min_resolution=0)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The plane scene as scene.mvs + PNGs, and the same scene with every
    sparse point seen by views 0-2 only."""
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.utils.synth import make_plane_scene, write_plane_scene
    root = tmp_path_factory.mktemp("repairs")
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N,
                          fx=180.0 * W / 192.0)
    scene_path, img_dir = write_plane_scene(str(root), sc)
    iso = read_mvs(scene_path)
    p = len(iso.points)
    iso.point_view_counts = np.full(p, N - 1, np.int32)
    iso.point_view_ids = np.tile(np.arange(N - 1, dtype=np.uint32), p)
    iso.point_view_confs = np.ones(p * (N - 1), np.float32)
    return dict(sc=sc, root=root, scene_path=scene_path, img_dir=img_dir,
                iso=iso)


def test_isolated_view_matches_jax(written):
    import jax
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.pipeline.densify import build_scene_tensors as jbuild
    from hcmvs_tpu_torch.convert import scene_from_numpy, state_from_numpy
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    from hcmvs_tpu_torch.pipeline.densify import build_scene_tensors
    grays = list(written["sc"].images)
    jcfg, tcfg = JConfig(**SMALL, **FORCED), TConfig(**SMALL)
    js = jbuild(written["iso"], grays, jcfg)
    ts = build_scene_tensors(written["iso"], grays, tcfg, device="cpu")
    assert np.asarray(js.nbr_idx)[N - 1].tolist() == [N - 1] * (N - 1)
    assert np.array_equal(ts.nbr_idx.numpy(), np.asarray(js.nbr_idx))
    assert not ts.nbr_valid[N - 1].any()
    key = jax.random.PRNGKey(0)
    ref = jsd.estimate_scene(key, js, jcfg)
    d_j = np.asarray(jsd.finalize(ref, jcfg)[0])
    out = tsd.estimate_scene(
        torch.Generator().manual_seed(0), scene_from_numpy(js, device="cpu"),
        tcfg, init=state_from_numpy(jsd.init_scene_state(key, js),
                                    device="cpu"))
    d_t = tsd.finalize(out, tcfg)[0].numpy()
    for x in (out.depth, out.normal, out.cost):
        assert torch.isfinite(x).all()
    kept_t = (d_t > 0).reshape(N, -1).mean(1)
    kept_j = (d_j > 0).reshape(N, -1).mean(1)
    assert np.abs(kept_t - kept_j).max() <= 0.03, (kept_t, kept_j)
    assert kept_t[N - 1] == kept_j[N - 1] == 0.0
    assert kept_t[:N - 1].min() > 0.5, kept_t


def test_masks_dir_without_use_semantic_runs(written, tmp_path):
    from hcmvs_tpu_torch.pipeline.densify import main
    masks = tmp_path / "masks"
    masks.mkdir()
    (masks / "im0000.png").write_bytes(b"")
    stats = main(["--input-file", written["scene_path"], "--images-dir",
                  written["img_dir"], "-w", str(tmp_path / "out"),
                  "--device", "cpu", "--masks-dir", str(masks),
                  "--fusion-mode", "1", "--flags", "use-semantic=0",
                  "resolution-level=0", "min-resolution=0",
                  "n-EstimationIters=1", "n-EstimationIters-external=2",
                  "n-adapthalfwin=3"])
    assert stats["depth"].shape == (N, H, W) and stats["valid_frac"] > 0.5
