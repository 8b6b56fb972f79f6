"""PyTorch port vs the JAX package: the GLOBAL preset (``global_sfm`` +
``refine_with_distortion``) on chip_smoke.py phase 16's photo scene, on
the CPU.

The scene is phase 16's: 8 ridge views 0.25 apart, focal 1200 px at
1280 wide, the photos through k1 = -0.15, written as 8-bit PNGs whose
``eXIf`` chunk holds FocalLengthIn35mmFilm = 33.75.  The cameras lie on a
line, so every pairwise direction is nearly the same.  There the JAX
package's ``rotation_to_rvec`` returns NaN for global SfM's gauge camera
(``R0 @ R0.T``, an identity whose trace rounds below 3: it divides 0 by
0) and its whole bundle turns NaN; the port returns the zero rotation.

The test, at 240x320: the port's relative poses of every pair (its
``global_sfm`` on the photos) go through the JAX package's rotation and
translation averaging, which must give the port's global rotations and
centres (1e-9, both host numpy); the port's ``rotation_to_rvec`` of each
global rotation must be finite, and equal to the JAX package's wherever
that is not NaN; the port's run registers all 8 views with finite poses
and points.  Whether the gauge camera's trace rounds far enough to give
the JAX package NaN depends on its last bits: with the JAX run's own
relative poses it does here and at 960x1280 (the script's NaN count),
with the port's here it does not; tests/test_torch_ba.py holds the
function on random rotations.

Run as a script, ``PYTHONPATH=. python tests/test_torch_global_photos.py
H W [jax] [port] [seed=S ...]`` runs the whole preset at H x W: the JAX
package with the port's ``rotation_to_rvec`` in place of its own
(replaced inside the run only; its own NaN count is printed) and the port
with a CPU generator seeded S (default 0), and prints the registered
views, k, the rms and the ATE.  chip_smoke.py phase 17's gate is the JAX
reading at 960 1280.  It is not a test: the JAX package's 28 pairwise
RANSACs take ~500 s on a CPU at any of these sizes.
"""

import os

import numpy as np
import pytest
import torch

from hcmvs_tpu.eval.pose_eval import ate
from hcmvs_tpu.sfm import ba as jba
from hcmvs_tpu.sfm import distortion as jdist
from hcmvs_tpu.sfm import global_sfm as jglobal
from hcmvs_tpu.utils import synth as jsynth
from hcmvs_tpu.utils.synth import make_ridge_scene

from hcmvs_tpu_torch.io.exif import scene_intrinsics_from_photos
from hcmvs_tpu_torch.io.images import list_images, load_image, to_gray
from hcmvs_tpu_torch.sfm import ba as tba
from hcmvs_tpu_torch.sfm import distortion as tdist
from hcmvs_tpu_torch.sfm import global_sfm as tglobal
from hcmvs_tpu_torch.sfm.two_view import generator_sampler
from hcmvs_tpu_torch.utils.synth import (blob_texture_fn, distort_images,
                                         write_photos)

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

H, W = 240, 320


def photo_scene(h: int, w: int, root: str):
    """chip_smoke.py phase 16's photos at H x W; returns (scene, the
    grayscale photos as read back, K from their EXIF)."""
    fx = 1200.0 * w / 1280
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=8,
                          fx=fx, spacing=0.25, texture_fn=blob_texture_fn(
                              np.random.default_rng(0), device="cpu"))
    photos = os.path.join(root, "photos")
    write_photos(photos, distort_images(sc.images, np.asarray(
        sc.cameras[0].K), np.array([-0.15, 0.0, 0.0])), fx * 36.0 / w)
    paths = list_images(photos)
    grays = [to_gray(load_image(p)).astype(np.float32) for p in paths]
    K, _ = scene_intrinsics_from_photos(paths, [w] * len(paths),
                                        [h] * len(paths))
    return sc, grays, K


def summary(res, k, sc) -> dict:
    reg = sorted(res.poses)
    est = np.stack([res.poses[i][1] for i in reg])
    gt = np.stack([np.asarray(sc.cameras[i].C) for i in reg])
    finite = bool(np.isfinite(est).all() and np.isfinite(res.points).all())
    return {"registered": len(reg), "finite": finite,
            "k": [float(x) for x in k], "rms_px": float(res.reproj_rms),
            "ate": ate(est, gt)["rmse"] if finite else float("nan")}


def test_blob_texture_on_a_device_matches_numpy():
    """The texture's torch loop (``device=``) against its numpy loop,
    which is the JAX package's bit for bit: within float32 rounding."""
    xy = np.random.default_rng(3).uniform(-3.5, 3.5, (40, 50, 2))
    want = jsynth.blob_texture_fn(np.random.default_rng(0))(xy)
    np.testing.assert_array_equal(
        blob_texture_fn(np.random.default_rng(0))(xy), want)
    got = blob_texture_fn(np.random.default_rng(0), device="cpu")(xy)
    assert got.dtype == np.float32 and got.shape == (40, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_global_averaging_on_the_photo_scene(tmp_path, monkeypatch):
    sc, grays, K = photo_scene(H, W, str(tmp_path))
    seen = {}

    def recording(name):
        orig = getattr(tglobal, name)

        def wrapped(*args):
            seen[name] = (args, orig(*args))
            return seen[name][1]
        return wrapped

    for name in ("rotation_averaging", "translation_averaging"):
        monkeypatch.setattr(tglobal, name, recording(name))
    res = tglobal.global_sfm(grays, K, device="cpu")
    s = summary(res, np.zeros(3), sc)
    assert s["registered"] == 8 and s["finite"], s

    (n, pairs, R_rel), R_glob = seen["rotation_averaging"]
    assert len(pairs) == 28
    np.testing.assert_allclose(jglobal.rotation_averaging(n, pairs, R_rel),
                               R_glob, rtol=0, atol=1e-9)
    (_, _, _, t_rel), C_glob = seen["translation_averaging"]
    np.testing.assert_allclose(
        jglobal.translation_averaging(n, pairs, R_glob, t_rel), C_glob,
        rtol=0, atol=1e-9)
    jax_rv = np.stack([jba.rotation_to_rvec(R) for R in R_glob])
    port_rv = np.stack([tba.rotation_to_rvec(R) for R in R_glob])
    assert np.isfinite(port_rv).all()
    ok = ~np.isnan(jax_rv).any(axis=1)
    np.testing.assert_array_equal(port_rv[ok], jax_rv[ok])


def jax_global(grays, K):
    """The JAX package's GLOBAL preset with the port's ``rotation_to_rvec``;
    returns (result, k, how often the JAX function gave NaN on the same
    rotations)."""
    nan = []

    def repaired(R):
        nan.append(bool(np.isnan(orig(R)).any()))
        return tba.rotation_to_rvec(R)

    orig = jba.rotation_to_rvec
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jba, "rotation_to_rvec", repaired)
        res = jglobal.global_sfm(grays, K)
        res, k = jdist.refine_with_distortion(res, K)
    return res, k, sum(nan)


def port_global(grays, K, seed: int = 0):
    sampler = generator_sampler(torch.Generator().manual_seed(seed))
    res = tglobal.global_sfm(grays, K, sampler=sampler, device="cpu")
    return tdist.refine_with_distortion(res, K, device="cpu")


if __name__ == "__main__":
    import sys
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    h, w = int(sys.argv[1]), int(sys.argv[2])
    args = sys.argv[3:]
    seeds = [int(a[5:]) for a in args if a.startswith("seed=")] or [0]
    runs = ([("jax", None)] if "jax" in args or "port" not in args else []
            ) + ([("port", s) for s in seeds]
                 if "port" in args or "jax" not in args else [])
    with tempfile.TemporaryDirectory() as root:
        sc, grays, K = photo_scene(h, w, root)
        for which, seed in runs:
            if which == "jax":
                res, k, n_nan = jax_global(grays, K)
            else:
                (res, k), n_nan = port_global(grays, K, seed), None
            print({"package": which, "seed": seed, "h": h, "w": w,
                   "f": float(K[0, 0]), **summary(res, k, sc),
                   "jax_nan_rvecs": n_nan}, flush=True)
