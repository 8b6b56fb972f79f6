"""PyTorch port vs the JAX package: the optical flow
(``hcmvs_tpu_torch/dense/flow.py``: Farneback and LK) and the flow term
of the cost (``score.flow_score`` and its blend in
``patchmatch.finish_cost``).

Inputs: views of the 96x128 plane scene (camera 0 against camera 1), and
for Farneback the committed JPEG photos p00 -> p01
(tests/data/jpeg/photos, gray, reduced with INTER_AREA below 960x1280),
the same numpy arrays through both packages (JAX on the CPU; its
Farneback is cv2's).

Tolerances: window sums within 1e-5 relative (float32 sums in another
order); the flow upsampling within 5e-6 px of ``jax.image.resize`` at
the pyramid sizes of 960x1280 and at odd sizes (the weights are
computed in another order); the LK flow (up to 43 px here) within 1e-2
px everywhere and 1e-3 px on >= 97% of pixels (the 2x2 solve divides by
small determinants, which amplifies rounding over 15 iterations);
Farneback's blur and resize within 1e-4 of cv2's on 0-255 values (one
or two f32 ulps: sums in another order), its flow within 1e-3 px of
cv2's up to 480x640 (1 to 4 pyramid levels, and an odd size), and at
960x1280 within 5e-3 px with >= 99.9% of pixels within 1e-3 px; the flow
score and the blended cost within 1e-5.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JConfig
from hcmvs_tpu.dense import flow as jflow
from hcmvs_tpu.dense import patchmatch as jpm
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.dense import score as jscore
from hcmvs_tpu_torch.convert import geometry_from_numpy, scene_from_numpy
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import flow as tflow
from hcmvs_tpu_torch.dense import patchmatch as tpm
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.dense import score as tscore
from hcmvs_tpu_torch.utils.synth import make_plane_scene

torch.set_num_threads(1)
H, W, N = 96, 128, 3
BACKENDS = ("farneback", "lk")


@contextlib.contextmanager
def flow_backend(backend: str):
    """Both packages' default flow backend set to ``backend``:
    "farneback" is each package's own default (cv2 imports here), "lk"
    patches the JAX package's ``_HAVE_CV2`` to False and the port's
    ``DEFAULT_BACKEND`` to "lk"."""
    assert backend in BACKENDS
    with pytest.MonkeyPatch.context() as mp:
        if backend == "lk":
            mp.setattr(jflow, "_HAVE_CV2", False)
            mp.setattr(tflow, "DEFAULT_BACKEND", "lk")
        yield


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def world():
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    grays = np.stack(sc.images).astype(np.float32)
    flow01 = _np(jflow.lk_flow(jnp.asarray(grays[0]), jnp.asarray(grays[1])))
    return dict(sc=sc, grays=grays, flow01=flow01)


def test_box_sum_matches_reduce_window():
    x = np.random.default_rng(0).uniform(-1, 1, (37, 45)).astype(np.float32)
    for r in (1, 7):
        np.testing.assert_allclose(
            tflow._box_sum(torch.from_numpy(x), r).numpy(),
            _np(jflow._box_sum(jnp.asarray(x), r)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((240, 320), (480, 640)),
                                     ((480, 640), (960, 1280)),
                                     ((120, 160), (240, 320)),
                                     ((8, 11), (15, 21)), ((5, 3), (9, 6))])
def test_flow_upsampling_matches_jax_resize(src, dst):
    f = np.random.default_rng(1).uniform(-3, 3, (2,) + src).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(f), (2,) + dst, "bilinear")
    out = tflow.upsample_flow(torch.from_numpy(f), *dst)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=5e-6)


def test_lk_flow_matches(world):
    g = world["grays"]
    out = tflow.lk_flow(torch.from_numpy(g[0]), torch.from_numpy(g[1]))
    err = np.abs(out.numpy() - world["flow01"]).max(0)
    assert (err <= 1e-3).mean() >= 0.97, (err <= 1e-3).mean()
    assert err.max() <= 1e-2, err.max()
    # the camera moves sideways: the flow is far from zero
    assert np.abs(world["flow01"][0]).mean() > 1.0


def test_scene_flows_match(world):
    g = world["grays"]
    nbr = np.array([[1, 2], [0, 2], [1, 0]], np.int32)
    ref = jflow.scene_flows(g, nbr, backend="lk")
    out = tflow.scene_flows(torch.from_numpy(g), nbr, backend="lk")
    assert out.shape == (N, 2, H, W)
    err = np.abs(out.numpy() - ref).max(1)
    assert (err <= 1e-3).mean() >= 0.97 and err.max() <= 1e-2


def test_scene_flows_default_backend_matches(world):
    """No backend named on either side: Farneback in both packages (cv2
    imports here); under ``flow_backend("lk")`` both take LK."""
    g = world["grays"]
    nbr = np.array([[1, 2], [0, 2], [1, 0]], np.int32)
    ref = jflow.scene_flows(g, nbr)
    out = tflow.scene_flows(torch.from_numpy(g), nbr)
    assert np.abs(out.numpy() - ref).max() <= 1e-3
    assert np.abs(ref).max() > 1.0
    assert np.array_equal(
        ref, jflow.scene_flows(g, nbr, backend="farneback"))
    with flow_backend("lk"):
        lk = tflow.scene_flows(torch.from_numpy(g), nbr)
        assert np.array_equal(lk.numpy(), tflow.scene_flows(
            torch.from_numpy(g), nbr, backend="lk").numpy())
        assert not jflow._HAVE_CV2
    with pytest.raises(ValueError, match="backend"):
        tflow.scene_flows(torch.from_numpy(g), nbr, backend="tvl1")


def _photo(i: int, h: int, w: int) -> np.ndarray:
    """Committed photo i in gray at (h, w) as [0, 1] f32 (INTER_AREA)."""
    cv2 = pytest.importorskip("cv2")
    path = os.path.join(os.path.dirname(__file__), "data", "jpeg", "photos",
                        f"p{i:02d}.jpg")
    g = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if g.shape != (h, w):
        g = cv2.resize(g, (w, h), interpolation=cv2.INTER_AREA)
    return g.astype(np.float32) / 255.0


@pytest.mark.parametrize("hw,levels", [((48, 64), 1), ((96, 128), 2),
                                       ((240, 320), 3), ((480, 640), 4),
                                       ((97, 131), 2), ((960, 1280), 4)])
def test_farneback_matches_cv2(hw, levels):
    """The port's Farneback against cv2's through the JAX package, p00 ->
    p01, at 1 to 4 pyramid levels and an odd size."""
    a, b = _photo(0, *hw), _photo(1, *hw)
    assert tflow.pyramid_levels(*hw) == levels
    ref = jflow.farneback_flow(a, b)
    out = tflow.farneback_flow(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == (2,) + hw
    err = np.abs(out.numpy() - ref).max(0)
    if hw == (960, 1280):
        assert err.max() <= 5e-3, err.max()
        assert (err <= 1e-3).mean() >= 0.999, (err <= 1e-3).mean()
    else:
        assert err.max() <= 1e-3, err.max()
    assert np.abs(ref).max() > 5.0          # the flow is far from zero


def test_farneback_stages_match_cv2():
    """The Gaussian blur of each pyramid level and the bilinear resize
    (exact 2x, integer and odd ratios, and the flow's enlargement)
    against cv2's own, on 0-255 values."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (97, 131)).astype(np.float32)
    for ksize, sigma in ((3, 0.0), (3, 0.5), (9, 1.5), (19, 3.5)):
        ref = cv2.GaussianBlur(img, (ksize, ksize), sigma, sigmaY=sigma)
        out = tflow._gaussian_blur(torch.from_numpy(img),
                                   tflow._gaussian_taps(ksize, sigma))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    for src, dst in (((96, 128), (48, 64)), ((96, 128), (24, 32)),
                     ((97, 131), (48, 66)), ((97, 131), (12, 16)),
                     ((24, 33), (48, 66))):
        x = img[:src[0], :src[1]].copy()
        ref = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
        out = tflow._resize_linear(torch.from_numpy(x), *dst)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def _scene(world):
    sc = world["sc"]
    cams = JCamera(K=jnp.stack([jnp.asarray(c.K.numpy()) for c in sc.cameras]),
                   R=jnp.stack([jnp.asarray(c.R.numpy()) for c in sc.cameras]),
                   C=jnp.stack([jnp.asarray(c.C.numpy()) for c in sc.cameras]))
    nbr = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
    flows = np.stack([world["flow01"]] * N)
    return jsd.SceneTensors(
        gray=jnp.asarray(world["grays"]), cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((N, 2), bool),
        d_min=jnp.full((N,), sc.d_min, jnp.float32),
        d_max=jnp.full((N,), sc.d_max, jnp.float32),
        flows=jnp.asarray(flows))


def _hypotheses(world):
    sc = world["sc"]
    rng = np.random.default_rng(2)
    gt = (sc.depth_gt * (1 + 0.02 * rng.standard_normal((H, W)))).astype(
        np.float32)
    far = np.full((H, W), sc.d_max * 3, np.float32)     # projects outside
    n = np.broadcast_to(sc.normal_gt[:, None, None], (3, H, W)).astype(
        np.float32)
    return [(gt, n), (far, n)]


def test_flow_score_matches(world):
    jscene = _scene(world)
    cfg = JConfig()
    ctx_j = jsd._per_view_context(jscene, 0, None, None, cfg)
    geom_t = geometry_from_numpy(ctx_j.geom, device="cpu")
    rays = torch.from_numpy(_np(ctx_j.rays))
    flow = torch.from_numpy(world["flow01"])
    for depth, _ in _hypotheses(world):
        ref = jscore.flow_score(ctx_j.geom, jnp.asarray(depth), ctx_j.rays,
                                jnp.asarray(world["flow01"]))
        out = tscore.flow_score(geom_t, torch.from_numpy(depth), rays, flow)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-5)
    assert 0.0 <= float(out.min()) and float(out.max()) <= 2.0


@pytest.mark.parametrize("phase", [0, 1])
def test_finish_cost_blends_flow(world, phase):
    """The cost after the photometric term, with the flow blended into
    view 0's score (ref: DepthMap.cpp:741-792), against JAX's."""
    jscene = _scene(world)
    cfg_j = JConfig(use_geo_consistency=0)
    cfg_t = TConfig(use_geo_consistency=0)
    ctx_j = jsd._per_view_context(jscene, 0, None, None, cfg_j)
    tscene = scene_from_numpy(jscene, device="cpu")
    ctx_t = dataclasses.replace(
        tsd._per_view_context(tscene, 0, None, None, cfg_t),
        geom=geometry_from_numpy(ctx_j.geom, device="cpu"))
    assert ctx_t.flow is not None
    rng = np.random.default_rng(3)
    ncc = rng.uniform(0, 1.2, (2, H, W)).astype(np.float32)
    bad = rng.uniform(size=(2, H, W)) < 0.1
    for depth, normal in _hypotheses(world):
        args = (depth, normal, depth, normal)
        ref = jpm.finish_cost(ctx_j, jnp.asarray(ncc), jnp.asarray(bad),
                              *map(jnp.asarray, args), jnp.float32(1.0),
                              cfg_j, phase)
        out = tpm.finish_cost(ctx_t, torch.from_numpy(ncc),
                              torch.from_numpy(bad),
                              *map(torch.from_numpy, args),
                              torch.tensor(1.0), cfg_t, phase)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-5)
        no_flow = tpm.finish_cost(
            dataclasses.replace(ctx_t, flow=None), torch.from_numpy(ncc),
            torch.from_numpy(bad), *map(torch.from_numpy, args),
            torch.tensor(1.0), cfg_t, phase)
        assert not torch.equal(out, no_flow)
