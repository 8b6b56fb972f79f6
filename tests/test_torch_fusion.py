"""PyTorch port vs the JAX package: cross-view filter, gap interpolation,
re-propagation, the mid-schedule ``optimize_maps`` and point-cloud fusion
(``hcmvs_tpu_torch/dense/fusion.py``).

Inputs: a 4-view, 48x64 plane scene (every view's neighbours are the
other three); per-view depth maps from the analytic plane with 0.1%
noise, patches pushed 8% off the plane (cross-view disagreement), and
invalid runs of 1 to 12 pixels along rows and columns plus one large
hole; normals near the plane's; random confidences.  The same numpy
arrays go through both packages (JAX on the CPU).

Tolerances: float outputs within 1e-5 relative (1e-6 absolute for
values near zero); integer and boolean outputs, and the ragged view
lists of the compacted cloud, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmvs_tpu.core.camera import Camera as JCamera
from hcmvs_tpu.core.config import DenseConfig as JConfig
from hcmvs_tpu.dense import fusion as jf
from hcmvs_tpu.dense import scene_driver as jsd
from hcmvs_tpu.dense.types import pixel_rays as jrays
from hcmvs_tpu.ops.gradients import sobel_magnitude as jsobel
from hcmvs_tpu_torch.core.camera import Camera as TCamera
from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
from hcmvs_tpu_torch.dense import fusion as tf
from hcmvs_tpu_torch.dense import scene_driver as tsd
from hcmvs_tpu_torch.utils.synth import make_plane_scene, plane_depth_of_view

torch.set_num_threads(1)
H, W, N = 48, 64, 4


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def maps():
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W, n_views=N)
    rng = np.random.default_rng(1)
    depths, normals = [], []
    for v in range(N):
        d = plane_depth_of_view(sc, v) * (1 + 1e-3 * rng.standard_normal(
            (H, W)))
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 10)
        d[y:y + 8, x:x + 10] *= 1.08
        for _ in range(14):                       # row runs
            y, x, n = rng.integers(0, H), rng.integers(0, W), \
                rng.integers(1, 13)
            d[y, x:x + n] = 0
        for _ in range(10):                       # column runs
            y, x, n = rng.integers(0, H), rng.integers(0, W), \
                rng.integers(1, 13)
            d[y:y + n, x] = 0
        d[30:42, 40:56] = 0                        # a large hole
        depths.append(d)
        R = sc.cameras[v].R.numpy().astype(np.float64)
        n_c = R @ sc.n_w
        n_c = -n_c if n_c[2] > 0 else n_c
        nrm = n_c[:, None, None] + 0.05 * rng.standard_normal((3, H, W))
        normals.append(nrm / np.linalg.norm(nrm, axis=0))
    tcams = TCamera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                      for f in "KRC"))
    jcams = JCamera(*(jnp.asarray(getattr(tcams, f).numpy())
                      for f in "KRC"))
    nbr = np.array([[j for j in range(N) if j != i] for i in range(N)],
                   np.int32)
    valid = np.ones((N, N - 1), bool)
    valid[2, 2] = False
    return dict(
        sc=sc, tcams=tcams, jcams=jcams, nbr=nbr, valid=valid,
        depth=np.stack(depths).astype(np.float32),
        normal=np.stack(normals).astype(np.float32),
        conf=rng.uniform(0.2, 0.95, (N, H, W)).astype(np.float32),
        cost=rng.uniform(0.05, 0.8, (N, H, W)).astype(np.float32),
        colors=rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32),
        gray=np.stack(sc.images).astype(np.float32))


def test_conf_to_weight_matches(maps):
    _close(tf.conf_to_weight(_t(maps["conf"]), _t(maps["depth"])),
           jf.conf_to_weight(jnp.asarray(maps["conf"]),
                             jnp.asarray(maps["depth"])))


def test_cross_view_filter_matches(maps):
    m = maps
    ref = jf.cross_view_filter(
        jnp.asarray(m["depth"]), jnp.asarray(m["normal"]),
        jnp.asarray(m["conf"]), m["jcams"], jnp.asarray(m["nbr"]),
        jnp.asarray(m["valid"]), JConfig())
    out = tf.cross_view_filter(
        _t(m["depth"]), _t(m["normal"]), _t(m["conf"]), m["tcams"],
        _t(m["nbr"]).long(), _t(m["valid"]), TConfig())
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    assert np.array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert 0 < (out[0] > 0).float().mean() < (_t(m["depth"]) > 0).float(
        ).mean()                                # the filter removed some


@pytest.mark.parametrize("with_gra,with_normal", [(False, False),
                                                  (True, False),
                                                  (False, True),
                                                  (True, True)])
def test_gap_interpolate_matches(maps, with_gra, with_normal):
    d, c = maps["depth"][1], maps["conf"][1]
    gra = np.asarray(jsobel(jnp.asarray(maps["gray"][1])))
    kw_j, kw_t = {}, {}
    if with_gra:
        kw_j["gra"], kw_t["gra"] = jnp.asarray(gra), _t(gra)
    if with_normal:
        kw_j["normal"] = jnp.asarray(maps["normal"][1])
        kw_t["normal"] = _t(maps["normal"][1])
    ref = jf.gap_interpolate(jnp.asarray(d), jnp.asarray(c), JConfig(),
                             **kw_j)
    out = tf.gap_interpolate(_t(d), _t(c), TConfig(), **kw_t)
    assert len(out) == len(ref) == (3 if with_normal else 2)
    for a, b in zip(out, ref):
        _close(a, b)
    filled = (out[0].numpy() > 0).sum() - (d > 0).sum()
    assert filled > 0


def test_gap_repropagate_matches(maps):
    m = maps
    i = 2
    fuse = m["depth"][i].copy()
    fuse[5:25, 5:30] = 0
    gra = np.array(jsobel(jnp.asarray(m["gray"][i])))
    gra[::3] *= 3.0                      # both texture radii occur
    rays_j = jrays(jax.tree.map(lambda x: x[i], m["jcams"]).K_inv, H, W)
    args = (fuse, m["normal"][i], m["depth"][i], m["normal"][i],
            m["conf"][i], gra)
    ref = jf.gap_repropagate(*map(jnp.asarray, args), rays_j, JConfig())
    out = tf.gap_repropagate(*map(_t, args), _t(rays_j), TConfig())
    for a, b in zip(out, ref):
        _close(a, b)
    assert (out[0].numpy() > 0).sum() > (fuse > 0).sum()


def test_fuse_and_compact_match(maps):
    m = maps
    priority = np.argsort(np.argsort(-m["valid"].sum(1))).astype(np.float32)
    cfg_j, cfg_t = JConfig(), TConfig()
    ref = jf.fuse_point_cloud(
        jnp.asarray(m["depth"]), jnp.asarray(m["normal"]),
        jnp.asarray(m["conf"]), m["jcams"], jnp.asarray(m["nbr"]),
        jnp.asarray(m["valid"]), jnp.asarray(priority), cfg_j,
        colors=jnp.asarray(m["colors"]), with_colors=True)
    out = tf.fuse_point_cloud(
        _t(m["depth"]), _t(m["normal"]), _t(m["conf"]), m["tcams"],
        _t(m["nbr"]).long(), _t(m["valid"]), _t(priority), cfg_t,
        colors=_t(m["colors"]), with_colors=True)
    assert out.keys() == ref.keys()
    for k in ("support", "keep", "nbr_agree"):
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k])), k
    for k in ("points", "normals", "colors", "weights", "nbr_conf"):
        _close(out[k], ref[k])
    cj = jf.compact_point_cloud(ref, nbr_idx=m["nbr"], confs=m["conf"])
    ct = tf.compact_point_cloud(out, nbr_idx=_t(m["nbr"]),
                                confs=_t(m["conf"]))
    assert ct.keys() == cj.keys()
    for k in ("support", "owner_view", "view_counts", "view_ids"):
        assert ct[k].dtype == cj[k].dtype
        assert np.array_equal(ct[k], cj[k]), k
    for k in ("points", "normals", "colors", "weights", "view_confs"):
        assert ct[k].dtype == cj[k].dtype
        _close(ct[k], cj[k])
    assert len(cj["points"]) > 1000 and cj["view_counts"].max() > 1
    plain_t = tf.compact_point_cloud(out)
    plain_j = jf.compact_point_cloud(ref)
    assert plain_t.keys() == plain_j.keys()
    assert np.array_equal(plain_t["owner_view"], plain_j["owner_view"])


def test_optimize_maps_matches(maps):
    m = maps
    jscene = jsd.SceneTensors(
        gray=jnp.asarray(m["gray"]), cams=m["jcams"],
        nbr_idx=jnp.asarray(m["nbr"]), nbr_valid=jnp.asarray(m["valid"]),
        d_min=jnp.full((N,), m["sc"].d_min, jnp.float32),
        d_max=jnp.full((N,), m["sc"].d_max, jnp.float32))
    jstate = jsd.SceneState(depth=jnp.asarray(m["depth"]),
                            normal=jnp.asarray(m["normal"]),
                            cost=jnp.asarray(m["cost"]),
                            keys=jax.random.split(jax.random.PRNGKey(0), N))
    ref = jsd.optimize_maps(jstate, jscene, JConfig())
    tscene = tsd.SceneTensors(
        gray=_t(m["gray"]), cams=m["tcams"], nbr_idx=_t(m["nbr"]).long(),
        nbr_valid=_t(m["valid"]),
        d_min=torch.full((N,), m["sc"].d_min),
        d_max=torch.full((N,), m["sc"].d_max))
    out = tsd.optimize_maps(tsd.SceneState(
        depth=_t(m["depth"]), normal=_t(m["normal"]), cost=_t(m["cost"])),
        tscene, TConfig())
    _close(out.depth, ref.depth)
    _close(out.normal, ref.normal)
    assert np.array_equal(out.cost.numpy(), m["cost"])
    assert not np.array_equal(out.depth.numpy(), m["depth"])

