"""PyTorch port vs the JAX package: the mesh path on the CPU.

The native rasterizer and max-flow, the PLY / OBJ mesh I/O, graph-cut
reconstruction and the Clean pipeline, the mesh utilities, texturing
(LBP / TRW-S / ICM labels, atlas, OBJ + MTL + PNG), the three mesh apps
and densify's ``--sample-mesh``.  Inputs are made with numpy from a seed
and go through both packages; JAX runs on the CPU.  Tolerances: bit
equality where both sides run the same numpy / C++ code (rasterizer,
max-flow, reconstruction, clean-up, sampling); labels equal on at least
99.9% of faces (float32 messages summed in another order can flip a
tie); UVs within 1e-6; the atlas within 1 LSB (the JAX package shrinks a
chart with cv2.resize, the port with its own INTER_LINEAR).

    PYTHONPATH=. python tests/test_torch_mesh.py H W [jax|port] [lk]

runs both packages' mesh chain on the ridge scene of phases 12 and 14 of
chip_smoke.py at H x W (the masked densify on Farneback flow, or on LK
with ``lk``; a 60,000-point subsample, reconstruct, refine) and prints
the mesh F-scores before and after refine; chip_smoke.py's floor comes
from these numbers.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch

from hcmvs_tpu import native as jnative
from hcmvs_tpu.io import obj as jobj
from hcmvs_tpu.io import ply as jply
from hcmvs_tpu.mesh import delaunay as jdel
from hcmvs_tpu.mesh import mesh_ops as jops
from hcmvs_tpu.mesh import texture as jtex

from hcmvs_tpu_torch import native as tnative
from hcmvs_tpu_torch.io import obj as tobj
from hcmvs_tpu_torch.io.images import resize_linear
from hcmvs_tpu_torch.io import ply as tply
from hcmvs_tpu_torch.mesh import delaunay as tdel
from hcmvs_tpu_torch.mesh import mesh_ops as tops
from hcmvs_tpu_torch.mesh import texture as ttex
from test_torch_flow import flow_backend

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
LABEL_AGREE = 0.999


def _terrain_mesh(n=24, seed=0):
    """A wavy grid seen by a perspective camera (as tests/test_native.py)."""
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-0.8, 0.8, n))
    Z = 4.0 + 0.3 * np.sin(3 * X) + rng.normal(0, 0.02, X.shape)
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return V, np.asarray(faces, np.int32)


CAM = (np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1.0]]),
       np.eye(3), np.zeros(3))


def test_native_rasterizer_is_the_reference_and_matches_numpy():
    V, faces = _terrain_mesh()
    h, w = 96, 128
    d_t, f_t, b_t = tnative.rasterize(V, faces, *CAM, h, w)
    d_j, f_j, b_j = jnative.rasterize(V, faces, *CAM, h, w)
    # the same C++ source: bit-equal
    assert np.array_equal(d_t, d_j) and np.array_equal(f_t, f_j)
    assert np.array_equal(b_t, b_j)
    assert (f_t >= 0).mean() > 0.2
    # the port's plain version, the numpy scanline: the reference test's
    # bars (tests/test_native.py)
    d_p, f_p, b_p = tops.rasterize_attributes(V, faces, *CAM, h, w,
                                              backend="numpy")
    assert np.array_equal(d_t, d_p) and np.array_equal(f_t, f_p)
    np.testing.assert_allclose(b_t, b_p, atol=1e-6)
    assert np.array_equal(tops.rasterize_depth(V, faces, *CAM, h, w), d_t)
    assert np.array_equal(
        tops.rasterize_depth(V, faces, *CAM, h, w, backend="numpy"), d_t)
    with pytest.raises(ValueError):
        tops.rasterize_depth(V, faces, *CAM, h, w, backend="gl")


def _flow_instance(rng, n, m):
    eu = rng.integers(0, n, m).astype(np.int32)
    ev = rng.integers(0, n, m).astype(np.int32)
    keep = eu != ev
    eu, ev = eu[keep], ev[keep]
    cap_uv = rng.integers(0, 20, len(eu)).astype(np.float32)
    cap_vu = rng.integers(0, 20, len(eu)).astype(np.float32)
    cap_src = np.where(rng.random(n) < 0.3,
                       rng.integers(1, 30, n), 0).astype(np.float32)
    cap_snk = np.where(rng.random(n) < 0.3,
                       rng.integers(1, 30, n), 0).astype(np.float32)
    return n, eu, ev, cap_uv, cap_vu, cap_src, cap_snk


@pytest.mark.parametrize("seed", range(4))
def test_maxflow_matches_reference(seed):
    inst = _flow_instance(np.random.default_rng(seed), 60, 200)
    f_t, side_t = tnative.maxflow(*inst)
    f_j, side_j = jnative.maxflow(*inst)
    assert f_t == f_j and np.array_equal(side_t, side_j)
    # the plain version (scipy, integer capacities here) reaches the same
    # flow value
    f_s, side_s = tnative.maxflow_scipy(*inst, quantum=1.0)
    f_js, side_js = jnative._maxflow_scipy(*inst, quantum=1.0)
    assert f_s == pytest.approx(f_t, abs=1e-3)
    assert f_s == f_js and np.array_equal(side_s, side_js)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int main( { return 0; }\n")
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build("broken")
    assert not list((tmp_path / "_build").iterdir())   # no partial .so
    with pytest.raises(ValueError):
        tnative.maxflow(2, np.array([0]), np.array([5]), np.ones(1),
                        None, np.ones(2), np.ones(2))


def _observed_cloud(seed=0, n=300):
    """A noisy ridge sampled from three cameras, with every point's full
    (point, view, confidence) observation list."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = np.where(xy[:, 0] < 0, 3.0 + 0.4 * xy[:, 0], 3.0 - 0.3 * xy[:, 0])
    pts = np.column_stack([xy, z + rng.normal(0, 0.01, n)])
    cams = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [-0.5, 0.1, 0.0]])
    counts = rng.integers(1, 4, n)
    obs_pt = np.repeat(np.arange(n), counts)
    obs_cam = np.concatenate([rng.permutation(3)[:c] for c in counts])
    obs_w = rng.uniform(0.05, 1.0, len(obs_pt))
    owner = obs_cam[np.concatenate([[0], np.cumsum(counts)[:-1]])]
    return pts, cams, owner, obs_pt, obs_cam, obs_w


def test_reconstruct_and_clean_match():
    pts, cams, owner, obs_pt, obs_cam, obs_w = _observed_cloud()
    kw = dict(obs_pt=obs_pt, obs_cam=obs_cam, obs_weight=obs_w)
    mt = tdel.reconstruct_mesh(pts, cams, owner, **kw)
    mj = jdel.reconstruct_mesh(pts, cams, owner, **kw)
    assert len(mt.faces) > 100
    assert np.array_equal(mt.faces, mj.faces)
    assert np.array_equal(mt.vertices, mj.vertices)
    # owner-only rays, as without view lists
    assert np.array_equal(tdel.reconstruct_mesh(pts, cams, owner).faces,
                          jdel.reconstruct_mesh(pts, cams, owner).faces)
    ct = tops.clean_mesh(mt.vertices, mt.faces, min_component_faces=20,
                         smooth_iters=2, max_hole_size=30)
    cj = jops.clean_mesh(mj.vertices, mj.faces, min_component_faces=20,
                         smooth_iters=2, max_hole_size=30)
    assert np.array_equal(ct[0], cj[0]) and np.array_equal(ct[1], cj[1])
    # the plain max-flow gives a surface too
    ms = tdel.reconstruct_mesh(pts, cams, owner, maxflow_solver="scipy",
                               **kw)
    assert len(ms.faces) > 100
    with pytest.raises(ValueError):
        tdel.reconstruct_mesh(pts, cams, owner, maxflow_solver="ibfs")


def _mesh_op_cases():
    V, F = _terrain_mesh(10, seed=1)
    V = V.astype(np.float32)
    rng = np.random.default_rng(3)
    return {
        "decimate_qem": lambda m: m.decimate_mesh(V, F, 0.4),
        "decimate_cluster": lambda m: m.decimate_mesh(V, F, 0.4,
                                                      method="cluster"),
        "remove_small": lambda m: m.remove_small_components(V, F[:40], 30),
        "close_holes": lambda m: m.close_holes(
            V, np.delete(F, [40, 41, 42, 60], axis=0), 30),
        "smooth": lambda m: m.laplacian_smooth(V, F, 3),
        "normals": lambda m: m.compute_vertex_normals(V, F),
        "subdivide": lambda m: m.subdivide(V, F),
        "fix_non_manifold": lambda m: m.fix_non_manifold(
            V, np.concatenate([F, F[:5], [[0, 1, 12]]])),
        "sample_points": lambda m: m.sample_points(
            V, F, 500, np.random.default_rng(int(rng.integers(1 << 30)))),
    }


@pytest.mark.parametrize("case", list(_mesh_op_cases()))
def test_mesh_ops_match(case):
    fn_t = _mesh_op_cases()[case]
    fn_j = _mesh_op_cases()[case]
    out_t, out_j = fn_t(tops), fn_j(jops)
    if not isinstance(out_t, tuple):
        out_t, out_j = (out_t,), (out_j,)
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mesh_io_matches(tmp_path):
    V, F = _terrain_mesh(8)
    V = V.astype(np.float32)
    tply.write_ply_mesh(str(tmp_path / "t.ply"), V, F)
    jply.write_ply_mesh(str(tmp_path / "j.ply"), V, F)
    assert filecmp.cmp(tmp_path / "t.ply", tmp_path / "j.ply", shallow=False)
    vt, et = tply.read_ply(str(tmp_path / "j.ply"))
    vj, ej = jply.read_ply(str(tmp_path / "j.ply"))
    assert np.array_equal(vt, vj) and np.array_equal(et["faces"],
                                                     ej["faces"])
    # a polygon list (quads and a triangle) takes the per-face reader
    quads = np.empty(2, dtype=[("n", "u1"), ("v", "<i4", 4)])
    quads["n"] = 4
    quads["v"] = [[0, 1, 2, 3], [4, 5, 6, 7]]
    body = quads.tobytes() + np.array([3], "u1").tobytes() + \
        np.array([1, 2, 3], "<i4").tobytes()
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 8\n"
              "property float x\nproperty float y\nproperty float z\n"
              "element face 3\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    with open(tmp_path / "poly.ply", "wb") as f:
        f.write(header.encode() + V[:8].tobytes() + body)
    assert np.array_equal(tply.read_ply(str(tmp_path / "poly.ply"))[1]
                          ["faces"],
                          jply.read_ply(str(tmp_path / "poly.ply"))[1]
                          ["faces"])
    uv = np.random.default_rng(0).random((len(V), 2)).astype(np.float32)
    jobj.write_obj(str(tmp_path / "m.obj"), V, F, texcoords=uv,
                   face_texcoords=F, mtllib="m.mtl", material="mat")
    ot, oj = (m.read_obj(str(tmp_path / "m.obj")) for m in (tobj, jobj))
    for a, b in zip(ot, oj):
        assert (a == b if isinstance(a, (str, type(None)))
                else np.array_equal(a, b))


def _label_problem(seed=0, n=14, n_views=4):
    V, F = _terrain_mesh(n, seed)
    rng = np.random.default_rng(seed)
    qual = rng.uniform(0.0, 1.0, (len(F), n_views)).astype(np.float32)
    qual[rng.random(qual.shape) < 0.2] = 0.0
    qual[:3] = 0.0                                  # unlabelled faces
    return F, qual


@pytest.mark.parametrize("solver", ["lbp", "trws", "icm"])
def test_labels_match(solver):
    F, qual = _label_problem()
    if solver == "icm":
        lt, lj = ttex.label_faces(F, qual), jtex.label_faces(F, qual)
    else:
        lt = getattr(ttex, f"label_faces_{solver}")(F, qual, device="cpu")
        lj = getattr(jtex, f"label_faces_{solver}")(F, qual)
    assert lt.dtype == lj.dtype == np.int64
    assert (lt == lj).mean() >= LABEL_AGREE
    assert np.array_equal(lt < 0, qual.max(1) <= 0) and (lt[:3] < 0).all()
    assert (ttex.labeling_energy(F, qual, lt)
            == pytest.approx(jtex.labeling_energy(F, qual, lj)))


def test_resize_matches_cv2():
    """cv2.resize INTER_LINEAR of uint8 images, shrinking and enlarging,
    gray and colour, the exact halving included: within 1 LSB (measured
    equal)."""
    import cv2
    rng = np.random.default_rng(0)
    for t in range(60):
        h, w = rng.integers(2, 90, 2)
        size = (int(rng.integers(1, 2 * w)), int(rng.integers(1, 2 * h)))
        if t == 0:
            h, w, size = 40, 60, (30, 20)
        img = rng.integers(0, 256, (h, w) if t % 2 else (h, w, 3),
                           dtype=np.uint8)
        ours = resize_linear(img, size[1], size[0])
        ref = cv2.resize(img, size)
        assert ours.shape == ref.shape and ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - ref).max() <= 1


def _two_view_scene():
    """Grid mesh on a textured z=4 plane; two laterally offset views each
    covering about one half (as tests/test_mesh.py)."""
    h, w = 96, 128
    K = np.array([[170.0, 0, w / 2], [0, 170.0, h / 2], [0, 0, 1.0]])
    Cs = np.array([[-0.75, 0.0, 0.0], [0.75, 0.0, 0.0]])
    Rs = np.stack([np.eye(3), np.eye(3)])
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    ray = np.linalg.inv(K) @ np.stack([uu.ravel(), vv.ravel(),
                                       np.ones(h * w)])
    imgs = []
    for v in range(2):
        X = Cs[v][:, None] + ray * (4.0 / ray[2])
        img = (0.5 + 0.25 * np.sin(5.1 * X[0] + 3.3 * X[1])
               + 0.25 * np.sin(9.7 * X[0] * X[1] + 1.0)).reshape(h, w)
        if v == 1:
            img = img + np.linspace(-0.15, 0.15, w)[None, :]
        imgs.append(np.clip(img, 0, 1).astype(np.float32))
    n = 10
    X, Y = np.meshgrid(np.linspace(-1.0, 1.0, n), np.linspace(-1.0, 1.0, n))
    verts = np.stack([X.ravel(), Y.ravel(), np.full(n * n, 4.0)], 1)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i
            faces += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
    return (verts, np.asarray(faces, np.int32), imgs, np.stack([K, K]), Rs,
            Cs)


@pytest.mark.parametrize("atlas_size", [64, 256])
def test_texture_mesh_matches(atlas_size, tmp_path):
    """At 64 every chart is larger than the atlas, so it is shrunk (cv2 in
    the JAX package, ``io.images.resize_linear`` in the port)."""
    import cv2
    verts, faces, imgs, Ks, Rs, Cs = _two_view_scene()
    tt = ttex.texture_mesh(verts, faces, imgs, Ks, Rs, Cs,
                           atlas_size=atlas_size, device="cpu")
    tj = jtex.texture_mesh(verts, faces, imgs, Ks, Rs, Cs,
                           atlas_size=atlas_size)
    assert (tt.labels == tj.labels).mean() >= LABEL_AGREE
    same = tt.labels == tj.labels
    np.testing.assert_allclose(tt.uvs[same], tj.uvs[same], rtol=0,
                               atol=1e-6)
    assert np.abs(tt.atlas.astype(int) - tj.atlas).max() <= 1
    assert tt.atlas.max() > 0 and tt.utilization == tj.utilization
    ttex.write_textured_obj(str(tmp_path / "t.obj"), tt)
    back = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back[..., ::-1], tt.atlas)
    jtex.write_textured_obj(str(tmp_path / "j.obj"), tt)
    assert filecmp.cmp(tmp_path / "t.obj", tmp_path / "j.obj",
                       shallow=False) is False   # only the mtllib name
    t_lines = open(tmp_path / "t.obj").read().splitlines()[1:]
    j_lines = open(tmp_path / "j.obj").read().splitlines()[1:]
    assert t_lines == j_lines


@pytest.fixture(scope="module")
def dense_scene(tmp_path_factory):
    """A 3-view ridge scene densified on the CPU by the port."""
    from hcmvs_tpu_torch.pipeline import densify
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn,
                                             write_ridge_scene)
    root = tmp_path_factory.mktemp("mesh_apps")
    h, w = 48, 64
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=3,
                          fx=180.0 * w / 192.0,
                          texture_fn=sinusoid_texture_fn(
                              np.random.default_rng(1)))
    path, img_dir = write_ridge_scene(str(root / "ridge"), sc)
    densify.main(["--input-file", path, "--images-dir", img_dir, "-w",
                  str(root / "dense"), "--device", "cpu", "--flags",
                  "resolution-level=0", "min-resolution=0",
                  "n-EstimationIters=1", "n-EstimationIters-external=3",
                  "n-adapthalfwin=3"])
    return root, str(root / "dense" / "scene_dense.mvs"), img_dir


def test_mesh_apps_match(dense_scene):
    """reconstruct -> refine -> texture through both packages' apps on the
    same scene_dense.mvs: equal mesh, refined vertices within the refine
    tolerance of tests/test_torch_refine.py, labels, UVs and atlas as
    above."""
    from hcmvs_tpu.pipeline import mesh_apps as japps
    from hcmvs_tpu_torch.pipeline import mesh_apps as tapps
    root, mvs, img_dir = dense_scene
    out = {}
    for name, apps, extra in (("t", tapps, ["--device", "cpu"]),
                              ("j", japps, [])):
        base = str(root / f"{name}_mesh")
        apps.main(["reconstruct", "-i", mvs, "-o", base + ".ply"])
        apps.main(["refine", "-i", mvs, "-m", base + ".ply",
                   "--images-dir", img_dir] + extra)
        apps.main(["texture", "-i", mvs, "-m", base + "_refine.ply",
                   "--images-dir", img_dir] + extra)
        out[name] = base
    (vt, et), (vj, ej) = (tply.read_ply(out[k] + ".ply") for k in "tj")
    assert len(et["faces"]) > 100
    assert np.array_equal(vt, vj) and np.array_equal(et["faces"],
                                                     ej["faces"])
    rt = tply.read_ply(out["t"] + "_refine.ply")[0]
    rj = tply.read_ply(out["j"] + "_refine.ply")[0]
    moved = np.abs(rj - vj).max(1)
    dv = np.abs(rt - rj).max(1)
    assert np.median(dv) <= 0.05 * np.median(moved), (np.median(dv),
                                                      np.median(moved))
    ot, oj = (tobj.read_obj(out[k] + "_refine_texture.obj") for k in "tj")
    assert np.array_equal(ot.faces, oj.faces)
    assert len(ot.texcoords) == len(oj.texcoords) == 3 * len(ot.faces)
    import cv2
    at = cv2.imread(out["t"] + "_refine_texture.png")
    aj = cv2.imread(out["j"] + "_refine_texture.png")
    assert at.shape == aj.shape == (1024, 1024, 3) and at.max() > 0
    # the atlases are gray in three channels (cmd_texture's gray images)
    assert (at[..., 0] == at[..., 1]).all() and (at[..., 1]
                                                 == at[..., 2]).all()
    mtl = open(out["t"] + "_refine_texture.mtl").read()
    assert "map_Kd t_mesh_refine_texture.png" in mtl


def test_sample_mesh_matches(dense_scene):
    from hcmvs_tpu.pipeline import densify as jdens
    from hcmvs_tpu_torch.pipeline import densify as tdens
    root, mvs, _ = dense_scene
    V, F = _terrain_mesh(12)
    tply.write_ply_mesh(str(root / "s.ply"), V.astype(np.float32), F)
    tobj.write_obj(str(root / "s.obj"), V.astype(np.float32), F)
    for src, flag in (("s.ply", "-2000"), ("s.obj", "300")):
        for name, mod in (("t", tdens), ("j", jdens)):
            mod.main(["--input-file", str(root / src), "-w",
                      str(root / f"{name}_{src}"), "--sample-mesh", flag])
        pt, ext = tply.read_ply(str(root / f"t_{src}" / "scene_sampled.ply"))
        pj, exj = jply.read_ply(str(root / f"j_{src}" / "scene_sampled.ply"))
        assert len(pt) > 100
        assert np.array_equal(pt, pj)
        assert np.array_equal(ext["normals"], exj["normals"])


# ---- the mesh chain of chip_smoke.py's phase 14, at a size, as a script ----

def _chain(h: int, w: int, which: str, root: str,
           backend: str = "farneback") -> dict:
    """Phase 12's masked densify on its scene at h x w (as
    tests/test_torch_masks.py's ``compare_at``, on the flow ``backend`` in
    both packages), then phase 14's mesh chain on a 60,000-point
    subsample."""
    import time
    from chip_smoke import mesh_fscore, subsample_mvs
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn,
                                             write_ridge_masks,
                                             write_ridge_prior,
                                             write_ridge_scene)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=4,
                          fx=180.0 * w / 192.0,
                          texture_fn=sinusoid_texture_fn(
                              np.random.default_rng(12345)))
    small = make_ridge_scene(np.random.default_rng(0), h=h // 4, w=w // 4,
                             n_views=4, fx=180.0 * (w // 4) / 192.0,
                             texture_fn=lambda xy: np.zeros(xy.shape[:-1]))
    path, img_dir = write_ridge_scene(os.path.join(root, "ridge"), sc)
    write_ridge_masks(img_dir, sc)
    priors = os.path.join(root, "priors")
    write_ridge_prior(priors, small, 1)
    out = os.path.join(root, f"dense_{which}")
    t0 = time.perf_counter()
    if which == "jax":
        from hcmvs_tpu.core.config import DenseConfig
        from hcmvs_tpu.pipeline import densify as jdens
        from hcmvs_tpu.pipeline import mesh_apps as apps
        with flow_backend(backend):
            jdens.densify(path, img_dir, out,
                          DenseConfig(resolution_level=0, use_semantic=True),
                          priors_dir=priors, verbose=False)
        dev = []
    else:
        from hcmvs_tpu_torch.core.config import DenseConfig
        from hcmvs_tpu_torch.pipeline import densify as tdens
        from hcmvs_tpu_torch.pipeline import mesh_apps as apps
        with flow_backend(backend):
            tdens.densify(path, img_dir, out,
                          DenseConfig(resolution_level=0, use_semantic=True),
                          priors_dir=priors, verbose=False, device="cpu")
        dev = ["--device", "cpu"]
    t1 = time.perf_counter()
    mvs = os.path.join(out, "scene_mesh_input.mvs")
    subsample_mvs(os.path.join(out, "scene_dense.mvs"), mvs, 60000)
    mesh = os.path.join(out, "mesh.ply")
    apps.main(["reconstruct", "-i", mvs, "-o", mesh])
    t2 = time.perf_counter()
    apps.main(["refine", "-i", mvs, "-m", mesh, "--images-dir",
               img_dir] + dev)
    t3 = time.perf_counter()
    v, e = tply.read_ply(mesh)
    vr, _ = tply.read_ply(mesh.replace(".ply", "_refine.ply"))
    return {"which": which, "h": h, "w": w, "faces": len(e["faces"]),
            "densify_s": t1 - t0, "reconstruct_s": t2 - t1,
            "refine_s": t3 - t2,
            "fscore": mesh_fscore(v, e["faces"], sc),
            "fscore_refined": mesh_fscore(vr, e["faces"], sc)}


if __name__ == "__main__":
    import tempfile
    h, w = int(sys.argv[1]), int(sys.argv[2])
    rest = sys.argv[3:]
    backend = "lk" if "lk" in rest else "farneback"
    for which in [a for a in rest if a != "lk"] or ["jax", "port"]:
        if which == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
        with tempfile.TemporaryDirectory() as root:
            print(_chain(h, w, which, root, backend), flush=True)
