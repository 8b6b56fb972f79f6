"""PyTorch port vs the JAX package (and OpenCV): semantic masks, external
prior maps and label projection, through densify and the hierarchy.

- The PNG decoder against ``cv2.imread(..., IMREAD_UNCHANGED)`` (channel
  order aside) and ``load_image`` against the JAX package's, on every
  colour type and bit depth: gray at 1/2/4/8/16 bits, gray + alpha, RGB
  and RGBA at 8/16, palette at 1/2/4/8 with and without ``tRNS``, RGB
  with a ``tRNS`` colour; exactly.
- ``load_semantic_mask`` (16-bit, 8-bit, colour-coded RGB / RGBA /
  palette masks), ``resize_mask`` (ratios 2, 0.8, 1.5), ``find_scene_masks``
  / ``load_scene_masks`` and ``load_prior_maps`` against the JAX
  package's, exactly.
- A 96x128 densify of the 4-view ridge scene with 16-bit face masks
  (labels 1000 / 2000), ``--priors-dir`` (view 1's ground truth at 24x32)
  and ``use-semantic=1``, from the JAX package's init and with its RANSAC
  draws: view 0's depth accuracy and the valid share within 0.03 of the
  JAX package's, the depths within 1e-3 on >= 97% of pixels, the point
  count within 2%; ``--project-labels`` on the dense cloud gives the same
  colours in both packages, exactly.
- The hierarchy with masks: tests/test_torch_masks_hierarchy.py.

Where flows are on, both packages compute Farneback flow, each one's
default.

Run as a script, ``PYTHONPATH=. python tests/test_torch_masks.py H W
[jax|port ...]`` runs densify with masks and ``--priors-dir`` on
chip_smoke.py's phase-12 scene at H x W (4 views, sinusoid texture,
focal length scaled with width) at DenseConfig() plus resolution-level=0
and use-semantic=1, and prints view 0's depth_acc_2pct, its prior
coverage, the valid share and the point count of each package.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W, N = 96, 128, 4
SMALL = dict(adapt_half_window=5, patch_half_window=3, patch_step=2,
             estimation_iters=1, estimation_iters_external=3, random_iters=0,
             use_optical_flow=1, optimize=1, use_geo_consistency=1,
             use_part_consistency=0, resolution_level=0, min_resolution=0,
             use_semantic=True)
FORCED = dict(exact_backend="volume", geo_backend="rect",
              volume_build="rect")
MARGIN = 6


def _acc(depth, gt, margin=MARGIN):
    rel = np.abs(depth - gt) / gt
    return float((rel < 0.02)[margin:-margin, margin:-margin].mean())


def _close(a, b) -> float:
    """Share of pixels whose depths agree within 1e-3 (relative)."""
    return float((np.abs(a - b) <= 1e-3 * np.abs(b)).mean())


# --------------------------------------------------------------------------
# PNG decoding

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(color, depth, rows, w, h, extra=b""):
    """A PNG of unfiltered (filter type 0) scanlines ``rows`` (bytes each)
    with the extra chunks ``extra`` before its IDAT."""
    raw = b"".join(b"\x00" + r for r in rows)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, 0))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _pack_bits(vals, depth):
    """Rows of sub-byte samples packed big-endian first, as PNG does."""
    bits = np.unpackbits(vals.astype(np.uint8)[..., None], axis=-1)
    bits = bits[..., 8 - depth:].reshape(vals.shape[0], -1)
    return [np.packbits(r).tobytes() for r in bits]


_PLTE = np.random.default_rng(8).integers(0, 256, (16, 3)).astype(np.uint8)


def _case(name):
    """(file bytes, the samples cv2 returns in RGB(A) order)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    h, w = 7, 13
    if name.startswith("gray"):
        depth = int(name[4:])
        top = (1 << depth) - 1
        vals = rng.integers(0, top + 1, (h, w))
        if depth == 16:
            rows = [r.astype(">u2").tobytes() for r in vals]
            want = vals.astype(np.uint16)
        elif depth == 8:
            rows = [r.astype(np.uint8).tobytes() for r in vals]
            want = vals.astype(np.uint8)
        else:
            rows = _pack_bits(vals, depth)
            want = (vals * (255 // top)).astype(np.uint8)
        return _png(0, depth, rows, w, h), want[..., None]
    if name == "rgb8trns":
        vals = rng.integers(0, 4, (h, w, 3)).astype(np.uint8)
        key = bytes([0, 1, 0, 2, 0, 3])
        alpha = np.where((vals == [1, 2, 3]).all(-1), 0, 255)
        vals[0, 0] = [1, 2, 3]
        alpha[0, 0] = 0
        rows = [r.tobytes() for r in vals]
        return (_png(2, 8, rows, w, h, _chunk(b"tRNS", key)),
                np.concatenate([vals, alpha[..., None].astype(np.uint8)],
                               -1))
    if name.startswith("ga") or name.startswith("rgb"):
        kind, depth = (name.rstrip("0123456789"),
                       int(name.lstrip("gargb")))
        ch = {"ga": 2, "rgb": 3, "rgba": 4}[kind]
        dt = np.uint16 if depth == 16 else np.uint8
        vals = rng.integers(0, np.iinfo(dt).max + 1, (h, w, ch)).astype(dt)
        rows = [r.astype(">u2" if depth == 16 else np.uint8).tobytes()
                for r in vals]
        color = {"ga": 4, "rgb": 2, "rgba": 6}[kind]
        want = vals[..., [0, 0, 0, 1]] if kind == "ga" else vals
        return _png(color, depth, rows, w, h), want
    # palette: "pal<depth>[t]"
    depth = int(name[3:].rstrip("t"))
    n_pal = min(1 << depth, len(_PLTE))
    idx = rng.integers(0, n_pal, (h, w))
    rows = (_pack_bits(idx, depth) if depth < 8
            else [r.astype(np.uint8).tobytes() for r in idx])
    extra = _chunk(b"PLTE", _PLTE[:n_pal].tobytes())
    want = _PLTE[idx]
    if name.endswith("t"):
        alpha = rng.integers(0, 256, n_pal - 1).astype(np.uint8)
        extra += _chunk(b"tRNS", alpha.tobytes())
        full = np.concatenate([alpha, [255]]).astype(np.uint8)
        want = np.concatenate([want, full[idx][..., None]], -1)
    return _png(3, depth, rows, w, h, extra), want


CASES = ["gray1", "gray2", "gray4", "gray8", "gray16", "ga8", "ga16",
         "rgb16", "rgba16", "rgb8trns", "pal1", "pal2", "pal4", "pal8",
         "pal2t", "pal8t"]


@pytest.mark.parametrize("name", CASES)
def test_png_decode_matches_opencv(tmp_path, name):
    cv2 = pytest.importorskip("cv2")
    from hcmvs_tpu.io.images import load_image as jload
    from hcmvs_tpu_torch.io import images as timg
    data, want = _case(name)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    ours = timg._decode_png(data, path)
    assert ours.dtype == want.dtype and np.array_equal(ours, want)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ref = ref[..., None] if ref.ndim == 2 else ref[..., [2, 1, 0, 3][
        :ref.shape[2]]]
    assert ref.dtype == ours.dtype and np.array_equal(ours, ref)
    for gray in (False, True):
        a, b = timg.load_image(path, gray=gray), jload(path, gray=gray)
        assert a.dtype == b.dtype and np.array_equal(a, b), (gray, name)


def test_png_writer_16bit_round_trips(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from hcmvs_tpu_torch.io import images as timg
    rng = np.random.default_rng(2)
    for shape in ((9, 11), (9, 11, 3), (9, 11, 4)):
        img = rng.integers(0, 65536, shape).astype(np.uint16)
        for f in (0, 1, 2, 3, 4):
            path = str(tmp_path / "x.png")
            timg.write_png(path, img, f)
            back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if back.ndim == 3:
                back = back[..., [2, 1, 0, 3][:back.shape[2]]]
            assert back.dtype == np.uint16 and np.array_equal(back, img)


# --------------------------------------------------------------------------
# masks, resize, scene masks, prior maps

def _write_masks(tmp_path):
    """16-bit, 8-bit, colour-coded RGB / RGBA and palette masks (as cv2
    writes them where it can) with their paths."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    h, w = 21, 30
    lab = rng.integers(0, 4, (h, w))
    out = {}
    out["u16"] = str(tmp_path / "u16.png")
    cv2.imwrite(out["u16"], (lab * 1000 + 7).astype(np.uint16))
    out["u8"] = str(tmp_path / "u8.png")
    cv2.imwrite(out["u8"], (lab * 40).astype(np.uint8))
    colours = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9]])
    out["rgb"] = str(tmp_path / "rgb.png")
    cv2.imwrite(out["rgb"], colours[lab][..., ::-1].astype(np.uint8))
    out["rgba"] = str(tmp_path / "rgba.png")
    rgba = np.concatenate([colours[lab], (lab[..., None] % 2) * 255], -1)
    cv2.imwrite(out["rgba"], rgba[..., [2, 1, 0, 3]].astype(np.uint8))
    data, _ = _case("pal4t")
    out["pal"] = str(tmp_path / "pal.png")
    with open(out["pal"], "wb") as f:
        f.write(data)
    return out


def test_load_semantic_mask_matches_jax(tmp_path):
    from hcmvs_tpu.io.images import load_semantic_mask as jload
    from hcmvs_tpu_torch.io.images import load_semantic_mask
    for kind, path in _write_masks(tmp_path).items():
        ours, ref = load_semantic_mask(path), jload(path)
        assert ours.dtype == ref.dtype == np.int32
        assert np.array_equal(ours, ref), kind
    assert len(np.unique(load_semantic_mask(str(tmp_path / "rgb.png")))) == 4


@pytest.mark.parametrize("ratio", [2.0, 0.8, 1.5])
def test_resize_mask_matches_opencv(ratio):
    pytest.importorskip("cv2")
    from hcmvs_tpu.io.images import resize_mask as jresize
    from hcmvs_tpu_torch.io.images import resize_mask
    rng = np.random.default_rng(7)
    for shape in ((30, 40), (37, 53), (96, 128)):
        mask = rng.integers(0, 3000, shape).astype(np.int32)
        to = (round(shape[0] * ratio), round(shape[1] * ratio))
        ours, ref = resize_mask(mask, to), jresize(mask, to)
        assert ours.shape == ref.shape == to
        assert np.array_equal(ours, ref), (shape, ratio)
    assert resize_mask(mask, shape) is mask


def _written_ridge(root, h, w):
    """The h x w, 4-view ridge scene as scene.mvs + PNGs under ``root``,
    with 16-bit face masks and colour label images beside the images, and
    a priors dir holding view 1's ground truth at a quarter of the
    size."""
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn,
                                             write_ridge_masks,
                                             write_ridge_prior,
                                             write_ridge_scene)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w, n_views=N,
                          fx=180.0 * w / 192.0,
                          texture_fn=sinusoid_texture_fn(
                              np.random.default_rng(12345)))
    scene_path, img_dir = write_ridge_scene(str(root), sc)
    masks = write_ridge_masks(img_dir, sc)
    small = make_ridge_scene(np.random.default_rng(0), h=h // 4, w=w // 4,
                             n_views=N, fx=180.0 * (w // 4) / 192.0,
                             texture_fn=lambda xy: np.zeros(xy.shape[:-1]))
    priors = str(root / "priors")
    write_ridge_prior(priors, small, 1)
    return dict(sc=sc, root=root, scene_path=scene_path, img_dir=img_dir,
                masks=masks, priors=priors, h=h, w=w)


@pytest.fixture(scope="module")
def ridge(tmp_path_factory):
    """The 96x128 written ridge scene."""
    return _written_ridge(tmp_path_factory.mktemp("masks"), H, W)


def test_scene_masks_and_prior_maps_match_jax(ridge, tmp_path):
    from hcmvs_tpu.pipeline import densify as jd
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.io.images import load_semantic_mask
    from hcmvs_tpu_torch.pipeline import densify as td
    scene = read_mvs(ridge["scene_path"])
    assert load_semantic_mask(ridge["masks"][0]).max() == 2000
    # beside the images; then a masks dir missing view 2's mask, which
    # falls back to the image's own .mask.png
    other = tmp_path / "masks"
    other.mkdir()
    for i in (0, 1, 3):
        (other / f"im{i:04d}.png").write_bytes(
            open(ridge["masks"][(i + 1) % N], "rb").read())
    for masks_dir in (None, str(other)):
        paths = td.find_scene_masks(scene, ridge["img_dir"], masks_dir)
        assert paths == jd.find_scene_masks(scene, ridge["img_dir"],
                                            masks_dir)
        for hw in ((H, W), (H // 2, W // 2), (60, 80)):
            ours = td.load_scene_masks(paths, hw)
            assert np.array_equal(ours, jd.load_scene_masks(paths, hw))
        assert ours.max() == 1
    partial = [ridge["masks"][0], None, None, ridge["masks"][3]]
    assert np.array_equal(td.load_scene_masks(partial, (H, W)),
                          jd.load_scene_masks(partial, (H, W)))
    assert td.find_scene_masks(scene, str(tmp_path)) is None
    for hw in ((H, W), (50, 70)):
        ours = td.load_prior_maps(ridge["priors"], scene, hw)
        ref = jd.load_prior_maps(ridge["priors"], scene, hw)
        assert np.array_equal(ours, ref)
        assert (ours[1] > 0).all() and not ours[[0, 2, 3]].any()
    assert td.load_prior_maps(str(tmp_path), scene, (H, W)) is None


# --------------------------------------------------------------------------
# densify with masks, --priors-dir and --project-labels

def _jax_draws_by_view(n, h, w):
    """The JAX package's RANSAC draws of each view of its prior pass."""
    import jax
    out = []
    for k in jax.random.split(jax.random.PRNGKey(7), n):
        k0, k1 = jax.random.split(k)
        out.append((torch.from_numpy(np.asarray(jax.random.randint(
            k0, (64,), 0, h * w))), torch.from_numpy(np.asarray(
                jax.random.randint(k1, (64, 2, 2), -12, 13)))))
    return out


def _patch_draws(monkeypatch):
    """The port's prior pass takes the JAX package's RANSAC draws."""
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    run = tsd.compute_scene_priors
    calls = []

    def with_jax_draws(state, scene, *args, **kw):
        n, h, w = scene.gray.shape
        calls.append((h, w))
        return run(state, scene, *args,
                   draws=_jax_draws_by_view(n, h, w), **kw)

    monkeypatch.setattr(tsd, "compute_scene_priors", with_jax_draws)
    return calls


def _jax_call(fn, *args, **kw):
    return fn(*args, verbose=False, **kw)


def _jax_init(ridge, jcfg):
    """The JAX package's scene tensors of the written scene (masks
    included) and its init state."""
    import jax
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.pipeline import densify as jd
    from hcmvs_tpu_torch.convert import state_from_numpy
    from hcmvs_tpu_torch.io.images import load_image
    from hcmvs_tpu_torch.io.mvs import read_mvs
    scene = read_mvs(ridge["scene_path"])
    grays = [load_image(os.path.join(ridge["img_dir"], im.name), gray=True)
             for im in scene.images]
    sem = jd.load_scene_masks(jd.find_scene_masks(scene, ridge["img_dir"]),
                              (H, W))
    jscene = jd.build_scene_tensors(scene, grays, jcfg, semantic=sem)
    return state_from_numpy(jsd.init_scene_state(jax.random.PRNGKey(0),
                                                 jscene), device="cpu")


def test_masked_densify_and_labels_match_jax(ridge, monkeypatch):
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.pipeline import densify as jd
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.pipeline import densify as td
    from hcmvs_tpu_torch.utils.profiling import report, reset_report
    jcfg, tcfg = JConfig(**SMALL, **FORCED), TConfig(**SMALL)
    args = (ridge["scene_path"], ridge["img_dir"])
    ref = _jax_call(jd.densify, *args, str(ridge["root"] / "jax"), jcfg,
                    priors_dir=ridge["priors"])
    calls = _patch_draws(monkeypatch)
    reset_report()
    out_dir = str(ridge["root"] / "port")
    stats = td.densify(*args, out_dir, tcfg, verbose=False, device="cpu",
                       priors_dir=ridge["priors"],
                       init=_jax_init(ridge, jcfg))
    assert calls == [(H, W)] and report()["estimate.priors"]["calls"] == 1
    gt = ridge["sc"].depth_gt
    acc_t, acc_j = _acc(stats["depth"][0], gt), _acc(ref["depth"][0], gt)
    assert acc_t > 0.9, acc_t
    assert abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    assert abs(stats["valid_frac"] - ref["valid_frac"]) <= 0.03
    share = _close(stats["depth"], ref["depth"])
    assert share >= 0.97, share
    assert abs(stats["n_points"] - ref["n_points"]) <= 0.02 * ref["n_points"]
    # --project-labels on the port's dense cloud, both packages
    dense = os.path.join(out_dir, "scene_dense.mvs")
    lab_t = td.main(["--input-file", dense, "--images-dir", args[1], "-w",
                     str(ridge["root"] / "lab_t"), "--project-labels"])
    os.makedirs(str(ridge["root"] / "lab_j"))
    lab_j = jd.project_labels(dense, args[1],
                              str(ridge["root"] / "lab_j" / "scene"),
                              verbose=False)
    assert lab_t["n_label_images"] == lab_j["n_label_images"] == N
    j_cols = read_mvs(str(ridge["root"] / "lab_j" / "scene_labelled.mvs"))
    t_cols = read_mvs(str(ridge["root"] / "lab_t" / "scene_labelled.mvs"))
    assert np.array_equal(lab_t["colors"], j_cols.point_colors)
    assert np.array_equal(t_cols.point_colors, j_cols.point_colors)
    labelled = (lab_t["colors"] != 255).any(1).mean()
    assert labelled > 0.99, labelled


def test_estimate_point_labels_matches_jax(ridge):
    """The fusion module's per-point labels (owner view's mask)."""
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera as JCamera
    from hcmvs_tpu.dense.fusion import estimate_point_labels as jlabels
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.fusion import estimate_point_labels
    sc = ridge["sc"]
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    jcams = JCamera(*(jnp.asarray(getattr(cams, f).numpy()) for f in "KRC"))
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (400, 2)),
                          rng.uniform(2.5, 5.0, (400, 1))], 1
                         ).astype(np.float32)
    pts[:5, 2] = -1.0                                 # behind the cameras
    owner = rng.integers(0, N, 400)
    sem = np.stack(sc.faces).astype(np.int32) * 3 + 1
    ours = estimate_point_labels(pts, owner, torch.from_numpy(sem), cams)
    ref = jlabels(pts, owner, sem, jcams)
    assert ours.dtype == np.int32 and np.array_equal(ours, ref)
    assert (ours == -1).sum() >= 5 and set(np.unique(ours)) <= {-1, 1, 4}


def compare_at(h: int, w: int, which=("jax", "port")) -> None:
    """Both packages' densify with masks and --priors-dir at
    DenseConfig() + resolution-level=0 + use-semantic=1 on chip_smoke.py's
    phase-12 scene at h x w; prints what its floor rests on."""
    import tempfile
    import time
    from hcmvs_tpu.core.config import DenseConfig as JConfig
    from hcmvs_tpu.dense import scene_driver as jsd
    from hcmvs_tpu.pipeline import densify as jd
    from hcmvs_tpu_torch.core.config import DenseConfig as TConfig
    from hcmvs_tpu_torch.dense import scene_driver as tsd
    from hcmvs_tpu_torch.pipeline import densify as td
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
    priors = {}

    def keep(mod):
        run = mod.compute_scene_priors

        def kept(*args, **kw):
            out = run(*args, **kw)
            priors["map"] = np.asarray(out.prior_depth[0])
            priors["labels"] = int(np.asarray(out.semantic).max()) + 1
            return out
        return kept

    with tempfile.TemporaryDirectory() as root:
        scene_path, img_dir = write_ridge_scene(root, sc)
        write_ridge_masks(img_dir, sc)
        write_ridge_prior(os.path.join(root, "priors"), small, 1)
        runs = [("jax", jsd, lambda d: _jax_call(
                    jd.densify, scene_path, img_dir, d,
                    JConfig(resolution_level=0, use_semantic=True),
                    priors_dir=os.path.join(root, "priors"))),
                ("port", tsd, lambda d: td.densify(
                    scene_path, img_dir, d,
                    TConfig(resolution_level=0, use_semantic=True),
                    verbose=False, device="cpu",
                    priors_dir=os.path.join(root, "priors")))]
        for name, mod, run in runs:
            if name not in which:
                continue
            out = os.path.join(root, name)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mod, "compute_scene_priors",
                           keep(mod))
                t0 = time.perf_counter()
                st = run(out)
                sec = time.perf_counter() - t0
            print(f"{name} {h}x{w}: depth_acc_2pct "
                  f"{_acc(st['depth'][0], sc.depth_gt):.4f}, view 0 prior "
                  f"coverage {(priors['map'] > 0).mean():.4f}, labels "
                  f"{priors['labels']}, valid {st['valid_frac']:.4f}, "
                  f"points {st['n_points']}, {sec:.1f} s", flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    compare_at(int(sys.argv[1]), int(sys.argv[2]),
               tuple(sys.argv[3:]) or ("jax", "port"))
