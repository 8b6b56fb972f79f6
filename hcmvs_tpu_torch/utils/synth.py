"""Synthetic scenes with analytic ground truth (numpy port of
``hcmvs_tpu/utils/synth.py``'s plane, box and ridge scenes).

The arithmetic is the JAX package's, in numpy float64 until the end, so
the same arguments give bit-identical images and cameras.  Cameras come
back as the port's ``Camera`` with float32 CPU tensors.  The writers
store a scene as ``scene.mvs`` plus gray PNGs, the input of the
pipeline's entry points.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from hcmvs_tpu_torch.core.camera import Camera


_N_WAVES = 24               # sinusoids in the world texture
_SLANT = (0.3, 0.15)        # plane z = Z0 + a*x + b*y
_Z0 = 4.0


def _texture_params(rng: np.random.Generator, n_waves: int = _N_WAVES):
    return (rng.uniform(1.5, 11.0, (n_waves, 2)),
            rng.uniform(0, 2 * np.pi, n_waves),
            rng.uniform(0.3, 1.0, n_waves) / n_waves)


def _texture(xy: np.ndarray, params, device=None) -> np.ndarray:
    """Random sum of sinusoids, fixed per scene, so every view samples
    the same Lambertian world texture.  numpy (bit-identical to the JAX
    package's) unless ``device`` is given, where the same float64 sums run
    in torch on that device (the sines' last bits are the device's)."""
    freqs, phases, amps = params
    if device is None:
        x, y, sin = xy[..., 0], xy[..., 1], np.sin
    else:
        x, y = (torch.as_tensor(xy[..., i], dtype=torch.float64,
                                device=device) for i in (0, 1))
        sin = torch.sin
    val = x * 0
    for k in range(len(amps)):
        val = val + amps[k] * sin(x * freqs[k, 0] + y * freqs[k, 1]
                                  + phases[k])
    if device is not None:
        val = val.cpu().numpy()
    return (0.5 + 0.5 * val / np.abs(val).max()).astype(np.float32)


@dataclasses.dataclass
class PlaneScene:
    cameras: List[Camera]
    images: List[np.ndarray]          # (H, W) float32 gray
    depth_gt: np.ndarray              # (H, W) ref-view ground truth
    normal_gt: np.ndarray             # (3,) plane normal in ref cam coords
    n_w: np.ndarray                   # world plane normal
    c_w: float                        # world plane offset: n.X = c
    d_min: float
    d_max: float


def _rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def make_plane_scene(rng: np.random.Generator, h: int = 64, w: int = 80,
                     n_views: int = 3, fx: float = 100.0,
                     texture_device=None) -> PlaneScene:
    """Textured slanted plane z = z0 + a*x + b*y seen from ``n_views``
    cameras: camera 0 is the reference at the origin, the others are
    translated sideways with a small rotation.  ``rng`` is accepted for
    signature parity; the texture comes from a fixed seed, its sines
    computed on ``texture_device`` if given (``_texture``)."""
    del rng
    a, b = _SLANT
    z0 = _Z0
    n_w = np.array([-a, -b, 1.0])
    norm = np.linalg.norm(n_w)
    n_w = n_w / norm
    c_w = z0 / norm

    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    cams_np = []
    for i in range(n_views):
        if i == 0:
            R = np.eye(3)
            C = np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.01 * side * k, -0.02 * side * k, 0.005 * k)
            C = np.array([0.25 * side * k, 0.05 * k, 0.0])
        cams_np.append((K, R, C))

    tex_params = _texture_params(np.random.default_rng(12345))

    def render(cam_np) -> Tuple[np.ndarray, np.ndarray]:
        Kn, Rn, Cn = cam_np
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_w = (p @ Kinv.T) @ Rn           # R^T @ ray
        t = (c_w - n_w @ Cn) / (ray_w @ n_w)
        X = Cn + ray_w * t[..., None]
        img = _texture(X[..., :2] * 2.0, tex_params, texture_device)
        return img.astype(np.float32), t.astype(np.float32)

    images = []
    depth_ref = None
    for i, cam_np in enumerate(cams_np):
        img, depth = render(cam_np)
        images.append(img)
        if i == 0:
            depth_ref = depth
    cams = [Camera(K=torch.as_tensor(Kn, dtype=torch.float32),
                   R=torch.as_tensor(Rn, dtype=torch.float32),
                   C=torch.as_tensor(Cn, dtype=torch.float32))
            for Kn, Rn, Cn in cams_np]

    n_cam = n_w.astype(np.float32)
    if n_cam[2] > 0:
        n_cam = -n_cam   # face the camera
    d_min = float(depth_ref.min() * 0.7)
    d_max = float(depth_ref.max() * 1.4)
    return PlaneScene(cameras=cams, images=images, depth_gt=depth_ref,
                      normal_gt=n_cam, n_w=n_w, c_w=c_w,
                      d_min=d_min, d_max=d_max)


@dataclasses.dataclass
class BoxScene:
    cameras: List[Camera]
    images: List[np.ndarray]
    depth_gts: List[np.ndarray]       # per-view ground-truth depth
    d_min: float
    d_max: float


def make_box_scene(rng: np.random.Generator, h: int = 96, w: int = 128,
                   n_views: int = 4, fx: float = 150.0,
                   z_bg: float = 6.0, z_fg: float = 4.0,
                   fg_half: float = 0.6) -> BoxScene:
    """Occlusion scene: a textured foreground plate (z = z_fg, |x|, |y| <=
    fg_half) floating over a textured background plane (z = z_bg): depth
    discontinuities and per-view occlusion, the failure mode the LR check,
    the cross-view filter and fusion must survive.  (``rng`` is unused,
    as in the JAX package: the textures have fixed seeds.)"""
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    cams_np = []
    for i in range(n_views):
        if i == 0:
            R, C = np.eye(3), np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.008 * side * k, -0.015 * side * k, 0.004 * k)
            C = np.array([0.3 * side * k, 0.04 * k, 0.0])
        cams_np.append((K, R, C))
    tex_bg = _texture_params(np.random.default_rng(777))
    tex_fg = _texture_params(np.random.default_rng(778))

    images, depths = [], []
    for Kn, Rn, Cn in cams_np:
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_w = (p @ Kinv.T) @ Rn
        # intersect both z = const planes (ray_w[..., 2] != 0)
        t_fg = (z_fg - Cn[2]) / ray_w[..., 2]
        t_bg = (z_bg - Cn[2]) / ray_w[..., 2]
        X_fg = Cn + ray_w * t_fg[..., None]
        X_bg = Cn + ray_w * t_bg[..., None]
        on_fg = ((np.abs(X_fg[..., 0]) <= fg_half)
                 & (np.abs(X_fg[..., 1]) <= fg_half))
        img = np.where(on_fg, _texture(X_fg[..., :2] * 2.0, tex_fg),
                       _texture(X_bg[..., :2], tex_bg))
        # camera depth = z of the hit point in camera coordinates
        d_fg = ((X_fg - Cn) @ Rn.T)[..., 2]
        d_bg = ((X_bg - Cn) @ Rn.T)[..., 2]
        depth = np.where(on_fg, d_fg, d_bg)
        images.append(img.astype(np.float32))
        depths.append(depth.astype(np.float32))
    cams = [Camera(K=torch.as_tensor(Kn, dtype=torch.float32),
                   R=torch.as_tensor(Rn, dtype=torch.float32),
                   C=torch.as_tensor(Cn, dtype=torch.float32))
            for Kn, Rn, Cn in cams_np]
    return BoxScene(cameras=cams, images=images, depth_gts=depths,
                    d_min=z_fg * 0.6, d_max=z_bg * 1.4)


def blob_texture_fn(rng: np.random.Generator, n_blobs: int = 1200,
                    extent: float = 3.5, device=None):
    """A world-(x, y) -> intensity function rich in Gaussian blobs; blob
    sigmas span ~2-9 px at the default scene geometry (z ~ 4, fx ~ 180).
    Costs n_blobs ``exp`` per pixel: numpy (bit-identical to the JAX
    package's) unless ``device`` is given, where the same float64 sums run
    in torch on that device (the exp's last bits are the device's)."""
    centers = rng.uniform(-extent, extent, (n_blobs, 2))
    sigmas = rng.uniform(0.03, 0.08, n_blobs)
    amps = rng.uniform(0.25, 0.6, n_blobs) * rng.choice([-1, 1], n_blobs)

    def fn(xy: np.ndarray) -> np.ndarray:
        if device is None:
            x, y, exp = xy[..., 0], xy[..., 1], np.exp
        else:
            x, y = (torch.as_tensor(xy[..., i], dtype=torch.float64,
                                    device=device) for i in (0, 1))
            exp = torch.exp
        val = x * 0 + 0.5
        for c, s, a in zip(centers, sigmas, amps):
            d2 = ((x - c[0]) ** 2 + (y - c[1]) ** 2)
            val = val + a * exp(-d2 / (2 * s * s))
        if device is not None:
            val = val.cpu().numpy()
        return np.clip(val, 0.0, 1.0).astype(np.float32)

    return fn


def sinusoid_texture_fn(rng: np.random.Generator, device=None):
    """The plane scene's texture (a random sum of 24 sinusoids over world
    x, y at twice the plane scene's coordinates' scale, normalised per
    image) as a world-(x, y) -> intensity function: 24 ``sin`` per pixel,
    cheap enough for multi-megapixel ridge scenes; on ``device`` if given
    (``_texture``)."""
    params = _texture_params(rng)

    def fn(xy: np.ndarray) -> np.ndarray:
        return _texture(xy * 2.0, params, device)

    return fn


@dataclasses.dataclass
class RidgeScene:
    cameras: List[Camera]
    images: List[np.ndarray]
    depth_gt: np.ndarray              # ref-view depth
    planes: List[Tuple[np.ndarray, float]]   # [(n_w, c_w)] two planes
    depths: List[np.ndarray] = None   # every view's ground-truth depth
    faces: List[np.ndarray] = None    # every view's (H, W) uint8 face:
                                      # 0 the plane at x < 0, 1 the other

    def surface_dist(self, pts: np.ndarray) -> np.ndarray:
        """Distance of world points to the ridge surface (the plane of the
        point's side of x = 0)."""
        (n1, c1), (n2, c2) = self.planes
        d1 = np.abs(pts @ n1 - c1)
        d2 = np.abs(pts @ n2 - c2)
        return np.where(pts[:, 0] < 0, d1, d2)


def make_ridge_scene(rng: np.random.Generator, h: int = 96, w: int = 128,
                     n_views: int = 4, fx: float = 180.0,
                     z0: float = 4.0, slopes: Tuple[float, float] =
                     (0.5, -0.35), spacing: float = 0.5,
                     texture_fn=None) -> RidgeScene:
    """Two planes meeting at x = 0 (a ridge): non-planar structure seen by
    ``n_views`` cameras, camera 0 the reference at the origin, the others
    translated sideways by ``spacing`` steps with a small rotation.
    ``texture_fn`` maps world (x, y) to intensity (default:
    ``blob_texture_fn(rng)``)."""
    a1, a2 = slopes
    planes = []
    for a in (a1, a2):
        n = np.array([-a, 0.0, 1.0])
        nn = np.linalg.norm(n)
        planes.append((n / nn, z0 / nn))

    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    cams_np = []
    for i in range(n_views):
        if i == 0:
            R = np.eye(3)
            C = np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.01 * side * k, -0.02 * side * k, 0.005 * k)
            C = np.array([spacing * side * k, 0.1 * spacing * k, 0.0])
        cams_np.append((K, R, C))

    tex = texture_fn or blob_texture_fn(rng)

    def render(cam_np):
        Kn, Rn, Cn = cam_np
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_w = (p @ Kinv.T) @ Rn
        ts, valids = [], []
        for k, (n_w, c_w) in enumerate(planes):
            t = (c_w - n_w @ Cn) / (ray_w @ n_w)
            X = Cn + ray_w * t[..., None]
            want_neg = (k == 0)
            ok = (t > 0) & ((X[..., 0] < 0) == want_neg)
            ts.append(t)
            valids.append(ok)
        t = np.where(valids[0], ts[0],
                     np.where(valids[1], ts[1],
                              np.minimum(ts[0], ts[1])))
        face = np.where(valids[0], 0, np.where(valids[1], 1,
                                               ts[1] < ts[0]))
        X = Cn + ray_w * t[..., None]
        img = tex(X[..., :2])
        return (img.astype(np.float32), t.astype(np.float32),
                face.astype(np.uint8))

    images, depths, faces = [], [], []
    for cam_np in cams_np:
        img, depth, face = render(cam_np)
        images.append(img)
        depths.append(depth)
        faces.append(face)
    cams = [Camera(K=torch.as_tensor(Kn, dtype=torch.float32),
                   R=torch.as_tensor(Rn, dtype=torch.float32),
                   C=torch.as_tensor(Cn, dtype=torch.float32))
            for Kn, Rn, Cn in cams_np]
    return RidgeScene(cameras=cams, images=images, depth_gt=depths[0],
                      planes=planes, depths=depths, faces=faces)


def ridge_sparse_points(scene: RidgeScene, n_sparse: int = 100,
                        seed: int = 0) -> np.ndarray:
    """(n_sparse, 3) float32 world points: view 0's ground-truth depth at
    pixels drawn from ``seed``, back-projected."""
    cam = scene.cameras[0]
    K, R, C = (cam.K.cpu().numpy().astype(np.float64),
               cam.R.cpu().numpy().astype(np.float64),
               cam.C.cpu().numpy().astype(np.float64))
    h, w = scene.depth_gt.shape
    rng = np.random.default_rng(seed)
    u = rng.integers(0, w, n_sparse)
    v = rng.integers(0, h, n_sparse)
    d = scene.depth_gt[v, u].astype(np.float64)
    rays = np.stack([u, v, np.ones(n_sparse)], 1) @ np.linalg.inv(K).T
    return ((rays * d[:, None]) @ R + C).astype(np.float32)


def plane_depth_of_view(scene: PlaneScene, view: int) -> np.ndarray:
    """Ground-truth depth of any view from the world plane n_w . X = c_w."""
    cam = scene.cameras[view]
    K, R, C = (np.asarray(x.cpu()) for x in (cam.K, cam.R, cam.C))
    h, w = scene.images[view].shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    K_inv = np.linalg.inv(K)
    rc = np.stack([u, v, np.ones_like(u)])            # (3, H, W) cam rays
    dir_w = np.einsum("ji,jhw->ihw", R, np.einsum(
        "ij,jhw->ihw", K_inv, rc))                    # R^T K^-1 p
    denom = np.einsum("i,ihw->hw", scene.n_w, dir_w)
    s = (scene.c_w - scene.n_w @ C) / np.where(
        np.abs(denom) < 1e-12, 1e-12, denom)
    return s.astype(np.float32)                       # rc_z == 1 => depth


def plane_normal_of_view(scene: PlaneScene, view: int) -> np.ndarray:
    """(3,) ground-truth plane normal in the view's camera frame, facing
    the camera: R @ n_w in float32, as a chain of fused multiply-adds
    (each product and sum rounded once, as the JAX package's float32
    product on the CPU), so both packages give the same bits."""
    R = scene.cameras[view].R.numpy().astype(np.float64)
    n_w = scene.n_w.astype(np.float32).astype(np.float64)
    acc = np.zeros(3, np.float32)
    for k in range(3):
        acc = (R[:, k] * n_w[k] + acc.astype(np.float64)).astype(np.float32)
    return -acc if acc[2] > 0 else acc


def plane_sparse_points(scene: PlaneScene, n_sparse: int = 60,
                        seed: int = 0) -> np.ndarray:
    """(n_sparse, 3) float32 points drawn on the scene's plane."""
    xy = np.random.default_rng(seed).uniform(-0.5, 0.5, (n_sparse, 2))
    z = (scene.c_w - xy @ scene.n_w[:2]) / scene.n_w[2]
    return np.column_stack([xy, z]).astype(np.float32)


def write_plane_scene(root: str, scene: PlaneScene, n_sparse: int = 60,
                      seed: int = 0, png_filter: int = 2) -> Tuple[str, str]:
    """Write ``scene`` as ``root/scene.mvs`` (one shared intrinsic, a pose
    per view, ``plane_sparse_points`` seen by every view) and 8-bit gray
    PNGs ``root/images/im%04d.png`` (every row with the PNG row filter
    ``png_filter``); returns (scene path, images dir), the inputs of
    ``pipeline.densify``."""
    return _write_scene(root, scene, plane_sparse_points(scene, n_sparse,
                                                         seed), png_filter)


def write_ridge_scene(root: str, scene: RidgeScene, n_sparse: int = 100,
                      seed: int = 0, png_filter: int = 2) -> Tuple[str, str]:
    """``write_plane_scene`` for a ridge scene: the sparse points are
    ``ridge_sparse_points``, listed as seen by every view."""
    return _write_scene(root, scene, ridge_sparse_points(scene, n_sparse,
                                                         seed), png_filter)


# the ridge's face labels in its masks: above 255, so a mask is a 16-bit
# PNG; and the faces' colours in the label images of --project-labels
RIDGE_MASK_LABELS = (1000, 2000)
RIDGE_LABEL_COLOURS = ((230, 60, 20), (20, 120, 230))


def write_ridge_masks(img_dir: str, scene: RidgeScene) -> List[str]:
    """Write each view's semantic mask beside its image, as the densify
    app finds masks: ``im%04d.mask.png``, a 16-bit gray PNG labelling
    each pixel by the ridge face it sees (``RIDGE_MASK_LABELS``), and
    the colour label image of ``--project-labels``,
    ``im%04d_l_colored.png`` (RGB, ``RIDGE_LABEL_COLOURS``).  Returns the
    mask paths."""
    from hcmvs_tpu_torch.io.images import write_png
    labels = np.asarray(RIDGE_MASK_LABELS, np.uint16)
    colours = np.asarray(RIDGE_LABEL_COLOURS, np.uint8)
    paths = []
    for i, face in enumerate(scene.faces):
        paths.append(os.path.join(img_dir, f"im{i:04d}.mask.png"))
        write_png(paths[-1], labels[face])
        write_png(os.path.join(img_dir, f"im{i:04d}_l_colored.png"),
                  colours[face])
    return paths


def write_ridge_prior(priors_dir: str, scene: RidgeScene, view: int) -> str:
    """Write view ``view``'s ground-truth depth of ``scene`` (at its own
    size) as ``priors_dir/depth%04d.dmap``, an external prior map of the
    densify app's ``--priors-dir``; returns the path."""
    from hcmvs_tpu_torch.io.dmap import DepthMapData, write_dmap
    os.makedirs(priors_dir, exist_ok=True)
    cam = scene.cameras[view]
    h, w = scene.depths[view].shape
    path = os.path.join(priors_dir, f"depth{view:04d}.dmap")
    write_dmap(path, DepthMapData(
        depth=scene.depths[view], normal=None, conf=None,
        K=cam.K.cpu().numpy().astype(np.float64),
        R=cam.R.cpu().numpy().astype(np.float64),
        C=cam.C.cpu().numpy().astype(np.float64),
        d_min=float(scene.depths[view].min()),
        d_max=float(scene.depths[view].max()), image_size=(w, h),
        image_name=f"im{view:04d}.png", view_ids=[view]))
    return path


def _write_scene(root: str, scene, points: np.ndarray,
                 png_filter: int) -> Tuple[str, str]:
    from hcmvs_tpu_torch.io.images import write_png
    from hcmvs_tpu_torch.io.mvs import (CameraIntrinsic, ImageRecord,
                                        Platform, Pose, SceneMVS, write_mvs)
    h, w = scene.images[0].shape
    n = len(scene.cameras)
    plat = Platform(name="p0")
    plat.cameras.append(CameraIntrinsic(
        name="c0", width=w, height=h,
        K=scene.cameras[0].K.cpu().numpy().astype(np.float64),
        R=np.eye(3), C=np.zeros(3)))
    mvs = SceneMVS(platforms=[plat])
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i, cam in enumerate(scene.cameras):
        plat.poses.append(Pose(R=cam.R.cpu().numpy().astype(np.float64),
                               C=cam.C.cpu().numpy().astype(np.float64)))
        name = f"im{i:04d}.png"
        write_png(os.path.join(img_dir, name),
                  (scene.images[i] * 255).astype(np.uint8), png_filter)
        mvs.images.append(ImageRecord(name=name, platform_id=0,
                                      camera_id=0, pose_id=i, id=i))
    n_sparse = len(points)
    mvs.points = points
    mvs.point_view_counts = np.full(n_sparse, n, np.int32)
    mvs.point_view_ids = np.tile(np.arange(n, dtype=np.uint32), n_sparse)
    mvs.point_view_confs = np.ones(n_sparse * n, np.float32)
    path = os.path.join(root, "scene.mvs")
    write_mvs(path, mvs)
    return path, img_dir


def distort_images(images: List[np.ndarray], K: np.ndarray,
                   k: np.ndarray) -> List[np.ndarray]:
    """Distorted photos from ideal pinhole renders: D(p) = I(undistort(p))
    (bilinear, float32), so that ``sfm.distortion.undistort_image(D)``
    gives I back; the synthetic photos of the JAX package's distortion
    golden (tests/test_distortion.py)."""
    from hcmvs_tpu_torch.sfm.distortion import undistort_points_px
    h, w = images[0].shape
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    uv = np.stack([xx, yy], -1).reshape(-1, 2)
    src = undistort_points_px(
        torch.from_numpy(uv), torch.from_numpy(np.array(K, np.float32)),
        torch.from_numpy(np.array(k, np.float32))).numpy().reshape(h, w, 2)
    x = np.clip(src[..., 0], 0, w - 1.001)
    y = np.clip(src[..., 1], 0, h - 1.001)
    x0 = x.astype(np.int64)
    y0 = y.astype(np.int64)
    fx = x - x0
    fy = y - y0
    return [((im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx) * (1 - fy)
             + (im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx) * fy
             ).astype(np.float32) for im in images]


def write_photos(photo_dir: str, images: List[np.ndarray],
                 focal_35mm=None) -> List[str]:
    """Write (H, W) images in [0, 1] as 8-bit gray PNGs
    ``photo_dir/p%02d.png``, each with an ``eXIf`` chunk holding
    FocalLengthIn35mmFilm when ``focal_35mm`` is given (the photo
    directory of ``pipeline.mvgmvs``); returns the paths."""
    from hcmvs_tpu_torch.io.exif import exif_bytes
    from hcmvs_tpu_torch.io.images import write_png
    os.makedirs(photo_dir, exist_ok=True)
    blob = (None if focal_35mm is None
            else exif_bytes(FocalLengthIn35mmFilm=float(focal_35mm)))
    paths = []
    for i, im in enumerate(images):
        paths.append(os.path.join(photo_dir, f"p{i:02d}.png"))
        write_png(paths[-1], (np.clip(im, 0, 1) * 255).astype(np.uint8),
                  exif=blob)
    return paths
