"""Writes the JPEG fixtures of the port's image decoders and their
manifest (needs numpy, torch, Pillow and OpenCV; runs on the CPU).

    PYTHONPATH=. python tests/data/jpeg/make_fixtures.py

- ``photos/p00.jpg`` .. ``p07.jpg``: chip_smoke.py phase 16's scene, the
  ridge of ``make_ridge_scene(default_rng(0))`` at 1280x960 with the blob
  texture, focal 1200 px, views 0.25 apart, put through a radial
  distortion k1 = -0.15 (``distort_images``), as 8-bit RGB (the gray
  render three times) baseline 4:2:0 JPEGs at quality 95 whose APP1
  EXIF holds FocalLengthIn35mmFilm = 33.75 (-> 1200 px).
- ``variants/``: small images (48x64, a seeded pattern), one feature
  each: every chroma sampling cv2 writes, progressive, restart markers,
  optimized Huffman tables, gray, an RGB (Adobe transform 0) file, EXIF
  orientations 6 and 8, and a PNG whose ``eXIf`` chunk holds orientation
  6.
- ``manifest.json``: for each file and each of ``cv2.imread``'s
  IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED, the shape and the
  sha256 of the array cv2 returns (C order, cv2's BGR channel order).

``tests/test_torch_images.py`` re-derives every digest from cv2, so the
manifest cannot go stale; ``chip_smoke.py`` holds the port's decodes to
it where no cv2 exists.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHOTO_HW = (960, 1280)
PHOTO_VIEWS = 8
PHOTO_K1 = -0.15
PHOTO_QUALITY = 95
MODES = ("color", "gray", "unchanged")


def ridge_photos(h: int, w: int, n_views: int = PHOTO_VIEWS,
                 device: str = "cpu"):
    """(scene, uint8 photos): phase 16's ridge at h x w (focal 1200 w /
    1280, blob texture summed in torch on ``device``) through k1."""
    from hcmvs_tpu_torch.utils.synth import (blob_texture_fn,
                                             distort_images,
                                             make_ridge_scene)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views, fx=1200.0 * w / 1280,
                          spacing=0.25, texture_fn=blob_texture_fn(
                              np.random.default_rng(0), device=device))
    K = np.asarray(sc.cameras[0].K)
    photos = distort_images(sc.images, K, np.array([PHOTO_K1, 0.0, 0.0]))
    return sc, [(np.clip(p, 0, 1) * 255).astype(np.uint8) for p in photos]


def focal_exif(focal_35mm: float) -> bytes:
    """An EXIF block holding FocalLengthIn35mmFilm, as Pillow writes it."""
    from PIL import Image
    exif = Image.Exif()
    exif.get_ifd(0x8769)[41989] = focal_35mm
    return exif.tobytes()


def save_jpeg_photos(photo_dir: str, photos, focal_35mm: float):
    """Each (H, W) uint8 photo as ``p%02d.jpg``: RGB, baseline 4:2:0,
    quality 95, FocalLengthIn35mmFilm in its EXIF; returns the paths."""
    from PIL import Image
    os.makedirs(photo_dir, exist_ok=True)
    paths = []
    for i, im in enumerate(photos):
        paths.append(os.path.join(photo_dir, f"p{i:02d}.jpg"))
        Image.fromarray(np.repeat(im[..., None], 3, -1)).save(
            paths[-1], "JPEG", quality=PHOTO_QUALITY, subsampling=2,
            exif=focal_exif(focal_35mm))
    return paths


def pattern(h: int = 48, w: int = 64) -> np.ndarray:
    """(h, w, 3) uint8 RGB: smooth colour ramps plus seeded noise, so that
    every chroma sampling and the upsampling's edges are exercised."""
    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / 5 + y / 9),
                    128 + 90 * np.cos(x / 7 - y / 4),
                    128 + 90 * np.sin((x + y) / 6)], -1)
    return np.clip(img + rng.normal(0, 18, img.shape), 0,
                   255).astype(np.uint8)


def write_variants(var_dir: str):
    """The small variants; returns their paths."""
    import cv2
    from PIL import Image
    os.makedirs(var_dir, exist_ok=True)
    rgb = pattern()
    bgr = rgb[..., ::-1]
    out = []
    cv2_cases = {
        "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
        "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
        "s420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
        "s440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
        "s411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111],
        "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
        "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    }
    for name, params in cv2_cases.items():
        out.append(os.path.join(var_dir, f"{name}.jpg"))
        cv2.imwrite(out[-1], bgr, [cv2.IMWRITE_JPEG_QUALITY, 90] + params)
    out.append(os.path.join(var_dir, "gray.jpg"))
    cv2.imwrite(out[-1], rgb[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    out.append(os.path.join(var_dir, "rgb.jpg"))
    Image.fromarray(rgb).save(out[-1], "JPEG", quality=90, keep_rgb=True)
    for orient in (6, 8):
        exif = Image.Exif()
        exif[274] = orient
        out.append(os.path.join(var_dir, f"orient{orient}.jpg"))
        Image.fromarray(rgb).save(out[-1], "JPEG", quality=90,
                                  exif=exif.tobytes())
    exif = Image.Exif()
    exif[274] = 6
    out.append(os.path.join(var_dir, "orient6.png"))
    Image.fromarray(rgb).save(out[-1], "PNG", exif=exif.tobytes())
    return out


def cv2_digests(path: str) -> dict:
    """{mode: {"shape", "sha256"}} of ``cv2.imread``'s three reads."""
    import cv2
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    out = {}
    for mode in MODES:
        img = np.ascontiguousarray(cv2.imread(path, flags[mode]))
        out[mode] = {"shape": list(img.shape),
                     "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    return out


def manifest_entries(root: str = HERE) -> dict:
    """{relative path: cv2_digests} of every fixture under ``root``."""
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, names in os.walk(root) for f in names
                   if f.endswith((".jpg", ".png")))
    return {f: cv2_digests(os.path.join(root, f)) for f in files}


def main() -> int:
    import cv2
    h, w = PHOTO_HW
    _, photos = ridge_photos(h, w)
    save_jpeg_photos(os.path.join(HERE, "photos"), photos,
                     1200.0 * 36.0 / 1280)
    write_variants(os.path.join(HERE, "variants"))
    manifest = {"cv2": cv2.__version__, "files": manifest_entries()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
