#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hcmvs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build: compile the CUDA kernels from hcmvs_tpu_torch/kernels/csrc,
     and the earlier designs of kernels B and D from csrc/earlier into a
     library of their own (one nvcc per source, all started together);
  3. kernel parity: each of the five kernels against its plain PyTorch
     version on the card, at the 1280x960 shapes the paths give it (B
     at every index-field width: 36 and 9 offsets, and the densify
     path's 64 and 16 on a table at its depth range; D at 324 and 81
     columns), A, B (64, 16) and C also at the hierarchy's 640x480 ones,
     and E also at 12 views (two launches), with its device time (``cuda_ms``: launches queued
     behind a spin kernel, so the host's launch work is not counted;
     checked against torch.profiler on kernel A), B's and D's earlier
     designs timed on the same inputs (``earlier_ms``), and the least
     time the card could take (bound: B's and D's table bytes are the
     sectors this run's lookups read);
  4. the exact path through the kernels: estimate_scene + finalize at
     4 views x 3 neighbours, 1280x960, exact table scoring; kernels A, B
     and C must have launched;
  5. the same path through the plain versions on the card, compared with
     phase 4;
  6. the hybrid, candidate-batched path through the kernels (warped
     scoring in the photometric phase, batched table scoring in the
     geometric one); all five kernels must have launched;
  7. the same path through the plain versions, compared with phase 6;
  8. the densify path through the kernels: the DensifyPointCloud entry
     point (``hcmvs_tpu_torch.pipeline.densify.main``) on the same scene
     written as ``scene.mvs`` + four 1280x960 PNGs, at DenseConfig()
     defaults plus ``resolution-level=0`` (4 external iterations of 3
     sweeps, 6 random steps, the mid-schedule filter at iterations 1 and
     2, LK flow, 3 neighbours); kernels A, B and C must have launched, the
     ``.dmap`` / ``.ply`` / ``.mvs`` files must read back, view 0 must
     reach its accuracy floor and the fused cloud must lie on the plane;
  9. the same ``densify`` through the plain versions, compared with 8;
 10. the hierarchy path through the kernels: the hierarchical-cross
     schedule's entry point (``hcmvs_tpu_torch.pipeline.hierarchy.main``)
     on a 4-view ridge scene written as ``scene.mvs`` + four 2560x1920
     PNGs at DenseConfig() with two external iterations a stage
     (HIER_FLAGS): the five default stages (levels 3 / 2 / 2 /
     1 / 1, variants A / B / A / B / A) at 640 / 640 / 640 / 1280 / 1280
     wide, with the cross-scale injection in the B stages; kernels A, B
     and C must have launched (C in every A stage), each stage's launches,
     seconds and view 0 accuracy against the ground truth at its size are
     printed, the ``.dmap`` / ``.ply`` files must read back, view 0 must
     reach its floor and the fused cloud must lie on the ridge;
 11. the same hierarchy through the plain versions, compared with 10;
 12. the masked densify path through the kernels: the DensifyPointCloud
     entry point on a 4-view ridge scene written as ``scene.mvs`` + four
     1280x960 PNGs (phase 10's texture) with a 16-bit face mask
     (``<stem>.mask.png``, labels 1000 / 2000) and a colour label image
     beside each image, and ``--priors-dir`` holding view 1's ground
     truth at 320x240, at DenseConfig() plus ``resolution-level=0`` and
     ``use-semantic=1``: the planar-prior pass (superpixel planes, RANSAC
     planes per mask region, the a-contrario gate, the external channel
     merged in on view 1) must run exactly once and cover part of view 0,
     kernels A, B and C must have launched, the files must read back and
     view 0 must reach its floor; then ``--project-labels`` colours the
     dense cloud from the label images;
 13. the same masked densify through the plain versions, compared with 12
     (view 0's prior maps included);
 14. the mesh path: a 60,000-point subsample of phase 12's dense cloud
     (with its view lists) through the three mesh apps
     (``hcmvs_tpu_torch.pipeline.mesh_apps.main``) at their defaults:
     reconstruct (graph cut, remove-spurious 20, close-holes 30, smooth
     2), refine (3 scales, 10 iterations each, on the four 1280x960
     images) and texture (LBP, seam leveling, 1024 atlas); the PLY, OBJ,
     MTL and PNG files must read back, the mesh must reach its F-score
     floor and refine must not lower it by more than 0.01; each stage's
     seconds, refine's gradient device time and device operations per
     iteration and the peak memory are printed (no kernel of the port is
     on this path: the reference's mesh stages reach no Pallas kernel);
 15. the same mesh again: refine and the labelling give equal vertices and
     labels, and one refine gradient on the card agrees with the CPU's;
 16. photos -> SfM -> dense: the MvgMvsPipeline entry point
     (``hcmvs_tpu_torch.pipeline.mvgmvs.main``, SEQUENTIAL, distortion
     estimated, ``--no-mesh``, ``resolution-level=0``, two external
     iterations) on 8 ridge photos at
     1280x960 (focal 1200 px) put through a radial distortion k1 = -0.15
     and written as PNGs whose EXIF holds FocalLengthIn35mmFilm = 33.75:
     K from EXIF exactly 1200, 8 of 8 views registered, k1 in (-0.25,
     -0.08), the refined rms below the unrefined one and within 0.05 px
     of the JAX package's on these photos, ATE below 0.025 after
     similarity alignment, kernels A, B and C launched,
     ``scene.mvs`` / ``scene_dense.ply`` read back, view 0's depth (times
     the median ratio to the ground truth) at its floor; each stage's
     seconds and the peak memory are printed; then the dense step again
     from the same SfM result through the plain versions (no launch),
     compared;
 17. SfM again on those photos, library calls only: ``incremental_sfm``
     twice (poses, points and tracks equal), the GLOBAL preset's
     ``global_sfm`` + ``refine_with_distortion`` (8 of 8 with finite poses
     and points, its ATE at most a margin above the JAX package's on
     these photos);
 18. bundle adjustment at scale: ``eval.ba_bench`` at 200 cameras, 200,000
     points, ~1 M observations, 8 LM iterations on the PCG solver: the
     final rms within 0.01 px of the JAX package's on the same problem
     and at most 0.6 px, seconds per step, the PCG budget, peak memory; a
     second run equal;
 19. the whole chain, small: ``mvgmvs.main`` with mesh and texture on 4
     pinhole ridge photos at 320x240 at ``DenseConfig()`` with two external
     iterations; the PLY mesh,
     OBJ, MTL and PNG atlas read back with at least one face; then its
     dense step again through the plain versions, compared;
 20. kernels B and D past 128 planes: B on view 0's per-plane tables at
     256 / 384 / 512 planes (image-order rows) at the four field widths,
     D on the 256-plane table in its three modes at 324 and 81 columns,
     bit-equal to their plain versions, timed, with their bounds;
 21. the dense routes on the quality ladder's ridge scene at 1280x960
     (``hcmvs_tpu_torch.eval.quality_ladder``, 5 views, 3 neighbours, 3 x
     2 sweeps): rect tables at 128 planes, the per-plane build at 128 and
     256, direct bilinear + direct geo, rect tables + view spread (also at
     640x480): view 0's accuracy against its floors, each route's kernels
     launched (none on the direct route), wall and peak memory; then the
     256-plane route through the plain versions (no launch, the same map);
 22. the reference's 10-neighbour operating point: 11 views x 10
     neighbours at 1280x960 (bench._build's workload at one sweep a
     phase, 128 planes) with
     streamed tables, then with scene-wide attached ones (bit-equal maps;
     at 640x480 if they do not fit), chunks of 4 / 4 / 3 views against
     one sweep call (equal), and 256 planes streamed with the candidates
     batched (kernel D), with views/s, the live tables' bytes and the
     peak memory of each.
 23. kernels B, D and E past the caps they once had: B at 512 planes on
     4.3 M rows (2.2 G table entries) and D packed and bounded at 576
     columns on 3.8 M rows (2.19 G items), each in two row chunks and
     bit-equal to its plain version; E with 140 warped offsets
     (adapt_half_window 11, patch step 2) on view 0's three pairs at
     1280x960, exact; each timed, with its bound;
 24. SGM: densify --fusion-mode -2, then -1, through the CLI entry point
     on phase 8's scene: no kernel launched, view 0 at its floor, the
     .dmap / .ply files read back, the two modes' maps equal, SGM's wall,
     device operations and peak memory printed; then the box scene's
     left-right check removing occlusion ghosts;
 25. ``eval.golden`` on the card at 144x192, 5 views: the default run,
     ``--hierarchy`` and ``--full-stack --fx 180``, each key held against
     the JAX package's same-tree CPU run of that mode;
 26. ``eval.full_run`` at 1280x960, 6 views (SfM, the 5-stage hierarchy,
     fusion, graph cut, refine, texture): ATE, depth accuracy, mesh
     F-score and refine's drop against their gates, each stage's wall
     and the peak memory;
 27. real photos: every JPEG fixture of tests/data/jpeg through
     ``io.images.imread`` (the port's own decoder, native/jpeg.cpp, built
     on first use) in its three modes against the manifest's cv2
     digests, the decode's ms per megapixel and ``resize_image``'s time
     to halve a 6000x4000 gray and RGB image on this host; then the 8
     committed 1280x960 JPEG photos (phase 16's scene, EXIF focal
     33.75 mm) through ``mvgmvs.main`` as phase 16 runs them: K exactly
     1200 from EXIF, 8 of 8 registered, k1 in its window, ATE below
     0.025, the refined rms within 0.05 px of the JAX package's on these
     JPEGs, view 0 at its floor, kernels A, B and C launched.
Phases 19, 21, 24-26 and 27's pipeline run last, after phase 23 and 27's
decoder check, side by side, each in a process of its own
(``chip_smoke.py --worker KIND OUT``, an internal mode), which counts
its own launches and hands them back.  Launches are counted by kernel
and output shape (B and D with the table's depth).  Then a JSON line per
path, one for the kernels, the nvidia-smi line, and a last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, without a CUDA device or without the package beside this
script.  The densify, hierarchy, mesh, photo, SGM and full-run outputs go
to temporary directories beside this script, removed at the end.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H, W, N_VIEWS, N_NBR = 960, 1280, 4, 3
MARGIN = 6   # interior margin of depth_acc_2pct, as in the parity tests
# H100 SXM peaks (NVIDIA data sheet) for the bound: device memory rate and
# float32 outside the tensor cores (the kernels' integer work is counted
# at the same rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# spin-kernel clock for cuda_ms's sleep (H100 SXM boost 1.98 GHz; a lower
# clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 1.98e9
MAX_SLEEP_CYCLES = 2 ** 33
# kernel A's time from CUDA events and from torch.profiler must agree
TIMER_AGREEMENT = 0.05
# operations per output element of each kernel (from its source: index
# arithmetic, clamps, decode, lerp, encode; kernel E per offset, its exp
# counted as one)
OPS_PER_ELEMENT = {"rect_build": 25, "volume_lookup": 10, "rect_lookup": 15,
                   "volume_lookup_multi": 10, "zncc_warped": 20}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sleep_cycles(fn, reps: int, warmup: int) -> int:
    """Spin-kernel cycles that should outlast the host's enqueue of
    ``reps`` calls: twice their synchronised host time, at least 1 ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    seconds = max(2 * reps * (time.perf_counter() - t0), 1e-3)
    return int(seconds * SLEEP_CYCLES_PER_S)


def _queued_round(fn, reps: int, cycles: int):
    """(ms per call, covered): CUDA events around ``reps`` calls queued
    behind a spin kernel of ``cycles``; ``covered`` is False when the
    spin had ended before the last call was queued."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    covered = not a.query()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, covered


def cuda_ms(fn, reps: int, warmup: int = 2, rounds: int = 5,
            host_bound_ok: bool = False) -> float:
    """Device milliseconds of one call of ``fn``: the median over
    ``rounds`` of the time between two CUDA events around ``reps`` calls
    queued back to back, divided by ``reps``.

    A spin kernel (``torch.cuda._sleep``) keeps the stream busy while the
    host enqueues the calls, so the launchers' host work (argument checks,
    allocation, ctypes) overlaps the device's work instead of being timed.
    If the first event has already fired when the last call is queued,
    the spin was too short: the round is repeated with twice the spin.  A
    function that makes the host wait for the device (kernel A's plain
    version does at 1280x960) cannot be covered: with ``host_bound_ok``
    its rounds count as they come, host waits included; without, it
    raises."""
    cycles = _sleep_cycles(fn, reps, warmup)
    times = []
    while len(times) < rounds:
        ms, covered = _queued_round(fn, reps, cycles)
        if covered or host_bound_ok:
            times.append(ms)
        elif cycles < MAX_SLEEP_CYCLES:
            cycles *= 2
        else:
            raise RuntimeError("cuda_ms: the host could not queue the calls "
                               "ahead of the device")
    times.sort()
    return times[len(times) // 2]


def timer_check(fn, kernel: str, reps: int):
    """(events ms, profiler ms) per call of ``fn``, both from the same
    ``reps`` launches of one queued round (``cuda_ms``'s method) taken
    under torch.profiler: the events' span over ``reps`` and the mean
    device time of the CUDA kernels whose name contains ``kernel``.  The
    spin is four times ``cuda_ms``'s first guess, since the profiler
    slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cycles = 4 * _sleep_cycles(fn, reps, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms, covered = _queued_round(fn, reps, cycles)
    if not covered:
        raise RuntimeError("timer_check: the host could not queue the calls "
                           "ahead of the device")
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in evs)
    if n != reps:
        raise AssertionError(f"profiler: {n} launches of {kernel}, expected "
                             f"{reps} ({[e.key for e in evs]})")
    return ms, sum(e.device_time_total for e in evs) / n / 1e3


def device_busy(fn):
    """(ms, count): the summed device time and the number of the device
    operations (kernels, copies, fills) of one call of ``fn``, from
    torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return (sum(e.device_time_total for e in evs) / 1e3,
            sum(e.count for e in evs))


def bound(name: str, n_bytes: float, n_elements: float):
    """(ms, "bytes" or "operations"): the least time of the work, the
    larger of its bytes over the memory rate and its operations over the
    float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_elements * OPS_PER_ELEMENT[name] / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def table_bytes(tab, i0, need=None) -> int:
    """Bytes of the u16 table ``tab`` (P, D) that this run's lookups
    need: the distinct 32-byte sectors of each row holding tap ``i0`` or
    ``i0 + 1`` ((P, S) int64), of the entries where ``need`` holds (all
    by default).  A lookup that ends near one end of the grid, or outside
    its bounds, needs less than the whole row."""
    import torch
    per = 32 // tab.element_size()
    n_sec = -(-tab.shape[1] // per)
    touched = torch.zeros((tab.shape[0], n_sec + 1), dtype=torch.bool,
                          device=tab.device)
    for idx in (i0 // per, (i0 + 1) // per):
        if need is not None:
            idx = torch.where(need, idx, n_sec)
        touched.scatter_(1, idx, True)
    return int(touched[:, :n_sec].sum()) * 32


def make_scene(dev):
    """The bench scene (bench._build) at 1280x960, focal length scaled with
    width as hcmvs_tpu/eval/golden.py does."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W,
                          n_views=N_VIEWS, fx=180.0 * W / 192.0)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(dev)
    nbr = [[j for j in range(N_VIEWS) if j != i][:N_NBR]
           for i in range(N_VIEWS)]
    scene = SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]).to(dev),
        cams=cams, nbr_idx=torch.tensor(nbr, device=dev),
        nbr_valid=torch.ones(N_VIEWS, N_NBR, dtype=torch.bool, device=dev),
        d_min=torch.full((N_VIEWS,), sc.d_min, device=dev),
        d_max=torch.full((N_VIEWS,), sc.d_max, device=dev))
    return sc, scene


def slice_cfg():
    """bench._build's workload plus one photometric and one geometric
    external iteration, without the (unported) fusion filter."""
    from hcmvs_tpu_torch.core.config import DenseConfig
    return DenseConfig(adapt_half_window=5, patch_half_window=3,
                       patch_step=2, estimation_iters=2, random_iters=4,
                       use_optical_flow=0, use_geo_consistency=1,
                       use_part_consistency=1, estimation_iters_external=2,
                       optimize=0)


# the kernels each path runs
EXACT_KERNELS = ("rect_build", "volume_lookup", "rect_lookup")
HYBRID_KERNELS = EXACT_KERNELS + ("volume_lookup_multi", "zncc_warped")
# view 0 depth_acc_2pct floors.  With two external iterations the hybrid
# path's warped photometric phase (explore sampling: one exactly warped
# corner) leaves it far below the exact path, in the JAX package too, and
# lower the larger the image (tests/test_torch_batched.py, run as a
# script, compares the two packages at a given size; PERF.md has the
# numbers); the random init scores about 0.05.
MIN_ACC = {"exact": 0.5, "hybrid_batched": 0.15, "densify": 0.85,
           "hierarchy": 0.85, "densify_masks": 0.85}
# the densify path: DenseConfig() defaults plus these reference flags; the
# fused cloud's median distance to the scene's plane, at most this share
# of the median depth (the JAX package's own CPU runs of this config at
# 96x128 and 240x320 reach 0.0015 and 0.0010; PERF.md)
DENSIFY_FLAGS = ("resolution-level=0",)
MAX_CLOUD_DISTANCE = 0.01
# the densify path's images are written with the Paeth row filter, as
# OpenCV's encoder writes smooth images, so that their decode takes the
# decoder's wavefront, its slow path
DENSIFY_PNG_FILTER = 4


# the hierarchy path: a 4-view ridge scene written as HIER_IMAGE_HW PNGs,
# through the hierarchy CLI at DenseConfig() + HIER_FLAGS; the default
# schedule's levels
# 3 / 2 / 2 / 1 / 1 run at 640 / 640 / 640 / 1280 / 1280 wide (its
# min_resolution of 640 clamps levels 3 and 2 to HIER_LEVEL_HW).  Its
# floor is the densify app's (the JAX package's own hierarchy on this
# scene at 144x192 and 240x320 reads above 0.90 on the CPU; PERF.md)
HIER_IMAGE_HW = (1920, 2560)
HIER_LEVEL_HW = (480, 640)
# two external iterations a stage (DenseConfig() runs four): the whole
# script must stay inside its time limit with phases 23-26; every check of
# phases 10-11 stays
HIER_FLAGS = ("n-EstimationIters-external=2",)


def hierarchy_scene(h: int, w: int, textured: bool = True):
    """The hierarchy path's ridge scene at h x w (focal length scaled with
    width as hcmvs_tpu/eval/golden.py does, the plane scene's sinusoid
    texture); untextured it only renders the ground truth."""
    import numpy as np
    from hcmvs_tpu_torch.utils.synth import (make_ridge_scene,
                                             sinusoid_texture_fn)
    tex = (sinusoid_texture_fn(np.random.default_rng(12345)) if textured
           else lambda xy: np.zeros(xy.shape[:-1], np.float32))
    return make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                            n_views=N_VIEWS, fx=180.0 * w / 192.0,
                            texture_fn=tex)


# the masked densify path: the densify flags plus use-semantic=1 on the
# ridge scene at H x W with face masks, label images and view 1's ground
# truth at MASKS_PRIOR_HW as an external prior map.  Its floor is the
# densify app's (the JAX package's own densify of this scene with masks
# reads 0.9754 at 240x320 on the CPU; PERF.md); kernel and plain runs'
# view 0 prior maps must agree (both 0, or within MASKS_PRIOR_RTOL) on
# MASKS_PRIOR_AGREE of the pixels: the prior pass's float sums on the card
# add in a varying order, which may flip an inlier threshold
MASKS_FLAGS = DENSIFY_FLAGS + ("use-semantic=1",)
MASKS_PRIOR_HW = (240, 320)
MASKS_PRIOR_RTOL = 1e-3
MASKS_PRIOR_AGREE = 0.99

# the mesh path: the three mesh apps (hcmvs_tpu_torch.pipeline.mesh_apps)
# at their defaults on phase 12's dense output, cut to a MESH_POINTS
# subsample of its cloud (default_rng(1), as hcmvs_tpu/eval/full_run.py:
# 198).  Floors: the mesh F-score at 1% of view 0's median ground-truth
# depth (MESH_SAMPLES samples each side, as full_run.py:221-233) at or
# above MESH_FSCORE_FLOOR, the lowest of the JAX package's own chain on
# this scene on the CPU less 0.05: 0.8488 / 0.8292 / 0.7849 at 240x320 /
# 480x640 / 720x960 (tests/test_torch_mesh.py H W; it falls with size,
# so the largest size that ends sets it), and refine lowering it by no
# more than MESH_REFINE_DROP; at least
# MESH_MIN_FACES faces and MESH_MIN_LABELLED of them labelled.  Phase 15:
# refine and the labelling again give equal vertices and labels (fixed-
# order sums), and one gradient on the card is within MESH_GRAD_RTOL
# (relative L2) of the CPU's
MESH_POINTS = 60000
MESH_SAMPLES = 12000
MESH_FSCORE_FLOOR = 0.7349
MESH_REFINE_DROP = 0.01
MESH_MIN_FACES = 10000
MESH_MIN_LABELLED = 0.5
MESH_GRAD_RTOL = 1e-4


def densify_cfg(flags=DENSIFY_FLAGS):
    """DenseConfig() defaults plus ``flags``, as a densify path runs
    them."""
    from hcmvs_tpu_torch.core.config import config_from_cli_flags
    return config_from_cli_flags(dict(f.split("=", 1) for f in flags))


def _d_mode(a) -> tuple:
    """Kernel D's mode as a launch-key suffix: none for the bounded mode
    (the paths' own), "packed" or "f32" otherwise."""
    import torch
    if a[1].dtype == torch.float32:
        return ("f32",)
    return () if len(a) > 2 and a[2] is not None else ("packed",)


# each kernel's launches are counted by the shape of its output, read
# from its arguments: A (V, P_pad, 128), B (P, S) and D (P, C) with the
# table's depth D appended (P, S, D) / (P, C, D) (D's mode after that
# unless bounded), C (V, 2, H, W), E (V, H, W)
SHAPE_OF = {
    "rect_build": lambda a: (a[0].shape[0], a[6], 128),
    "volume_lookup": lambda a: tuple(a[1].shape) + (a[0].shape[1],),
    "rect_lookup": lambda a: tuple(a[0].shape[:2]) + tuple(a[5].shape),
    "volume_lookup_multi": lambda a: (tuple(a[1].shape) + (a[0].shape[1],)
                                      + _d_mode(a)),
    "zncc_warped": lambda a: (a[3].shape[0],) + tuple(a[1].shape)}


def shape_key(shape) -> str:
    return "x".join(x if isinstance(x, str) else str(int(x))
                    for x in shape)


@contextlib.contextmanager
def launch_shapes():
    """Counts each kernel's launches by output shape inside the block:
    recorders around the launchers in ``kernels``, which the ops call
    through the module; each adds what the launcher added to
    ``kernels.launches`` (which is unchanged).  Yields {kernel: Counter
    of shape keys}."""
    from hcmvs_tpu_torch import kernels
    counts = {name: collections.Counter() for name in SHAPE_OF}
    launchers = {name: getattr(kernels, name) for name in SHAPE_OF}

    def recorder(name):
        def recorded(*args):
            before = kernels.launches[name]
            out = launchers[name](*args)
            counts[name][shape_key(SHAPE_OF[name](args))] += (
                kernels.launches[name] - before)
            return out
        return recorded

    for name in SHAPE_OF:
        setattr(kernels, name, recorder(name))
    try:
        yield counts
    finally:
        for name, launch in launchers.items():
            setattr(kernels, name, launch)


def check_shapes(label, launches, shapes, failed) -> dict:
    """Launches by output shape; a failed check unless each kernel's add
    up to its launch count."""
    out = {}
    for name, counts in shapes.items():
        log(f"[{label}] {name} launches by shape {dict(counts)}")
        if sum(counts.values()) != launches[name]:
            failed.append(f"{label}: {name} launches by shape "
                          f"{dict(counts)} do not add up to "
                          f"{launches[name]}")
        out[name] = dict(counts)
    return out


def read_rgb(path: str):
    """An image file's samples as stored, colour in RGB(A) order."""
    from hcmvs_tpu_torch.io.images import imread
    img = imread(path, "unchanged")
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def depth_acc_2pct(depth, gt) -> float:
    import numpy as np
    rel = np.abs(depth - gt) / gt
    m = MARGIN
    return float((rel < 0.02)[m:-m, m:-m].mean())


def lookup_cases(sc, scene, cfg, geom, st, rays):
    """Kernel B's and D's inputs at the shapes the paths give them, on
    view 0's first pair: ([(field, table, f)], [(table, f, bounds)]).

    B: a random (P_pad, 36) field, the fields of the random init ``st`` at
    the exact path's explore offsets (9), and, as the densify path runs
    it, at its final (64) and explore (16) offsets on a table at the depth
    range densify takes from the scene's sparse points.  D: the packed,
    bounded field of view 0's nine propagation candidates at full (C =
    324) and explore (C = 81) sampling."""
    import dataclasses

    import numpy as np
    import torch
    from hcmvs_tpu_torch.core.config import window_cfg_for_width
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.patchmatch import (_propagate_from,
                                                  propagation_offsets)
    from hcmvs_tpu_torch.dense.scene_driver import (init_scene_state,
                                                    phase_cfg)
    from hcmvs_tpu_torch.dense.view_selection import depth_range_from_points
    from hcmvs_tpu_torch.ops import volume as vol
    from hcmvs_tpu_torch.utils.synth import plane_sparse_points

    dev = st.depth.device
    nbr = scene.nbr_idx[0]
    w = scene.gray.shape[2]
    vt = vol.build_volume_tables_rect(geom, scene.gray[nbr], scene.d_min[0],
                                      scene.d_max[0])
    g = torch.Generator(device=dev).manual_seed(1)
    f = torch.rand((vt.tab.shape[1], 36), generator=g, device=dev) * 131 - 2
    b_cases = [("random", vt.tab[0], f), ("init", vt.tab[0], S.volume_fields(
        geom, vt, st.depth[0], st.normal[0], rays,
        S.patch_offsets(phase_cfg(cfg, 0, False)))[2])]
    pts = plane_sparse_points(sc)
    d_lo, d_hi = depth_range_from_points(
        pts, np.full(len(pts), N_VIEWS), np.tile(np.arange(N_VIEWS),
                                                 len(pts)),
        scene.cams.R[0].cpu().numpy().astype(np.float64),
        scene.cams.C[0].cpu().numpy().astype(np.float64), 0)
    log(f"[parity] densify depth range of view 0 (from the sparse points): "
        f"{d_lo:.4f} to {d_hi:.4f}, against {float(scene.d_min[0]):.4f} to "
        f"{float(scene.d_max[0]):.4f}")
    scene_d = dataclasses.replace(
        scene, d_min=torch.full_like(scene.d_min, d_lo),
        d_max=torch.full_like(scene.d_max, d_hi))
    vt_d = vol.build_volume_tables_rect(geom, scene.gray[nbr],
                                        scene_d.d_min[0], scene_d.d_max[0])
    st_d = init_scene_state(torch.Generator(device=dev).manual_seed(3),
                            scene_d)
    dcfg = window_cfg_for_width(densify_cfg(), w)
    for final in (True, False):
        offsets = S.patch_offsets(phase_cfg(dcfg, 0, final))
        b_cases.append(("init, densify range", vt_d.tab[0], S.volume_fields(
            geom, vt_d, st_d.depth[0], st_d.normal[0], rays, offsets)[2]))
    cand = [(st.depth[0], st.normal[0])] + [
        _propagate_from(st.depth[0], st.normal[0], rays, dy, dx)
        for dy, dx in propagation_offsets(cfg)]
    depths = torch.stack([c[0] for c in cand])
    normals = torch.stack([c[1] for c in cand])
    bounds0 = S.volume_bounds(vt, True)[0]
    d_cases = []
    for step in (cfg.patch_step, cfg.explore_patch_step):
        offsets = S.patch_offsets(cfg.replace(patch_step=step))
        f2, _ = S.packed_fields(geom, vt, depths, normals, rays, offsets)
        d_cases.append((vt.tab[0], f2, bounds0))
    return b_cases, d_cases


def hierarchy_level(dev):
    """The hierarchy path's scene at its coarse levels' size (HIER_LEVEL_HW,
    where levels 3 and 2 run): the ridge scene of ``hierarchy_scene`` as
    scene tensors, 3 neighbours a view, the depth range that
    ``build_scene_tensors`` takes from the sparse points."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.dense.view_selection import depth_range_from_points
    from hcmvs_tpu_torch.utils.synth import ridge_sparse_points
    h, w = HIER_LEVEL_HW
    sc = hierarchy_scene(h, w)
    pts = ridge_sparse_points(sc)
    d_lo, d_hi = depth_range_from_points(
        pts, np.full(len(pts), N_VIEWS), np.tile(np.arange(N_VIEWS),
                                                 len(pts)),
        np.eye(3), np.zeros(3), 0)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(dev)
    nbr = [[j for j in range(N_VIEWS) if j != i][:N_NBR]
           for i in range(N_VIEWS)]
    return SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]).to(dev),
        cams=cams, nbr_idx=torch.tensor(nbr, device=dev),
        nbr_valid=torch.ones(N_VIEWS, N_NBR, dtype=torch.bool, device=dev),
        d_min=torch.full((N_VIEWS,), d_lo, device=dev),
        d_max=torch.full((N_VIEWS,), d_hi, device=dev))


def hierarchy_lookup_cases(scene, nbr, geom, st):
    """Kernel B's inputs at the hierarchy's coarse levels: view 0's first
    pair's table and the index fields of the random init ``st`` at the
    final (64) and explore (16) offsets of DenseConfig(), which every
    stage of the default schedule samples with."""
    from hcmvs_tpu_torch.core.config import window_cfg_for_width
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.scene_driver import phase_cfg
    from hcmvs_tpu_torch.dense.types import pixel_rays
    from hcmvs_tpu_torch.ops import volume as vol
    h, w = scene.gray.shape[1:]
    rays = pixel_rays(geom.K_inv_ref, h, w)
    vt = vol.build_volume_tables_rect(geom, scene.gray[nbr], scene.d_min[0],
                                      scene.d_max[0])
    cfg = window_cfg_for_width(densify_cfg(), w)
    return [("hierarchy, init", vt.tab[0], S.volume_fields(
        geom, vt, st.depth[0], st.normal[0], rays,
        S.patch_offsets(phase_cfg(cfg, 0, final)))[2])
        for final in (True, False)]


def kernel_parity(sc, scene, cfg, dev):
    """Phase 3: each kernel vs its plain version at the paths' shapes.
    Returns one row per kernel (name, source, replaces, max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms, and for A-D ``shapes``: the
    same numbers at each shape the paths give the kernel, with, for B and
    D, the earlier design's time ``earlier_ms``; the row's own are its
    first shape's).  A, B and C are held at the slice's 1280x960 shapes
    and at the hierarchy's 640x480 ones."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.scene_driver import init_scene_state
    from hcmvs_tpu_torch.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu_torch.ops import rect_gather as rg
    from hcmvs_tpu_torch.ops import volume as vol
    from hcmvs_tpu_torch.ops import zncc_warped as zw
    from hcmvs_tpu_torch.ops.gradients import sobel_magnitude

    rows = []

    def measured(name, err, ms, plain_ms, n_bytes, n_elements, **extra):
        b_ms, b_by = bound(name, n_bytes, n_elements)
        return dict(extra, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    def row(name, replaces, *args, shapes=None):
        r = (dict(shapes[0], shapes=shapes) if shapes
             else measured(name, *args))
        r.pop("shape", None)
        r.pop("field", None)
        rows.append(dict(
            r, name=name, source=f"hcmvs_tpu_torch/kernels/csrc/{name}.cu",
            replaces=replaces,
            # no single PyTorch call computes any of these functions
            library_ms=None))

    # view 0 of the slice's scene and of the hierarchy's coarse levels,
    # each with a random init
    levels = []
    for label, sc_ in (("slice", scene), ("hierarchy", hierarchy_level(dev))):
        nbr = sc_.nbr_idx[0]
        geom = make_view_geometry(sc_.cams[0], sc_.cams[nbr])
        st = init_scene_state(torch.Generator(device=dev).manual_seed(2), sc_)
        levels.append((label, sc_, nbr, geom, st))

    # A: the rect-frame table build of view 0's three pairs
    shapes = []
    for label, sc_, nbr, geom, _ in levels:
        s = vol.rect_build_setup(geom, sc_.gray[nbr], sc_.d_min[0],
                                 sc_.d_max[0])
        args = (s.rect_src, s.rb, s.cb, s.rowf_g, s.c0w_g, s.kp_g, s.p_pad)
        tab = kernels.rect_build(*args)
        plain = vol._rect_build_plain(*args)
        d = (tab.to(torch.int32) - plain.to(torch.int32)).abs()
        log(f"[parity] A rect_build ({label}): tab {tuple(tab.shape)} u16, "
            f"max |kernel - plain| {int(d.max())} LSB")
        if int(d.max()) != 0:
            raise AssertionError(f"kernel A differs from its plain version "
                                 f"by up to {int(d.max())} LSB")
        shapes.append(measured(
            "rect_build", float(d.max()) / 65535.0,
            cuda_ms(lambda: kernels.rect_build(*args), 10),
            cuda_ms(lambda: vol._rect_build_plain(*args), 3, 1,
                    host_bound_ok=True),
            nbytes(*args[:-1], tab), tab.numel(), shape=list(tab.shape),
            field=label))
        if label == "slice":
            a_args = args
        del plain, d, tab
    row("rect_build", "hcmvs_tpu/ops/volume.py:569", shapes=shapes)

    # B: one pair's table against index fields of each width the paths
    # give it; D: the same table against the packed, bounded fields of
    # the propagation candidates (see lookup_cases)
    _, _, nbr, geom, st = levels[0]
    h, w = scene.gray.shape[1:]
    rays = pixel_rays(geom.K_inv_ref, h, w)
    b_cases, d_cases = lookup_cases(sc, scene, cfg, geom, st, rays)
    b_cases += hierarchy_lookup_cases(*levels[1][1:])
    shapes = []
    for field, tab0, f in b_cases:
        out = kernels.volume_lookup(tab0, f)
        plain = vol.volume_lookup_plain(tab0, f)
        with kernels.earlier_designs():
            earlier = kernels.volume_lookup(tab0, f)
        err = float((out - plain).abs().max())
        same = torch.equal(earlier, out)
        log(f"[parity] B volume_lookup ({field} field): table "
            f"{tuple(tab0.shape)}, field {tuple(f.shape)}, max |kernel - "
            f"plain| {err:.3g}, equal to the earlier design {same}")
        if err != 0 or not same:
            raise AssertionError(f"kernel B at {tuple(f.shape)}: max abs "
                                 f"err {err}, equal to the earlier design "
                                 f"{same}")
        ms = cuda_ms(lambda: kernels.volume_lookup(tab0, f), 20)
        with kernels.earlier_designs():
            earlier_ms = cuda_ms(lambda: kernels.volume_lookup(tab0, f), 20)
        shapes.append(measured(
            "volume_lookup", err, ms,
            cuda_ms(lambda: vol.volume_lookup_plain(tab0, f), 10,
                    host_bound_ok=True),
            nbytes(f, out) + table_bytes(tab0, torch.clamp(
                torch.floor(f), 0, tab0.shape[1] - 2).long()),
            out.numel(), shape=list(f.shape) + [tab0.shape[1]], field=field,
            earlier_ms=earlier_ms))
    row("volume_lookup", "hcmvs_tpu/ops/volume.py:211", shapes=shapes)
    del b_cases, tab0, f, out, plain, earlier

    # C: the neighbour maps of view 0 (random init) at the init depths
    shapes = []
    for label, _, nbr_, geom_, st_ in levels:
        ctx = rg.build_rect_context(geom_, rg.pack_depth_normals(
            st_.depth[nbr_], st_.normal[nbr_]))
        sigma = (1.0 / st_.depth[0]).contiguous()
        out = rg.rect_lookup(ctx, sigma)
        plain = rg.rect_lookup_plain(ctx, sigma)
        same = torch.equal(out.view(torch.int32), plain.view(torch.int32))
        hit = float((out[:, 0] != 0).float().mean())
        # the words are bit-packed: compare the depths and normals they
        # carry
        err = float((rg.unpack_taps(out)[0] - rg.unpack_taps(plain)[0])
                    .abs().max())
        log(f"[parity] C rect_lookup ({label}): out {tuple(out.shape)}, "
            f"bit-equal {same}, max |taps kernel - plain| {err:.3g}, reads "
            f"hit {hit:.4f}")
        if not same:
            raise AssertionError("kernel C differs from its plain version")
        c_args = (ctx.maps, ctx.row_int, ctx.c0, ctx.k, ctx.rb, sigma)
        shapes.append(measured(
            "rect_lookup", err,
            cuda_ms(lambda: kernels.rect_lookup(*c_args), 20),
            cuda_ms(lambda: rg.rect_lookup_plain(ctx, sigma), 10,
                    host_bound_ok=True),
            nbytes(*c_args, out), out[:, 0].numel(), shape=list(out.shape),
            field=label))
        del ctx, out, plain
    row("rect_lookup", "hcmvs_tpu/ops/rect_gather.py:322", shapes=shapes)
    del levels

    # D: view 0's table against the packed, bounded fields of its nine
    # propagation candidates at C = 324 and 81
    shapes = []
    for tab0, f2, bounds0 in d_cases:
        out = kernels.volume_lookup_multi(tab0, f2, bounds0)
        plain = vol.volume_lookup_multi_plain(tab0, f2, bounds0)
        with kernels.earlier_designs():
            earlier = kernels.volume_lookup_multi(tab0, f2, bounds0)
        oi, pi = vol.u16_as_int32(out), vol.u16_as_int32(plain)
        err = float((oi - pi).abs().max())
        same = torch.equal(vol.u16_as_int32(earlier), oi)
        valid = float((oi < 65535).float().mean())
        log(f"[parity] D volume_lookup_multi: out {tuple(out.shape)} u16 "
            f"bounded, bit-equal {err == 0}, valid {valid:.4f}, equal to "
            f"the earlier design {same}")
        if err != 0 or not same:
            raise AssertionError(f"kernel D differs from its plain version "
                                 f"by up to {err} LSB; equal to the "
                                 f"earlier design {same}")
        # of the bounds panel only lanes 0 and 64 are needed: two 32 B
        # sectors a row; of the table only what the in-bounds entries read
        fi = vol.u16_as_int32(f2)
        b = vol.u16_as_int32(bounds0)
        t_bytes = table_bytes(
            tab0, torch.clamp_max(fi >> 6, tab0.shape[1] - 2).long(),
            (fi >= b[:, :1]) & (fi <= b[:, 64:65]))
        del fi, b
        ms = cuda_ms(lambda: kernels.volume_lookup_multi(tab0, f2, bounds0),
                     20)
        with kernels.earlier_designs():
            earlier_ms = cuda_ms(
                lambda: kernels.volume_lookup_multi(tab0, f2, bounds0), 20)
        shapes.append(measured(
            "volume_lookup_multi", err, ms,
            cuda_ms(lambda: vol.volume_lookup_multi_plain(tab0, f2,
                                                          bounds0), 5,
                    host_bound_ok=True),
            nbytes(f2, out) + 64 * tab0.shape[0] + t_bytes, out.numel(),
            shape=list(out.shape) + [tab0.shape[1]], earlier_ms=earlier_ms))
        del f2, out, plain, earlier, oi, pi
    row("volume_lookup_multi", "hcmvs_tpu/ops/volume.py:290", shapes=shapes)
    del d_cases, bounds0, tab0

    # E: view 0's random init scored warped against its three neighbours
    # with the photometric phase's explore sampling (pad 5, 8 offsets), and
    # against twelve (the three, four times over): more views than one
    # launch holds, so two launches
    cfg_x = cfg.replace(patch_step=cfg.explore_patch_step)
    offsets = S.patch_offsets(cfg_x)
    hw = S.halfwin_map(sobel_magnitude(scene.gray[0]), cfg_x)
    stats = S.ref_patch_stats(scene.gray[0], hw, offsets)
    shapes = []
    for label, nbr_ in (("3 views", nbr), ("12 views", nbr.repeat(4))):
        geom_ = make_view_geometry(scene.cams[0], scene.cams[nbr_])
        x = S.warped_inputs(geom_, scene.gray[nbr_], stats, hw, st.depth[0],
                            st.normal[0], rays, offsets)
        e_args = x[:9]
        before = kernels.launches["zncc_warped"]
        out_s, out_v = kernels.zncc_warped(*e_args)
        n_launch = kernels.launches["zncc_warped"] - before
        plain_s, plain_v = zw.zncc_warped_plain(*e_args)
        err = max(float((out_s - plain_s).abs().max()),
                  float((out_v - plain_v).abs().max()))
        log(f"[parity] E zncc_warped ({label}): out {tuple(out_s.shape)} x "
            f"2 in {n_launch} launch(es), {len(x.scan_offsets)} offsets, pad "
            f"{x.pad}, max |kernel - plain| {err:.3g}")
        if err != 0:
            raise AssertionError(f"kernel E ({label}): max abs err {err}")
        shapes.append(measured(
            "zncc_warped", err,
            cuda_ms(lambda: kernels.zncc_warped(*e_args), 20),
            cuda_ms(lambda: zw.zncc_warped_plain(*e_args), 10,
                    host_bound_ok=True),
            nbytes(*(t for t in e_args if torch.is_tensor(t)), out_s, out_v),
            out_s.numel() * len(x.scan_offsets), shape=list(out_s.shape),
            field=label))
        del x, e_args, out_s, out_v, plain_s, plain_v
    row("zncc_warped", "hcmvs_tpu/ops/pallas_zncc.py:43", shapes=shapes)
    for r in rows:
        for x in r.get("shapes", [r]):
            at = f" {x['shape']}" if "shape" in x else ""
            was = (f", earlier design {x['earlier_ms']:.3f} ms"
                   if "earlier_ms" in x else "")
            log(f"[parity] {r['name']}{at}: kernel {x['ms']:.3f} ms{was}, "
                f"plain {x['plain_ms']:.3f} ms, bound {x['bound_ms']:.3f} "
                f"ms ({x['bound_by']}), {100 * x['bound_ms'] / x['ms']:.1f}% "
                f"of the bound")
    # the timer against the profiler's device time on kernel A
    ev_ms, prof_ms = timer_check(lambda: kernels.rect_build(*a_args),
                                 "rect_build", 10)
    gap = abs(ev_ms - prof_ms) / prof_ms
    log(f"[timer] A rect_build, the same 10 launches: CUDA events "
        f"{ev_ms:.4f} ms, torch.profiler {prof_ms:.4f} ms, {100 * gap:.2f}% "
        f"apart (cuda_ms: {rows[0]['ms']:.4f} ms)")
    if gap > TIMER_AGREEMENT:
        raise AssertionError(f"kernel A's event and profiler times are "
                             f"{100 * gap:.1f}% apart")
    return rows


def run_path(scene, cfg, dev, label):
    """One estimate_scene + finalize; returns (depth, keep, stage report,
    seconds)."""
    import torch
    from hcmvs_tpu_torch.dense.scene_driver import estimate_scene, finalize
    from hcmvs_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset_report()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state = estimate_scene(gen, scene, cfg)
    depth, normal, conf = finalize(state, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rep = profiling.report()
    if not (torch.isfinite(state.depth).all()
            and torch.isfinite(state.cost).all()
            and torch.isfinite(normal).all()):
        raise AssertionError(f"{label}: non-finite output")
    if tuple(depth.shape) != (N_VIEWS, H, W) \
            or tuple(normal.shape) != (N_VIEWS, 3, H, W):
        raise AssertionError(f"{label}: wrong output shapes")
    phases = ", ".join(f"{k[len('estimate.sweeps.'):]} {t:.3f} s"
                       for k, t in sweep_seconds(rep))
    log(f"[{label}] tables {rep['estimate.tables']['total_s']:.3f} s, "
        f"{phases}, total {seconds:.3f} s, {N_VIEWS / seconds:.4f} views/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"kept {float((depth > 0).float().mean()):.4f}")
    return state.depth.cpu().numpy(), depth.cpu().numpy() > 0, rep, seconds


def sweep_seconds(rep):
    """[(stage, seconds)] of the report's sweep stages, in run order."""
    return [(k, v["total_s"]) for k, v in rep.items()
            if k.startswith("estimate.sweeps.")]


def check_path(sc, scene, cfg, dev, label, path_kernels):
    """Phases 4-7 for one path: through the kernels (every kernel of the
    path launched, counts reset just before and read just after), then
    through the plain versions (no launch), compared.  Returns (launches,
    JSON summary, the checks that failed)."""
    import numpy as np
    from hcmvs_tpu_torch import kernels

    failed = []
    kernels.reset_launches()
    with launch_shapes() as shapes:
        depth_k, keep_k, t_k, sec_k = run_path(scene, cfg, dev, label)
    launches = dict(kernels.launches)
    log(f"[{label}] kernel launches {launches}")
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in path_kernels) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    acc_k = depth_acc_2pct(depth_k[0], sc.depth_gt)
    log(f"[{label}] view 0 interior depth_acc_2pct {acc_k:.4f}")
    if acc_k < MIN_ACC[label]:
        failed.append(f"{label}: depth accuracy {acc_k} < {MIN_ACC[label]}")

    kernels.reset_launches()
    with kernels.plain_versions():
        depth_p, keep_p, t_p, sec_p = run_path(scene, cfg, dev,
                                               f"{label} plain")
    if any(kernels.launches.values()):
        failed.append(f"{label} plain run launched kernels: "
                      f"{kernels.launches}")
    acc_p = depth_acc_2pct(depth_p[0], sc.depth_gt)
    agree = float((np.abs(depth_k - depth_p)
                   <= 0.01 * np.abs(depth_p)).mean())
    keep_agree = float((keep_k == keep_p).mean())
    log(f"[{label} plain] view 0 interior depth_acc_2pct {acc_p:.4f}; depth "
        f"within 1% of the kernel run on {agree:.5f} of pixels; keep masks "
        f"agree on {keep_agree:.5f}")
    if agree < 0.98:
        failed.append(f"{label}: kernel and plain runs agree on {agree}")
    if abs(acc_k - acc_p) > 0.01:
        failed.append(f"{label}: accuracy {acc_k} (kernels) vs {acc_p} "
                      f"(plain)")
    return launches, {
        "views": N_VIEWS, "neighbours": N_NBR, "h": H, "w": W,
        "tables_s": t_k["estimate.tables"]["total_s"],
        "phase_s": [t for _, t in sweep_seconds(t_k)],
        "total_s": sec_k, "views_per_s": N_VIEWS / sec_k,
        "plain_total_s": sec_p, "depth_acc_2pct": acc_k,
        "plain_depth_acc_2pct": acc_p, "agree_1pct": agree,
        "launches_by_shape": shapes}, failed


def _densify_run(scene_path, img_dir, out_dir, plain: bool):
    """One densify run on the card, the kernel pass through the CLI entry
    point, the plain pass through ``densify`` with the same work (depth
    PNGs included); returns (stats, stage report, seconds, peak GiB)."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import densify as D
    from hcmvs_tpu_torch.utils import profiling
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if plain:
        with kernels.plain_versions():
            stats = D.densify(scene_path, img_dir, out_dir, densify_cfg())
    else:
        stats = D.main(["--input-file", scene_path, "--images-dir", img_dir,
                        "-w", out_dir, "--flags", *DENSIFY_FLAGS])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (stats, profiling.report(), seconds,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def check_densify(sc, root):
    """Phases 8-9: the DensifyPointCloud path through the kernels (counts
    reset just before, read just after), its files read back and checked,
    then through the plain versions, compared.  Returns (launches, JSON
    summary, the checks that failed)."""
    import numpy as np
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.utils.synth import write_plane_scene

    label = "densify"
    failed = []
    t0 = time.perf_counter()
    scene_path, img_dir = write_plane_scene(str(root), sc,
                                            png_filter=DENSIFY_PNG_FILTER)
    log(f"[{label}] scene.mvs + {N_VIEWS} PNGs (row filter "
        f"{DENSIFY_PNG_FILTER}) written in "
        f"{time.perf_counter() - t0:.3f} s")
    out_k = str(root / "kernels")
    kernels.reset_launches()
    with launch_shapes() as shapes:
        st_k, rep_k, sec_k, peak_k = _densify_run(scene_path, img_dir,
                                                  out_k, plain=False)
    launches = dict(kernels.launches)
    log(f"[{label}] kernel launches {launches}")
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    for name, s in sorted(rep_k.items(), key=lambda kv: -kv[1]["total_s"]):
        log(f"[{label}] stage {name:<26} {s['total_s']:9.3f} s "
            f"x{int(s['calls'])}")
    log(f"[{label}] total {sec_k:.3f} s, {N_VIEWS / sec_k:.4f} views/s, "
        f"peak memory {peak_k:.2f} GiB, valid {st_k['valid_frac']:.4f}, "
        f"points {st_k['n_points']}")
    for i in range(N_VIEWS):
        dm = read_dmap(str(root / "kernels" / "depthmap"
                           / f"depth{i:04d}.dmap"))
        if dm.depth.shape != (H, W) or not np.array_equal(dm.depth,
                                                         st_k["depth"][i]):
            failed.append(f"{label}: depth{i:04d}.dmap reads back "
                          f"{dm.depth.shape}, not the run's map")
    dense = read_mvs(str(root / "kernels" / "scene_dense.mvs"))
    if not len(dense.points) == st_k["n_points"] > 0:
        failed.append(f"{label}: scene_dense.mvs has {len(dense.points)} "
                      f"points, stats {st_k['n_points']}")
    if not (root / "kernels" / "scene_dense.ply").exists():
        failed.append(f"{label}: no scene_dense.ply")
    acc_k = depth_acc_2pct(st_k["depth"][0], sc.depth_gt)
    dist = np.abs(dense.points.astype(np.float64) @ sc.n_w - sc.c_w)
    cloud = float(np.median(dist) / np.median(sc.depth_gt))
    log(f"[{label}] view 0 interior depth_acc_2pct {acc_k:.4f}; fused "
        f"cloud median distance to the plane / median depth {cloud:.6f}")
    if acc_k < MIN_ACC[label]:
        failed.append(f"{label}: depth accuracy {acc_k} < {MIN_ACC[label]}")
    if cloud > MAX_CLOUD_DISTANCE:
        failed.append(f"{label}: cloud distance {cloud} > "
                      f"{MAX_CLOUD_DISTANCE}")
    del dense, dist

    kernels.reset_launches()
    st_p, rep_p, sec_p, peak_p = _densify_run(scene_path, img_dir,
                                              str(root / "plain"), plain=True)
    if any(kernels.launches.values()):
        failed.append(f"{label} plain run launched kernels: "
                      f"{kernels.launches}")
    acc_p = depth_acc_2pct(st_p["depth"][0], sc.depth_gt)
    agree = float((np.abs(st_k["depth"] - st_p["depth"])
                   <= 0.01 * np.abs(st_p["depth"])).mean())
    n_rel = abs(st_k["n_points"] - st_p["n_points"]) / max(st_p["n_points"],
                                                             1)
    log(f"[{label} plain] total {sec_p:.3f} s (estimate "
        f"{rep_p['densify.estimate']['total_s']:.3f} s against "
        f"{rep_k['densify.estimate']['total_s']:.3f} s), peak memory "
        f"{peak_p:.2f} GiB, "
        f"view 0 interior depth_acc_2pct {acc_p:.4f}, points "
        f"{st_p['n_points']}; depth within 1% of the kernel run on "
        f"{agree:.5f} of pixels")
    if agree < 0.98:
        failed.append(f"{label}: kernel and plain runs agree on {agree}")
    if abs(acc_k - acc_p) > 0.01:
        failed.append(f"{label}: accuracy {acc_k} (kernels) vs {acc_p} "
                      f"(plain)")
    if n_rel > 0.01:
        failed.append(f"{label}: point counts {st_k['n_points']} (kernels) "
                      f"vs {st_p['n_points']} (plain)")
    return launches, {
        "views": N_VIEWS, "h": H, "w": W, "flags": list(DENSIFY_FLAGS),
        "total_s": sec_k, "views_per_s": N_VIEWS / sec_k,
        "stage_s": {k: v["total_s"] for k, v in rep_k.items()},
        "peak_gib": peak_k, "valid_frac": st_k["valid_frac"],
        "n_points": st_k["n_points"], "depth_acc_2pct": acc_k,
        "cloud_distance": cloud, "plain_total_s": sec_p,
        "plain_stage_s": {k: v["total_s"] for k, v in rep_p.items()},
        "plain_depth_acc_2pct": acc_p, "plain_n_points": st_p["n_points"],
        "agree_1pct": agree, "launches_by_shape": shapes}, failed


@contextlib.contextmanager
def stage_records():
    """Records each hierarchy stage inside the block: a recorder around
    the stage's schedule, ``estimate_scene`` as ``pipeline.hierarchy``
    calls it, that keeps each stage's kernel launches and view 0's depth.
    Yields the list of records."""
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import hierarchy
    records = []
    run_stage = hierarchy.estimate_scene

    def recorded(gen, tensors, *args, **kw):
        before = dict(kernels.launches)
        out = run_stage(gen, tensors, *args, **kw)
        records.append(dict(
            hw=tuple(tensors.gray.shape[1:]),
            launches={k: kernels.launches[k] - before[k] for k in before},
            depth0=out.depth[0].cpu().numpy()))
        return out

    hierarchy.estimate_scene = recorded
    try:
        yield records
    finally:
        hierarchy.estimate_scene = run_stage


def hier_cfg():
    """The hierarchy path's base config: DenseConfig() with HIER_FLAGS."""
    from hcmvs_tpu_torch.core.config import config_from_cli_flags
    return config_from_cli_flags(dict(f.split("=", 1) for f in HIER_FLAGS))


def _hierarchy_run(scene_path, img_dir, out_dir, plain: bool):
    """One hierarchy run on the card, the kernel pass through the CLI entry
    point, the plain pass through ``densify_hierarchical`` with the same
    work; returns (stats, stage report, seconds, peak GiB, stage
    records)."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import hierarchy
    from hcmvs_tpu_torch.utils import profiling
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with stage_records() as records:
        t0 = time.perf_counter()
        if plain:
            with kernels.plain_versions():
                stats = hierarchy.densify_hierarchical(
                    scene_path, img_dir, out_dir, hier_cfg())
        else:
            stats = hierarchy.main(["--input-file", scene_path,
                                    "--images-dir", img_dir, "-w", out_dir,
                                    "--flags", *HIER_FLAGS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return (stats, profiling.report(), seconds,
            torch.cuda.max_memory_allocated() / 2 ** 30, records)


def check_hierarchy(root):
    """Phases 10-11: the hierarchical-cross path through the kernels
    (counts reset just before, read just after), per stage and in all,
    its files read back and checked against the ground truth, then
    through the plain versions, compared.  Returns (launches, JSON
    summary, the checks that failed)."""
    import numpy as np
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline.hierarchy import default_schedule
    from hcmvs_tpu_torch.utils.synth import write_ridge_scene

    label = "hierarchy"
    failed = []
    t0 = time.perf_counter()
    sc = hierarchy_scene(*HIER_IMAGE_HW)
    scene_path, img_dir = write_ridge_scene(str(root), sc,
                                            png_filter=DENSIFY_PNG_FILTER)
    sc.images = None                   # on disk now; the planes stay
    log(f"[{label}] ridge scene.mvs + {N_VIEWS} {HIER_IMAGE_HW[1]}x"
        f"{HIER_IMAGE_HW[0]} PNGs (row filter {DENSIFY_PNG_FILTER}) written "
        f"in {time.perf_counter() - t0:.3f} s")
    schedule = default_schedule(hier_cfg())
    gts = {}

    def stage_acc(rec):
        if rec["hw"] not in gts:
            gts[rec["hw"]] = hierarchy_scene(*rec["hw"],
                                             textured=False).depth_gt
        return depth_acc_2pct(rec["depth0"], gts[rec["hw"]])

    out_k = root / "kernels"
    kernels.reset_launches()
    with launch_shapes() as shapes:
        st_k, rep_k, sec_k, peak_k, rec_k = _hierarchy_run(
            scene_path, img_dir, str(out_k), plain=False)
    launches = dict(kernels.launches)
    log(f"[{label}] kernel launches {launches}")
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    if len(rec_k) != len(schedule):
        failed.append(f"{label}: {len(rec_k)} stages ran, not "
                      f"{len(schedule)}")
    stages = []
    for si, (stage, rec) in enumerate(zip(schedule, rec_k)):
        stages.append(dict(
            level=stage.level, variant=stage.variant, h=rec["hw"][0],
            w=rec["hw"][1], seconds=rep_k[f"hierarchy.stage{si}"]["total_s"],
            launches=rec["launches"], depth_acc_2pct=stage_acc(rec)))
        log(f"[{label}] stage {si} (level {stage.level}, variant "
            f"{stage.variant}) {rec['hw'][1]}x{rec['hw'][0]}: "
            f"{stages[-1]['seconds']:.3f} s, launches {rec['launches']}, "
            f"view 0 depth_acc_2pct {stages[-1]['depth_acc_2pct']:.4f}")
        if stage.variant == "A" and rec["launches"]["rect_lookup"] <= 0:
            failed.append(f"{label}: stage {si} launched no kernel C")
    for name, s in sorted(rep_k.items(), key=lambda kv: -kv[1]["total_s"]):
        log(f"[{label}] report {name:<24} {s['total_s']:9.3f} s "
            f"x{int(s['calls'])}")
    final_hw = (H, W)
    if rec_k and rec_k[-1]["hw"] != final_hw:
        failed.append(f"{label}: the last stage ran at {rec_k[-1]['hw']}, "
                      f"not {final_hw}")
    log(f"[{label}] total {sec_k:.3f} s, peak memory {peak_k:.2f} GiB, "
        f"valid {st_k['valid_frac']:.4f}, points {st_k['n_points']}")
    for i in range(N_VIEWS):
        dm = read_dmap(str(out_k / "depthmap" / f"depth{i:04d}.dmap"))
        if dm.depth.shape != final_hw or not np.array_equal(
                dm.depth, st_k["depth"][i]):
            failed.append(f"{label}: depth{i:04d}.dmap reads back "
                          f"{dm.depth.shape}, not the run's map")
    pts, _ = read_ply(str(out_k / "scene_dense.ply"))
    if not len(pts) == st_k["n_points"] > 0:
        failed.append(f"{label}: scene_dense.ply has {len(pts)} points, "
                      f"stats {st_k['n_points']}")
    gt = hierarchy_scene(*final_hw, textured=False).depth_gt
    acc_k = depth_acc_2pct(st_k["depth"][0], gt)
    cloud = float(np.median(sc.surface_dist(pts.astype(np.float64)))
                  / np.median(gt))
    log(f"[{label}] view 0 interior depth_acc_2pct {acc_k:.4f}; fused "
        f"cloud median distance to the ridge / median depth {cloud:.6f}")
    if acc_k < MIN_ACC[label]:
        failed.append(f"{label}: depth accuracy {acc_k} < {MIN_ACC[label]}")
    if cloud > MAX_CLOUD_DISTANCE:
        failed.append(f"{label}: cloud distance {cloud} > "
                      f"{MAX_CLOUD_DISTANCE}")
    del pts

    kernels.reset_launches()
    st_p, rep_p, sec_p, peak_p, rec_p = _hierarchy_run(
        scene_path, img_dir, str(root / "plain"), plain=True)
    if any(kernels.launches.values()):
        failed.append(f"{label} plain run launched kernels: "
                      f"{kernels.launches}")
    for si, rec in enumerate(rec_p):
        stages[si].update(
            plain_seconds=rep_p[f"hierarchy.stage{si}"]["total_s"],
            plain_depth_acc_2pct=stage_acc(rec))
    acc_p = depth_acc_2pct(st_p["depth"][0], gt)
    agree = float((np.abs(st_k["depth"] - st_p["depth"])
                   <= 0.01 * np.abs(st_p["depth"])).mean())
    n_rel = abs(st_k["n_points"] - st_p["n_points"]) / max(st_p["n_points"],
                                                             1)
    log(f"[{label} plain] total {sec_p:.3f} s (stages "
        f"{[round(x['plain_seconds'], 3) for x in stages]} against "
        f"{[round(x['seconds'], 3) for x in stages]}), peak memory "
        f"{peak_p:.2f} GiB, view 0 interior depth_acc_2pct {acc_p:.4f} "
        f"(stages {[round(x['plain_depth_acc_2pct'], 4) for x in stages]}), "
        f"points {st_p['n_points']}; depth within 1% of the kernel run on "
        f"{agree:.5f} of pixels")
    if agree < 0.98:
        failed.append(f"{label}: kernel and plain runs agree on {agree}")
    if abs(acc_k - acc_p) > 0.01:
        failed.append(f"{label}: accuracy {acc_k} (kernels) vs {acc_p} "
                      f"(plain)")
    if n_rel > 0.01:
        failed.append(f"{label}: point counts {st_k['n_points']} (kernels) "
                      f"vs {st_p['n_points']} (plain)")
    return launches, {
        "views": N_VIEWS, "image_h": HIER_IMAGE_HW[0],
        "image_w": HIER_IMAGE_HW[1], "stages": stages, "total_s": sec_k,
        "stage_s": {k: v["total_s"] for k, v in rep_k.items()},
        "peak_gib": peak_k, "valid_frac": st_k["valid_frac"],
        "n_points": st_k["n_points"], "depth_acc_2pct": acc_k,
        "cloud_distance": cloud, "plain_total_s": sec_p,
        "plain_stage_s": {k: v["total_s"] for k, v in rep_p.items()},
        "plain_depth_acc_2pct": acc_p, "plain_n_points": st_p["n_points"],
        "agree_1pct": agree, "launches_by_shape": shapes}, failed


@contextlib.contextmanager
def prior_records():
    """Records each planar-prior pass inside the block: a recorder around
    ``scene_driver.compute_scene_priors`` (as ``estimate_scene`` calls it)
    that keeps view 0's prior map and the number of mask labels.  Yields
    the list of records."""
    from hcmvs_tpu_torch.dense import scene_driver
    records = []
    run = scene_driver.compute_scene_priors

    def recorded(state, scene, *args, **kw):
        out = run(state, scene, *args, **kw)
        records.append(dict(
            prior0=out.prior_depth[0].cpu().numpy(),
            labels=(0 if scene.semantic is None
                    else int(scene.semantic.max()) + 1),
            inputs0=dict(gray=scene.gray[0].cpu(),
                         depth=state.depth[0].cpu(),
                         semantic=(None if scene.semantic is None
                                   else scene.semantic[0].cpu()))))
        return out

    scene_driver.compute_scene_priors = recorded
    try:
        yield records
    finally:
        scene_driver.compute_scene_priors = run


def prior_parts(inputs, n_labels, dev, reps: int = 3) -> dict:
    """Each part of one view's prior pass (``dense/priors.py``, the
    superpixel and the semantic channels) on its inputs as the pass got
    them: {part: {"wall_ms": synchronised host time, median of ``reps``,
    "ms": device time (``cuda_ms``, host waits included where the part
    makes the host wait)}}."""
    import torch
    from hcmvs_tpu_torch.dense import priors as P
    gray = inputs["gray"].to(dev)
    depth = inputs["depth"].to(dev)
    sem = inputs["semantic"].to(dev)
    h, w = gray.shape
    n_sp = (h // 16) * (w // 16)
    spacing = P.inv_depth_spacing(depth)
    eps = spacing * 1.4
    labels = P.slic_superpixels(gray)
    planes = P.fit_segment_planes(labels, depth, n_sp, tukey_c=eps)[0]
    draws = P.ransac_draws(torch.Generator(device=dev).manual_seed(0), h, w,
                           P.hyps_from_probability(0.005))
    s_planes = P.ransac_segment_planes(draws, sem, depth, n_labels,
                                       epsilon=eps)[0]
    parts = {
        "spacing": lambda: P.inv_depth_spacing(depth),
        "slic": lambda: P.slic_superpixels(gray),
        "fit_planes": lambda: P.fit_segment_planes(labels, depth, n_sp,
                                                   tukey_c=eps),
        "nfa_superpixels": lambda: P.segment_plane_nfa(
            labels, depth, planes, n_sp, spacing),
        "ransac": lambda: P.ransac_segment_planes(draws, sem, depth,
                                                  n_labels, epsilon=eps),
        "nfa_semantic": lambda: P.segment_plane_nfa(
            sem, depth, s_planes, n_labels, spacing),
        "generate_priors": lambda: P.generate_priors(
            gray, depth, semantic=sem, n_semantic_labels=n_labels,
            draws=draws)}
    out = {}
    for name, fn in parts.items():
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls = sorted(walls[1:])
        out[name] = {"wall_ms": walls[len(walls) // 2],
                     "ms": cuda_ms(fn, 2, warmup=1, rounds=reps,
                                   host_bound_ok=True)}
    return out


def _masks_run(scene_path, img_dir, priors_dir, out_dir, plain: bool):
    """One masked densify run on the card, the kernel pass through the CLI
    entry point, the plain pass through ``densify``; returns (stats, stage
    report, seconds, peak GiB, prior records)."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import densify as D
    from hcmvs_tpu_torch.utils import profiling
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with prior_records() as records:
        t0 = time.perf_counter()
        if plain:
            with kernels.plain_versions():
                stats = D.densify(scene_path, img_dir, out_dir,
                                  densify_cfg(MASKS_FLAGS),
                                  priors_dir=priors_dir)
        else:
            stats = D.main(["--input-file", scene_path, "--images-dir",
                            img_dir, "-w", out_dir, "--priors-dir",
                            priors_dir, "--flags", *MASKS_FLAGS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return (stats, profiling.report(), seconds,
            torch.cuda.max_memory_allocated() / 2 ** 30, records)


def check_masks(root):
    """Phases 12-13: the masked densify path through the kernels (counts
    reset just before, read just after), its prior pass, files and labels
    checked, then through the plain versions, compared.  Returns
    (launches, JSON summary, the checks that failed)."""
    import numpy as np
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline import densify as D
    from hcmvs_tpu_torch.utils.synth import (write_ridge_masks,
                                             write_ridge_prior,
                                             write_ridge_scene)

    label = "densify_masks"
    failed = []
    t0 = time.perf_counter()
    sc = hierarchy_scene(H, W)
    scene_path, img_dir = write_ridge_scene(str(root), sc,
                                            png_filter=DENSIFY_PNG_FILTER)
    write_ridge_masks(img_dir, sc)
    priors_dir = str(root / "priors")
    write_ridge_prior(priors_dir, hierarchy_scene(*MASKS_PRIOR_HW,
                                                  textured=False), 1)
    sc.images = sc.depths = None           # on disk now
    log(f"[{label}] ridge scene.mvs + {N_VIEWS} {W}x{H} PNGs, 16-bit face "
        f"masks, label images and view 1's {MASKS_PRIOR_HW[1]}x"
        f"{MASKS_PRIOR_HW[0]} prior map written in "
        f"{time.perf_counter() - t0:.3f} s")
    out_k = root / "kernels"
    kernels.reset_launches()
    with launch_shapes() as shapes:
        st_k, rep_k, sec_k, peak_k, pri_k = _masks_run(
            scene_path, img_dir, priors_dir, str(out_k), plain=False)
    launches = dict(kernels.launches)
    log(f"[{label}] kernel launches {launches}")
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    for name, s in sorted(rep_k.items(), key=lambda kv: -kv[1]["total_s"]):
        log(f"[{label}] stage {name:<26} {s['total_s']:9.3f} s "
            f"x{int(s['calls'])}")
    prior_s = rep_k.get("estimate.priors", {}).get("total_s", 0.0)
    if len(pri_k) != 1 or rep_k.get("estimate.priors", {}).get(
            "calls") != 1:
        failed.append(f"{label}: the prior pass ran {len(pri_k)} times, "
                      f"not once")
    cover = float((pri_k[0]["prior0"] > 0).mean()) if pri_k else 0.0
    n_labels = pri_k[0]["labels"] if pri_k else 0
    if cover <= 0 or n_labels < 2:
        failed.append(f"{label}: view 0's prior covers {cover} of its "
                      f"pixels, {n_labels} mask labels")
    acc_k = depth_acc_2pct(st_k["depth"][0], sc.depth_gt)
    log(f"[{label}] total {sec_k:.3f} s, prior pass {prior_s:.3f} s "
        f"({prior_s / sec_k:.4f} of the wall), view 0 prior coverage "
        f"{cover:.4f}, {n_labels} mask labels, peak memory {peak_k:.2f} "
        f"GiB, valid {st_k['valid_frac']:.4f}, points {st_k['n_points']}, "
        f"view 0 interior depth_acc_2pct {acc_k:.4f}")
    if acc_k < MIN_ACC[label]:
        failed.append(f"{label}: depth accuracy {acc_k} < {MIN_ACC[label]}")
    parts = {}
    if pri_k:
        import torch
        parts = prior_parts(pri_k[0]["inputs0"], n_labels,
                            torch.device("cuda", 0))
        log(f"[{label}] view 0's prior pass by part, ms (synchronised "
            f"wall / device): " + ", ".join(
                f"{k} {v['wall_ms']:.3f} / {v['ms']:.3f}"
                for k, v in parts.items()))
        for r in pri_k:
            del r["inputs0"]
    for i in range(N_VIEWS):
        dm = read_dmap(str(out_k / "depthmap" / f"depth{i:04d}.dmap"))
        if dm.depth.shape != (H, W) or not np.array_equal(dm.depth,
                                                         st_k["depth"][i]):
            failed.append(f"{label}: depth{i:04d}.dmap reads back "
                          f"{dm.depth.shape}, not the run's map")
    dense_path = str(out_k / "scene_dense.mvs")
    dense = read_mvs(dense_path)
    pts, _ = read_ply(str(out_k / "scene_dense.ply"))
    if not len(dense.points) == len(pts) == st_k["n_points"] > 0:
        failed.append(f"{label}: scene_dense.mvs / .ply have "
                      f"{len(dense.points)} / {len(pts)} points, stats "
                      f"{st_k['n_points']}")
    del dense, pts
    t0 = time.perf_counter()
    lab = D.main(["--input-file", dense_path, "--images-dir", img_dir,
                  "-w", str(root / "labels"), "--project-labels"])
    labelled = float((lab["colors"] != 255).any(1).mean())
    back = read_mvs(str(root / "labels" / "scene_labelled.mvs"))
    log(f"[{label}] --project-labels {time.perf_counter() - t0:.3f} s: "
        f"{lab['n_label_images']} label images, {labelled:.5f} of "
        f"{lab['n_points']} points labelled")
    if lab["n_label_images"] != N_VIEWS or labelled <= 0 or not \
            np.array_equal(back.point_colors, lab["colors"]):
        failed.append(f"{label}: --project-labels read "
                      f"{lab['n_label_images']} label images, labelled "
                      f"{labelled} of the points")
    del lab, back

    kernels.reset_launches()
    st_p, rep_p, sec_p, peak_p, pri_p = _masks_run(
        scene_path, img_dir, priors_dir, str(root / "plain"), plain=True)
    if any(kernels.launches.values()):
        failed.append(f"{label} plain run launched kernels: "
                      f"{kernels.launches}")
    acc_p = depth_acc_2pct(st_p["depth"][0], sc.depth_gt)
    agree = float((np.abs(st_k["depth"] - st_p["depth"])
                   <= 0.01 * np.abs(st_p["depth"])).mean())
    n_rel = abs(st_k["n_points"] - st_p["n_points"]) / max(st_p["n_points"],
                                                             1)
    prior_agree = 0.0
    if len(pri_p) == 1 and pri_k:
        a, b = pri_k[0]["prior0"], pri_p[0]["prior0"]
        prior_agree = float((((a > 0) == (b > 0))
                             & (np.abs(a - b) <= MASKS_PRIOR_RTOL
                                * np.abs(b))).mean())
    log(f"[{label} plain] total {sec_p:.3f} s (estimate "
        f"{rep_p['densify.estimate']['total_s']:.3f} s against "
        f"{rep_k['densify.estimate']['total_s']:.3f} s, prior pass "
        f"{rep_p.get('estimate.priors', {}).get('total_s', 0.0):.3f} s), "
        f"peak memory {peak_p:.2f} GiB, view 0 interior depth_acc_2pct "
        f"{acc_p:.4f}, points {st_p['n_points']}; depth within 1% of the "
        f"kernel run on {agree:.5f} of pixels; view 0 prior maps agree on "
        f"{prior_agree:.5f}")
    if agree < 0.98:
        failed.append(f"{label}: kernel and plain runs agree on {agree}")
    if abs(acc_k - acc_p) > 0.01:
        failed.append(f"{label}: accuracy {acc_k} (kernels) vs {acc_p} "
                      f"(plain)")
    if n_rel > 0.01:
        failed.append(f"{label}: point counts {st_k['n_points']} (kernels) "
                      f"vs {st_p['n_points']} (plain)")
    if prior_agree < MASKS_PRIOR_AGREE:
        failed.append(f"{label}: view 0's prior maps agree on "
                      f"{prior_agree} of the pixels")
    return launches, {
        "views": N_VIEWS, "h": H, "w": W, "flags": list(MASKS_FLAGS),
        "total_s": sec_k, "views_per_s": N_VIEWS / sec_k,
        "prior_s": prior_s, "prior_share": prior_s / sec_k,
        "prior_coverage0": cover, "mask_labels": n_labels,
        "prior_parts0": parts,
        "stage_s": {k: v["total_s"] for k, v in rep_k.items()},
        "peak_gib": peak_k, "valid_frac": st_k["valid_frac"],
        "n_points": st_k["n_points"], "labelled_share": labelled,
        "depth_acc_2pct": acc_k, "plain_total_s": sec_p,
        "plain_stage_s": {k: v["total_s"] for k, v in rep_p.items()},
        "plain_depth_acc_2pct": acc_p, "plain_n_points": st_p["n_points"],
        "agree_1pct": agree, "prior_agree": prior_agree,
        "launches_by_shape": shapes}, failed


def subsample_mvs(src: str, dst: str, n_points: int, seed: int = 1):
    """Write the scene of ``src`` with a ``default_rng(seed)`` subsample of
    ``n_points`` of its points, in the permutation's order, each with its
    view lists (ids and confidences), to ``dst`` (as
    hcmvs_tpu/eval/full_run.py:198-205); returns (points before, points
    after)."""
    import numpy as np
    from hcmvs_tpu_torch.io.mvs import read_mvs, write_mvs
    scene = read_mvs(src)
    n = len(scene.points)
    sub = np.random.default_rng(seed).permutation(n)[:n_points]
    counts = np.asarray(scene.point_view_counts, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)])[:-1][sub]
    cnt = counts[sub]
    rows = (np.repeat(start - np.cumsum(cnt) + cnt, cnt)
            + np.arange(int(cnt.sum())))
    scene.points = scene.points[sub]
    scene.point_view_counts = scene.point_view_counts[sub]
    scene.point_view_ids = scene.point_view_ids[rows]
    scene.point_view_confs = scene.point_view_confs[rows]
    for f in ("point_normals", "point_colors"):
        arr = getattr(scene, f)
        if arr is not None and len(arr):
            setattr(scene, f, arr[sub])
    write_mvs(dst, scene)
    return n, len(sub)


def mesh_fscore(vertices, faces, sc, n_samples: int = MESH_SAMPLES) -> dict:
    """F-score of a mesh against view 0's ground-truth surface of the
    synthetic scene ``sc`` at 1% of its median depth: ``n_samples`` area-
    weighted samples of the mesh (``sample_points``' default rng) against
    as many pixels of view 0 (``default_rng(2)``) back-projected at their
    true depth through view 0's pose (hcmvs_tpu/eval/full_run.py:221-233,
    which has view 0 at the origin)."""
    import numpy as np
    from hcmvs_tpu_torch.eval.compare import point_cloud_fscore
    from hcmvs_tpu_torch.mesh.mesh_ops import sample_points
    samples, _ = sample_points(vertices, faces, n_samples)
    gt = sc.depth_gt
    h, w = gt.shape
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sel = np.random.default_rng(2).permutation(h * w)[:n_samples]
    K, R, C = (np.asarray(getattr(sc.cameras[0], f), np.float64)
               for f in "KRC")
    rays = np.linalg.inv(K) @ np.stack([uu.ravel()[sel], vv.ravel()[sel],
                                        np.ones(len(sel))])
    gt_pts = (R.T @ (rays * gt.ravel()[sel])).T + C
    tol = 0.01 * float(np.median(gt[gt > 0]))
    return dict(point_cloud_fscore(samples, gt_pts, tol), tol=tol)


def check_mesh(root, dev):
    """Phases 14-15: the mesh apps on phase 12's dense output under
    ``root`` (reconstruct -> refine -> texture through
    ``mesh_apps.main``), the files read back and the mesh held to its
    floors; refine's gradient timed and its device operations counted;
    then refine and the labelling again, and one gradient on the card
    against the CPU's.  Returns (launches, JSON summary, the checks that
    failed)."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.io.obj import read_obj
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.mesh import refine as R
    from hcmvs_tpu_torch.mesh import texture as T
    from hcmvs_tpu_torch.mesh.mesh_ops import compute_vertex_normals
    from hcmvs_tpu_torch.pipeline import mesh_apps
    from hcmvs_tpu_torch.utils import profiling

    label = "mesh"
    failed = []
    out = root / "mesh"
    out.mkdir()
    img_dir = str(root / "images")
    mvs = str(out / "scene_mesh_input.mvs")
    t0 = time.perf_counter()
    n_cloud, n_sub = subsample_mvs(str(root / "kernels" / "scene_dense.mvs"),
                                   mvs, MESH_POINTS)
    sc = hierarchy_scene(H, W, textured=False)          # the ground truth
    log(f"[{label}] {n_sub} of phase 12's {n_cloud} points with their view "
        f"lists in {time.perf_counter() - t0:.3f} s")

    # 14. the three apps on the card, counts reset just before
    mesh_ply, refine_ply = str(out / "mesh.ply"), str(out / "mesh_refine.ply")
    obj_path = str(out / "mesh_refine_texture.obj")
    kernels.reset_launches()
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = mesh_apps.main(["reconstruct", "-i", mvs, "-o", mesh_ply])
    ref = mesh_apps.main(["refine", "-i", mvs, "-m", mesh_ply,
                          "--images-dir", img_dir])
    tex = mesh_apps.main(["texture", "-i", mvs, "-m", refine_ply,
                          "--images-dir", img_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(kernels.launches)
    rep = profiling.report()
    if any(launches.values()):
        failed.append(f"{label}: the mesh path launched kernels {launches}")
    tm = tex["textured"]
    V0, F = rec["vertices"], rec["faces"]
    V1 = ref["vertices"]

    # the files read back
    v, e = read_ply(mesh_ply)
    vr, er = read_ply(refine_ply)
    obj = read_obj(obj_path)
    mtl = (out / "mesh_refine_texture.mtl").read_text()
    atlas = read_rgb(str(out / "mesh_refine_texture.png"))
    back = {"ply": np.array_equal(v, V0) and np.array_equal(e["faces"], F),
            "refined_ply": (np.array_equal(vr, V1)
                            and np.array_equal(er["faces"], F)),
            "obj": (np.array_equal(obj.vertices, tm.vertices)
                    and np.array_equal(obj.faces, F)
                    and obj.mtllib == "mesh_refine_texture.mtl"
                    and np.array_equal(obj.texcoords,
                                       tm.uvs.reshape(-1, 2))),
            "mtl": "map_Kd mesh_refine_texture.png" in mtl,
            "png": np.array_equal(atlas, tm.atlas)}
    if not all(back.values()):
        failed.append(f"{label}: files read back: {back}")
    labelled = tm.labels >= 0
    uv_ok = bool(((tm.uvs[labelled] >= 0) & (tm.uvs[labelled] <= 1)).all())
    fs0 = mesh_fscore(V0, F, sc)
    fs1 = mesh_fscore(V1, F, sc)
    log(f"[{label}] {len(V0)} vertices, {len(F)} faces (graph cut "
        f"{rec['graph_cut_faces']}), labelled {labelled.mean():.4f}, UVs in "
        f"[0, 1]: {uv_ok}, atlas max {int(tm.atlas.max())}, utilization "
        f"{tm.utilization:.4f}; F-score at {fs0['tol']:.5f}: "
        f"{fs0['fscore']:.4f} "
        f"(precision {fs0['precision']:.4f}, recall {fs0['recall']:.4f}) "
        f"-> refined {fs1['fscore']:.4f} (precision {fs1['precision']:.4f}, "
        f"recall {fs1['recall']:.4f}); total {seconds:.3f} s, peak memory "
        f"{peak:.2f} GiB")
    if len(F) < MESH_MIN_FACES:
        failed.append(f"{label}: {len(F)} faces < {MESH_MIN_FACES}")
    if labelled.mean() < MESH_MIN_LABELLED or not uv_ok or \
            tm.atlas.max() == 0:
        failed.append(f"{label}: labelled {labelled.mean()}, UVs in [0, 1] "
                      f"{uv_ok}, atlas max {tm.atlas.max()}")
    if fs0["fscore"] < MESH_FSCORE_FLOOR:
        failed.append(f"{label}: F-score {fs0['fscore']} < "
                      f"{MESH_FSCORE_FLOOR}")
    if fs1["fscore"] < fs0["fscore"] - MESH_REFINE_DROP:
        failed.append(f"{label}: refine lowered the F-score "
                      f"{fs0['fscore']} -> {fs1['fscore']}")
    stages = {k: {"total_s": r["total_s"], "calls": r["calls"],
                  "share": r["total_s"] / seconds, "each_s": r["each_s"]}
              for k, r in rep.items()}
    for name, st in sorted(stages.items(), key=lambda kv: -kv[1]["total_s"]):
        each = (" (" + ", ".join(f"{x:.3f}" for x in st["each_s"]) + ")"
                if 1 < st["calls"] <= 3 else "")
        log(f"[{label}] stage {name:<24} {st['total_s']:9.3f} s "
            f"x{int(st['calls'])} share {st['share']:.4f}{each}")

    # refine's gradient at the first scale's inputs: device time and the
    # device operations of one iteration
    scene = read_mvs(mvs)
    images = mesh_apps._load_images(scene, img_dir)
    h, w = images[0].shape
    Ks, Rs, Cs = mesh_apps._scene_cams(scene, w, h)
    n = len(images)
    pairs = np.array([(i, (i + 1) % n) for i in range(n)], np.int32)
    rr = R.RasterRefine(F, np.stack(images), Ks, Rs, Cs, pairs, len(V0), dev)
    rasters = rr.rasterize(V0)
    Vd = torch.as_tensor(V0, device=dev)
    normals = torch.as_tensor(compute_vertex_normals(V0, F), device=dev)
    base_step = 0.5 * float(np.median(np.linalg.norm(
        V0[F[:, 0]] - V0[F[:, 1]], axis=1)))
    # ~10^3 launches a call fill the launch queue behind cuda_ms's spin, so
    # the host cannot queue ahead: the events' span is the host-bound wall
    # of a call, and the profiler's sum of device times its busy time
    grad_span = cuda_ms(lambda: rr.grad(Vd, rasters), reps=3,
                        host_bound_ok=True)
    step_span = cuda_ms(lambda: rr.step(Vd, normals, rasters, base_step,
                                        0.2), reps=3, host_bound_ok=True)
    grad_ms, grad_ops = device_busy(lambda: rr.grad(Vd, rasters))
    step_ms, ops = device_busy(lambda: rr.step(Vd, normals, rasters,
                                               base_step, 0.2))
    grad_wall = rep.get("refine.grad", {}).get("each_s", [0.0])
    log(f"[{label}] raster_refine_grad at {w}x{h} x {len(pairs)} pairs, "
        f"{len(F)} faces: {grad_ms:.3f} ms of device time (profiler), "
        f"{grad_span:.3f} ms between events (cuda_ms, host-bound), "
        f"{grad_ops} device operations; a whole iteration {step_ms:.3f} ms "
        f"of device time, {step_span:.3f} ms between events, {ops} device "
        f"operations; refine.grad wall {np.median(grad_wall) * 1e3:.3f} ms "
        f"(median of {len(grad_wall)})")

    # 15. the same mesh again: refine and the labelling, then the gradient
    # on the card against the CPU's
    t0 = time.perf_counter()
    verts_in, _ = read_ply(mesh_ply)
    V2 = R.refine_mesh(verts_in, F, np.stack(images), Ks, Rs, Cs, pairs,
                       device=dev)
    refine_equal = bool(np.array_equal(V2, V1))
    qual = T.face_view_quality(V1, F, Ks, Rs, Cs, [(w, h)] * n)
    qual = T.reject_outlier_views(V1, F, qual, images, Ks, Rs, Cs)
    labels2 = T.label_faces_lbp(F, qual, device=dev)
    labels_equal = bool(np.array_equal(labels2, tm.labels))
    g_c, w_c = (x.cpu().numpy() for x in rr.grad(Vd, rasters))
    rr_cpu = R.RasterRefine(F, np.stack(images), Ks, Rs, Cs, pairs, len(V0),
                            "cpu")
    cpu_rasters = R.ScaleRasters(rasters.face_ids.cpu(),
                                 rasters.barys.cpu(), rasters.depth.cpu(),
                                 len(F))
    g_h, w_h = (x.numpy() for x in rr_cpu.grad(torch.as_tensor(V0),
                                                cpu_rasters))
    g_err = float(np.linalg.norm(g_c - g_h) / np.linalg.norm(g_h))
    w_err = float(np.linalg.norm(w_c - w_h) / np.linalg.norm(w_h))
    log(f"[{label} again] refined vertices equal: {refine_equal} (max "
        f"|diff| {np.abs(V2 - V1).max():.3g}), labels equal: {labels_equal} "
        f"({(labels2 == tm.labels).mean():.6f}); gradient card vs CPU "
        f"relative L2: grad {g_err:.3g}, wsum {w_err:.3g} "
        f"({time.perf_counter() - t0:.3f} s)")
    if not (refine_equal and labels_equal):
        failed.append(f"{label}: the second run differs (vertices equal "
                      f"{refine_equal}, labels equal {labels_equal})")
    if max(g_err, w_err) > MESH_GRAD_RTOL:
        failed.append(f"{label}: gradient card vs CPU {g_err}, {w_err} > "
                      f"{MESH_GRAD_RTOL}")
    return launches, {
        "views": n, "h": h, "w": w, "cloud_points": n_cloud,
        "mesh_points": n_sub, "vertices": len(V0), "faces": len(F),
        "graph_cut_faces": rec["graph_cut_faces"],
        "total_s": seconds, "stages": stages, "peak_gib": peak,
        "fscore": fs0, "fscore_refined": fs1,
        "labelled_share": float(labelled.mean()),
        "atlas_utilization": tm.utilization, "files_read_back": back,
        "grad_device_ms": grad_ms, "grad_span_ms": grad_span,
        "grad_device_ops": grad_ops, "iteration_device_ms": step_ms,
        "iteration_span_ms": step_span, "device_ops_per_iteration": ops,
        "again_vertices_equal": refine_equal,
        "again_labels_equal": labels_equal,
        "grad_rel_l2_card_vs_cpu": g_err, "wsum_rel_l2_card_vs_cpu": w_err,
        "launches_by_shape": {k: {} for k in launches}}, failed


# phases 16-19: the SfM front end through pipeline.mvgmvs.  Phase 16's
# scene: the golden's fixed-FOV ridge (focal 1200 px at 1280 wide, 8
# views 0.25 apart) through k1 = -0.15, as 8-bit PNGs whose eXIf chunk
# holds FocalLengthIn35mmFilm = 33.75 (-> 1200 px)
PHOTO_HW = (960, 1280)
PHOTO_VIEWS = 8
PHOTO_FX = 1200.0
PHOTO_K1 = -0.15
# two external iterations (DenseConfig() runs four) keep the script inside
# its time limit with phases 23-26; every check stays
PHOTO_FLAGS = ("resolution-level=0", "n-EstimationIters-external=2")
# k1's window and the ATE bound (10% of the spacing) of the JAX package's
# distortion golden (tests/test_distortion.py:121, :134)
PHOTO_K1_WINDOW = (-0.25, -0.08)
PHOTO_ATE_MAX = 0.025
# the refined rms must fall below the unrefined one and stay within
# PHOTO_RMS_TOL of the JAX package's own on these photos (its
# incremental_sfm + refine_with_distortion on the CPU, tests/
# test_torch_mvgmvs.py 960 1280 jax sfm): at 1280x960 the JAX golden's
# 1 px bar (set at 144x192) is above what the JAX package reaches
PHOTO_JAX_RMS = 1.1658747822928535
PHOTO_RMS_TOL = 0.05
# view 0's depth_acc_2pct floor, its depth scaled by the median ratio to
# the ground truth over its valid pixels (eval/golden.py --hierarchy's
# alignment): the JAX package's own run_pipeline_photos on this scene on
# the CPU reads 0.9835 / 0.7041 at 240x320 / 480x640 (tests/
# test_torch_mvgmvs.py H W jax); the lower less 0.05.  Scaled by the
# similarity (Umeyama) scale of the camera centres instead, it is printed,
# not gated: the JAX package's own reads 0.0011 / 0.0000 there (SfM's
# depth-to-baseline ratio is a few per cent off, which the centres on a
# line do not show, and that puts nearly every pixel past 2%)
PHOTO_ACC_MEDIAN_FLOOR = 0.6541
# phase 17's GLOBAL preset: the cameras lie on a line, so every pairwise
# direction is nearly the same and translation averaging places them
# along it poorly, at an ATE that moves with the RANSAC draws.  Its ATE
# at most GLOBAL_ATE_TOL above the JAX package's own global_sfm +
# refine_with_distortion on these photos on the CPU, 0.1497 (tests/
# test_torch_global_photos.py 960 1280 jax; that run has the port's
# rotation_to_rvec, as the JAX package's own returns NaN for the gauge
# camera there).  The margin covers the port's own spread over draws: a
# CPU generator seeded 0-8 gives 0.123-0.372 (the same script, port
# seed=S)
GLOBAL_JAX_ATE = 0.14974088374337752
GLOBAL_ATE_TOL = 0.25
# phase 18: eval.ba_bench at the benchmark's size; the JAX package's final
# rms on the same problem on the CPU (tests/test_torch_ba.py 200 200000
# jax)
BA_SIZE = (200, 200_000)
BA_ITERS = 8
BA_JAX_RMS = 0.5910669642688551
BA_RMS_TOL = 0.01
BA_RMS_MAX = 0.6
# phase 19: the whole chain, small: 4 pinhole ridge photos, same FOV
CHAIN_HW = (240, 320)
CHAIN_VIEWS = 4
CHAIN_FLAGS = ("n-EstimationIters-external=2",)    # as PHOTO_FLAGS


def photo_scene(h: int, w: int, n_views: int):
    """``make_ridge_scene(default_rng(0), ...)`` with its blob texture
    (1,200 exp a pixel) summed on the card: the same blobs, the card's
    float64 exp."""
    import numpy as np
    from hcmvs_tpu_torch.utils.synth import blob_texture_fn, make_ridge_scene
    return make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                            n_views=n_views, fx=PHOTO_FX * w / 1280,
                            spacing=0.25, texture_fn=blob_texture_fn(
                                np.random.default_rng(0), device="cuda"))


def _centres(result):
    import numpy as np
    reg = sorted(result.poses)
    return reg, np.stack([result.poses[i][1] for i in reg])


def _stage_lines(label, rep, names):
    """Logs each named stage's seconds (every call's, for a few calls);
    returns {name: total seconds} of the stages that ran."""
    out = {}
    for name in names:
        if name not in rep:
            continue
        s = rep[name]
        each = (" (" + ", ".join(f"{x:.3f}" for x in s["each_s"]) + ")"
                if 1 < s["calls"] <= 12 else "")
        log(f"[{label}] stage {name:<24} {s['total_s']:9.3f} s "
            f"x{int(s['calls'])}{each}")
        out[name] = s["total_s"]
    return out


SFM_STAGES = ("photos.load", "sfm.features", "sfm.matching",
              "sfm.init_pair", "sfm.registration", "sfm.ba",
              "sfm.relative_poses", "sfm.averaging", "sfm.tracks",
              "photos.distortion", "photos.undistort",
              "dense.scene_tensors", "estimate.tables", "dense.estimate",
              "dense.fuse", "mesh.reconstruct", "mesh.texture")


def check_plain_dense(label, photos, flags, out, out_dir, sc, med, failed):
    """The dense step of ``mvgmvs.main``'s run ``out`` again, from the same
    SfM result through the plain versions (the photos read and undistorted
    as ``run_pipeline_photos`` does them), compared with the kernel run as
    the densify path compares its two: no launch, depth within 1% on >= 98%
    of the pixels, view 0's accuracy (at the kernel run's median scale)
    within 0.01, points within 1%.  Returns the JSON summary's entries."""
    import os
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.core.config import config_from_cli_flags
    from hcmvs_tpu_torch.io.images import list_images, load_image, to_gray
    from hcmvs_tpu_torch.pipeline import mvgmvs
    from hcmvs_tpu_torch.sfm.distortion import undistort_image
    from hcmvs_tpu_torch.sfm.incremental import sfm_to_scene

    dev = mvgmvs.resolve_device("cuda")
    paths = list_images(photos)
    grays = [to_gray(load_image(p)).astype(np.float32) for p in paths]
    K, k = out["K"], out["distortion"]
    if np.abs(k).max() > 1e-4:
        grays = [undistort_image(g, K, k, device=dev) for g in grays]
    h, w = grays[0].shape
    scene = sfm_to_scene(out["sfm"], K, [os.path.basename(p) for p in paths],
                         w, h)
    cfg = config_from_cli_flags(dict(f.split("=", 1) for f in flags))
    os.makedirs(out_dir, exist_ok=True)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with kernels.plain_versions():
        plain = mvgmvs._dense_mesh_texture(out["sfm"], scene, grays, K,
                                           out_dir, cfg, False, False,
                                           False, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(kernels.launches.values()):
        failed.append(f"{label} plain run launched kernels: "
                      f"{kernels.launches}")
    dk, dp = out["depth"], plain["depth"]
    agree = float((np.abs(dk - dp) <= 0.01 * np.abs(dp)).mean())
    acc_k = depth_acc_2pct(dk[0] * med, sc.depth_gt)
    acc_p = depth_acc_2pct(dp[0] * med, sc.depth_gt)
    n_k, n_p = len(out["cloud"]["points"]), len(plain["cloud"]["points"])
    log(f"[{label} plain] dense step {seconds:.3f} s, view 0 interior "
        f"depth_acc_2pct {acc_p:.4f} (kernels {acc_k:.4f}) at the median "
        f"scale, points {n_p} (kernels {n_k}); depth within 1% of the "
        f"kernel run on {agree:.5f} of pixels")
    if agree < 0.98:
        failed.append(f"{label}: kernel and plain runs agree on {agree}")
    if abs(acc_k - acc_p) > 0.01:
        failed.append(f"{label}: accuracy {acc_k} (kernels) vs {acc_p} "
                      f"(plain)")
    if abs(n_k - n_p) > 0.01 * max(n_p, 1):
        failed.append(f"{label}: point counts {n_k} (kernels) vs {n_p} "
                      f"(plain)")
    return {"plain_dense_s": seconds, "plain_depth_acc_2pct": acc_p,
            "plain_n_points": n_p, "agree_1pct": agree}


def check_photos(root):
    """Phase 16: the photo directory through ``pipeline.mvgmvs.main``
    (SEQUENTIAL, distortion estimated, ``--no-mesh``) on the card, counts
    reset just before, read just after; then its dense step through the
    plain versions.  Returns (launches, JSON summary, the checks that
    failed, the scene)."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval.pose_eval import ate, umeyama_align
    from hcmvs_tpu_torch.io.mvs import read_mvs
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline import mvgmvs
    from hcmvs_tpu_torch.utils import profiling
    from hcmvs_tpu_torch.utils.synth import distort_images, write_photos

    label = "photos"
    failed = []
    h, w = PHOTO_HW
    t0 = time.perf_counter()
    sc = photo_scene(h, w, PHOTO_VIEWS)
    K_gt = sc.cameras[0].K.numpy()
    photos = str(root / "photos")
    write_photos(photos, distort_images(sc.images, K_gt,
                                        np.array([PHOTO_K1, 0.0, 0.0])),
                 PHOTO_FX * 36.0 / 1280)
    log(f"[{label}] {PHOTO_VIEWS} ridge photos {w}x{h} through k1 = "
        f"{PHOTO_K1} written as PNGs with EXIF in "
        f"{time.perf_counter() - t0:.3f} s")
    out_dir = str(root / "out")
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        out = mvgmvs.main([photos, out_dir, "--flags", *PHOTO_FLAGS,
                           "--no-mesh"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{label}] kernel launches {launches}")
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    rep = profiling.report()
    stages = _stage_lines(label, rep, SFM_STAGES)
    res = out["sfm"]
    reg, est = _centres(res)
    gt = np.stack([sc.cameras[i].C.numpy() for i in reg])
    a = ate(est, gt)
    scale = umeyama_align(est, gt)[0]
    k = [float(x) for x in out["distortion"]]
    d0 = out["depth"][0]
    acc = depth_acc_2pct(d0 * scale, sc.depth_gt)
    med = float(np.median(sc.depth_gt[d0 > 0] / d0[d0 > 0]))
    acc_med = depth_acc_2pct(d0 * med, sc.depth_gt)
    scene = read_mvs(str(root / "out" / "scene.mvs"))
    cloud, _ = read_ply(str(root / "out" / "scene_dense.ply"))
    back = {"mvs": (len(scene.images) == len(reg)
                    and len(scene.points) > 0),
            "ply": len(cloud) == len(out["cloud"]["points"]) > 0}
    log(f"[{label}] f = {out['K'][0, 0]!r} px from EXIF; {len(reg)} of "
        f"{PHOTO_VIEWS} registered; k = {k}; rms {out['rms_unrefined']:.4f}"
        f" -> {res.reproj_rms:.4f} px refined (JAX on the CPU "
        f"{PHOTO_JAX_RMS:.4f}); ATE rmse {a['rmse']:.5f} "
        f"(max {a['max']:.5f}, scale {scale:.5f}); view 0 interior "
        f"depth_acc_2pct {acc_med:.4f} at the median scale {med:.5f} "
        f"(floor {PHOTO_ACC_MEDIAN_FLOOR}), {acc:.4f} at the similarity "
        f"scale; valid {(d0 > 0).mean():.4f}; "
        f"{len(out['cloud']['points'])} points; files read back {back}; "
        f"total {seconds:.3f} s, peak memory {peak:.2f} GiB")
    if out["K"][0, 0] != PHOTO_FX:
        failed.append(f"{label}: K from EXIF {out['K'][0, 0]!r} != "
                      f"{PHOTO_FX}")
    if len(reg) != PHOTO_VIEWS:
        failed.append(f"{label}: registered {reg}")
    if not PHOTO_K1_WINDOW[0] < k[0] < PHOTO_K1_WINDOW[1]:
        failed.append(f"{label}: k1 {k[0]} outside {PHOTO_K1_WINDOW}")
    if not (res.reproj_rms < out["rms_unrefined"] and
            res.reproj_rms <= PHOTO_JAX_RMS + PHOTO_RMS_TOL):
        failed.append(f"{label}: rms {out['rms_unrefined']} -> "
                      f"{res.reproj_rms} (JAX {PHOTO_JAX_RMS})")
    if a["rmse"] >= PHOTO_ATE_MAX:
        failed.append(f"{label}: ATE {a['rmse']} >= {PHOTO_ATE_MAX}")
    if acc_med < PHOTO_ACC_MEDIAN_FLOOR:
        failed.append(f"{label}: depth accuracy {acc_med} (median scale) "
                      f"< {PHOTO_ACC_MEDIAN_FLOOR}")
    if not all(back.values()):
        failed.append(f"{label}: files read back {back}")
    plain = check_plain_dense(label, photos, PHOTO_FLAGS, out,
                              str(root / "plain"), sc, med, failed)
    return launches, {
        "views": PHOTO_VIEWS, "h": h, "w": w, "flags": list(PHOTO_FLAGS),
        "f_px": float(out["K"][0, 0]), "registered": len(reg), "k": k,
        "rms_unrefined_px": out["rms_unrefined"],
        "rms_px": res.reproj_rms, "ate_rmse": a["rmse"], "ate_max": a["max"],
        "scale": scale, "depth_acc_2pct": acc,
        "median_scale": med, "depth_acc_2pct_median_scale": acc_med,
        "median_floor": PHOTO_ACC_MEDIAN_FLOOR, **plain,
        "valid_frac": float((d0 > 0).mean()),
        "n_points": len(out["cloud"]["points"]),
        "sparse_points": len(res.points), "total_s": seconds,
        "stage_s": stages, "ba_each_s": rep.get("sfm.ba", {}).get("each_s"),
        "peak_gib": peak, "files_read_back": back,
        "launches_by_shape": shapes}, failed, sc


def check_sfm_again(root, sc, dev):
    """Phase 17: ``incremental_sfm`` twice on phase 16's photos (equal
    poses and points: fixed-order sums, a seeded generator), then the
    GLOBAL preset's ``global_sfm`` + ``refine_with_distortion``: all
    views registered with finite poses and points, the ATE at most
    GLOBAL_ATE_TOL above the JAX package's on the same photos."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval.pose_eval import ate
    from hcmvs_tpu_torch.io.exif import scene_intrinsics_from_photos
    from hcmvs_tpu_torch.io.images import list_images, load_image, to_gray
    from hcmvs_tpu_torch.sfm.distortion import refine_with_distortion
    from hcmvs_tpu_torch.sfm.global_sfm import global_sfm
    from hcmvs_tpu_torch.sfm.incremental import incremental_sfm
    from hcmvs_tpu_torch.utils import profiling

    label = "sfm_again"
    failed = []
    paths = list_images(str(root / "photos"))
    grays = [to_gray(load_image(p)).astype(np.float32) for p in paths]
    h, w = grays[0].shape
    K, _ = scene_intrinsics_from_photos(paths, [w] * len(paths),
                                        [h] * len(paths))
    kernels.reset_launches()
    runs, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(incremental_sfm(grays, K, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    a, b = runs
    equal = (list(a.poses) == list(b.poses)
             and all(np.array_equal(a.poses[i][0], b.poses[i][0])
                     and np.array_equal(a.poses[i][1], b.poses[i][1])
                     for i in a.poses)
             and np.array_equal(a.points, b.points)
             and a.track_obs == b.track_obs)
    profiling.reset_report()
    t0 = time.perf_counter()
    g = global_sfm(grays, K, device=dev)
    g, k = refine_with_distortion(g, K, device=dev)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    stages = _stage_lines(label, profiling.report(), SFM_STAGES)
    reg, est = _centres(g)
    gt = np.stack([sc.cameras[i].C.numpy() for i in reg])
    ga = ate(est, gt)
    launches = dict(kernels.launches)
    log(f"[{label}] incremental_sfm twice {secs[0]:.3f} / {secs[1]:.3f} s: "
        f"poses, points and tracks equal {equal} ({len(a.poses)} views, "
        f"{len(a.points)} points, rms {a.reproj_rms:.4f} px); global_sfm + "
        f"distortion {g_s:.3f} s: {len(reg)} registered, k = "
        f"{[float(x) for x in k]}, rms {g.reproj_rms:.4f} px, ATE rmse "
        f"{ga['rmse']:.5f} (JAX on the CPU {GLOBAL_JAX_ATE:.5f}); kernel "
        f"launches {launches}")
    if not equal:
        failed.append(f"{label}: two incremental_sfm runs differ")
    finite = bool(np.isfinite(est).all() and np.isfinite(g.points).all())
    if len(reg) != PHOTO_VIEWS or not finite:
        failed.append(f"{label}: global_sfm registered {reg}, poses and "
                      f"points finite {finite}")
    if not ga["rmse"] <= GLOBAL_JAX_ATE + GLOBAL_ATE_TOL:
        failed.append(f"{label}: global ATE {ga['rmse']} > JAX "
                      f"{GLOBAL_JAX_ATE} + {GLOBAL_ATE_TOL}")
    return launches, {
        "incremental_s": secs, "again_equal": equal,
        "incremental_rms_px": a.reproj_rms, "global_s": g_s,
        "global_registered": len(reg), "global_k": [float(x) for x in k],
        "global_rms_px": g.reproj_rms, "global_ate_rmse": ga["rmse"],
        "global_jax_cpu_ate": GLOBAL_JAX_ATE,
        "global_finite": finite,
        "global_stage_s": stages,
        "launches_by_shape": {n: {} for n in launches}}, failed


def check_ba(dev):
    """Phase 18: ``eval.ba_bench`` at 200 cameras / 200,000 points / ~1 M
    observations, 8 LM iterations on the PCG solver, twice."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval import ba_bench

    label = "ba"
    failed = []
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = [ba_bench.run(*BA_SIZE, BA_ITERS, device=dev) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    a, b = runs
    equal = all(torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
    launches = dict(kernels.launches)
    for r in runs:
        log(f"[{label}] {r['cams']} cameras, {r['points']} points, "
            f"{r['observations']} observations: rms {r['rms_px_before']!r} "
            f"-> {r['rms_px_after']!r} px in {r['iters']} LM iterations "
            f"({r['total_seconds']:.3f} s, "
            f"{r['total_seconds'] / r['iters']:.4f} s an iteration); one "
            f"trial step {r['step_seconds']:.4f} s (device synchronised), "
            f"PCG budget {r['cg_iters']}")
    log(f"[{label}] JAX package on the CPU {BA_JAX_RMS!r} px; the two runs "
        f"equal {equal}; peak memory {peak:.2f} GiB")
    if abs(a["rms_px_after"] - BA_JAX_RMS) > BA_RMS_TOL or \
            a["rms_px_after"] > BA_RMS_MAX:
        failed.append(f"{label}: final rms {a['rms_px_after']} (JAX "
                      f"{BA_JAX_RMS}, max {BA_RMS_MAX})")
    if not equal:
        failed.append(f"{label}: the second run differs")
    return launches, {
        **{k: v for k, v in a.items() if k != "state"},
        "second_total_seconds": b["total_seconds"],
        "second_step_seconds": b["step_seconds"], "again_equal": equal,
        "jax_cpu_rms_px": BA_JAX_RMS, "peak_gib": peak,
        "launches_by_shape": {n: {} for n in launches}}, failed


def check_chain(root):
    """Phase 19: ``pipeline.mvgmvs.main`` with mesh and texture on 4
    pinhole ridge photos at 320x240, ``DenseConfig()`` with CHAIN_FLAGS,
    counts reset just
    before, read just after; then its dense step through the plain
    versions."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.io.obj import read_obj
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.pipeline import mvgmvs
    from hcmvs_tpu_torch.utils import profiling
    from hcmvs_tpu_torch.utils.synth import write_photos

    label = "chain"
    failed = []
    h, w = CHAIN_HW
    sc = photo_scene(h, w, CHAIN_VIEWS)
    photos = str(root / "photos")
    write_photos(photos, sc.images, PHOTO_FX * 36.0 / 1280)
    out_dir = root / "out"
    profiling.reset_report()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        out = mvgmvs.main([photos, str(out_dir), "--flags", *CHAIN_FLAGS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    shapes = check_shapes(label, launches, shapes, failed)
    stages = _stage_lines(label, profiling.report(), SFM_STAGES)
    mv, mf = out.get("mesh", (np.zeros((0, 3)), np.zeros((0, 3))))
    back = {}
    if (out_dir / "scene_mesh.ply").exists():
        v, e = read_ply(str(out_dir / "scene_mesh.ply"))
        back["ply"] = (np.array_equal(v, mv)
                       and np.array_equal(e["faces"], mf))
    if (out_dir / "scene_textured.obj").exists():
        tm = out["textured"]
        obj = read_obj(str(out_dir / "scene_textured.obj"))
        back["obj"] = (np.array_equal(obj.faces, tm.faces)
                       and obj.mtllib == "scene_textured.mtl")
        back["mtl"] = ("map_Kd scene_textured.png"
                       in (out_dir / "scene_textured.mtl").read_text())
        atlas = read_rgb(str(out_dir / "scene_textured.png"))
        back["png"] = np.array_equal(atlas, tm.atlas)
    log(f"[{label}] {len(out['sfm'].poses)} of {CHAIN_VIEWS} registered, "
        f"k = {[float(x) for x in out['distortion']]}, "
        f"{len(out['cloud']['points'])} points, {len(mv)} vertices, "
        f"{len(mf)} faces; files read back {back}; kernel launches "
        f"{launches}; total {seconds:.3f} s")
    if len(mf) < 1 or set(back) != {"ply", "obj", "mtl", "png"} or \
            not all(back.values()):
        failed.append(f"{label}: {len(mf)} faces, files read back {back}")
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    d0 = out["depth"][0]
    med = float(np.median(sc.depth_gt[d0 > 0] / d0[d0 > 0]))
    plain = check_plain_dense(label, photos, CHAIN_FLAGS, out,
                              str(root / "plain"), sc, med, failed)
    return launches, {
        "views": CHAIN_VIEWS, "h": h, "w": w,
        "registered": len(out["sfm"].poses),
        "n_points": len(out["cloud"]["points"]), "faces": len(mf),
        "total_s": seconds, "stage_s": stages, "files_read_back": back,
        **plain, "launches_by_shape": shapes}, failed


# phase 20: kernels B and D on the per-plane build's deeper tables
DEEP_PLANES = (256, 384, 512)
DEEP_D_PLANES = 256
# phase 21: the quality ladder's scene (hcmvs_tpu/eval/quality_ladder.py)
# at 1280x960, fixed FOV, once per route.  Route (i)'s floor is the JAX
# package's 0.8966 at this config (BASELINE.md, u16 tables) less 0.02;
# routes (ii)-(iv) within ROUTE_SPREAD of route (i).  View spread (route
# (v)) is held against the JAX package's own view-spread ladder on the CPU
# (volume / rect backends forced): at 640x480 like for like, within the
# parity tests' 0.03, and at 1280x960 against that 640x480 number less
# 0.05.  The JAX package's view-spread accuracy falls with size (0.9274 at
# 240x320, 0.9033 at 640x480; PERF.md), so its 240x320 number is no floor
# at 1280x960.
LADDER_ARGS = ("--h", "960", "--w", "1280", "--fx", "1200", "--views", "5",
               "--ext", "3", "--iters", "2", "--device", "cuda")
AT_640 = ("--h", "480", "--w", "640", "--fx", "600")
ROUTES = (
    ("rect128", (), EXACT_KERNELS),
    ("planes128", ("--cfg", '{"volume_build": "planes"}'),
     ("volume_lookup", "rect_lookup")),
    ("planes256", ("--volume-planes", "256"),
     ("volume_lookup", "rect_lookup")),
    ("direct", ("--exact-backend", "bilinear", "--geo-backend", "direct"),
     ()),
    ("view_spread", ("--cfg", '{"view_spread": 1}'), EXACT_KERNELS),
    ("view_spread_640", AT_640 + ("--cfg", '{"view_spread": 1}'),
     EXACT_KERNELS))
ROUTE_FLOOR = 0.8766
ROUTE_SPREAD = 0.01
JAX_VIEW_SPREAD_640 = 0.9033   # hcmvs_tpu.eval.quality_ladder --h 480
                               # --w 640 --fx 600 --cpu, volume / rect
                               # backends, view_spread 1 (PERF.md)
VIEW_SPREAD_PARITY = 0.03
VIEW_SPREAD_TOL = 0.05
# phase 22: the reference's operating point, 10 neighbours a view
OP_VIEWS, OP_NBR, OP_CHUNK = 11, 10, 4


def deep_parity(scene, cfg, dev, rows):
    """Phase 20: kernel B on view 0's first pair's per-plane tables at
    256 / 384 / 512 planes (image order) against the index fields of a
    random init at each width the paths use (36 / 9 / 64 / 16), and
    kernel D on the 256-plane table in its f32, packed and bounded modes
    at 324 and 81 columns: bit-equal to the plain versions, timed, with
    their bounds; the entries join B's and D's rows' ``shapes``."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.core.config import window_cfg_for_width
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.patchmatch import (_propagate_from,
                                                  propagation_offsets)
    from hcmvs_tpu_torch.dense.scene_driver import (init_scene_state,
                                                    phase_cfg)
    from hcmvs_tpu_torch.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu_torch.ops import volume as vol

    by_name = {r["name"]: r for r in rows}
    h, w = scene.gray.shape[1:]
    nbr = scene.nbr_idx[0, :1]
    geom = make_view_geometry(scene.cams[0], scene.cams[nbr])
    rays = pixel_rays(geom.K_inv_ref, h, w)
    st = init_scene_state(torch.Generator(device=dev).manual_seed(2), scene)
    dcfg = window_cfg_for_width(densify_cfg(), w)
    widths = [S.patch_offsets(phase_cfg(cfg, 1, True)),
              S.patch_offsets(phase_cfg(cfg, 0, False)),
              S.patch_offsets(phase_cfg(dcfg, 1, True)),
              S.patch_offsets(phase_cfg(dcfg, 0, False))]

    def entry(name, tab, f, out, ms, plain_ms, n_bytes, label, mode=None):
        b_ms, b_by = bound(name, n_bytes, out.numel())
        suffix = [] if mode in (None, "bounded") else [mode]
        return dict(shape=list(f.shape) + [tab.shape[1]] + suffix,
                    field=label,
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by)

    vt256 = None
    for d in DEEP_PLANES:
        vt = vol.build_volume_tables(geom, scene.gray[nbr], scene.d_min[0],
                                     scene.d_max[0], n_chunks=d // 128)
        tab0 = vt.tab[0]
        for offsets in widths:
            f = S.volume_fields(geom, vt, st.depth[0], st.normal[0], rays,
                                offsets, blocked=False)[2]
            out = kernels.volume_lookup(tab0, f)
            plain = vol.volume_lookup_plain(tab0, f)
            same = torch.equal(out, plain)
            log(f"[deep] B volume_lookup: table {tuple(tab0.shape)}, field "
                f"{tuple(f.shape)}, bit-equal {same}")
            if not same:
                raise AssertionError(
                    f"kernel B at D = {d}, {tuple(f.shape)}: max abs err "
                    f"{float((out - plain).abs().max())}")
            ms = cuda_ms(lambda: kernels.volume_lookup(tab0, f), 20)
            plain_ms = cuda_ms(lambda: vol.volume_lookup_plain(tab0, f), 5,
                               host_bound_ok=True)
            n_bytes = nbytes(f, out) + table_bytes(tab0, torch.clamp(
                torch.floor(f), 0, d - 2).long())
            by_name["volume_lookup"]["shapes"].append(entry(
                "volume_lookup", tab0, f, out, ms, plain_ms, n_bytes,
                f"init, planes build {d}"))
            del f, out, plain
        if d == DEEP_D_PLANES:
            vt256 = vt
        del vt, tab0

    # D: view 0's nine propagation candidates on the 256-plane table
    tab0 = vt256.tab[0]
    cand = [(st.depth[0], st.normal[0])] + [
        _propagate_from(st.depth[0], st.normal[0], rays, dy, dx)
        for dy, dx in propagation_offsets(cfg)]
    depths = torch.stack([c[0] for c in cand])
    normals = torch.stack([c[1] for c in cand])
    bounds0 = S.volume_bounds(vt256, False)[0]
    for step in (cfg.patch_step, cfg.explore_patch_step):
        offsets = S.patch_offsets(cfg.replace(patch_step=step))
        f2, _ = S.packed_fields(geom, vt256, depths, normals, rays, offsets,
                                blocked=False)
        f32 = torch.cat([S.volume_fields(geom, vt256, depths[k], normals[k],
                                         rays, offsets, blocked=False)[2]
                         for k in range(depths.shape[0])], dim=1)
        fi = vol.u16_as_int32(f2)
        b = vol.u16_as_int32(bounds0)
        for mode, f, bnd in (("bounded", f2, bounds0), ("packed", f2, None),
                             ("f32", f32, None)):
            out = kernels.volume_lookup_multi(tab0, f, bnd)
            plain = vol.volume_lookup_multi_plain(tab0, f, bnd)
            same = (torch.equal(out, plain) if mode == "f32" else
                    torch.equal(vol.u16_as_int32(out),
                                vol.u16_as_int32(plain)))
            log(f"[deep] D volume_lookup_multi ({mode}): table "
                f"{tuple(tab0.shape)}, field {tuple(f.shape)}, bit-equal "
                f"{same}")
            if not same:
                raise AssertionError(f"kernel D ({mode}) at D = "
                                     f"{DEEP_D_PLANES} differs from its "
                                     f"plain version")
            if mode == "f32":
                i0 = torch.clamp(torch.floor(f), 0,
                                 DEEP_D_PLANES - 2).long()
                need = None
            else:
                i0 = torch.clamp_max(fi >> 6, DEEP_D_PLANES - 2).long()
                need = ((fi >= b[:, :1]) & (fi <= b[:, 64:65])
                        if bnd is not None else None)
            n_bytes = (nbytes(f, out) + table_bytes(tab0, i0, need)
                       + (64 * tab0.shape[0] if bnd is not None else 0))
            del i0, need
            ms = cuda_ms(lambda: kernels.volume_lookup_multi(tab0, f, bnd),
                         20)
            plain_ms = cuda_ms(
                lambda: vol.volume_lookup_multi_plain(tab0, f, bnd), 3,
                host_bound_ok=True)
            by_name["volume_lookup_multi"]["shapes"].append(entry(
                "volume_lookup_multi", tab0, f, out, ms, plain_ms,
                n_bytes, f"{mode}, planes build {DEEP_D_PLANES}", mode))
            del out, plain
        del f2, f32, fi, b
    for name in ("volume_lookup", "volume_lookup_multi"):
        for x in by_name[name]["shapes"]:
            if 128 in x["shape"][2:]:
                continue
            log(f"[deep] {name} {x['shape']} ({x['field']}): kernel "
                f"{x['ms']:.3f} ms, plain {x['plain_ms']:.3f} ms, bound "
                f"{x['bound_ms']:.3f} ms ({x['bound_by']}), "
                f"{100 * x['bound_ms'] / x['ms']:.1f}% of the bound")


def route_run(label, extra):
    """One quality-ladder run on the card: (final record, seconds, peak
    GiB, launches, launches by shape)."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval import quality_ladder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        recs = quality_ladder.run(list(LADDER_ARGS) + list(extra),
                                  emit=lambda line: log(f"[{label}] {line}"))
        seconds = time.perf_counter() - t0
    final = recs[-1]
    if not np.isfinite(final["depth0"]).all():
        raise AssertionError(f"{label}: non-finite depth")
    return (final, seconds, torch.cuda.max_memory_allocated() / 2 ** 30,
            dict(kernels.launches), shapes)


def check_routes():
    """Phase 21: the quality ladder's scene at 1280x960 through each
    route (rect tables at 128 planes; the per-plane build at 128 and 256;
    direct bilinear + direct geo; rect tables + view spread, also at
    640x480, where the JAX package's number was measured): view 0's
    accuracies, valid share, wall, peak memory and launches by shape,
    each route's kernels launched (none on the direct route, no A on the
    per-plane builds); then route (iii) again through the plain versions:
    no launch and the same depth map."""
    import numpy as np
    from hcmvs_tpu_torch import kernels

    failed = []
    summary = {}
    launches_all = collections.Counter()
    by_shape = {name: collections.Counter() for name in SHAPE_OF}
    finals = {}
    for label, extra, path_kernels in ROUTES:
        final, sec, peak, launches, shapes = route_run(label, extra)
        finals[label] = final
        shapes = check_shapes(label, launches, shapes, failed)
        for name, c in shapes.items():
            by_shape[name].update(c)
        launches_all.update(launches)
        log(f"[{label}] view 0 acc2pct {final['acc2pct']:.4f}, acc1pct "
            f"{final['acc1pct']:.4f}, valid {final['valid']:.3f}, "
            f"{sec:.3f} s, peak memory {peak:.2f} GiB, launches {launches}")
        missing = [k for k in path_kernels if launches[k] <= 0]
        extra_k = [k for k in launches if k not in path_kernels
                   and launches[k] > 0]
        if missing or extra_k:
            failed.append(f"{label}: kernels missing {missing}, launched "
                          f"outside the route {extra_k}")
        summary[label] = {"acc2pct": final["acc2pct"],
                          "acc1pct": final["acc1pct"],
                          "valid": final["valid"], "seconds": sec,
                          "peak_gib": peak, "launches_by_shape": shapes}
    base = finals["rect128"]["acc2pct"]
    if base < ROUTE_FLOOR:
        failed.append(f"rect128: acc2pct {base} < {ROUTE_FLOOR}")
    for label in ("planes128", "planes256", "direct"):
        if abs(finals[label]["acc2pct"] - base) > ROUTE_SPREAD:
            failed.append(f"{label}: acc2pct {finals[label]['acc2pct']} "
                          f"more than {ROUTE_SPREAD} from rect128's {base}")
    for label, floor in (
            ("view_spread_640", JAX_VIEW_SPREAD_640 - VIEW_SPREAD_PARITY),
            ("view_spread", JAX_VIEW_SPREAD_640 - VIEW_SPREAD_TOL)):
        if finals[label]["acc2pct"] < floor:
            failed.append(f"{label}: acc2pct {finals[label]['acc2pct']} < "
                          f"{floor}")

    kernels.reset_launches()
    with kernels.plain_versions():
        final, sec, peak, launches, _ = route_run(
            "planes256 plain", dict((r[0], r[1]) for r in ROUTES)[
                "planes256"])
    same = np.array_equal(final["depth0"], finals["planes256"]["depth0"])
    log(f"[planes256 plain] view 0 acc2pct {final['acc2pct']:.4f}, "
        f"{sec:.3f} s, launches {launches}, depth map equal to the kernel "
        f"run {same}")
    if any(launches.values()):
        failed.append(f"planes256 plain run launched kernels: {launches}")
    if not same:
        failed.append("planes256: the plain run's depth map differs")
    summary["planes256"]["plain_seconds"] = sec
    summary["planes256"]["plain_equal"] = same
    return dict(launches_all), {"launches_by_shape": {
        k: dict(v) for k, v in by_shape.items()}, "routes": summary}, failed


def op_scene(h, w, dev):
    """Phase 22's scene: ``make_plane_scene`` (bench._build's) with
    OP_VIEWS views at h x w, focal length scaled with width, each view's
    first OP_NBR other views as neighbours."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=OP_VIEWS, fx=180.0 * w / 192.0)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(dev)
    nbr = [[j for j in range(OP_VIEWS) if j != i][:OP_NBR]
           for i in range(OP_VIEWS)]
    return sc, SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]).to(dev),
        cams=cams, nbr_idx=torch.tensor(nbr, device=dev),
        nbr_valid=torch.ones(OP_VIEWS, OP_NBR, dtype=torch.bool,
                             device=dev),
        d_min=torch.full((OP_VIEWS,), sc.d_min, device=dev),
        d_max=torch.full((OP_VIEWS,), sc.d_max, device=dev))


def op_run(label, scene, cfg, dev):
    """One estimate_scene + finalize at the operating point: (state,
    seconds, peak GiB, launches, launches by shape, stage report)."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.dense.scene_driver import estimate_scene
    from hcmvs_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset_report()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        state = estimate_scene(torch.Generator(device=dev).manual_seed(0),
                               scene, cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if not (torch.isfinite(state.depth).all()
            and torch.isfinite(state.cost).all()):
        raise AssertionError(f"{label}: non-finite output")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rep = profiling.report()
    streamed = rep.get("estimate.tables.streamed", {"total_s": 0.0,
                                                    "calls": 0})
    log(f"[{label}] {seconds:.3f} s, {OP_VIEWS / seconds:.4f} views/s, "
        f"tables {rep['estimate.tables']['total_s']:.3f} s attached + "
        f"{streamed['total_s']:.3f} s streamed ({streamed['calls']} "
        f"builds), peak memory {peak:.2f} GiB, launches "
        f"{dict(kernels.launches)}")
    return state, seconds, peak, dict(kernels.launches), shapes, rep


def check_operating_point(dev):
    """Phase 22: 11 views x 10 neighbours at 1280x960 (bench._build's
    workload, 128 planes) with streamed tables (one view's tables live at
    a time): views/s, peak memory, the live tables' bytes, launches by
    shape; the same run with attached tables gives bit-equal maps (at
    640x480 if the attached tables do not fit); chunks of 4 / 4 / 3 views
    from one entry state equal one unchunked sweep call; then the
    streamed run at 256 planes, one external iteration, candidates
    batched (kernel D on the 256-plane tables), and its peak."""
    import torch
    from hcmvs_tpu_torch.dense.scene_driver import (init_scene_state,
                                                    scene_sweeps,
                                                    sweep_in_chunks)
    failed = []
    summary = {}
    launches_all = collections.Counter()
    by_shape = {name: collections.Counter() for name in SHAPE_OF}

    def record(label, out):
        state, sec, peak, launches, shapes, rep = out
        shapes = check_shapes(label, launches, shapes, failed)
        for name, c in shapes.items():
            by_shape[name].update(c)
        launches_all.update(launches)
        summary[label] = {"seconds": sec, "views_per_s": OP_VIEWS / sec,
                          "peak_gib": peak, "launches_by_shape": shapes,
                          "streamed_tables_s": rep.get(
                              "estimate.tables.streamed", {}).get(
                              "total_s", 0.0)}
        return state

    # one sweep a phase (the slice's workload runs two): the script's time
    # limit; no check depends on the sweep count
    cfg = slice_cfg().replace(volume_streaming=True, estimation_iters=1)
    for h, w in ((H, W), (H // 2, W // 2)):
        sc, scene = op_scene(h, w, dev)
        live = OP_NBR * -(-h * w // 2048) * 2048 * 128 * 2
        st_s = record("op_streamed", op_run("op_streamed", scene, cfg, dev))
        if min(launches_all[k] for k in EXACT_KERNELS) <= 0:
            failed.append(f"op_streamed: a kernel never launched "
                          f"{dict(launches_all)}")
        summary["op_streamed"].update(
            h=h, w=w, live_table_bytes=live,
            scene_table_bytes=OP_VIEWS * live,
            depth_acc_2pct=depth_acc_2pct(st_s.depth[0].cpu().numpy(),
                                          sc.depth_gt))
        log(f"[op_streamed] {h}x{w}: live tables {live / 1e9:.3f} GB (one "
            f"view), scene-wide {OP_VIEWS * live / 1e9:.3f} GB, view 0 "
            f"depth_acc_2pct {summary['op_streamed']['depth_acc_2pct']:.4f}")
        try:
            st_a = record("op_attached", op_run(
                "op_attached", scene, cfg.replace(volume_streaming=False),
                dev))
        except torch.cuda.OutOfMemoryError:
            log(f"[op_attached] scene-wide tables do not fit at {h}x{w}: "
                f"both runs again at {h // 2}x{w // 2}")
            del st_s
            torch.cuda.empty_cache()
            continue
        same = all(torch.equal(getattr(st_s, k), getattr(st_a, k))
                   for k in ("depth", "normal", "cost"))
        log(f"[op_attached] {h}x{w}: maps bit-equal to the streamed run "
            f"{same}")
        summary["op_attached"].update(h=h, w=w, equal_to_streamed=same)
        if not same:
            failed.append("op: streamed and attached maps differ")
        del st_s, st_a
        break
    torch.cuda.empty_cache()

    # chunks of OP_CHUNK views from one entry state vs one call
    sc, scene = op_scene(H, W, dev)
    entry = init_scene_state(torch.Generator(device=dev).manual_seed(0),
                             scene)
    one = scene_sweeps(entry, scene, cfg, 1, cfg.estimation_iters, True,
                       torch.Generator(device=dev).manual_seed(5))
    t0 = time.perf_counter()
    chunked = sweep_in_chunks(entry, scene, cfg, 1, cfg.estimation_iters,
                              True, torch.Generator(device=dev).manual_seed(5),
                              OP_CHUNK)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(one, k), getattr(chunked, k))
               for k in ("depth", "normal", "cost"))
    log(f"[op_chunked] chunks of {OP_CHUNK} (4 / 4 / 3 views), geometric "
        f"phase, {time.perf_counter() - t0:.3f} s: maps equal to the "
        f"unchunked call {same}")
    summary["op_chunked"] = {"equal_to_unchunked": same}
    if not same:
        failed.append("op: chunked and unchunked maps differ")
    del entry, one, chunked
    torch.cuda.empty_cache()

    # 256 planes, streamed, one external iteration, candidates batched
    cfg256 = cfg.replace(volume_planes=256, estimation_iters_external=1,
                         candidate_kernel="on")
    record("op_streamed_256", op_run("op_streamed_256", scene, cfg256, dev))
    live = OP_NBR * -(-H * W // 2048) * 2048 * 256 * 2
    summary["op_streamed_256"].update(live_table_bytes=live,
                                      scene_table_bytes=OP_VIEWS * live)
    log(f"[op_streamed_256] live tables {live / 1e9:.3f} GB, scene-wide "
        f"{OP_VIEWS * live / 1e9:.3f} GB, peak "
        f"{summary['op_streamed_256']['peak_gib']:.2f} GiB")
    if summary["op_streamed_256"]["launches_by_shape"][
            "volume_lookup_multi"] == {}:
        failed.append("op_streamed_256: kernel D never launched")
    return dict(launches_all), {"launches_by_shape": {
        k: dict(v) for k, v in by_shape.items()}, "runs": summary}, failed


# phase 23: kernels B, D and E one chunk past the caps they once had: B
# and D split rows into launches of under 2^31 items and table entries, E
# reads its offsets from a device buffer of any length
CAP_B = (4_300_000, 9, 512)     # rows, field width, planes (2.2 G entries)
CAP_D = (3_800_000, 576, 128)   # rows, 9 candidates x 64 offsets, planes
CAP_E = dict(adapt_half_window=11, patch_step=2)     # 140 warped offsets
CAP_E_OFFSETS = 140


def _by_rows(fn, rows: int, *arrays):
    """A row-wise plain version over slices of ``rows`` rows, joined (its
    int64 temporaries at 2 G items would not fit the card at once)."""
    import torch
    p = arrays[0].shape[0]
    return torch.cat([fn(*(None if a is None else a[r:r + rows]
                           for a in arrays)) for r in range(0, p, rows)])


def past_caps(scene, cfg, dev, rows):
    """Phase 23: kernel B at D = 512 on 4.3 M rows (2.2 G table entries)
    and kernel D packed and bounded at 576 columns on 3.8 M rows (2.19 G
    items): two row chunks each, bit-equal to their plain versions (run
    in row slices); kernel E with the 140 warped offsets of
    adapt_half_window 11 at patch step 2, on view 0's three pairs at
    1280x960: exact.  Each timed with its bound; the entries join the
    rows' ``shapes``."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.dense import score as S
    from hcmvs_tpu_torch.dense.scene_driver import init_scene_state
    from hcmvs_tpu_torch.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu_torch.ops import volume as vol
    from hcmvs_tpu_torch.ops import zncc_warped as zw
    from hcmvs_tpu_torch.ops.gradients import sobel_magnitude

    by_name = {r["name"]: r for r in rows}
    gen = torch.Generator(device=dev).manual_seed(23)

    def add(name, shape, label, n_launch, ms, plain_ms, n_bytes, n_el):
        b_ms, b_by = bound(name, n_bytes, n_el)
        x = dict(shape=shape, field=label, max_abs_err=0.0, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 launches_per_call=n_launch)
        by_name[name].setdefault("shapes", []).append(x)
        log(f"[caps] {name} {shape} ({label}): {n_launch} launches a call, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the bound")

    # B: a random 512-plane table, fields over the whole grid and past it
    p, s, d = CAP_B
    tab = torch.randint(-32768, 32768, (p, d), dtype=torch.int16,
                        device=dev, generator=gen).view(torch.uint16)
    f = torch.rand((p, s), device=dev, generator=gen) * (d + 4) - 2
    before = kernels.launches["volume_lookup"]
    out = kernels.volume_lookup(tab, f)
    n_launch = kernels.launches["volume_lookup"] - before
    same = torch.equal(out, _by_rows(vol.volume_lookup_plain, 500_000, tab,
                                     f))
    log(f"[caps] B volume_lookup: table {tuple(tab.shape)} "
        f"({p * d / 2 ** 31:.3f} x 2^31 entries), field {tuple(f.shape)}, "
        f"{n_launch} launches, bit-equal {same}")
    if not same or n_launch != 2:
        raise AssertionError(f"kernel B past the item cap: bit-equal {same},"
                             f" {n_launch} launches")
    i0 = torch.clamp(torch.floor(f), 0, d - 2).long()
    n_bytes = nbytes(f, out) + table_bytes(tab, i0)
    del i0
    add("volume_lookup", [p, s, d], "random, past the item cap", n_launch,
        cuda_ms(lambda: kernels.volume_lookup(tab, f), 5),
        cuda_ms(lambda: _by_rows(vol.volume_lookup_plain, 500_000, tab, f),
                1, 1, 3, host_bound_ok=True), n_bytes, out.numel())
    del tab, f, out
    torch.cuda.empty_cache()

    # D, packed and bounded: random 128-plane table and packed field,
    # per-row intervals holding part of each row's items
    p, c, d = CAP_D
    tab = torch.randint(-32768, 32768, (p, d), dtype=torch.int16,
                        device=dev, generator=gen).view(torch.uint16)
    f = torch.randint(0, (d - 1) * vol.F_PACK_SCALE + 1, (p, c),
                      dtype=torch.int16, device=dev,
                      generator=gen).view(torch.uint16)
    lo = torch.randint(0, 40 * vol.F_PACK_SCALE, (p, 1), device=dev,
                       generator=gen)
    hi = torch.randint(60 * vol.F_PACK_SCALE, 65535, (p, 1), device=dev,
                       generator=gen)
    bounds = torch.cat([lo.expand(p, 64), hi.expand(p, 64)],
                       1).to(torch.uint16)
    before = kernels.launches["volume_lookup_multi"]
    out = kernels.volume_lookup_multi(tab, f, bounds)
    n_launch = kernels.launches["volume_lookup_multi"] - before
    plain = _by_rows(vol.volume_lookup_multi_plain, 400_000, tab, f, bounds)
    same = torch.equal(out.view(torch.int16), plain.view(torch.int16))
    del plain
    log(f"[caps] D volume_lookup_multi (bounded): table {tuple(tab.shape)},"
        f" field {tuple(f.shape)} ({p * c / 2 ** 31:.3f} x 2^31 items), "
        f"{n_launch} launches, bit-equal {same}")
    if not same or n_launch != 2:
        raise AssertionError(f"kernel D past the item cap: bit-equal {same},"
                             f" {n_launch} launches")
    need_bytes = 0
    for r in range(0, p, 400_000):
        fi = vol.u16_as_int32(f[r:r + 400_000])
        need = (fi >= lo[r:r + 400_000]) & (fi <= hi[r:r + 400_000])
        need_bytes += table_bytes(tab[r:r + 400_000],
                                  torch.clamp_max(fi >> 6, d - 2).long(),
                                  need)
        del fi, need
    add("volume_lookup_multi", [p, c, d], "random bounded, past the item "
        "cap", n_launch,
        cuda_ms(lambda: kernels.volume_lookup_multi(tab, f, bounds), 3),
        cuda_ms(lambda: _by_rows(vol.volume_lookup_multi_plain, 400_000,
                                 tab, f, bounds), 1, 1, 3,
                host_bound_ok=True),
        nbytes(f, out) + need_bytes + 64 * p, out.numel())
    del tab, f, out, bounds, lo, hi
    torch.cuda.empty_cache()

    # E: view 0 against its three neighbours, warped scoring at full
    # sampling with the widest adaptive window of the reference's presets
    cfg_e = cfg.replace(**CAP_E)
    h, w = scene.gray.shape[1:]
    nbr = scene.nbr_idx[0]
    geom = make_view_geometry(scene.cams[0], scene.cams[nbr])
    rays = pixel_rays(geom.K_inv_ref, h, w)
    st = init_scene_state(torch.Generator(device=dev).manual_seed(2), scene)
    offsets = S.patch_offsets(cfg_e)
    hw = S.halfwin_map(sobel_magnitude(scene.gray[0]), cfg_e)
    stats = S.ref_patch_stats(scene.gray[0], hw, offsets)
    x = S.warped_inputs(geom, scene.gray[nbr], stats, hw, st.depth[0],
                        st.normal[0], rays, offsets)
    e_args = x[:9]
    before = kernels.launches["zncc_warped"]
    out_s, out_v = kernels.zncc_warped(*e_args)
    n_launch = kernels.launches["zncc_warped"] - before
    plain_s, plain_v = zw.zncc_warped_plain(*e_args)
    err = max(float((out_s - plain_s).abs().max()),
              float((out_v - plain_v).abs().max()))
    n_off = len(x.scan_offsets)
    log(f"[caps] E zncc_warped: out {tuple(out_s.shape)} x 2, {n_off} "
        f"offsets, pad {x.pad}, {n_launch} launch, max |kernel - plain| "
        f"{err:.3g}")
    if err != 0 or n_off != CAP_E_OFFSETS:
        raise AssertionError(f"kernel E at {n_off} offsets: max abs err "
                             f"{err}")
    add("zncc_warped", list(out_s.shape) + [f"{n_off} offsets"],
        f"adapt_half_window {CAP_E['adapt_half_window']}, patch step "
        f"{CAP_E['patch_step']}", n_launch,
        cuda_ms(lambda: kernels.zncc_warped(*e_args), 10),
        cuda_ms(lambda: zw.zncc_warped_plain(*e_args), 3,
                host_bound_ok=True),
        nbytes(*(t for t in e_args if torch.is_tensor(t)), out_s, out_v),
        out_s.numel() * n_off)
    del x, e_args, out_s, out_v, plain_s, plain_v
    torch.cuda.empty_cache()


# phase 24: SGM (densify --fusion-mode -2, then -1) on the densify phase's
# scene.  SGM_FLOOR: the JAX package's view 0 depth_acc_2pct with
# --fusion-mode -2 on this scene at 480x640 on the CPU, less 0.05
# (tests/test_torch_sgm.py run as a script); it reaches none of the five
# kernels
SGM_JAX_ACC = 0.8581
SGM_FLOOR = SGM_JAX_ACC - 0.05
SGM_MATCHES = N_VIEWS * N_NBR * 2      # a pair's match and its reverse
BOX_HW = (64, 96)                      # tests/test_sgm.py's box scene


def _sgm_run(scene_path, img_dir, out_dir, mode):
    """densify's CLI entry point in SGM mode ``mode`` on the card: (stats,
    stage report, seconds, peak GiB, launches, launches by shape)."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.pipeline import densify as D
    from hcmvs_tpu_torch.utils import profiling
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        stats = D.main(["--input-file", scene_path, "--images-dir", img_dir,
                        "-w", out_dir, "--fusion-mode", str(mode),
                        "--flags", *DENSIFY_FLAGS])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return (stats, profiling.report(), seconds,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            dict(kernels.launches), shapes)


def _box_lr_check(dev):
    """tests/test_sgm.py's occlusion check on the card: single-pair SGM on
    the box scene with and without the left-right check; (ghost share,
    estimates in the occluded band) for each."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch.core.camera import Camera
    from hcmvs_tpu_torch.dense.scene_driver import SceneTensors
    from hcmvs_tpu_torch.dense.sgm import lr_consistency, sgm_scene
    from hcmvs_tpu_torch.dense.types import make_view_geometry
    from hcmvs_tpu_torch.utils.synth import make_box_scene
    sc = make_box_scene(np.random.default_rng(5), h=BOX_HW[0], w=BOX_HW[1],
                        n_views=2)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(dev)
    scene = SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]).to(dev),
        cams=cams, nbr_idx=torch.tensor([[1], [0]], device=dev),
        nbr_valid=torch.ones(2, 1, dtype=torch.bool, device=dev),
        d_min=torch.full((2,), sc.d_min, device=dev),
        d_max=torch.full((2,), sc.d_max, device=dev))
    g01 = make_view_geometry(cams[0], cams[1:2])
    occl = ~lr_consistency(
        g01, torch.from_numpy(sc.depth_gts[0]).to(dev),
        torch.from_numpy(sc.depth_gts[1]).to(dev),
        rel_thr=0.01).cpu().numpy()
    inner = np.s_[6:-6, 6:-6]
    out = {}
    for lr in (False, True):
        d0 = sgm_scene(scene, n_depths=64, n_pairs=1,
                       lr_check=lr)[0][0].cpu().numpy()
        gt = sc.depth_gts[0]
        val = d0 > 0
        ghost = val & (np.abs(d0 - gt) / gt > 0.05)
        out[lr] = (float(ghost[inner].sum() / max(val[inner].sum(), 1)),
                   float((val & occl)[inner].mean()))
    return out


def check_sgm(root, dev):
    """Phase 24: densify --fusion-mode -2 and -1 (SGM) through the CLI
    entry point on the densify phase's scene (1280x960, 4 views, 3
    neighbours, scene.mvs + PNGs): no kernel of the port may launch, view
    0 must reach SGM_FLOOR, the .dmap / .ply files must read back, the two
    modes' maps must be equal; SGM's wall, its device operations (one
    match profiled, times the run's matches) and the peak memory are
    printed; then the box scene's occlusion check."""
    import numpy as np
    from hcmvs_tpu_torch.dense.sgm import sgm_match
    from hcmvs_tpu_torch.dense.types import make_view_geometry
    from hcmvs_tpu_torch.io.dmap import read_dmap
    from hcmvs_tpu_torch.io.ply import read_ply
    from hcmvs_tpu_torch.utils.synth import make_plane_scene, write_plane_scene

    label = "sgm"
    failed = []
    sc = make_plane_scene(np.random.default_rng(0), h=H, w=W,
                          n_views=N_VIEWS, fx=180.0 * W / 192.0)
    scene_path, img_dir = write_plane_scene(str(root), sc,
                                            png_filter=DENSIFY_PNG_FILTER)
    runs, summary = {}, {}
    launches_all = collections.Counter()
    by_shape = {name: collections.Counter() for name in SHAPE_OF}
    for mode in (-2, -1):
        out_dir = root / f"mode{-mode}"
        st, rep, sec, peak, launches, shapes = _sgm_run(
            scene_path, img_dir, str(out_dir), mode)
        runs[mode] = st
        launches_all.update(launches)
        for name, cnt in check_shapes(f"{label} {mode}", launches, shapes,
                                      failed).items():
            by_shape[name].update(cnt)
        if any(launches.values()):
            failed.append(f"{label} {mode}: kernels launched {launches}")
        acc = depth_acc_2pct(st["depth"][0], sc.depth_gt)
        sgm_s = rep["densify.sgm"]["total_s"]
        log(f"[{label}] --fusion-mode {mode}: total {sec:.3f} s, SGM "
            f"{sgm_s:.3f} s ({SGM_MATCHES} matches), peak memory "
            f"{peak:.2f} GiB, valid {st['valid_frac']:.4f}, points "
            f"{st['n_points']}, view 0 interior depth_acc_2pct {acc:.4f} "
            f"(floor {SGM_FLOOR:.4f}), launches {launches}")
        if acc < SGM_FLOOR:
            failed.append(f"{label} {mode}: depth accuracy {acc} < "
                          f"{SGM_FLOOR}")
        for i in range(N_VIEWS):
            dm = read_dmap(str(out_dir / "depthmap" / f"depth{i:04d}.dmap"))
            if not np.array_equal(dm.depth, st["depth"][i]):
                failed.append(f"{label} {mode}: depth{i:04d}.dmap does not "
                              f"read back")
        if mode == -2:
            pts, _ = read_ply(str(out_dir / "scene_dense.ply"))
            if not len(pts) == st["n_points"] > 0:
                failed.append(f"{label}: scene_dense.ply has {len(pts)} "
                              f"points, stats {st['n_points']}")
        elif st["n_points"] != 0 or (out_dir / "scene_dense.ply").exists():
            failed.append(f"{label} -1: a cloud was fused")
        summary[f"mode{mode}"] = {"total_s": sec, "sgm_s": sgm_s,
                                  "peak_gib": peak,
                                  "valid_frac": st["valid_frac"],
                                  "n_points": st["n_points"],
                                  "depth_acc_2pct": acc}
    if not np.array_equal(runs[-2]["depth"], runs[-1]["depth"]):
        failed.append(f"{label}: modes -2 and -1 give different maps")

    # device operations of one match: view 0 against its first neighbour
    # at the run's depth range (from depth0000.dmap), times the matches
    import torch
    from hcmvs_tpu_torch.io.images import load_image
    dm0 = read_dmap(str(root / "mode2" / "depthmap" / "depth0000.dmap"))
    nb = int(dm0.view_ids[1])
    grays = [torch.from_numpy(load_image(str(Path(img_dir)
                                             / f"im{i:04d}.png"),
                                         gray=True)).to(dev)
             for i in (0, nb)]
    cams = [sc.cameras[i].to(dev) for i in (0, nb)]
    geom = make_view_geometry(cams[0], cams[1][None])
    dmin = torch.tensor(dm0.d_min, dtype=torch.float32, device=dev)
    dmax = torch.tensor(dm0.d_max, dtype=torch.float32, device=dev)
    ms, ops = device_busy(lambda: sgm_match(geom, grays[0], grays[1], dmin,
                                            dmax))
    log(f"[{label}] one match at {H}x{W}, 64 depths: {ops} device "
        f"operations, {ms:.3f} ms of device time (profiler); the run's "
        f"{SGM_MATCHES} matches ~{ops * SGM_MATCHES} operations")
    summary.update(match_device_ops=ops, match_device_ms=ms,
                   run_device_ops_est=ops * SGM_MATCHES)

    box = _box_lr_check(dev)
    (g_no, occ_no), (g_lr, occ_lr) = box[False], box[True]
    log(f"[{label}] box scene {BOX_HW[0]}x{BOX_HW[1]}, one pair: ghost "
        f"share {g_no:.4f} -> {g_lr:.4f} with the LR check, estimates in "
        f"the occluded band {occ_no:.4f} -> {occ_lr:.4f}")
    if not (occ_lr < occ_no * 0.35 and g_lr < g_no * 0.75):
        failed.append(f"{label}: the LR check does not remove the box "
                      f"scene's ghosts ({box})")
    summary["box_lr"] = {"ghost": [g_no, g_lr], "occluded": [occ_no, occ_lr]}
    summary["launches_by_shape"] = {k: dict(v) for k, v in by_shape.items()}
    return dict(launches_all), summary, failed


# phase 25: eval.golden on the card, held key by key against the JAX
# package's run of the same mode on the CPU (``JAX_PLATFORMS=cpu python -m
# hcmvs_tpu.eval.golden [--hierarchy | --full-stack --fx 180]``, 144x192,
# 5 views, on the same tree; PERF.md).  The SfM halves draw their own
# RANSAC samples, so ATE and rms are bounded from above.
GOLDEN_JAX = {
    "run": {"ate_rmse": 0.1616, "sfm_rms_px": 0.371, "depth_acc_2pct": 0.92,
            "cloud_dist": 0.00972, "mesh_fscore": 0.935, "registered": 5},
    "hierarchy": {"hier_depth_acc_2pct": 0.717},
    "full_stack": {"hier_depth_acc_2pct": 0.712}}
GOLDEN_ARGS = {"run": [], "hierarchy": ["--hierarchy"],
               "full_stack": ["--full-stack", "--fx", "180"]}
GOLDEN_ACC_TOL = 0.03
GOLDEN_CLOUD_RTOL = 0.25
GOLDEN_MESH_TOL = 0.05
GOLDEN_ATE_MARGIN = 0.05
GOLDEN_RMS_MARGIN = 0.1


def _golden_gates(mode, out, failed):
    ref = GOLDEN_JAX[mode]
    checks = []
    for key in ("depth_acc_2pct", "hier_depth_acc_2pct"):
        if key in ref:
            checks.append((key, abs(out[key] - ref[key]) <= GOLDEN_ACC_TOL))
    if "cloud_dist" in ref:
        checks += [
            ("cloud_dist", abs(out["cloud_dist"] - ref["cloud_dist"])
             <= GOLDEN_CLOUD_RTOL * ref["cloud_dist"]),
            ("mesh_fscore", abs(out["mesh_fscore"] - ref["mesh_fscore"])
             <= GOLDEN_MESH_TOL),
            ("registered", out["registered"] == ref["registered"]),
            ("ate_rmse", out["ate_rmse"] <= ref["ate_rmse"]
             + GOLDEN_ATE_MARGIN),
            ("sfm_rms_px", out["sfm_rms_px"] <= ref["sfm_rms_px"]
             + GOLDEN_RMS_MARGIN)]
    for key, ok in checks:
        if not ok:
            failed.append(f"golden {mode}: {key} {out[key]} against the JAX "
                          f"package's {ref[key]}")
    return {k: ok for k, ok in checks}


def check_golden(dev, modes=tuple(GOLDEN_ARGS)):
    """Phase 25: ``eval.golden.main`` on the card in each of ``modes`` (the
    default run, ``--hierarchy``, ``--full-stack --fx 180``), each key
    against the JAX package's same-tree CPU run; wall, launches and peak
    per run."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval import golden
    failed = []
    summary = {}
    launches_all = collections.Counter()
    by_shape = {name: collections.Counter() for name in SHAPE_OF}
    for mode in modes:
        args = GOLDEN_ARGS[mode]
        label = f"golden_{mode}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with launch_shapes() as shapes:
            t0 = time.perf_counter()
            out = golden.main(args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        launches = dict(kernels.launches)
        launches_all.update(launches)
        for name, cnt in check_shapes(label, launches, shapes,
                                      failed).items():
            by_shape[name].update(cnt)
        if min(launches[k] for k in EXACT_KERNELS) <= 0:
            failed.append(f"{label}: a kernel of the path never launched: "
                          f"{launches}")
        gates = _golden_gates(mode, out, failed)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[{label}] {sec:.3f} s, peak memory {peak:.2f} GiB, launches "
            f"{launches}: {out} against the JAX package's "
            f"{GOLDEN_JAX[mode]}, gates {gates}")
        summary[mode] = dict(out, seconds=sec, peak_gib=peak, gates=gates)
    summary["launches_by_shape"] = {k: dict(v) for k, v in by_shape.items()}
    return dict(launches_all), summary, failed


# phase 26: eval.full_run at 1280x960, 6 views; the gates are the JAX
# package's only full-size readings (BASELINE.md:119-123: ATE 0.0156,
# depth 0.971, mesh F 0.763 -> 0.794 refined), depth and F less the
# margins the other phases allow
FULL_ATE_MAX = 0.025
FULL_DEPTH_FLOOR = 0.94
FULL_MESH_FLOOR = 0.713
FULL_REFINE_DROP = 0.01


def check_full_run(root):
    """Phase 26: ``eval.full_run.main`` at 1280x960 with 6 views (SfM, the
    5-stage hierarchy, fusion, graph cut, refine, texture, all on the
    card): its gates, each stage's wall, the peak memory, launches by
    shape.  No plain rerun: A, B and C are held against their plain
    versions at these shapes in phases 3-11."""
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval import full_run
    label = "full_run"
    failed = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        out = full_run.main(["--out-dir", str(root)])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    launches = dict(kernels.launches)
    shapes = check_shapes(label, launches, shapes, failed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    log(f"[{label}] {sec:.3f} s, peak memory {peak:.2f} GiB; stages: SfM "
        f"{out['sfm_s']} s, dense {out['dense_s']} s, mesh {out['mesh_s']} "
        f"s, refine {out['refine_s']} s, texture {out['texture_s']} s; "
        f"dense stages {out['stage_walls']}")
    log(f"[{label}] ATE {out['ate_rmse']} (max {FULL_ATE_MAX}), depth "
        f"{out['depth_acc_2pct']} (floor {FULL_DEPTH_FLOOR}), cloud "
        f"{out['cloud_dist']}, mesh F {out['mesh_fscore']} -> refined "
        f"{out['mesh_fscore_refined']} (floor {FULL_MESH_FLOOR}), points "
        f"{out['n_points']}, faces {out['n_faces']}")
    for ok, what in (
            (out["ate_rmse"] < FULL_ATE_MAX, "ATE"),
            (out["depth_acc_2pct"] >= FULL_DEPTH_FLOOR, "depth accuracy"),
            (out["mesh_fscore"] >= FULL_MESH_FLOOR, "mesh F-score"),
            (out["mesh_fscore_refined"] >= out["mesh_fscore"]
             - FULL_REFINE_DROP, "refine's F-score drop")):
        if not ok:
            failed.append(f"{label}: {what} misses its gate: {out}")
    return launches, dict(out, seconds=sec, peak_gib=peak,
                          launches_by_shape=shapes), failed


# phase 27: real photos, the committed JPEGs of tests/data/jpeg (phase
# 16's scene saved by tests/data/jpeg/make_fixtures.py as RGB 4:2:0 JPEGs
# at quality 95 with FocalLengthIn35mmFilm = 33.75 in APP1).  First, in
# this process: every fixture's decode in the three imread modes against
# its cv2 digest in the manifest (no cv2 here), the decode's ms per
# megapixel and resize_image's time to halve a 6000x4000 image; then, as
# a worker: mvgmvs.main on the photos as phase 16 runs it.  Its gates:
# phase 16's K, registration, k1 window and ATE, the refined rms within
# PHOTO_RMS_TOL of the JAX package's own on these JPEGs (its
# incremental_sfm + refine_with_distortion on the CPU, tests/
# test_torch_photos_jpeg.py 960 1280 jax incremental), view 0 at the
# median scale at least the JAX package's own run_pipeline_photos on the
# scene's JPEGs at 480x640 (tests/test_torch_photos_jpeg.py 480 640 jax)
# less 0.05
JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
JPEG_MODES = ("color", "gray", "unchanged")
PHOTO_JPEG_JAX_RMS = 1.168623432442342
PHOTO_JPEG_JAX_ACC = 0.7512350971745876
PHOTO_JPEG_ACC_FLOOR = PHOTO_JPEG_JAX_ACC - 0.05
RESIZE_SHAPES = ((4000, 6000), (4000, 6000, 3))


def check_jpeg_decoder() -> tuple:
    """Phase 27, its host half: the JPEG fixtures through ``io.images.
    imread`` against the manifest's cv2 digests, the decode's ms per
    megapixel (the 8 photos in color mode, median of 3 rounds) and
    ``resize_image``'s seconds to halve RESIZE_SHAPES (median of 3).
    Returns (summary, failed checks)."""
    import hashlib
    import numpy as np
    from hcmvs_tpu_torch import native
    from hcmvs_tpu_torch.io.images import imread, resize_image
    label = "photos_jpeg"
    failed = []
    t0 = time.perf_counter()
    native.library("jpeg")
    build_s = time.perf_counter() - t0
    manifest = json.loads((JPEG_DIR / "manifest.json").read_text())["files"]
    bad = []
    for name, digests in manifest.items():
        for mode in JPEG_MODES:
            img = imread(str(JPEG_DIR / name), mode)
            want = digests[mode]
            if (list(img.shape) != want["shape"] or hashlib.sha256(
                    img.tobytes()).hexdigest() != want["sha256"]):
                bad.append(f"{name} {mode}")
    if bad:
        failed.append(f"{label}: decodes differ from the manifest: {bad}")
    photos = sorted((JPEG_DIR / "photos").glob("*.jpg"))
    each = []
    for _ in range(3):
        for path in photos:
            t0 = time.perf_counter()
            img = imread(str(path), "color")
            each.append(time.perf_counter() - t0)
    ph, pw = img.shape[:2]
    ms_per_mp = float(np.median(each)) * 1e3 / (ph * pw / 1e6)
    rng = np.random.default_rng(0)
    resize_s = {}
    for shape in RESIZE_SHAPES:
        img = rng.random(shape, dtype=np.float32)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            resize_image(img, 0.5)
            times.append(time.perf_counter() - t0)
        resize_s["x".join(map(str, shape))] = float(np.median(times))
    log(f"[{label}] jpeg.cpp built in {build_s:.3f} s; {len(manifest)} "
        f"fixtures x {len(JPEG_MODES)} modes, {len(bad)} differ from "
        f"their cv2 digests; decode {ms_per_mp:.3f} ms per megapixel (the "
        f"{len(photos)} photos, {pw}x{ph} colour, median of 3 rounds); "
        f"resize_image at 0.5 {resize_s} s "
        f"(median of 3) on this host; {smi_line()}")
    return {"build_s": build_s, "fixtures": len(manifest),
            "modes": list(JPEG_MODES), "differ": bad,
            "decode_ms_per_mp": ms_per_mp, "resize_half_s": resize_s}, failed


def check_photos_jpeg(root):
    """Phase 27, its pipeline half: ``pipeline.mvgmvs.main`` on the
    committed JPEG photos as phase 16 runs it (SEQUENTIAL, distortion
    estimated, ``--no-mesh``, PHOTO_FLAGS), counts reset just before,
    read just after.  Returns (launches, JSON summary, failed checks)."""
    import numpy as np
    import torch
    from hcmvs_tpu_torch import kernels
    from hcmvs_tpu_torch.eval.pose_eval import ate, umeyama_align
    from hcmvs_tpu_torch.pipeline import mvgmvs
    from hcmvs_tpu_torch.utils import profiling
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    label = "photos_jpeg"
    failed = []
    h, w = PHOTO_HW
    # the scene's geometry (its texture is in the JPEGs)
    sc = make_ridge_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=PHOTO_VIEWS, fx=PHOTO_FX, spacing=0.25,
                          texture_fn=lambda xy: np.zeros(xy.shape[:-1],
                                                         np.float32))
    profiling.reset_report()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        out = mvgmvs.main([str(JPEG_DIR / "photos"), str(root / "out"),
                           "--flags", *PHOTO_FLAGS, "--no-mesh"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shapes = check_shapes(label, launches, shapes, failed)
    if min(launches[k] for k in EXACT_KERNELS) <= 0:
        failed.append(f"{label}: a kernel of the path never launched: "
                      f"{launches}")
    stages = _stage_lines(label, profiling.report(), SFM_STAGES)
    res = out["sfm"]
    reg, est = _centres(res)
    gt = np.stack([sc.cameras[i].C.numpy() for i in reg])
    a = ate(est, gt)
    scale = umeyama_align(est, gt)[0]
    k = [float(x) for x in out["distortion"]]
    d0 = out["depth"][0]
    med = float(np.median(sc.depth_gt[d0 > 0] / d0[d0 > 0]))
    acc_med = depth_acc_2pct(d0 * med, sc.depth_gt)
    log(f"[{label}] f = {float(out['K'][0, 0])} px from EXIF; {len(reg)} "
        f"of {PHOTO_VIEWS} registered; k = {k}; rms "
        f"{out['rms_unrefined']:.4f} -> {res.reproj_rms:.4f} px refined "
        f"(JAX on the CPU {PHOTO_JPEG_JAX_RMS:.4f}); ATE rmse "
        f"{a['rmse']:.5f} (max {a['max']:.5f}, scale {scale:.5f}); view 0 "
        f"interior "
        f"depth_acc_2pct {acc_med:.4f} at the median scale {med:.5f} "
        f"(floor {PHOTO_JPEG_ACC_FLOOR:.4f}); valid {(d0 > 0).mean():.4f}; "
        f"{len(out['cloud']['points'])} points; launches {launches}; "
        f"total {seconds:.3f} s, peak memory {peak:.2f} GiB")
    for ok, what in (
            (out["K"][0, 0] == PHOTO_FX, "K from EXIF"),
            (len(reg) == PHOTO_VIEWS, "registered views"),
            (PHOTO_K1_WINDOW[0] < k[0] < PHOTO_K1_WINDOW[1], "k1"),
            (a["rmse"] < PHOTO_ATE_MAX, "ATE"),
            (abs(res.reproj_rms - PHOTO_JPEG_JAX_RMS) <= PHOTO_RMS_TOL,
             "refined rms"),
            (acc_med >= PHOTO_JPEG_ACC_FLOOR, "view 0 accuracy")):
        if not ok:
            failed.append(f"{label}: {what} misses its gate")
    return launches, {
        "views": PHOTO_VIEWS, "h": h, "w": w, "flags": list(PHOTO_FLAGS),
        "f_px": float(out["K"][0, 0]), "registered": len(reg), "k": k,
        "rms_unrefined_px": out["rms_unrefined"], "rms_px": res.reproj_rms,
        "jax_rms_px": PHOTO_JPEG_JAX_RMS, "ate_rmse": a["rmse"],
        "ate_max": a["max"], "median_scale": med,
        "depth_acc_2pct_median_scale": acc_med,
        "median_floor": PHOTO_JPEG_ACC_FLOOR,
        "valid_frac": float((d0 > 0).mean()),
        "n_points": len(out["cloud"]["points"]), "total_s": seconds,
        "stage_s": stages, "peak_gib": peak,
        "launches_by_shape": shapes}, failed


# phases 19, 21, 24-26 and 27's pipeline run last, side by side, each in a
# process of its own: they are host-bound (the card idles most of the
# time), and one after the other they would take ~400 s of the script's
# 1,200 s.  Each
# worker resets, drives and reads its own launch counts and sends them
# back as JSON.  (Their walls are taken side by side; the operating point,
# whose attached tables take 67 GiB of the card, ends before they start.)
WORKERS = ("full_run", "golden_full_stack", "routes", "chain", "sgm",
           "golden_hierarchy", "golden_run", "photos_jpeg")
WORKER_TIMEOUT_S = 600


def _worker(kind: str, out_path: str) -> int:
    """One phase of WORKERS (``chip_smoke.py --worker KIND OUT``): writes
    its (launches, summary, failed checks) as JSON to OUT."""
    import torch
    from hcmvs_tpu_torch import kernels
    dev = torch.device("cuda", 0)
    kernels.library()
    root = Path(tempfile.mkdtemp(prefix=f"_{kind}_smoke_",
                                 dir=Path(__file__).resolve().parent))
    try:
        if kind == "sgm":
            result = check_sgm(root, dev)
        elif kind == "chain":
            result = check_chain(root)
        elif kind == "routes":
            result = check_routes()
        elif kind == "full_run":
            result = check_full_run(root)
        elif kind == "photos_jpeg":
            result = check_photos_jpeg(root)
        else:
            result = check_golden(dev, (kind[len("golden_"):],))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    Path(out_path).write_text(json.dumps(     # numpy scalars as numbers
        result, default=lambda x: x.item()))
    return 0


def run_workers(kinds=WORKERS) -> dict:
    """Runs each phase of ``kinds`` in a process of its own, all at once
    (the card's host cores shared out among them), prints each one's log
    when it ends and returns {kind: (launches, summary, failed)}; raises if
    a worker fails.  Every worker is ended before this returns."""
    import os
    tmp = Path(tempfile.mkdtemp(prefix="_workers_smoke_",
                                dir=Path(__file__).resolve().parent))
    threads = str(max(1, (os.cpu_count() or 1) // len(kinds)))
    env = dict(os.environ, OMP_NUM_THREADS=threads)
    procs = {}
    try:
        for kind in kinds:
            log_f = (tmp / f"{kind}.log").open("w")
            procs[kind] = (subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 kind, str(tmp / f"{kind}.json")], stdout=log_f,
                stderr=subprocess.STDOUT, env=env), log_f)
        results = {}
        for kind, (proc, log_f) in procs.items():
            rc = proc.wait(timeout=WORKER_TIMEOUT_S)
            log_f.close()
            print((tmp / f"{kind}.log").read_text(), end="", flush=True)
            if rc != 0:
                raise RuntimeError(f"phase worker {kind} failed ({rc})")
            results[kind] = tuple(json.loads(
                (tmp / f"{kind}.json").read_text()))
        return results
    finally:
        for proc, log_f in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def merge_paths(parts) -> tuple:
    """(launches, summary, failed) of several workers as one path: counts
    and shapes summed, summaries side by side, failures joined."""
    launches = collections.Counter()
    by_shape = {name: collections.Counter() for name in SHAPE_OF}
    summary, failed = {}, []
    for label, (l, s, f) in parts.items():
        launches.update(l)
        for name, counts in s["launches_by_shape"].items():
            by_shape[name].update(counts)
        summary[label] = s
        failed += f
    summary["launches_by_shape"] = {k: dict(v) for k, v in by_shape.items()}
    return dict(launches), summary, failed


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        return _worker(sys.argv[2], sys.argv[3])
    t_start = time.perf_counter()

    def phase_done(phases: str) -> None:
        log(f"[time] phases {phases} done at "
            f"{time.perf_counter() - t_start:.1f} s")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from hcmvs_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc})",
              file=sys.stderr)
        return 1

    # 1. device
    smi = smi_line()
    dev = torch.device("cuda", 0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build: the library and the earlier designs, side by side
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lib_paths = list(pool.map(kernels.build,
                                  (kernels.CSRC, kernels.EARLIER)))
    kernels.library()
    kernels.earlier_library()
    log(f"[build] {lib_paths[0].name} and the earlier designs of B and D "
        f"ready in {time.perf_counter() - t0:.1f} s")
    for path in lib_paths:
        for line in (path.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {path.parent.name} {line.strip()}",
                      file=sys.stderr)

    # 3. kernel parity at the paths' shapes
    sc, scene = make_scene(dev)
    cfg = slice_cfg()
    rows = kernel_parity(sc, scene, cfg, dev)
    torch.cuda.empty_cache()

    phase_done("3")
    # 4-7. the two paths, each through the kernels and the plain versions
    paths = {}
    paths["exact"] = check_path(sc, scene, cfg, dev, "exact", EXACT_KERNELS)
    torch.cuda.empty_cache()
    paths["hybrid_batched"] = check_path(
        sc, scene, cfg.replace(score_mode="hybrid", candidate_kernel="on"),
        dev, "hybrid_batched", HYBRID_KERNELS)
    del scene
    torch.cuda.empty_cache()

    phase_done("4-7")
    # 8-9. the densify path, each through the kernels and the plain versions
    root = Path(tempfile.mkdtemp(prefix="_densify_smoke_",
                                 dir=Path(__file__).resolve().parent))
    try:
        paths["densify"] = check_densify(sc, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_done("8-9")
    # 10-11. the hierarchy path, each through the kernels and the plain
    # versions
    root = Path(tempfile.mkdtemp(prefix="_hierarchy_smoke_",
                                 dir=Path(__file__).resolve().parent))
    try:
        paths["hierarchy"] = check_hierarchy(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_done("10-11")
    # 12-13. the masked densify path, each through the kernels and the
    # plain versions; 14-15. the mesh path on its dense output
    root = Path(tempfile.mkdtemp(prefix="_masks_smoke_",
                                 dir=Path(__file__).resolve().parent))
    try:
        paths["densify_masks"] = check_masks(root)
        torch.cuda.empty_cache()
        paths["mesh"] = check_mesh(root, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    phase_done("12-15")
    # 16. photos -> SfM -> dense; 17. SfM again on its photos (library
    # calls); 18. bundle adjustment at scale
    root = Path(tempfile.mkdtemp(prefix="_photos_smoke_",
                                 dir=Path(__file__).resolve().parent))
    try:
        launches, summary, failed, photo_sc = check_photos(root)
        paths["photos"] = (launches, summary, failed)
        torch.cuda.empty_cache()
        paths["sfm_again"] = check_sfm_again(root, photo_sc, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    paths["ba"] = check_ba(dev)
    torch.cuda.empty_cache()
    phase_done("16-18")
    # 20. kernels B and D on the per-plane build's 256 / 384 / 512 planes
    _, scene = make_scene(dev)
    deep_parity(scene, cfg, dev, rows)
    del scene
    torch.cuda.empty_cache()
    phase_done("20")
    # 22. the 10-neighbour operating point, streamed
    paths["operating_point"] = check_operating_point(dev)
    torch.cuda.empty_cache()
    phase_done("22")
    # 23. kernels B, D and E past the caps they once had
    _, scene = make_scene(dev)
    past_caps(scene, cfg, dev, rows)
    del scene
    torch.cuda.empty_cache()
    phase_done("23")
    # 27, its host half: the JPEG decoder against the manifest, decode and
    # resize times (before the side-by-side group, so they run alone)
    jpeg_summary, jpeg_failed = check_jpeg_decoder()
    phase_done("27 (decoder)")
    # 19. the whole chain, small; 21. the dense routes at 1280x960; 24.
    # SGM through densify; 25. the golden quality gate, three modes; 26.
    # the full product run at 1280x960; 27. the pipeline from the JPEG
    # photos: side by side
    done = run_workers()
    for kind in ("chain", "routes", "sgm", "full_run"):
        paths[kind] = done[kind]
    launches, summary, failed = done["photos_jpeg"]
    paths["photos_jpeg"] = (launches, dict(summary, decoder=jpeg_summary),
                            failed + jpeg_failed)
    paths["golden"] = merge_paths({k[len("golden_"):]: v
                                   for k, v in done.items()
                                   if k.startswith("golden_")})
    phase_done("19, 21, 24-27")
    failed = [f for _, _, fs in paths.values() for f in fs]
    if failed:
        for f in failed:
            print(f"chip_smoke: {f}", file=sys.stderr)
        return 1

    for r in rows:
        per_path = {p: launches[r["name"]]
                    for p, (launches, _, _) in paths.items()}
        r.update(route="cuda", launches=sum(per_path.values()),
                 launches_per_path=per_path)
        for x in r.get("shapes", []):     # at each shape
            x["launches_per_path"] = {
                p: summary["launches_by_shape"][r["name"]].get(
                    shape_key(x["shape"]), 0)
                for p, (_, summary, _) in paths.items()}
            x["launches"] = sum(x["launches_per_path"].values())
    log(f"[total] all phases in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shapes")
    log(json.dumps({"paths": {p: summary
                              for p, (_, summary, _) in paths.items()}}))
    log(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                for r in rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
