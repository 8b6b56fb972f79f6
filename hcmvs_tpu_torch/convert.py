"""Conversions from the JAX package's arrays to the port's tensors.

Each function takes an object with the fields of the JAX package's
container (``SceneTensors``, ``SceneState``, ``ViewGeometry``,
``VolumeTables``, ``RectContext``, ``Keypoints``, ``BAProblem``,
``BAState``, ``SfMResult``) and reads every array through
``np.asarray``, so this module needs no JAX.  The tests use them to run
both packages on identical scenes, states, tables and rect contexts.
Like the port's other entry points they put the tensors on the card
unless the caller asks for another device (the CPU tests pass
``device="cpu"``); without a card torch's own error is raised.
"""

from __future__ import annotations

import numpy as np
import torch

from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.dense.scene_driver import SceneState, SceneTensors
from hcmvs_tpu_torch.dense.types import ViewGeometry
from hcmvs_tpu_torch.ops.rect_gather import RectContext
from hcmvs_tpu_torch.ops.volume import VolumeTables
from hcmvs_tpu_torch.sfm.ba import BAProblem, BAState
from hcmvs_tpu_torch.sfm.features import Keypoints
from hcmvs_tpu_torch.sfm.incremental import SfMResult


def _t(x, device, dtype=None) -> torch.Tensor:
    arr = np.array(np.asarray(x))          # writable copy
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.uint16).to(device)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def scene_from_numpy(scene, device="cuda") -> SceneTensors:
    """The JAX ``SceneTensors``: cameras, neighbours, depth ranges, and the
    seed depths, flows, cross-scale maps (prior, injected depth and
    normals), external prior maps and semantic labels when present (no
    tables)."""
    cams = Camera(K=_t(scene.cams.K, device, torch.float32),
                  R=_t(scene.cams.R, device, torch.float32),
                  C=_t(scene.cams.C, device, torch.float32))

    def opt(x):
        return None if x is None else _t(x, device, torch.float32)

    return SceneTensors(
        gray=_t(scene.gray, device, torch.float32), cams=cams,
        nbr_idx=_t(scene.nbr_idx, device, torch.int64),
        nbr_valid=_t(scene.nbr_valid, device, torch.bool),
        d_min=_t(scene.d_min, device, torch.float32),
        d_max=_t(scene.d_max, device, torch.float32),
        seed_depth=opt(scene.seed_depth), flows=opt(scene.flows),
        prior_depth=opt(scene.prior_depth),
        ext_prior_depth=opt(scene.ext_prior_depth),
        semantic=(None if scene.semantic is None
                  else _t(scene.semantic, device, torch.int64)),
        inject_depth=opt(scene.inject_depth),
        inject_normal=opt(scene.inject_normal))


def state_from_numpy(state, device="cuda") -> SceneState:
    """The JAX ``SceneState`` (its PRNG keys are dropped)."""
    return SceneState(depth=_t(state.depth, device, torch.float32),
                      normal=_t(state.normal, device, torch.float32),
                      cost=_t(state.cost, device, torch.float32))


def geometry_from_numpy(geom, device="cuda") -> ViewGeometry:
    """The JAX ``ViewGeometry``."""
    return ViewGeometry(**{f: _t(getattr(geom, f), device, torch.float32)
                           for f in ViewGeometry.__dataclass_fields__})


def tables_from_numpy(vol, device="cuda") -> VolumeTables:
    """The JAX ``VolumeTables`` (u16 tables, any leading dims)."""
    return VolumeTables(tab=_t(vol.tab, device),
                        sig0=_t(vol.sig0, device, torch.float32),
                        inv_dsig=_t(vol.inv_dsig, device, torch.float32),
                        sig_lo=_t(vol.sig_lo, device, torch.float32),
                        sig_hi=_t(vol.sig_hi, device, torch.float32))


def rect_context_from_numpy(ctx, device="cuda") -> RectContext:
    """The JAX ``RectContext``; its (V, C, n_rh, n_ch, 8, 256) blocked
    maps become (V, C, H_r, W_r)."""
    maps = np.asarray(ctx.maps)
    v, c, n_rh, n_ch, rh, cw = maps.shape
    maps = np.moveaxis(maps, 4, 3).reshape(v, c, n_rh * rh, n_ch * cw)
    return RectContext(maps=_t(maps, device, torch.float32).contiguous(),
                       row_int=_t(ctx.row_int, device, torch.int32),
                       c0=_t(ctx.c0, device, torch.float32),
                       k=_t(ctx.k, device, torch.float32),
                       rb=_t(ctx.rb, device, torch.int32))


def keypoints_from_numpy(kps, device="cuda") -> Keypoints:
    """The JAX ``Keypoints`` (xy, score, scale, angle, desc)."""
    return Keypoints(*(_t(getattr(kps, f), device, torch.float32)
                       for f in Keypoints._fields))


def ba_problem_from_numpy(problem, device="cuda") -> BAProblem:
    """The JAX ``BAProblem`` (observations already sorted by point)."""
    return BAProblem(
        K=_t(problem.K, device, torch.float32),
        obs_cam=_t(problem.obs_cam, device, torch.int64),
        obs_pt=_t(problem.obs_pt, device, torch.int64),
        obs_uv=_t(problem.obs_uv, device, torch.float32),
        obs_valid=_t(problem.obs_valid, device, torch.bool),
        fixed_cams=_t(problem.fixed_cams, device, torch.bool),
        dist=_t(problem.dist, device, torch.float32))


def ba_state_from_numpy(state, device="cuda") -> BAState:
    """The JAX ``BAState`` (rvecs, tvecs, points)."""
    return BAState(*(_t(getattr(state, f), device, torch.float32)
                     for f in BAState._fields))


def sfm_result_from_numpy(result) -> SfMResult:
    """The JAX ``SfMResult`` with its arrays as numpy (an SfM result lives
    on the host in both packages)."""
    return SfMResult(
        poses={int(i): (np.array(np.asarray(R)), np.array(np.asarray(C)))
               for i, (R, C) in result.poses.items()},
        points=np.array(np.asarray(result.points)),
        track_obs=[[(int(i), int(k)) for i, k in obs]
                   for obs in result.track_obs],
        keypoints=[np.array(np.asarray(x)) for x in result.keypoints],
        reproj_rms=float(result.reproj_rms))
