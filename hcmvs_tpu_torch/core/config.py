"""Dense-reconstruction configuration (PyTorch port).

The same frozen dataclass as ``hcmvs_tpu/core/config.py``: every field,
every default, the same ``replace``.  It is a copy and not an import,
because importing ``hcmvs_tpu.core`` pulls in JAX.  A test holds the two
classes field for field.

Routing (the accelerator knobs below): the port's "auto" means the sigma
tables, the rect-frame build and the rect engine on every device (kernels
on CUDA, plain versions on the CPU); the direct paths, the per-plane build
and streaming are taken when the config names them, as in the JAX package.
``batch_candidates`` scores every propagation candidate in one cost call
on the candidate stack, as the JAX package's vmapped path does;
``volume_planes`` is taken as the JAX package takes it (max(volume_planes
// 128, 1) chunks of 128 planes); nothing is silently rerouted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    # --- resolution / view selection (ref: DepthMap.cpp:70-86) -------------
    resolution_level: int = 1
    max_resolution: int = 3200
    min_resolution: int = 640
    min_views: int = 2
    max_views: int = 12
    min_views_fuse: int = 2
    min_views_filter: int = 2
    min_views_filter_adjust: int = 1
    min_views_trust_point: int = 2
    num_views: int = 10
    filter_adjust: bool = True
    add_corners: bool = True
    view_min_score: float = 0.0
    view_min_score_ratio: float = 0.3
    min_angle: float = 3.0
    optim_angle: float = 10.0
    max_angle: float = 65.0
    min_area: float = 0.01

    # --- patch matching core (ref: DepthMap.cpp:120-134) -------------------
    patch_half_window: int = 5
    patch_step: int = 2
    adapt_half_window: int = 7
    propagate_half_window: int = 5
    propagate_step: int = 4
    estimation_iters: int = 3
    estimation_iters_external: int = 4
    random_iters: int = 6
    random_max_scale: int = 2
    random_depth_ratio: float = 0.003
    random_angle1_range: float = 16.0
    random_angle2_range: float = 10.0
    random_smooth_depth: float = 0.02
    random_smooth_normal: float = 13.0
    random_smooth_bonus: float = 0.93
    ncc_threshold_keep: float = 0.55
    min_patch_variance: float = 0.01
    depth_diff_threshold: float = 0.01
    normal_diff_threshold: float = 25.

    # --- HC-MVS cost-term schedule (ref: DepthMap.cpp:96-117) --------------
    photo2geo: int = 1
    use_geo_consistency: int = 1
    use_part_consistency: int = 0
    use_optical_flow: int = 1
    view_spread: int = 0               # 1: neighbours' hypotheses join
                                       # the propagation candidates
                                       # (score.view_spread_candidates)
    init_triangulate: int = 0
    tx_threshold: float = 150.0
    tx_threshold2: float = 175.0
    para_part: float = 0.1
    para_part2: float = 0.05
    para_tapa: float = 0.26
    para_tapa2: float = 0.26
    para_prior: float = 0.4
    photometric_flow: float = 0.26
    maxgeo_proportion: float = 5.0
    sigma_texture: float = 0.05
    sigma_prior: float = 0.2

    # --- priors (ref: DepthMap.cpp:135-141) --------------------------------
    use_semantic: bool = False
    self_priors: int = 0
    semantic_consistency_mul: float = 0.1
    ransac_probability: float = 0.005
    ransac_epsilon_mul: float = 1.4
    ransac_cluster_mul: float = 7.0
    ransac_min_points_div: float = 40.

    # --- filtering / fusion (ref: DepthMap.cpp:101,142-143) ---------------
    optimize: int = 1
    speckle_size: int = 100
    ipol_gap_size: int = 7
    depth_weight: float = 1.0
    normal_weight: float = 1.0
    estimate_colors: int = 2
    estimate_normals: int = 2

    # --- accelerator knobs (see hcmvs_tpu/core/config.py for each) --------
    explore_patch_step: int = 4        # coarse patch sampling in every
                                       # external iteration but the last
    explore_until_last: bool = True    # ... and in all but the last inner
                                       # sweep of the final one
    cross_scale_inject: int = 1
    cross_scale_prior: int = 1
    geo_max_neighbors: int = 4
    agg_top_k: int = 0
    use_pallas: bool = True            # False: "auto" backends and
                                       # builds resolve to the direct
                                       # paths and the per-plane build
    sweep_mode: str = "jacobi"         # "jacobi" | "redblack"
    batch_candidates: bool = False     # every propagation candidate in
                                       # one cost call on the (K, H, W)
                                       # stack (B, C, E launched as for
                                       # one candidate)
    score_mode: str = "exact"          # "exact" | "warped" | "hybrid"
    exact_backend: str = "auto"        # "auto"/"volume": sigma tables on
                                       # every device (kernels B / D);
                                       # "bilinear": direct bilinear ZNCC,
                                       # one sample per view and offset
    geo_backend: str = "auto"          # "auto"/"rect": rect engine on every
                                       # device (kernel C); "direct":
                                       # nearest gathers of the maps
    volume_planes: int = 128           # sigma planes, in chunks of 128
                                       # (max(volume_planes // 128, 1));
                                       # above 128 the tables are built
                                       # plane by plane; past 1024 batched
                                       # scoring takes f32 index fields
    candidate_kernel: str = "auto"     # "on": batched candidate scoring
                                       # (kernel D); "auto" is off
    refine_batched: bool = False
    window_ref_width: int = 0
    volume_streaming: bool = False     # build view i's tables inside its
                                       # sweep, dropped before view i + 1:
                                       # one view's tables live at a time
                                       # (the 10-neighbour operating point)
    volume_build: str = "auto"         # "auto"/"rect": rect-frame build
                                       # (kernel A, tile-major rows) on
                                       # every device; "planes": per-plane
                                       # bilinear warps + Catmull-Rom
                                       # (image-order rows)

    @property
    def num_patch_samples(self) -> int:
        """Sample count along one patch axis."""
        return self.patch_half_window * 2 // self.patch_step + 1

    def replace(self, **kw) -> "DenseConfig":
        return dataclasses.replace(self, **kw)


def window_cfg_for_width(cfg: DenseConfig, w: int) -> DenseConfig:
    """Resolution-aware patch windows (see ``window_ref_width``): double
    the adapt/patch window and step for images >= 2x the reference
    width."""
    if not cfg.window_ref_width or w < 2 * cfg.window_ref_width:
        return cfg
    return cfg.replace(
        adapt_half_window=cfg.adapt_half_window * 2,
        patch_half_window=cfg.patch_half_window * 2,
        patch_step=cfg.patch_step * 2)


# CLI flag name -> field name, for parity with the reference's run.py layer
# (ref: apps/DensifyPointCloud/DensifyPointCloud.cpp:140-199).
CLI_FLAG_MAP = {
    "resolution-level": "resolution_level",
    "max-resolution": "max_resolution",
    "min-resolution": "min_resolution",
    "number-views": "num_views",
    "number-views-fuse": "min_views_fuse",
    "n-EstimationIters": "estimation_iters",
    "n-EstimationIters-external": "estimation_iters_external",
    "n-photo2geo": "photo2geo",
    "n-viewspread": "view_spread",
    "n-opticalflow": "use_optical_flow",
    "n-initTriangulate": "init_triangulate",
    "n-photometric_flow": "photometric_flow",
    "n-nOptimize": "optimize",
    "n-usepartconsistency": "use_part_consistency",
    "n-usegeoconsistency": "use_geo_consistency",
    "use-semantic": "use_semantic",
    "n-maxgeo_proportion": "maxgeo_proportion",
    "n-txthreshold": "tx_threshold",
    "n-txthreshold2": "tx_threshold2",
    "n-para_part": "para_part",
    "n-para_part2": "para_part2",
    "n-para_tapa": "para_tapa",
    "n-para_tapa2": "para_tapa2",
    "n-para_prior": "para_prior",
    "n-adapthalfwin": "adapt_half_window",
    "n-propagatehalfwin": "propagate_half_window",
    "n-propagatestep": "propagate_step",
    "ransac-probability": "ransac_probability",
    "ransac-epsilon": "ransac_epsilon_mul",
    "ransac-cluster": "ransac_cluster_mul",
    "ransac-min-points": "ransac_min_points_div",
    "estimate-normals": "estimate_normals",
}


def config_from_cli_flags(flags: dict, base: Optional[DenseConfig] = None
                          ) -> DenseConfig:
    """Build a DenseConfig from reference-style CLI flags.

    ``flags`` maps flag names (without leading dashes, e.g. from parsing a
    reference ``run.py``) to string/number values.
    """
    cfg = base or DenseConfig()
    fields = {f.name: f.type for f in dataclasses.fields(DenseConfig)}
    updates = {}
    for flag, value in flags.items():
        name = CLI_FLAG_MAP.get(flag)
        if name is None:
            continue
        ftype = fields[name]
        if ftype in ("int", int):
            updates[name] = int(value)
        elif ftype in ("float", float):
            updates[name] = float(value)
        elif ftype in ("bool", bool):
            updates[name] = bool(int(value))
        else:
            updates[name] = value
    return cfg.replace(**updates)
