"""See the package docstring of hcmvs_tpu_torch."""
from hcmvs_tpu_torch.dense.types import (PatchMatchState, ViewGeometry,
                                         make_view_geometry)
from hcmvs_tpu_torch.dense.patchmatch import estimate_depth_map
