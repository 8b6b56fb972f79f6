"""Scene, depth-map, mesh and image I/O of the port: the names
``hcmvs_tpu.io`` exports, from the port's own numpy copies."""

from hcmvs_tpu_torch.io.dmap import DepthMapData, read_dmap, write_dmap
from hcmvs_tpu_torch.io.mvs import SceneMVS, read_mvs, write_mvs
from hcmvs_tpu_torch.io.nvm import read_nvm, write_nvm
from hcmvs_tpu_torch.io.obj import ObjMesh, read_obj, write_obj
from hcmvs_tpu_torch.io.openmvg import read_openmvg_json, write_openmvg_json
from hcmvs_tpu_torch.io.photoscan import (read_photoscan_xml,
                                          write_photoscan_xml)
