"""The fast configuration on the synthetic room (680x1200): the levers of
configs/replica/splatam_fast.py, after
isogs_slam_tpu/configs/synthetic/ablations/full_res_fastlegal.py:

  tracking.tile_subsample = 4      every 4th tile in the tracking loss
  mapping.tile_subsample = 4       stripe-cycled mapping
  mapping.exact_polish_iters = 4   an exact tail re-anchors the map
  raster.adaptive_max_per_tile     the per-tile cap escalates

under the silhouette-normalised tracking render.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/full_res_fastlegal.py \
         --end-at 30
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_full_res_base",
    os.path.join(os.path.dirname(__file__), "full_res.py")).load_module()

scene_name = "synthetic_room_fullres_fastlegal"
seed = 0
config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
config["tracking"]["tile_subsample"] = 4
config["tracking"]["sil_norm_render"] = True
config["mapping"]["tile_subsample"] = 4
config["mapping"]["exact_polish_iters"] = 4
config["raster"]["adaptive_max_per_tile"] = True
