"""Full-resolution fast-mode validation config (680x1200).

A copy of isogs_slam_tpu/configs/synthetic/full_res_fast.py on this
package's full_res.py: the same SLAM run with the opt-in tile-subset paths
on (mapping.tile_subsample and tracking.tile_subsample). Compare its
eval_summary.json against the exact full_res run: this is the quality
side of the speed / quality trade.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/full_res_fast.py --end-at 30
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_full_res_base",
    os.path.join(os.path.dirname(__file__), "full_res.py")).load_module()

scene_name = "synthetic_room_fullres_fast"
seed = 0

config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
config["mapping"]["tile_subsample"] = 4
config["tracking"]["tile_subsample"] = 4
