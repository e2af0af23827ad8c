"""Ablation full_res_track_coarse on this package's full_res.py: the keys and
values of
isogs_slam_tpu/configs/synthetic/ablations/full_res_track_coarse.py (its
docstring gives the rationale); primary_device "cuda" comes in through the
base config.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/ablations/full_res_track_coarse.py \
         --end-at 30
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_full_res_base",
    os.path.join(os.path.dirname(__file__), "..", "full_res.py")
).load_module()

scene_name = "synthetic_room_fullres_trackcoarse"
seed = 0
config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
t = config["tracking"]
t["num_iters"] = 10
t["pyramid_levels"] = 2
t["pyramid_iters"] = 40
t["pyramid_lr_scale"] = 1.5
t["tile_subsample"] = 4
