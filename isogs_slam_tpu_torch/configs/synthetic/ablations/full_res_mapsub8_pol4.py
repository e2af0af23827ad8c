"""Ablation full_res_mapsub8_pol4 on this package's full_res.py: the keys and
values of
isogs_slam_tpu/configs/synthetic/ablations/full_res_mapsub8_pol4.py (its
docstring gives the rationale); primary_device "cuda" comes in through the
base config.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/ablations/full_res_mapsub8_pol4.py \
         --end-at 30
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_full_res_base",
    os.path.join(os.path.dirname(__file__), "..", "full_res.py")
).load_module()

scene_name = "synthetic_room_fullres_mapsub8pol4"
seed = 0
config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
config["mapping"]["tile_subsample"] = 8
config["mapping"]["exact_polish_iters"] = 4
