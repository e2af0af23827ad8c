"""Toy-size fast configuration for CPU smoke runs: smoke.py with the levers
of full_res_fastlegal.py (tile-subset tracking, stripe mapping with an
exact tail).

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/smoke_fast.py --end-at 4 \
         --device cpu
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_smoke_base",
    os.path.join(os.path.dirname(__file__), "smoke.py")).load_module()

scene_name = "synthetic_room_fast"
seed = 0
config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
config["tracking"]["tile_subsample"] = 2
config["mapping"]["tile_subsample"] = 2
config["mapping"]["exact_polish_iters"] = 2
