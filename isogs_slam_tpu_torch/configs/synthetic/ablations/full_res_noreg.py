"""Ablation full_res_noreg on this package's full_res.py: the keys and values
of isogs_slam_tpu/configs/synthetic/ablations/full_res_noreg.py (its
docstring gives the rationale); primary_device "cuda" comes in through the
base config.

Run: python -m isogs_slam_tpu_torch.scripts.splatam \
         isogs_slam_tpu_torch/configs/synthetic/ablations/full_res_noreg.py \
         --end-at 30
"""
import copy
import os
from importlib.machinery import SourceFileLoader

_base = SourceFileLoader(
    "_full_res_base",
    os.path.join(os.path.dirname(__file__), "..", "full_res.py")
).load_module()

scene_name = "synthetic_room_fullres_noreg"
seed = 0
config = copy.deepcopy(_base.config)
config["run_name"] = f"{scene_name}_{seed}"
config["data"]["sequence"] = scene_name
config["mapping"]["loss_weights"] = dict(im=0.5, depth=1.0, flat=0.0,
                                         iso=0.0)
config["tracking"]["sil_thres"] = 0.99
config["tracking"]["sil_norm_render"] = False
