"""Experiment config system (counterpart of isogs_slam_tpu/slam/config.py).

An experiment config is an executable Python module exposing a `config`
dict, loaded via SourceFileLoader. Missing keys get the same runtime
defaults as in the JAX package, key for key; a missing `primary_device`
means the card (slam/pipeline.py::primary_device).
"""
from __future__ import annotations

import os
import shutil
from importlib.machinery import SourceFileLoader


def load_experiment_config(path: str) -> dict:
    module = SourceFileLoader(os.path.basename(path), path).load_module()
    return module.config


def inject_defaults(config: dict) -> dict:
    """Runtime defaults (splatam.py:879-947)."""
    config = dict(config)
    tr = config.setdefault("tracking", {})
    tr.setdefault("use_depth_loss_thres", False)
    tr.setdefault("depth_loss_thres", 100000)
    tr.setdefault("visualize_tracking_loss", False)
    config.setdefault("gaussian_distribution", "isotropic")
    data = config.setdefault("data", {})
    data.setdefault("ignore_bad", False)
    data.setdefault("use_train_split", True)
    if "densification_image_height" not in data:
        data["densification_image_height"] = data.get("desired_image_height")
        data["densification_image_width"] = data.get("desired_image_width")
    if "tracking_image_height" not in data:
        data["tracking_image_height"] = data.get("desired_image_height")
        data["tracking_image_width"] = data.get("desired_image_width")
    config.setdefault("report_global_progress_every", 500)
    config.setdefault("eval_every", 5)
    config.setdefault("checkpoint_interval", 100)
    config.setdefault("save_checkpoints", False)
    config.setdefault("load_checkpoint", False)
    config.setdefault("use_wandb", False)
    # rasterizer knobs (absent in reference configs -> defaults)
    config.setdefault("raster", {})
    config["raster"].setdefault("max_per_tile", 512)
    config["raster"].setdefault("isect_per_gaussian", 4.0)
    config["raster"].setdefault("tile_chunk", 256)
    config.setdefault("capacity_granule", 65536)
    # multi-device mapping / tracking: map_views > 1 runs the view-parallel
    # mapping phase on that many ranks under torch.distributed.run
    # (parallel/), clamped to the world size (one rank without it)
    config.setdefault("parallel", {})
    config["parallel"].setdefault("map_views", 0)
    # mapping loss weight defaults for the IsoGS terms (splatam.py:733-739)
    mw = config.get("mapping", {}).get("loss_weights", {})
    mw.setdefault("flat", 50.0)
    mw.setdefault("iso", 2.0)
    return config


def copy_config_for_provenance(config_path: str, results_dir: str):
    os.makedirs(results_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(results_dir, "config.py"))
