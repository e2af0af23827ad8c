"""YAML camera-config loader with inherit_from chaining (counterpart of
isogs_slam_tpu/datasets/dataconfig.py). PyYAML is imported at first use."""
from __future__ import annotations


def load_dataset_config(path: str, default_path: str | None = None) -> dict:
    import yaml
    with open(path) as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_dataset_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path) as f:
            cfg = yaml.full_load(f)
    else:
        cfg = {}

    _update_recursive(cfg, cfg_special)
    return cfg


def _update_recursive(dict1: dict, dict2: dict):
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            _update_recursive(dict1[k], v)
        else:
            dict1[k] = v
