"""Files found by name: benchmark/<folder>/<name>.py, loaded on use.

Per-layer metrics (metrics/), camera motions (motion/) and depth sensor
models (sensor/) each live in a file of their own, so that a later cell or
metric adds a file and edits none."""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(folder: str, name: str):
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no {folder}/{name}.py under benchmark/")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
