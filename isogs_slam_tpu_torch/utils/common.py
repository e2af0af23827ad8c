"""Seeding and small host utilities (counterpart of
isogs_slam_tpu/utils/common.py)."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42):
    """Seed python, numpy's module-level generator and torch (CPU and, when
    present, CUDA). The SLAM object draws from its own RandomState and
    torch.Generator, both made from the config's seed; this covers library
    code that uses the global generators."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"Seed set to: {seed}")


def params2cpu(params: dict) -> dict:
    """{name: tensor on any device} -> {name: numpy array on the host}."""
    return {k: torch.as_tensor(v).detach().cpu().numpy()
            for k, v in params.items()}
