"""ScanNet + AI2Thor loaders (counterpart of
isogs_slam_tpu/datasets/scannet.py)."""
from __future__ import annotations

import glob
import os

import numpy as np

from .base import RGBDDataset, natsorted


class ScannetDataset(RGBDDataset):
    """color/*.jpg, depth/*.png, pose/*.txt 4x4 per file."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        kwargs.setdefault("desired_height", 968)
        kwargs.setdefault("desired_width", 1296)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(f"{self.input_folder}/color/*.jpg")),
                natsorted(glob.glob(f"{self.input_folder}/depth/*.png")))

    def load_poses(self):
        posefiles = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(p) for p in posefiles]


class Ai2thorDataset(RGBDDataset):
    """color/*.png, depth/*.png, pose/*.txt (ai2thor.py)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(f"{self.input_folder}/color/*.png")),
                natsorted(glob.glob(f"{self.input_folder}/depth/*.png")))

    def load_poses(self):
        posefiles = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(p) for p in posefiles]
