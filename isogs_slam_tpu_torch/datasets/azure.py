"""Azure Kinect loader (counterpart of isogs_slam_tpu/datasets/azure.py):
color/*.jpg, depth/*.png; poses from a .log (5 lines per frame) or a
flat-16-floats file, identity when absent."""
from __future__ import annotations

import glob
import os

import numpy as np

from .base import RGBDDataset, natsorted


class AzureKinectDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, odomfile=None,
                 **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = (os.path.join(self.input_folder, odomfile)
                          if odomfile else None)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(f"{self.input_folder}/color/*.jpg")),
                natsorted(glob.glob(f"{self.input_folder}/depth/*.png")))

    def load_poses(self):
        if self.pose_path is None:
            print("WARNING: Dataset does not contain poses. "
                  "Returning identity transform.")
            return [np.eye(4) for _ in range(self.num_imgs)]
        with open(self.pose_path) as f:
            lines = f.readlines()
        poses = []
        if self.pose_path.endswith(".log"):
            if len(lines) % 5 != 0:
                raise ValueError(
                    "Incorrect file format for .log odom file: number of "
                    "non-empty lines must be a multiple of 5")
            for i in range(len(lines) // 5):
                rowstr = lines[5 * i + 1: 5 * i + 5]
                poses.append(np.array(
                    [list(map(float, r.split())) for r in rowstr]))
        else:
            for line in lines:
                if not line.split():
                    continue
                poses.append(np.array(
                    list(map(float, line.split()))).reshape(4, 4))
        return poses
