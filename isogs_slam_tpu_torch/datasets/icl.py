"""ICL-NUIM loader (counterpart of isogs_slam_tpu/datasets/icl.py): rgb /
depth pngs and a *.gt.sim pose file of 3 rows per frame."""
from __future__ import annotations

import glob
import os

import numpy as np

from .base import RGBDDataset, natsorted


class ICLDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        sims = glob.glob(os.path.join(self.input_folder, "*.gt.sim"))
        if not sims:
            raise ValueError("Need pose file ending in extension `*.gt.sim`")
        self.pose_path = sims[0]
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(f"{self.input_folder}/rgb/*.png")),
                natsorted(glob.glob(f"{self.input_folder}/depth/*.png")))

    def load_poses(self):
        rows = []
        with open(self.pose_path) as f:
            for line in f:
                t = line.strip().split()
                if t:
                    rows.append([float(x) for x in t[:4]])
        rows = np.asarray(rows)
        poses = []
        for i in range(0, rows.shape[0], 3):
            # reference quirk preserved: corner set to 3 then the pose is
            # normalized relative to frame 0 anyway (icl.py:70-80)
            p = np.zeros((4, 4))
            p[3, 3] = 3
            p[0] = rows[i]
            p[1] = rows[i + 1]
            p[2] = rows[i + 2]
            poses.append(p)
        return poses
