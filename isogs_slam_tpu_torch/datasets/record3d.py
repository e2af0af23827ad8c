"""Record3D + Realsense loaders (counterpart of
isogs_slam_tpu/datasets/record3d.py): per-frame .npy c2w poses conjugated
by P = diag(1,-1,-1,1) (ARKit/OpenGL -> OpenCV camera convention)."""
from __future__ import annotations

import glob
import os

import numpy as np

from .base import RGBDDataset, natsorted

P_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _npy_poses(pose_dir: str):
    posefiles = natsorted(glob.glob(os.path.join(pose_dir, "*.npy")))
    return [P_FLIP @ np.load(p) @ P_FLIP.T for p in posefiles]


class Record3DDataset(RGBDDataset):
    """rgb/*.png + depth/*.png + poses/*.npy (save_record3d_stream layout)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_dir = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(
                    os.path.join(self.input_folder, "rgb", "*.png"))),
                natsorted(glob.glob(
                    os.path.join(self.input_folder, "depth", "*.png"))))

    def load_poses(self):
        return _npy_poses(self.pose_dir)


class RealsenseDataset(RGBDDataset):
    """rgb/*.jpg + depth/*.png + poses/*.npy."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_dir = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (natsorted(glob.glob(
                    os.path.join(self.input_folder, "rgb", "*.jpg"))),
                natsorted(glob.glob(
                    os.path.join(self.input_folder, "depth", "*.png"))))

    def load_poses(self):
        return _npy_poses(self.pose_dir)
