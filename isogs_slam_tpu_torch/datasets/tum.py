"""TUM RGB-D loader (counterpart of isogs_slam_tpu/datasets/tum.py):
timestamp association of the rgb / depth / groundtruth lists, frame-rate
thinning and quaternion poses."""
from __future__ import annotations

import os

import numpy as np

from .base import RGBDDataset


def quat_pose_to_matrix(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 c2w (scipy Rotation.from_quat order)."""
    tx, ty, tz, qx, qy, qz, qw = pvec
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = [tx, ty, tz]
    return pose


class TUMDataset(RGBDDataset):
    FRAME_RATE = 32

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        kwargs.setdefault("desired_height", 480)
        kwargs.setdefault("desired_width", 640)
        super().__init__(config_dict, **kwargs)

    def _parse_list(self, filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    def _associate(self, t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if (abs(t_depth[j] - t) < max_dt
                    and abs(t_pose[k] - t) < max_dt):
                assoc.append((i, j, k))
        return assoc

    def _load_associations(self):
        if hasattr(self, "_assoc_cache"):
            return self._assoc_cache
        folder = self.input_folder
        if os.path.isfile(os.path.join(folder, "groundtruth.txt")):
            pose_list = os.path.join(folder, "groundtruth.txt")
        else:
            pose_list = os.path.join(folder, "pose.txt")
        image_data = self._parse_list(os.path.join(folder, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(folder, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        # frame-rate thinning (tum.py:100-106)
        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / self.FRAME_RATE:
                indices.append(i)

        colors, depths, poses = [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            colors.append(os.path.join(folder, str(image_data[i, 1])))
            depths.append(os.path.join(folder, str(depth_data[j, 1])))
            poses.append(quat_pose_to_matrix(pose_vecs[k]))
        self._assoc_cache = (colors, depths, poses)
        return self._assoc_cache

    def get_filepaths(self):
        colors, depths, _ = self._load_associations()
        return colors, depths

    def load_poses(self):
        return self._load_associations()[2]
