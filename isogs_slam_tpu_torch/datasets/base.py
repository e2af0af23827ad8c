"""Dataset base class: RGB-D sequence loading and preprocessing
(counterpart of isogs_slam_tpu/datasets/base.py).

`ds[i]` returns (color [H,W,3] float 0..255, depth [H,W,1] float meters,
intrinsics [4,4], c2w pose [4,4]) as numpy arrays; color is
bilinear-resized, depth nearest-resized then divided by png_depth_scale,
intrinsics scaled by the resize ratios, and poses normalized relative to
the first frame. Host-side numpy; PIL (and cv2 for distorted cameras) is
imported at first use.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from ..io.images import imread as _imread


def natsorted(paths):
    """Natural sort (natsort replacement): numeric chunks compare as ints."""
    def key(s):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", os.fspath(s))]
    return sorted(paths, key=key)


def as_intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def relative_transformation(t0: np.ndarray, t: np.ndarray) -> np.ndarray:
    """inv(t0) @ t — pose normalization to the first frame
    (geometryutils.relative_transformation via basedataset.py:259-277)."""
    return np.linalg.inv(t0) @ t


class RGBDDataset:
    """Base sequence dataset. Subclasses implement get_filepaths() and
    load_poses()."""

    def __init__(self, config_dict: dict, stride: Optional[int] = 1,
                 start: int = 0, end: int = -1,
                 desired_height: int = 480, desired_width: int = 640,
                 relative_pose: bool = True, **kwargs):
        cp = config_dict["camera_params"]
        self.name = config_dict.get("dataset_name", "unknown")
        self.png_depth_scale = float(cp["png_depth_scale"])
        self.orig_height = int(cp["image_height"])
        self.orig_width = int(cp["image_width"])
        self.fx, self.fy = float(cp["fx"]), float(cp["fy"])
        self.cx, self.cy = float(cp["cx"]), float(cp["cy"])
        self.distortion = np.array(cp["distortion"]) \
            if cp.get("distortion") is not None else None
        self.crop_edge = cp.get("crop_edge", None)

        self.desired_height = desired_height
        self.desired_width = desired_width
        self.h_ratio = desired_height / self.orig_height
        self.w_ratio = desired_width / self.orig_width
        self.relative_pose = relative_pose

        stride = stride or 1
        self.color_paths, self.depth_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("color/depth count mismatch")
        self.num_imgs = len(self.color_paths)
        poses = self.load_poses()

        if end == -1:
            end = self.num_imgs
        self.color_paths = self.color_paths[start:end:stride]
        self.depth_paths = self.depth_paths[start:end:stride]
        poses = poses[start:end:stride]
        self.num_imgs = len(self.color_paths)

        poses = np.stack(poses).astype(np.float64)
        if self.relative_pose and len(poses):
            poses = np.stack([relative_transformation(poses[0], p)
                              for p in poses])
        self.transformed_poses = poses.astype(np.float32)

    def __len__(self):
        return self.num_imgs

    def get_filepaths(self):
        raise NotImplementedError

    def load_poses(self) -> List[np.ndarray]:
        raise NotImplementedError

    # -- preprocessing --------------------------------------------------
    def _resize_color(self, color: np.ndarray) -> np.ndarray:
        from PIL import Image
        img = Image.fromarray(color.astype(np.uint8))
        img = img.resize((self.desired_width, self.desired_height),
                         Image.BILINEAR)
        return np.asarray(img, dtype=np.float32)

    def _resize_depth(self, depth: np.ndarray) -> np.ndarray:
        from PIL import Image
        img = Image.fromarray(depth.astype(np.float32), mode="F")
        img = img.resize((self.desired_width, self.desired_height),
                         Image.NEAREST)
        return np.asarray(img, dtype=np.float32)

    def _read_depth(self, path: str) -> np.ndarray:
        return np.asarray(_imread(path), dtype=np.int64).astype(
            np.float32)

    def get_cam_K(self) -> np.ndarray:
        return as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)

    def __getitem__(self, index: int):
        color = np.asarray(_imread(self.color_paths[index]),
                           dtype=np.float32)
        if color.ndim == 3 and color.shape[2] == 4:
            color = color[:, :, :3]
        if self.distortion is not None:
            # undistortion applies to color only, not depth
            # (basedataset.py:308-310)
            import cv2
            color = cv2.undistort(color, self.get_cam_K(), self.distortion)
        color = self._resize_color(color)
        depth = self._read_depth(self.depth_paths[index])
        depth = self._resize_depth(depth)[:, :, None] / self.png_depth_scale

        K = self.get_cam_K().copy()
        K[0] *= self.w_ratio
        K[1] *= self.h_ratio
        intrinsics = np.eye(4, dtype=np.float32)
        intrinsics[:3, :3] = K
        pose = self.transformed_poses[index]
        return (color, depth, intrinsics, pose)
