"""NeRFCapture + ScanNet++ loaders (counterpart of
isogs_slam_tpu/datasets/nerfcapture.py): NeRFStudio-style transforms.json
metadata with P = diag(1,-1,-1,1) pose conjugation."""
from __future__ import annotations

import json
import os

import numpy as np

from .base import RGBDDataset, natsorted
from .record3d import P_FLIP


def create_filepath_index_mapping(frames):
    return {frame["file_path"]: idx for idx, frame in enumerate(frames)}


class NeRFCaptureDataset(RGBDDataset):
    def __init__(self, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        with open(f"{self.input_folder}/transforms.json") as f:
            self.cams_metadata = json.load(f)
        self.frames_metadata = self.cams_metadata["frames"]
        self.filepath_index_mapping = create_filepath_index_mapping(
            self.frames_metadata)
        self.image_names = [
            f"rgb/{n}" for n in natsorted(
                os.listdir(f"{self.input_folder}/rgb"))]
        config_dict = {
            "dataset_name": "nerfcapture",
            "camera_params": {
                "png_depth_scale": 6553.5,
                "image_height": self.cams_metadata["h"],
                "image_width": self.cams_metadata["w"],
                "fx": self.cams_metadata["fl_x"],
                "fy": self.cams_metadata["fl_y"],
                "cx": self.cams_metadata["cx"],
                "cy": self.cams_metadata["cy"],
                "distortion": None,
            },
        }
        kwargs.setdefault("desired_height", 1440)
        kwargs.setdefault("desired_width", 1920)
        kwargs.pop("use_train_split", None)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        colors, depths, self.tmp_poses = [], [], []
        for image_name in self.image_names:
            fm = self.frames_metadata[
                self.filepath_index_mapping.get(image_name)]
            colors.append(f"{self.input_folder}/{image_name}")
            depths.append(
                f"{self.input_folder}/{image_name.replace('rgb', 'depth')}")
            c2w = np.array(fm["transform_matrix"], np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        return colors, depths

    def load_poses(self):
        return self.tmp_poses


class ScannetPPDataset(RGBDDataset):
    """ScanNet++ DSLR: undistorted images/depths with the
    train_test_lists.json split; NVS mode prepends the first train frame
    (scannetpp.py:18-141)."""

    def __init__(self, basedir, sequence, ignore_bad: bool = False,
                 use_train_split: bool = True, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.ignore_bad = ignore_bad
        self.use_train_split = use_train_split
        with open(f"{self.input_folder}/dslr/train_test_lists.json") as f:
            self.train_test_split = json.load(f)
        if use_train_split:
            self.image_names = self.train_test_split["train"]
        else:
            self.image_names = self.train_test_split["test"]
            self.train_image_names = self.train_test_split["train"]
        with open(f"{self.input_folder}/dslr/nerfstudio/"
                  f"transforms_undistorted.json") as f:
            self.cams_metadata = json.load(f)
        if use_train_split:
            self.frames_metadata = self.cams_metadata["frames"]
        else:
            self.frames_metadata = self.cams_metadata["test_frames"]
            self.train_frames_metadata = self.cams_metadata["frames"]
        self.filepath_index_mapping = create_filepath_index_mapping(
            self.frames_metadata)
        if not use_train_split:
            self.train_filepath_index_mapping = \
                create_filepath_index_mapping(self.train_frames_metadata)

        config_dict = {
            "dataset_name": "scannetpp",
            "camera_params": {
                "png_depth_scale": 1000.0,
                "image_height": self.cams_metadata["h"],
                "image_width": self.cams_metadata["w"],
                "fx": self.cams_metadata["fl_x"],
                "fy": self.cams_metadata["fl_y"],
                "cx": self.cams_metadata["cx"],
                "cy": self.cams_metadata["cy"],
                "distortion": None,
            },
        }
        kwargs.setdefault("desired_height", 1168)
        kwargs.setdefault("desired_width", 1752)
        kwargs.pop("use_train_split", None)
        kwargs.pop("ignore_bad", None)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        base = f"{self.input_folder}/dslr"
        colors, depths, self.tmp_poses = [], [], []
        if not self.use_train_split:
            first = self.train_image_names[0]
            fm = self.train_frames_metadata[
                self.train_filepath_index_mapping.get(first)]
            colors.append(f"{base}/undistorted_images/{first}")
            depths.append(f"{base}/undistorted_depths/"
                          f"{first.replace('.JPG', '.png')}")
            c2w = np.array(fm["transform_matrix"], np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        for image_name in self.image_names:
            fm = self.frames_metadata[
                self.filepath_index_mapping.get(image_name)]
            if self.ignore_bad and fm.get("is_bad", False):
                continue
            colors.append(f"{base}/undistorted_images/{image_name}")
            depths.append(f"{base}/undistorted_depths/"
                          f"{image_name.replace('.JPG', '.png')}")
            c2w = np.array(fm["transform_matrix"], np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        return colors, depths

    def load_poses(self):
        return self.tmp_poses
