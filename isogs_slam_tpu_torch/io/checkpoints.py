"""Checkpoint I/O with the reference's .npz artifact schema (counterpart of
isogs_slam_tpu/io/checkpoints.py; numpy only).

Keys: means3D, rgb_colors, unnorm_rotations, logit_opacities, log_scales,
cam_unnorm_rots [1,4,T], cam_trans [1,3,T], timestep [N], intrinsics, w2c,
org_width, org_height, gt_w2c_all_frames [T',4,4], keyframe_time_indices,
sh_coeffs_flat [N,48]. Files are `params{frame}.npz` +
`keyframe_time_indices{frame}.npy`; auto-resume picks the highest frame; GC
keeps the last 3. A checkpoint written by this package loads in the JAX
package and the reverse.
"""
from __future__ import annotations

import os
import re

import numpy as np


GAUSS_KEYS = ("means3D", "rgb_colors", "unnorm_rotations",
              "logit_opacities", "log_scales")


def save_checkpoint(output_dir: str, time_idx: int, gauss_params: dict,
                    cam_unnorm_rots: np.ndarray, cam_trans: np.ndarray,
                    timestep: np.ndarray, intrinsics: np.ndarray,
                    first_frame_w2c: np.ndarray, org_width: int,
                    org_height: int, gt_w2c_all_frames: list,
                    keyframe_time_indices: list, keep_last: int = 3):
    os.makedirs(output_dir, exist_ok=True)
    out = {k: np.asarray(v, np.float32) for k, v in gauss_params.items()}
    out["cam_unnorm_rots"] = np.asarray(cam_unnorm_rots,
                                        np.float32).reshape(1, 4, -1)
    out["cam_trans"] = np.asarray(cam_trans, np.float32).reshape(1, 3, -1)
    out["timestep"] = np.asarray(timestep, np.float32)
    out["intrinsics"] = np.asarray(intrinsics, np.float32)
    out["w2c"] = np.asarray(first_frame_w2c, np.float32)
    out["org_width"] = np.asarray(org_width)
    out["org_height"] = np.asarray(org_height)
    if len(gt_w2c_all_frames):
        out["gt_w2c_all_frames"] = np.stack(
            [np.asarray(g, np.float32) for g in gt_w2c_all_frames])
    out["keyframe_time_indices"] = np.asarray(keyframe_time_indices,
                                              np.int64)
    # sh_coeffs_flat [N,48]: SH0 derived from rgb via rgb = C0*sh0 + 0.5,
    # higher bands zero (3DGS viewers and the C++ loader read SH)
    if "rgb_colors" in out and "sh_coeffs_flat" not in out:
        C0 = 0.28209479177387814
        rgb = out["rgb_colors"]
        sh = np.zeros((rgb.shape[0], 48), np.float32)
        sh[:, 0:3] = (rgb - 0.5) / C0
        out["sh_coeffs_flat"] = sh
    np.savez(os.path.join(output_dir, f"params{time_idx}.npz"), **out)
    np.save(os.path.join(output_dir,
                         f"keyframe_time_indices{time_idx}.npy"),
            np.asarray(keyframe_time_indices))
    gc_checkpoints(output_dir, keep_last)


def list_checkpoints(output_dir: str):
    """[(frame_idx, path)] sorted by frame."""
    if not os.path.isdir(output_dir):
        return []
    found = []
    for fname in os.listdir(output_dir):
        m = re.fullmatch(r"params(\d+)\.npz", fname)
        if m:
            found.append((int(m.group(1)), os.path.join(output_dir, fname)))
    return sorted(found)


def latest_checkpoint(output_dir: str):
    cks = list_checkpoints(output_dir)
    return cks[-1] if cks else (None, None)


def gc_checkpoints(output_dir: str, keep_last: int = 3):
    cks = list_checkpoints(output_dir)
    for frame, path in cks[:-keep_last] if keep_last > 0 else []:
        for p in (path, os.path.join(output_dir,
                                     f"keyframe_time_indices{frame}.npy")):
            try:
                if os.path.exists(p):
                    os.remove(p)
            except OSError:
                pass


def load_checkpoint(path: str) -> dict:
    return dict(np.load(path, allow_pickle=True))
