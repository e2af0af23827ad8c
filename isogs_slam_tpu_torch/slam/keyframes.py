"""Keyframe library + overlap-based selection (counterpart of
isogs_slam_tpu/slam/keyframes.py).

Selection: sample 1600 valid-depth pixels of the current frame,
back-project, re-project into each candidate keyframe, rank by the fraction
inside the frustum (20 px margin), drop zero-overlap frames, then
random-permute and take k. It is O(1600 * n_keyframes) numpy on the host
and feeds host-side control flow, drawing from the caller's RandomState
(`randint`, then `permutation`).

The keyframe image library lives on the device with a static capacity:
uint8 colour + f32 depth, written in place once per keyframe, so mapping
phases never re-upload frames.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class KeyframeLibrary:
    """Fixed-capacity device-side keyframe store.

    Slots [0, max_keyframes) hold keyframes in insertion order; slot
    `max_keyframes` is scratch for the current frame.
    """

    def __init__(self, max_keyframes: int, height: int, width: int,
                 device="cuda"):
        dev = resolve_device(device)
        self.max_keyframes = max_keyframes
        s = max_keyframes + 1
        self.colors = torch.zeros((s, height, width, 3), dtype=torch.uint8,
                                  device=dev)
        self.depths = torch.zeros((s, height, width), device=dev)
        self.quats = torch.zeros((s, 4), device=dev)
        self.trans = torch.zeros((s, 3), device=dev)
        self.time_indices: list[int] = []   # host-side ids
        self.w2cs: list[np.ndarray] = []    # host copies for selection

    def __len__(self):
        return len(self.time_indices)

    @property
    def current_slot(self) -> int:
        return self.max_keyframes

    def _write(self, slot, color_chw, depth_1hw, quat, trans):
        self.colors[slot] = torch.clamp(
            torch.round(color_chw.permute(1, 2, 0) * 255.0), 0, 255
        ).to(torch.uint8)
        self.depths[slot] = depth_1hw[0]
        self.quats[slot] = quat
        self.trans[slot] = trans

    def add_keyframe(self, time_idx: int, color_chw, depth_1hw, quat, trans,
                     w2c: np.ndarray):
        assert len(self.time_indices) < self.max_keyframes, "keyframe overflow"
        slot = len(self.time_indices)
        self._write(slot, color_chw, depth_1hw, quat, trans)
        self.time_indices.append(time_idx)
        self.w2cs.append(np.asarray(w2c))

    def set_current(self, color_chw, depth_1hw, quat, trans):
        self._write(self.current_slot, color_chw, depth_1hw, quat, trans)


def backproject_sampled(depth_hw: np.ndarray, K: np.ndarray,
                        w2c: np.ndarray, sampled: np.ndarray) -> np.ndarray:
    """Back-project sampled (row, col) pixels to world points; drops
    points collapsing to the camera origin."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = depth_hw[sampled[:, 0], sampled[:, 1]]
    xx = (sampled[:, 1] - cx) / fx
    yy = (sampled[:, 0] - cy) / fy
    pts_cam = np.stack([xx * z, yy * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    keep = ~np.all(np.abs(np.round(pts, 4)) == 0.0, axis=1)
    return pts[keep]


def keyframe_selection_overlap(gt_depth_hw: np.ndarray, w2c: np.ndarray,
                               K: np.ndarray, keyframe_w2cs: list,
                               k: int, rng: np.random.RandomState,
                               width: int, height: int,
                               pixels: int = 1600) -> list:
    """Returns indices into keyframe_w2cs of up to k overlapping keyframes."""
    valid = np.argwhere(gt_depth_hw > 0)
    if valid.shape[0] == 0 or len(keyframe_w2cs) == 0:
        return []
    sel = rng.randint(valid.shape[0], size=(pixels,))
    sampled = valid[sel]
    pts = backproject_sampled(gt_depth_hw, K, w2c, sampled)
    if pts.shape[0] == 0:
        return []
    pts4 = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)

    percent_inside = []
    for est_w2c in keyframe_w2cs:
        tp = (np.asarray(est_w2c) @ pts4.T).T[:, :3]
        p2 = (K @ tp.T).T
        zc = p2[:, 2:] + 1e-5
        uv = p2[:, :2] / zc
        edge = 20
        mask = ((uv[:, 0] < width - edge) & (uv[:, 0] > edge)
                & (uv[:, 1] < height - edge) & (uv[:, 1] > edge)
                & (zc[:, 0] > 0))
        percent_inside.append(mask.mean())

    order = sorted(range(len(keyframe_w2cs)),
                   key=lambda i: percent_inside[i], reverse=True)
    selected = [i for i in order if percent_inside[i] > 0.0]
    return list(rng.permutation(np.array(selected, dtype=np.int64))[:k])
