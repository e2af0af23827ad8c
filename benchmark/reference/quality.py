"""Quality arithmetic of the end-to-end metrics, frozen in the benchmark.

`ate` is SplaTAM's "ATE RMSE" as the port's eval computes it
(isogs_slam_tpu_torch/eval/metrics.py::evaluate_ate): the mean translational
error after Horn's closed-form alignment, over the world-to-camera
translations of the estimated and the true trajectory. `psnr` renders a
map with the plain renderer, every intersection composited.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import render as R


def horn_align(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form alignment of 3 x N trajectories: (R, t, errors)
    with R model + t fitted to data."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    W = (model - mu_m) @ (data - mu_d).T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    Rm = U @ S @ Vh
    t = mu_d - Rm @ mu_m
    err = np.sqrt((((Rm @ model + t) - data) ** 2).sum(axis=0))
    return Rm, t, err


def ate_errors(gt_w2c, est_w2c) -> np.ndarray:
    """Per-frame translational errors (m) after alignment."""
    gt = np.stack([np.asarray(g)[:3, 3] for g in gt_w2c]).T
    est = np.stack([np.asarray(e)[:3, 3] for e in est_w2c]).T
    return horn_align(gt, est)[2]


def w2c_from(quat, trans) -> np.ndarray:
    q = np.asarray(quat, np.float64)
    q = q / np.linalg.norm(q)
    out = np.eye(4)
    out[:3, :3] = R.quat_to_rot(torch.as_tensor(q)).numpy()
    out[:3, 3] = np.asarray(trans, np.float64)
    return out


def psnr(m, alive, quat, trans, gt_im, cam: R.Cam) -> float:
    """PSNR (dB) of the map rendered at (quat, trans) against gt_im [3, H,
    W] in 0..1."""
    dev = gt_im.device
    q = torch.as_tensor(np.asarray(quat), dtype=torch.float32, device=dev)
    t = torch.as_tensor(np.asarray(trans), dtype=torch.float32, device=dev)
    with torch.no_grad():
        rec, rad, val = R.records(*m, alive, q, t, cam)
        bins = R.bin_tiles(rec, rad, val, cam)
        img = R.render(rec, bins, cam)
    mse = float(torch.mean((img[0:3] - gt_im) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))
