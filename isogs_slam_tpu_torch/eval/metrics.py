"""Evaluation metrics: PSNR, depth RMSE/L1 helpers, ATE RMSE, LPIPS
(counterpart of isogs_slam_tpu/eval/metrics.py; numpy, except LPIPS).

PSNR via the per-channel-MSE formula; ATE via Horn closed-form alignment
(numpy SVD).

LPIPS: the reference uses a pretrained AlexNet. No weights ship with the
repository and none are fetched: `lpips()` loads them from
$ISOGS_LPIPS_WEIGHTS (an .npz export) when present, and otherwise uses a
seeded random-feature AlexNet, labeled "rand-alexnet" wherever reported
(set ISOGS_LPIPS_FALLBACK=none to get NaN instead).
"""
from __future__ import annotations

import os

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """img [C,H,W] in [0,1]; mean over per-channel 20log10(1/sqrt(mse))."""
    a = np.asarray(img1, np.float64).reshape(img1.shape[0], -1)
    b = np.asarray(img2, np.float64).reshape(img2.shape[0], -1)
    mse = ((a - b) ** 2).mean(axis=1)
    return float((20.0 * np.log10(1.0 / np.sqrt(np.maximum(mse, 1e-20))))
                 .mean())


def horn_align(model: np.ndarray, data: np.ndarray):
    """Horn closed-form alignment of 3xN trajectories -> (R, t, errors)."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = mz @ dz.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = mu_d - R @ mu_m
    aligned = R @ model + t
    err = np.sqrt(((aligned - data) ** 2).sum(axis=0))
    return R, t, err


def evaluate_ate(gt_traj: list, est_traj: list) -> float:
    """Mean translational error after Horn alignment, in meters."""
    gt = np.stack([np.asarray(g)[:3, 3] for g in gt_traj]).T
    est = np.stack([np.asarray(e)[:3, 3] for e in est_traj]).T
    _, _, err = horn_align(gt, est)
    return float(err.mean())


# ---------------------------------------------------------------- LPIPS
_LPIPS_NETS: dict = {}


def lpips_variant() -> str:
    """Which LPIPS is in effect: "alex" (pretrained export), "rand-alexnet"
    (seeded random-feature fallback), or "none" (NaN reported)."""
    path = os.environ.get("ISOGS_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return "alex"
    if os.environ.get("ISOGS_LPIPS_FALLBACK", "random") != "none":
        return "rand-alexnet"
    return "none"


def lpips(img1, img2, device="cuda") -> float:
    """AlexNet LPIPS of [3,H,W] images in [0,1], computed on `device`."""
    variant = lpips_variant()
    if variant == "none":
        return float("nan")
    from .lpips import LPIPSAlex
    key = (variant, str(device))
    if key not in _LPIPS_NETS:
        if variant == "alex":
            _LPIPS_NETS[key] = LPIPSAlex(os.environ["ISOGS_LPIPS_WEIGHTS"],
                                         device=device)
        else:
            _LPIPS_NETS[key] = LPIPSAlex.random(seed=0, device=device)
    return float(_LPIPS_NETS[key](img1, img2))
