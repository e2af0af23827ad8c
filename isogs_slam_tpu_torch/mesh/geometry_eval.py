"""Mesh geometry metrics (counterpart of
isogs_slam_tpu/mesh/geometry_eval.py; numpy + scipy): accuracy /
completion / chamfer / F-score / Hausdorff / completion ratio on sampled
surface points via cKDTree.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .marching import sample_surface


def compute_accuracy(pred_points, gt_points):
    d, _ = cKDTree(gt_points).query(pred_points, k=1)
    return float(np.mean(d))


def compute_completion(pred_points, gt_points):
    d, _ = cKDTree(pred_points).query(gt_points, k=1)
    return float(np.mean(d))


def compute_chamfer_distance(pred_points, gt_points):
    return (compute_accuracy(pred_points, gt_points)
            + compute_completion(pred_points, gt_points)) / 2.0


def compute_f_score(pred_points, gt_points, threshold=0.05):
    dp, _ = cKDTree(gt_points).query(pred_points, k=1)
    precision = float(np.sum(dp < threshold) / len(pred_points))
    dg, _ = cKDTree(pred_points).query(gt_points, k=1)
    recall = float(np.sum(dg < threshold) / len(gt_points))
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return f, precision, recall


def compute_hausdorff_distance(pred_points, gt_points, percentile=100):
    dp, _ = cKDTree(gt_points).query(pred_points, k=1)
    dg, _ = cKDTree(pred_points).query(gt_points, k=1)
    alld = np.concatenate([dp, dg])
    return float(np.max(alld) if percentile == 100
                 else np.percentile(alld, percentile))


def compute_completion_ratio(pred_points, gt_points, threshold=0.05):
    d, _ = cKDTree(pred_points).query(gt_points, k=1)
    return float(np.sum(d < threshold) / len(gt_points))


def evaluate_mesh_geometry(pred_verts, pred_faces, gt_verts, gt_faces,
                           num_samples: int = 200000, f_threshold=0.05,
                           seed: int = 0) -> dict:
    """Full metric set on `num_samples` area-weighted surface samples
    (the reference samples 200k, eval_mesh_geometry.py main)."""
    rng = np.random.default_rng(seed)
    pred_pts = sample_surface(pred_verts, pred_faces, num_samples, rng)
    gt_pts = sample_surface(gt_verts, gt_faces, num_samples, rng)
    # each direction's nearest distances once: the functions above query
    # each tree again for every metric (as the reference does), for the
    # same numbers; a far-from-complete mesh makes each of those queries
    # seconds long
    dp, _ = cKDTree(gt_pts).query(pred_pts, k=1, workers=-1)
    dg, _ = cKDTree(pred_pts).query(gt_pts, k=1, workers=-1)
    accuracy, completion = float(np.mean(dp)), float(np.mean(dg))
    precision = float(np.sum(dp < f_threshold) / len(pred_pts))
    recall = float(np.sum(dg < f_threshold) / len(gt_pts))
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {
        "accuracy": accuracy,
        "completion": completion,
        "chamfer_distance": (accuracy + completion) / 2.0,
        "f_score": f, "precision": precision, "recall": recall,
        "hausdorff_95": float(np.percentile(np.concatenate([dp, dg]), 95)),
        "completion_ratio": recall,
        "num_samples": num_samples,
        "f_threshold": f_threshold,
    }
