"""Mesh geometry evaluation (counterpart of
isogs_slam_tpu/scripts/eval_mesh_geometry.py): Accuracy / Completion /
Chamfer / F-score / Hausdorff / Completion-ratio between a reconstructed
mesh and ground truth, on 200k area-weighted surface samples (cKDTree).
`--render-eval` adds the per-pose depth-render comparison through the
software z-buffer (mesh/zbuffer.py), on config["primary_device"]: "cuda"
unless the config or `--device cpu` says otherwise.

    python -m isogs_slam_tpu_torch.scripts.eval_mesh_geometry <config.py> \\
        --gt-mesh <gt.ply> [--pred-mesh mesh_thickened_800.ply]
        [--num-samples 200000] [--f-threshold 0.05] [--render-eval]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..mesh.geometry_eval import evaluate_mesh_geometry
from ..mesh.meshio import read_ply
from ..slam.config import load_experiment_config
from ..slam.pipeline import primary_device


def find_pred_mesh(result_dir: str) -> str | None:
    """Latest mesh_thickened_{N}.ply, else mesh_fast.ply."""
    cands = glob.glob(os.path.join(result_dir, "mesh_thickened_*.ply"))
    if cands:
        def frame(p):
            try:
                return int(os.path.basename(p).split("_")[-1].split(".")[0])
            except ValueError:
                return -1
        return max(cands, key=frame)
    fallback = os.path.join(result_dir, "mesh_fast.ply")
    return fallback if os.path.exists(fallback) else None


def run_render_eval(config, result_dir: str, pred: dict, gt: dict,
                    every: int = 50, max_frames: int = 0,
                    device="cuda") -> dict:
    """Render pred and GT mesh depth at every `every`-th dataset pose via
    the software z-buffer on `device`, save comparison figures, and return
    aggregate depth L1 / RMSE over pixels both meshes cover (the headless
    analog of a pyrender loop)."""
    from ..mesh.zbuffer import render_mesh_depth
    from ..slam.pipeline import _dataset_from_config

    dc = config["data"]
    dataset = _dataset_from_config(config, dc["desired_image_height"],
                                   dc["desired_image_width"], device)
    n = len(dataset)
    frames = list(range(0, n, max(every, 1)))
    if max_frames > 0:
        frames = frames[:max_frames]
    out_dir = os.path.join(result_dir, "mesh_render_eval")
    os.makedirs(out_dir, exist_ok=True)

    l1s, rmses, overlaps = [], [], []
    for fi in frames:
        color, depth, intrinsics, pose = dataset[fi]
        K = np.asarray(intrinsics)[:3, :3]
        H, W = np.asarray(depth).shape[:2]
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        pd = render_mesh_depth(pred["vertices"], pred["faces"], w2c, K,
                               W, H, device=device)
        gd = render_mesh_depth(gt["vertices"], gt["faces"], w2c, K, W, H,
                               device=device)
        m = (pd > 0) & (gd > 0)
        cnt = max(int(m.sum()), 1)
        diff = np.where(m, pd - gd, 0.0)
        l1 = float(np.abs(diff).sum() / cnt)
        rmse = float(np.sqrt((diff ** 2).sum() / cnt))
        cov = float(m.mean())
        l1s.append(l1)
        rmses.append(rmse)
        overlaps.append(cov)
        print(f"[render-eval] frame {fi}: depth L1 {l1*100:.2f} cm, "
              f"RMSE {rmse*100:.2f} cm, overlap {cov:.2f}")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            vmax = float(np.percentile(gd[gd > 0], 98)) if m.any() else 6.0
            fig, axs = plt.subplots(1, 3, figsize=(15, 4))
            axs[0].imshow(gd, cmap="jet", vmin=0, vmax=vmax)
            axs[0].set_title("GT Mesh Depth")
            axs[1].imshow(pd, cmap="jet", vmin=0, vmax=vmax)
            axs[1].set_title("Predicted Mesh Depth")
            axs[2].imshow(np.abs(diff), cmap="jet", vmin=0,
                          vmax=max(np.percentile(np.abs(diff)[m], 95),
                                   1e-3) if m.any() else 0.1)
            axs[2].set_title(f"Depth |diff| (L1 {l1*100:.2f} cm)")
            for ax in axs:
                ax.axis("off")
            fig.suptitle(f"Frame {fi:04d}")
            plt.savefig(os.path.join(out_dir, f"frame_{fi:04d}.png"),
                        bbox_inches="tight", dpi=90)
            plt.close(fig)
        except Exception as e:
            print(f"[render-eval] plot skipped: {e}")

    summary = {
        "frames": frames,
        "depth_l1_cm": float(np.mean(l1s) * 100) if l1s else None,
        "depth_rmse_cm": float(np.mean(rmses) * 100) if rmses else None,
        "mean_overlap": float(np.mean(overlaps)) if overlaps else None,
    }
    print(f"[render-eval] mean depth L1 {summary['depth_l1_cm']:.2f} cm "
          f"over {len(frames)} poses -> {out_dir}")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="Mesh geometry evaluation")
    p.add_argument("config", type=str)
    p.add_argument("--gt-mesh", type=str, required=True)
    p.add_argument("--pred-mesh", type=str, default=None)
    p.add_argument("--num-samples", type=int, default=200000)
    p.add_argument("--f-threshold", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render-eval", action="store_true",
                   help="per-pose depth-render comparison of pred vs GT "
                        "mesh at dataset poses (software z-buffer)")
    p.add_argument("--render-every", type=int, default=50,
                   help="render every Nth dataset frame")
    p.add_argument("--render-max-frames", type=int, default=0,
                   help="cap on rendered frames (0 = all)")
    p.add_argument("--device", type=str, default=None,
                   help="Override config['primary_device'] (cuda or cpu)")
    args = p.parse_args(argv)

    config = load_experiment_config(args.config)
    if args.device is not None:
        config["primary_device"] = args.device
    # only the render eval uses a device; the metrics are numpy
    dev = primary_device(config) if args.render_eval else None
    result_dir = os.path.join(config["workdir"], config["run_name"])
    pred_path = args.pred_mesh or find_pred_mesh(result_dir)
    if pred_path is None:
        raise FileNotFoundError(
            f"No predicted mesh found in {result_dir}; run "
            f"extract_mesh_fast first or pass --pred-mesh")
    if not os.path.isabs(pred_path):
        cand = os.path.join(result_dir, pred_path)
        pred_path = cand if os.path.exists(cand) else pred_path

    print(f"Pred mesh: {pred_path}\nGT mesh:   {args.gt_mesh}")
    pred = read_ply(pred_path)
    gt = read_ply(args.gt_mesh)
    for name, m in (("pred", pred), ("gt", gt)):
        if m["vertices"] is None or m["faces"] is None:
            raise ValueError(f"{name} mesh missing vertices/faces")

    results = evaluate_mesh_geometry(
        pred["vertices"], pred["faces"], gt["vertices"], gt["faces"],
        num_samples=args.num_samples, f_threshold=args.f_threshold,
        seed=args.seed)
    if args.render_eval:
        results["render_eval"] = run_render_eval(
            config, result_dir, pred, gt, every=args.render_every,
            max_frames=args.render_max_frames, device=dev)

    print("\nMesh Geometry Metrics:")
    for k in ("accuracy", "completion", "chamfer_distance"):
        print(f"  {k}: {results[k]*100:.3f} cm")
    print(f"  f_score(@{args.f_threshold}m): {results['f_score']:.4f} "
          f"(P {results['precision']:.4f} / R {results['recall']:.4f})")
    print(f"  hausdorff_95: {results['hausdorff_95']*100:.3f} cm")
    print(f"  completion_ratio: {results['completion_ratio']:.4f}")

    out_json = os.path.join(result_dir, "mesh_geometry_eval.json")
    os.makedirs(result_dir, exist_ok=True)
    with open(out_json, "w") as f:
        json.dump({"pred_mesh": pred_path, "gt_mesh": args.gt_mesh,
                   **results}, f, indent=2)
    print(f"\nSaved: {out_json}")
    return results


if __name__ == "__main__":
    main()
