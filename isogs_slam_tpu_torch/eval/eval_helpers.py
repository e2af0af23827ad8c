"""Final-parameter evaluation (counterpart of
isogs_slam_tpu/eval/eval_helpers.py).

Per eval_every-th frame: render RGB and depth+silhouette at the estimated
pose, compute PSNR / MS-SSIM / LPIPS on valid-depth-masked images and depth
RMSE/L1, then ATE RMSE over the estimated trajectory; write
eval/eval_summary.{txt,json}, per-metric .txt arrays and, when matplotlib
is installed, per-frame plots and metrics.png (without it the plots are
skipped with a notice).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.rasterize import render_rgbd_sil
from ..ops.ssim import ms_ssim
from ..utils.transforms import pose_to_w2c, transform_to_frame
from .metrics import evaluate_ate, lpips, lpips_variant, psnr


@torch.no_grad()
def render_at_pose(slam, quat, trans, cam=None):
    """(im [3,H,W], depth [1,H,W], silhouette [H,W]) of slam's map at a
    w2c pose, on slam's device."""
    cam = cam or slam.cam
    dev = slam.device
    quat = torch.as_tensor(quat, dtype=torch.float32, device=dev)
    trans = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    p = slam.state.params
    mc, qc = transform_to_frame(p.means3d, p.unnorm_rotations, quat, trans,
                                gaussians_grad=False, camera_grad=False)
    im, depth, sil, _, _ = render_rgbd_sil(
        mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
        slam.state.alive, cam, slam.rcfg)
    return im, depth, sil


def est_w2c(slam, idx: int) -> np.ndarray:
    """The estimated world-to-camera matrix of frame idx (f32 math)."""
    q = slam.cam_rots[:, idx]
    q = q / np.linalg.norm(q)
    return pose_to_w2c(torch.as_tensor(q, dtype=torch.float32),
                       torch.as_tensor(slam.cam_trans[:, idx],
                                       dtype=torch.float32)).numpy()


def _save_frame_plot(plot_dir, time_idx, im, gt_im, rdepth, gt_depth,
                     psnr_v, l1_v):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(2, 2, figsize=(9, 6))
    axs[0, 0].imshow(np.clip(im.transpose(1, 2, 0), 0, 1))
    axs[0, 0].set_title(f"Rendered (PSNR {psnr_v:.2f})")
    axs[0, 1].imshow(np.clip(gt_im.transpose(1, 2, 0), 0, 1))
    axs[0, 1].set_title("GT RGB")
    vmax = np.percentile(gt_depth[gt_depth > 0], 98) \
        if (gt_depth > 0).any() else 1.0
    axs[1, 0].imshow(rdepth[0], cmap="turbo", vmin=0, vmax=vmax)
    axs[1, 0].set_title(f"Rendered depth (L1 {l1_v*100:.1f}cm)")
    axs[1, 1].imshow(gt_depth[0], cmap="turbo", vmin=0, vmax=vmax)
    axs[1, 1].set_title("GT depth")
    for ax in axs.ravel():
        ax.axis("off")
    plt.savefig(os.path.join(plot_dir, f"frame_{time_idx:05d}.png"),
                bbox_inches="tight", dpi=100)
    plt.close(fig)


def eval_sequence(dataset, slam, eval_dir: str, sil_thres: float,
                  mapping_iters: int, add_new_gaussians: bool,
                  eval_every: int = 1, num_frames: int | None = None,
                  save_frames: bool = False, make_plots: bool = True):
    print("Evaluating Final Parameters ...")
    os.makedirs(eval_dir, exist_ok=True)
    plot_dir = os.path.join(eval_dir, "plots")
    os.makedirs(plot_dir, exist_ok=True)
    if num_frames is None:
        num_frames = slam.num_frames
    dev = slam.device

    psnr_list, rmse_list, l1_list, ssim_list, lpips_list = [], [], [], [], []
    gt_w2c_list = []

    for time_idx in range(num_frames):
        color, depth, _, pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(np.asarray(pose, np.float64))
        gt_w2c_list.append(gt_w2c)
        if time_idx != 0 and (time_idx + 1) % eval_every != 0:
            continue

        gt_im = np.asarray(color, np.float32).transpose(2, 0, 1) / 255.0
        gt_depth = np.asarray(depth, np.float32).transpose(2, 0, 1)

        q = slam.cam_rots[:, time_idx]
        q = q / np.linalg.norm(q)
        t = slam.cam_trans[:, time_idx]
        im, rdepth, sil = (x.cpu().numpy()
                           for x in render_at_pose(slam, q, t))

        valid = (gt_depth > 0)
        presence = sil > sil_thres
        if mapping_iters == 0 and not add_new_gaussians:
            w = presence[None] * valid
        else:
            w = valid
        wim = im * w
        wgt = gt_im * w
        psnr_list.append(psnr(wim, wgt))
        ssim_list.append(float(ms_ssim(torch.as_tensor(wim, device=dev),
                                       torch.as_tensor(wgt, device=dev))))
        lpips_list.append(lpips(np.clip(wim, 0, 1), np.clip(wgt, 0, 1),
                                device=dev))

        rd = rdepth * valid
        if mapping_iters == 0 and not add_new_gaussians:
            diff = (rd - gt_depth) * presence[None] * valid
        else:
            diff = (rd - gt_depth) * valid
        denom = max(valid.sum(), 1)
        rmse_list.append(float(np.sqrt(diff ** 2).sum() / denom))
        l1_list.append(float(np.abs(diff).sum() / denom))

        if save_frames:
            _save_frame_plot(plot_dir, time_idx, im, gt_im, rdepth,
                             gt_depth, psnr_list[-1], l1_list[-1])

    # trajectory: estimated w2c chain vs gt
    try:
        est, gts = [slam.first_frame_w2c], [gt_w2c_list[0]]
        T = min(slam.cam_rots.shape[1], len(gt_w2c_list))
        for idx in range(1, T):
            if np.isnan(gt_w2c_list[idx]).any():
                continue
            est.append(est_w2c(slam, idx))
            gts.append(gt_w2c_list[idx])
        ate_rmse = evaluate_ate(gts, est)
        print(f"Final Average ATE RMSE: {ate_rmse*100:.2f} cm")
    except Exception as e:  # matches the reference's bare-except fallback
        ate_rmse = 100.0
        print(f"Failed to evaluate trajectory: {e}")

    results = {
        "Final Average ATE RMSE (cm)": float(ate_rmse * 100),
        "Average PSNR": float(np.mean(psnr_list)),
        "Average Depth RMSE (cm)": float(np.mean(rmse_list) * 100),
        "Average Depth L1 (cm)": float(np.mean(l1_list) * 100),
        "Average MS-SSIM": float(np.mean(ssim_list)),
        "Average LPIPS": float(np.mean(lpips_list)),
    }
    results["LPIPS Variant"] = lpips_variant()
    print(f"Average PSNR: {results['Average PSNR']:.2f}")
    print(f"Average Depth RMSE: {results['Average Depth RMSE (cm)']:.2f} cm")
    print(f"Average Depth L1: {results['Average Depth L1 (cm)']:.2f} cm")
    print(f"Average MS-SSIM: {results['Average MS-SSIM']:.3f}")
    print(f"Average LPIPS: {results['Average LPIPS']:.3f}")

    for name, vals in [("psnr", psnr_list), ("rmse", rmse_list),
                       ("l1", l1_list), ("ssim", ssim_list),
                       ("lpips", lpips_list)]:
        np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.asarray(vals))
    with open(os.path.join(eval_dir, "eval_summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(eval_dir, "eval_summary.txt"), "w") as f:
        f.write("Final Evaluation Metrics Summary\n")
        for k, v in results.items():
            f.write(f"{k}: {v}\n")

    if make_plots:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, axs = plt.subplots(1, 2, figsize=(12, 4))
            axs[0].plot(psnr_list)
            axs[0].set_title("RGB PSNR")
            axs[1].plot(np.asarray(l1_list) * 100)
            axs[1].set_title("Depth L1 (cm)")
            fig.suptitle(
                f"PSNR {results['Average PSNR']:.2f} | "
                f"L1 {results['Average Depth L1 (cm)']:.2f}cm | "
                f"ATE {results['Final Average ATE RMSE (cm)']:.2f}cm")
            plt.savefig(os.path.join(eval_dir, "metrics.png"),
                        bbox_inches="tight")
            plt.close()
        except Exception as e:
            print(f"[eval] plot generation skipped: {e}")
    return results
