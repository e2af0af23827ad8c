"""Online (during-run) evaluation (counterpart of
isogs_slam_tpu/eval/online.py).

Per reporting frame: render the current frame at its *estimated* pose,
compute PSNR / MS-SSIM / depth RMSE / depth L1, the latest absolute and
relative pose errors, and the running ATE RMSE over the trajectory so far;
append everything to `<run>/eval_online/online_*.txt`, save the qualitative
2x3 RGB/depth/silhouette figure when matplotlib is installed (skipped with
a notice otherwise), and log to wandb when enabled. `finalize()` writes
`online_summary.json` and the PSNR/L1 line plot (`online_metrics.png`).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils import spans


def _pose_errors(slam, time_idx: int):
    """(latest point error, relative point error, running ATE RMSE) —
    the tracking block of report_progress (eval_helpers.py:204-240)."""
    from .eval_helpers import est_w2c
    from .metrics import evaluate_ate

    est = [np.asarray(slam.first_frame_w2c)]
    gts = [np.asarray(slam.gt_w2c_all[0])]
    for idx in range(1, min(time_idx + 1, len(slam.gt_w2c_all))):
        gt = np.asarray(slam.gt_w2c_all[idx])
        if np.isnan(gt).any():
            continue
        est.append(est_w2c(slam, idx))
        gts.append(gt)

    pt_err = float(np.linalg.norm(est[-1][:3, 3] - gts[-1][:3, 3]))
    if len(est) > 1:
        rel_est = np.linalg.inv(est[-2]) @ est[-1]
        rel_gt = np.linalg.inv(gts[-2]) @ gts[-1]
        rel_err = float(np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3]))
    else:
        rel_err = 0.0
    try:
        ate = float(evaluate_ate(gts, est))
    except Exception:
        ate = float("nan")
    return pt_err, rel_err, ate


def _qual_plot(path, gt_im, gt_depth, im, rdepth, sil_mask, diff_l1,
               psnr_v, l1_v, title):
    """The reference's 2x3 figure: GT RGB / GT depth / silhouette over
    rendered RGB / rendered depth / depth-L1 error map."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 3, figsize=(12, 6))
    vmax = float(np.percentile(gt_depth[gt_depth > 0], 98)) \
        if (gt_depth > 0).any() else 6.0
    axs[0, 0].imshow(np.clip(gt_im.transpose(1, 2, 0), 0, 1))
    axs[0, 0].set_title("Ground Truth RGB")
    axs[0, 1].imshow(gt_depth[0], cmap="jet", vmin=0, vmax=vmax)
    axs[0, 1].set_title("Ground Truth Depth")
    axs[0, 2].imshow(sil_mask, cmap="gray")
    axs[0, 2].set_title("Rasterized Silhouette")
    axs[1, 0].imshow(np.clip(im.transpose(1, 2, 0), 0, 1))
    axs[1, 0].set_title(f"Rasterized RGB, PSNR: {psnr_v:.2f}")
    axs[1, 1].imshow(rdepth[0], cmap="jet", vmin=0, vmax=vmax)
    axs[1, 1].set_title(f"Rasterized Depth, L1: {l1_v:.2f}")
    axs[1, 2].imshow(diff_l1[0], cmap="jet", vmin=0, vmax=vmax)
    axs[1, 2].set_title("Diff Depth L1")
    for ax in axs.ravel():
        ax.axis("off")
    fig.suptitle(title, y=0.97, fontsize=14)
    fig.tight_layout()
    plt.savefig(path, bbox_inches="tight", dpi=90)
    plt.close(fig)


class OnlineEvaluator:
    """Accumulates online metrics during a SLAM run and writes the
    reference's eval_online artifact set."""

    def __init__(self, out_dir: str, sil_thres: float, logger=None,
                 save_qual: bool = True):
        self.dir = os.path.join(out_dir, "eval_online")
        self.plot_dir = os.path.join(self.dir, "plots")
        os.makedirs(self.plot_dir, exist_ok=True)
        self.sil_thres = sil_thres
        self.logger = logger
        self.save_qual = save_qual
        self.frames: list[int] = []
        self.psnr: list[float] = []
        self.ssim: list[float] = []
        self.rmse: list[float] = []
        self.l1: list[float] = []
        self.ate: list[float] = []

    def eval_frame(self, slam, time_idx: int, gt_im, gt_depth) -> dict:
        """gt_im [3,H,W] float in [0,1]; gt_depth [1,H,W] meters (device or
        host tensors or arrays). Returns the metric dict for this frame."""
        import torch

        from ..ops.ssim import ms_ssim
        from .eval_helpers import render_at_pose
        from .metrics import psnr as psnr_np

        q, t = slam._pose(time_idx)
        rendered = render_at_pose(slam, q, t)
        with spans.span("sync.eval_read"):
            rim, rdepth, sil = (x.cpu().numpy() for x in rendered)
            gt_im = torch.as_tensor(gt_im).cpu().numpy().astype(np.float32)
            gt_depth = torch.as_tensor(gt_depth).cpu().numpy().astype(
                np.float32)

        valid = gt_depth > 0
        # full-frame variant (mapping_iters > 0 path, eval_helpers.py:368+)
        p = float(psnr_np(rim * valid, gt_im * valid))
        with spans.span("sync.eval_ssim"):
            s = float(ms_ssim(torch.as_tensor(rim * valid,
                                              device=slam.device),
                              torch.as_tensor(gt_im * valid,
                                              device=slam.device)))
        diff = (rdepth - gt_depth) * valid
        denom = max(valid.sum(), 1)
        rmse = float(np.sqrt(diff ** 2).sum() / denom)
        l1 = float(np.abs(diff).sum() / denom)
        pt_err, rel_err, ate = _pose_errors(slam, time_idx)

        self.frames.append(time_idx)
        self.psnr.append(p)
        self.ssim.append(s)
        self.rmse.append(rmse)
        self.l1.append(l1)
        self.ate.append(ate)
        self._write_txt()

        if self.save_qual:
            try:
                _qual_plot(
                    os.path.join(self.plot_dir, f"{time_idx:04d}.png"),
                    gt_im, gt_depth, rim, rdepth,
                    sil > self.sil_thres, np.abs(diff), p, l1,
                    f"Time Step: {time_idx}")
            except Exception as e:
                print(f"[online eval] qual plot skipped: {e}")

        metrics = {"online/psnr": p, "online/ms_ssim": s,
                   "online/depth_rmse": rmse, "online/depth_l1": l1,
                   "online/pose_error": pt_err,
                   "online/rel_pose_error": rel_err,
                   "online/ate_rmse": ate, "online/frame": time_idx}
        if self.logger is not None:
            self.logger.log(metrics)
        return metrics

    def _write_txt(self):
        for name, vals in [("psnr", self.psnr), ("ssim", self.ssim),
                           ("rmse", self.rmse), ("l1", self.l1),
                           ("ate", self.ate)]:
            np.savetxt(os.path.join(self.dir, f"online_{name}.txt"),
                       np.asarray(vals))
        np.savetxt(os.path.join(self.dir, "online_frames.txt"),
                   np.asarray(self.frames, np.int64), fmt="%d")

    def finalize(self) -> dict | None:
        if not self.frames:
            return None
        summary = {
            "Online Average PSNR": float(np.mean(self.psnr)),
            "Online Average MS-SSIM": float(np.mean(self.ssim)),
            "Online Average Depth RMSE (cm)": float(np.mean(self.rmse)
                                                    * 100),
            "Online Average Depth L1 (cm)": float(np.mean(self.l1) * 100),
            "Online Final ATE RMSE (cm)": float(self.ate[-1] * 100),
            "Frames Evaluated": len(self.frames),
        }
        with open(os.path.join(self.dir, "online_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(f"Online Average PSNR: {summary['Online Average PSNR']:.2f}")
        print("Online Average Depth L1: "
              f"{summary['Online Average Depth L1 (cm)']:.2f} cm")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, axs = plt.subplots(1, 2, figsize=(12, 4))
            axs[0].plot(self.frames, self.psnr)
            axs[0].set_title("RGB PSNR")
            axs[0].set_xlabel("Time Step")
            axs[1].plot(self.frames, np.asarray(self.l1) * 100)
            axs[1].set_title("Depth L1 (cm)")
            axs[1].set_xlabel("Time Step")
            fig.suptitle(
                f"Average PSNR: {summary['Online Average PSNR']:.2f}, "
                "Average Depth L1: "
                f"{summary['Online Average Depth L1 (cm)']:.2f} cm")
            plt.savefig(os.path.join(self.dir, "online_metrics.png"),
                        bbox_inches="tight")
            plt.close(fig)
        except Exception as e:
            print(f"[online eval] metrics plot skipped: {e}")
        if self.logger is not None:
            self.logger.log({f"final/{k}": v for k, v in summary.items()
                             if isinstance(v, (int, float))})
        return summary
