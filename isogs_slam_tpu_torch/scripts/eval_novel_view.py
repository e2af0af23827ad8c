"""Novel-view-synthesis evaluation from a checkpoint (counterpart of
isogs_slam_tpu/scripts/eval_novel_view.py): render every frame of the
dataset's split at its ground-truth pose and report PSNR / MS-SSIM / LPIPS
and depth RMSE / L1.

    python -m isogs_slam_tpu_torch.scripts.eval_novel_view <config.py> \\
        [--checkpoint params800.npz] [--device cpu] [--set KEY=VALUE]

Writes <workdir>/<run_name>/eval_nvs/nvs_eval_summary.json and one .txt
per metric. Runs on config["primary_device"]: "cuda" unless the config or
`--device cpu` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..core import gaussians as G
from ..core.camera import Camera
from ..eval.eval_helpers import render_at_pose
from ..eval.metrics import lpips, lpips_variant, psnr
from ..io import checkpoints as ckpt_io
from ..ops.rasterize import RasterConfig
from ..ops.ssim import ms_ssim
from ..slam.config import load_experiment_config
from ..slam.pipeline import _dataset_from_config, primary_device
from ..utils.transforms import rotmat_to_quat
from .splatam import apply_overrides


def eval_nvs(dataset, state, cam: Camera, rcfg: RasterConfig, eval_dir: str,
             num_frames: int | None = None, skip_first: bool = True,
             device=None) -> dict:
    """Render every dataset frame at its (ground-truth) pose and compute
    the NVS metrics. With a use_train_split=False dataset the first frame
    is the anchoring train frame and is skipped."""
    os.makedirs(eval_dir, exist_ok=True)
    if num_frames is None:
        num_frames = len(dataset)
    dev = device if device is not None else state.alive.device
    # what render_at_pose reads of a SLAM object
    view = SimpleNamespace(state=state, cam=cam, rcfg=rcfg, device=dev)

    psnrs, ssims, lpipss, rmses, l1s = [], [], [], [], []
    for t in range(1 if skip_first else 0, num_frames):
        color, depth, _, pose = dataset[t]
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = rotmat_to_quat(torch.as_tensor(w2c[:3, :3], dtype=torch.float32))
        im, rdepth, _ = (x.cpu().numpy() for x in render_at_pose(
            view, q, np.asarray(w2c[:3, 3], np.float32)))
        gt_im = np.asarray(color, np.float32).transpose(2, 0, 1) / 255.0
        gt_depth = np.asarray(depth, np.float32).transpose(2, 0, 1)
        valid = gt_depth > 0
        wim, wgt = im * valid, gt_im * valid
        psnrs.append(psnr(wim, wgt))
        ssims.append(float(ms_ssim(torch.as_tensor(wim, device=dev),
                                   torch.as_tensor(wgt, device=dev))))
        lpipss.append(lpips(np.clip(wim, 0, 1), np.clip(wgt, 0, 1),
                            device=dev))
        diff = (rdepth - gt_depth) * valid
        denom = max(valid.sum(), 1)
        rmses.append(float(np.sqrt(diff ** 2).sum() / denom))
        l1s.append(float(np.abs(diff).sum() / denom))

    results = {
        "Average NVS PSNR": float(np.mean(psnrs)),
        "Average NVS MS-SSIM": float(np.mean(ssims)),
        "Average NVS LPIPS": float(np.mean(lpipss)),
        "Average NVS Depth RMSE (cm)": float(np.mean(rmses) * 100),
        "Average NVS Depth L1 (cm)": float(np.mean(l1s) * 100),
        "Frames": len(psnrs),
        "LPIPS Variant": lpips_variant(),
    }
    for name, vals in (("nvs_psnr", psnrs), ("nvs_ssim", ssims),
                       ("nvs_lpips", lpipss), ("nvs_l1", l1s)):
        np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.asarray(vals))
    with open(os.path.join(eval_dir, "nvs_eval_summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="Novel-view evaluation")
    p.add_argument("config", type=str)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="Override config['primary_device'] (cuda or cpu)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   dest="overrides",
                   help="Override a config entry by dotted path, as the "
                        "SLAM CLI's --set (e.g. --set data.basedir=D). "
                        "Repeatable.")
    args = p.parse_args(argv)
    config = load_experiment_config(args.config)
    apply_overrides(config, args.overrides)
    if args.device is not None:
        config["primary_device"] = args.device
    dev = primary_device(config)
    result_dir = os.path.join(config["workdir"], config["run_name"])

    if args.checkpoint:
        path = (args.checkpoint if os.path.isabs(args.checkpoint)
                else os.path.join(result_dir, args.checkpoint))
    else:
        final = os.path.join(result_dir, "params.npz")
        path = (final if os.path.exists(final)
                else ckpt_io.latest_checkpoint(result_dir)[1])
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"No checkpoint in {result_dir}")
    print(f"Loading checkpoint: {path}")
    data = ckpt_io.load_checkpoint(path)

    n = data["means3D"].shape[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    st = G.empty_state(G.round_capacity(n, 4096), dev)
    rows = G.GaussianParams(
        means3d=f32(data["means3D"]), rgb_colors=f32(data["rgb_colors"]),
        unnorm_rotations=f32(data["unnorm_rotations"]),
        logit_opacities=f32(data["logit_opacities"]),
        log_scales=f32(data["log_scales"]))
    st = G.append_rows(st, rows, torch.ones(n, dtype=torch.bool, device=dev),
                       0)

    # novel-view split (use_train_split=False -> first frame = train anchor)
    config = dict(config)
    config["data"] = dict(config["data"])
    dc = config["data"]
    dc["use_train_split"] = dc.get("use_train_split", False)
    dataset = _dataset_from_config(config, dc["desired_image_height"],
                                   dc["desired_image_width"], dev)
    c0, _, intr0, _ = dataset[0]
    cam = Camera.from_intrinsics(np.asarray(intr0)[:3, :3], c0.shape[1],
                                 c0.shape[0])
    r = config.get("raster", {})
    rcfg = RasterConfig(max_per_tile=r.get("max_per_tile", 512),
                        isect_per_gaussian=r.get("isect_per_gaussian", 2.5),
                        tile_chunk=r.get("tile_chunk", 256))
    return eval_nvs(dataset, st, cam, rcfg,
                    os.path.join(result_dir, "eval_nvs"),
                    skip_first=not dc["use_train_split"], device=dev)


if __name__ == "__main__":
    main()
