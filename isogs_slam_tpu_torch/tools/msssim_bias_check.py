"""The MS-SSIM precision check on a real run artifact (counterpart of
isogs_slam_tpu/tools/msssim_bias_check.py).

Renders eval frames from a SLAM checkpoint at its estimated poses and
computes MS-SSIM two ways on the SAME image pair:
  - fixed:  ops/ssim.py::ms_ssim as the package runs it (true f32 filter
    matmuls: the package turns TF32 off);
  - legacy: the same function with TF32 allowed for the Gaussian-window
    matmuls (torch.backends.cuda.matmul.allow_tf32 and the cuDNN flag),
    the card's counterpart of the JAX tool's DEFAULT-precision filters
    (bf16 operands on a TPU).
The delta is the inflation a reduced-precision filter would carry. On the
CPU the flags change nothing and the delta is 0. Both flags are restored
afterwards, also when the check fails.

    python -m isogs_slam_tpu_torch.tools.msssim_bias_check \\
        --config isogs_slam_tpu_torch/configs/synthetic/full_res.py \\
        --run experiments/Synthetic/synthetic_room_fullres_0 --frames 10
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..io import checkpoints as ckpt_io
from ..ops import ssim as ssim_mod
from ..slam.config import load_experiment_config


@contextlib.contextmanager
def tf32_allowed():
    """TF32 matmuls and convolutions inside the block; both flags restored
    on exit, whatever happens inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def legacy_ms_ssim(img1, img2, window_size: int = 11):
    """ms_ssim with TF32 filter matmuls."""
    with tf32_allowed():
        return ssim_mod.ms_ssim(img1, img2, window_size)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--run", required=True)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="Override config['primary_device'] (cuda or cpu)")
    args = p.parse_args(argv)

    config = load_experiment_config(args.config)
    if args.device is not None:
        config["primary_device"] = args.device
    dc = config["data"]
    from ..core import gaussians as G
    from ..core.camera import Camera
    from ..ops.rasterize import RasterConfig, render_rgbd_sil
    from ..slam.pipeline import _dataset_from_config, primary_device
    from ..utils.transforms import transform_to_frame

    dev = primary_device(config)
    dataset = _dataset_from_config(config, dc["desired_image_height"],
                                   dc["desired_image_width"], dev)
    frame, path = ckpt_io.latest_checkpoint(args.run)
    print(f"[bias-check] checkpoint {path} (frame {frame})")
    data = ckpt_io.load_checkpoint(path)
    n = data["means3D"].shape[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    st = G.empty_state(G.round_capacity(int(n * 1.05), 65536), dev)
    st = G.append_rows(st, G.GaussianParams(
        means3d=f32(data["means3D"]), rgb_colors=f32(data["rgb_colors"]),
        unnorm_rotations=f32(data["unnorm_rotations"]),
        logit_opacities=f32(data["logit_opacities"]),
        log_scales=f32(data["log_scales"])),
        torch.ones(n, dtype=torch.bool, device=dev), 0)

    _, d0, intr0, _ = dataset[0]
    cam = Camera.from_intrinsics(np.asarray(intr0)[:3, :3],
                                 dc["desired_image_width"],
                                 dc["desired_image_height"])
    r = config.get("raster", {})
    rcfg = RasterConfig(max_per_tile=r.get("max_per_tile", 512),
                        isect_per_gaussian=r.get("isect_per_gaussian", 2.5),
                        tile_chunk=r.get("tile_chunk", 256))

    rots = np.asarray(data["cam_unnorm_rots"])[0]
    trans = np.asarray(data["cam_trans"])[0]
    T = min(frame + 1, rots.shape[1])
    idxs = np.linspace(0, T - 1, args.frames).astype(int)
    rows = []
    p = st.params
    for t in idxs:
        color, depth, _, _ = dataset[int(t)]
        gt_im = np.asarray(color, np.float32).transpose(2, 0, 1) / 255.0
        gt_depth = np.asarray(depth, np.float32).transpose(2, 0, 1)
        q = rots[:, t] / np.linalg.norm(rots[:, t])
        with torch.no_grad():
            mc, qc = transform_to_frame(p.means3d, p.unnorm_rotations,
                                        f32(q), f32(trans[:, t]),
                                        gaussians_grad=False,
                                        camera_grad=False)
            im = render_rgbd_sil(mc, qc, p.log_scales, p.logit_opacities,
                                 p.rgb_colors, st.alive, cam, rcfg)[0]
        w = f32(gt_depth > 0)
        wim, wgt = im * w, f32(gt_im) * w
        vf = float(ssim_mod.ms_ssim(wim, wgt))
        vo = float(legacy_ms_ssim(wim, wgt))
        rows.append((int(t), vf, vo))
        print(f"frame {t:3d}: fixed {vf:.4f}  legacy {vo:.4f}  "
              f"delta {vo - vf:+.4f}")
    vf = np.array([r[1] for r in rows])
    vo = np.array([r[2] for r in rows])
    out = {"frames": [r[0] for r in rows],
           "fixed_mean": float(vf.mean()), "legacy_mean": float(vo.mean()),
           "bias_mean": float((vo - vf).mean()),
           "bias_max": float((vo - vf).max()),
           "legacy_above_1": int((vo > 1.0).sum())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
