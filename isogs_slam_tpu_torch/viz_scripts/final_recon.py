"""Final reconstruction viewer (counterpart of
isogs_slam_tpu/viz_scripts/final_recon.py).

Renders the final checkpoint along its estimated trajectory (color /
depth / silhouette modes) on --device (the card unless `--device cpu`),
writes a replay video (or PNG frames), a novel orbit around the scene, and
the 3D trajectory figure (when matplotlib is installed). With Open3D
installed, an interactive point-cloud window opens instead.

    python -m isogs_slam_tpu_torch.viz_scripts.final_recon <config.py> \\
        [--mode color|depth|sil|centers] [--every 5] [--orbit-frames 60]

The rasterizer's per-tile cap is the config's raster.max_per_tile, or 512,
fixed (no escalation), as in the reference: on a map with deeper tiles the
viewer composites only each tile's front-most 512 Gaussians.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..ops.rasterize import RasterConfig
from ..slam.config import load_experiment_config
from .common import (colorize_depth, frame_to_uint8, have_matplotlib,
                     have_open3d, load_scene, make_render_fn,
                     plot_trajectory, render_w2c, save_video_or_frames)


def orbit_poses(center: np.ndarray, radius: float, n: int,
                height: float = 0.0):
    """Look-at orbit around `center` (w2c matrices)."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = center + np.array([radius * np.sin(ang), height,
                                 radius * np.cos(ang)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, up2, fwd,
                                                          eye)
        poses.append(np.linalg.inv(c2w))
    return poses


def viewer_raster_config(config) -> RasterConfig:
    """The viewers' fixed rasterizer settings: the config's raster
    max_per_tile and tile_chunk, else 512 and 256."""
    r = config.get("raster", {})
    return RasterConfig(max_per_tile=r.get("max_per_tile", 512),
                        tile_chunk=r.get("tile_chunk", 256))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--mode", type=str, default="color",
                   choices=["color", "depth", "sil", "centers"])
    p.add_argument("--every", type=int, default=5,
                   help="render every Nth trajectory frame")
    p.add_argument("--orbit-frames", type=int, default=0,
                   help="additionally render an N-frame novel orbit")
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--sh", action="store_true",
                   help="view-dependent deg-3 SH colors when the "
                        "checkpoint carries nonzero higher-band "
                        "sh_coeffs_flat (C++ renderer parity)")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="device that renders (cuda or cpu)")
    args = p.parse_args(argv)

    config = load_experiment_config(args.config)
    result_dir = os.path.join(config["workdir"], config["run_name"])
    viz_dir = os.path.join(result_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)

    state, cam, est_w2cs, gt_w2cs, ckpt, sh_flat = load_scene(
        result_dir, args.checkpoint, return_sh=True, device=args.device)
    if not args.sh:
        sh_flat = None
    elif sh_flat is None:
        print("[viz] --sh requested but the checkpoint has no nonzero "
              "higher-band sh_coeffs_flat; rendering stored RGB")
    if args.downscale > 1:
        cam = cam.scaled(cam.width // args.downscale,
                         cam.height // args.downscale)
    print(f"[viz] {ckpt}: {int(state.hwm)} Gaussians, "
          f"{est_w2cs.shape[0]} poses, rendering at "
          f"{cam.width}x{cam.height} on {state.alive.device}")

    if have_open3d():  # pragma: no cover - interactive path
        print("[viz] Open3D found — interactive viewer")
        _interactive_open3d(state, cam, est_w2cs)
        return

    fn = make_render_fn(cam, viewer_raster_config(config))

    frames = []
    for t in range(0, est_w2cs.shape[0], max(args.every, 1)):
        im, depth, sil = render_w2c(fn, state, est_w2cs[t],
                                    sh_flat=sh_flat)
        if args.mode == "color":
            frames.append(frame_to_uint8(im))
        elif args.mode == "depth":
            frames.append(colorize_depth(depth[0]))
        else:
            s = sil.cpu().numpy()
            frames.append((np.stack([s] * 3, -1) * 255).astype(np.uint8))
    save_video_or_frames(frames, os.path.join(viz_dir,
                                              f"replay_{args.mode}"),
                         fps=args.fps)

    if args.orbit_frames > 0:
        means = state.params.means3d[: int(state.hwm)].cpu().numpy()
        center = np.median(means, axis=0)
        radius = 1.2 * np.percentile(
            np.linalg.norm(means - center, axis=1), 90)
        oframes = []
        for w2c in orbit_poses(center, radius, args.orbit_frames):
            im, depth, sil = render_w2c(fn, state, w2c,
                                        sh_flat=sh_flat)
            oframes.append(frame_to_uint8(im))
        save_video_or_frames(oframes, os.path.join(viz_dir, "orbit"),
                             fps=args.fps)

    if have_matplotlib():
        plot_trajectory(est_w2cs, gt_w2cs,
                        os.path.join(viz_dir, "trajectory.png"))
    else:
        print("[viz] matplotlib is not installed; trajectory figure "
              "skipped")
    print(f"[viz] outputs in {viz_dir}")


def _interactive_open3d(state, cam, est_w2cs):  # pragma: no cover
    import open3d as o3d
    n = int(state.hwm)
    pts = state.params.means3d[:n].cpu().numpy().astype(np.float64)
    cols = np.clip(state.params.rgb_colors[:n].cpu().numpy(), 0,
                   1).astype(np.float64)
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    pcd.colors = o3d.utility.Vector3dVector(cols)
    o3d.visualization.draw_geometries([pcd])


if __name__ == "__main__":
    main()
