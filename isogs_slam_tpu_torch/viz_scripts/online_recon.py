"""Online reconstruction replay (counterpart of
isogs_slam_tpu/viz_scripts/online_recon.py).

Watches a run directory for checkpoints as they appear during a live SLAM
run and renders the newest map from its latest estimated pose, on
--device (the card unless `--device cpu`); frames go to viz/online_*
(offscreen; the reference drives an Open3D window).

    python -m isogs_slam_tpu_torch.viz_scripts.online_recon <config.py> \\
        [--poll 2.0] [--max-wait 60] [--mode color|depth]
"""
from __future__ import annotations

import argparse
import os
import time
import zipfile

from ..io.checkpoints import latest_checkpoint, load_checkpoint
from ..slam.config import load_experiment_config
from .common import (colorize_depth, frame_to_uint8, load_scene,
                     make_render_fn, render_w2c, save_video_or_frames)
from .final_recon import viewer_raster_config

# what reading a checkpoint that is still being written raises
_PARTIAL_FILE_ERRORS = (OSError, EOFError, ValueError, KeyError,
                        zipfile.BadZipFile)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str)
    p.add_argument("--poll", type=float, default=2.0)
    p.add_argument("--max-wait", type=float, default=60.0,
                   help="stop after this many seconds without a new "
                        "checkpoint")
    p.add_argument("--mode", type=str, default="color",
                   choices=["color", "depth"])
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="device that renders (cuda or cpu)")
    args = p.parse_args(argv)

    config = load_experiment_config(args.config)
    result_dir = os.path.join(config["workdir"], config["run_name"])
    viz_dir = os.path.join(result_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    rcfg = viewer_raster_config(config)

    seen_frame = -1
    idle = 0.0
    frames = []
    fn = None
    cam = None
    print(f"[online-viz] watching {result_dir} "
          f"(poll {args.poll}s, stop after {args.max_wait}s idle)")
    while idle < args.max_wait:
        frame, path = latest_checkpoint(result_dir)
        if frame is None or frame <= seen_frame:
            time.sleep(args.poll)
            idle += args.poll
            continue
        idle = 0.0
        seen_frame = frame
        # a checkpoint still being written is skipped; only reading the
        # file is guarded: a render or device failure propagates
        try:
            load_checkpoint(path)
        except _PARTIAL_FILE_ERRORS as e:
            print(f"[online-viz] skipping {path}: {e}")
            time.sleep(args.poll)
            continue
        state, cam_full, est_w2cs, _, _ = load_scene(
            result_dir, os.path.basename(path), device=args.device)
        if fn is None:
            cam = (cam_full.scaled(cam_full.width // args.downscale,
                                   cam_full.height // args.downscale)
                   if args.downscale > 1 else cam_full)
            fn = make_render_fn(cam, rcfg)
        # newest pose with a non-degenerate quat
        t_last = frame if frame < est_w2cs.shape[0] else \
            est_w2cs.shape[0] - 1
        im, depth, sil = render_w2c(fn, state, est_w2cs[t_last])
        out = (frame_to_uint8(im) if args.mode == "color"
               else colorize_depth(depth[0]))
        frames.append(out)
        print(f"[online-viz] rendered checkpoint frame {frame} "
              f"({int(state.hwm)} Gaussians)")
    if frames:
        save_video_or_frames(frames, os.path.join(viz_dir, "online_replay"))
    else:
        print("[online-viz] no checkpoints appeared")
    return frames


if __name__ == "__main__":
    main()
