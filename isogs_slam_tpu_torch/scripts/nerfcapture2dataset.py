"""Capture a NeRFCapture stream to an on-disk dataset (counterpart of
isogs_slam_tpu/scripts/nerfcapture2dataset.py):

    python -m isogs_slam_tpu_torch.scripts.nerfcapture2dataset --source dir \\
        --watch /path/incoming --save ./experiments/iPhone_Captures/demo
    python -m isogs_slam_tpu_torch.scripts.nerfcapture2dataset \\
        --demo-synthetic --save /tmp/capture_demo --n-frames 10

The resulting directory (rgb/, depth/, transforms.json) loads through the
`nerfcapture` dataset loader. --demo-synthetic streams the synthetic scene,
rendered on --device (the card unless `--device cpu`), through the same
writer: the capture path without a phone.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

from ..ingest.sources import make_source, write_capture_frame


def capture_loop(source, save_path: str, n_frames: int, overwrite: bool):
    if os.path.exists(os.path.join(save_path, "rgb")):
        if not overwrite:
            raise SystemExit(f"{save_path} exists; pass --overwrite")
        shutil.rmtree(save_path)
    os.makedirs(save_path, exist_ok=True)
    print(f"Waiting for frames... (target {n_frames})")
    idx = 0
    t0 = time.time()
    while idx < n_frames:
        frame = source.next_frame(timeout=60.0)
        if frame is None:
            print("stream ended / timed out")
            break
        color, depth, c2w, K = frame
        write_capture_frame(save_path, idx, color, depth, c2w, K)
        idx += 1
        print(f"  frame {idx}/{n_frames}", end="\r", flush=True)
    open(os.path.join(save_path, "done"), "w").close()
    print(f"\ncaptured {idx} frames to {save_path} "
          f"({idx / max(time.time() - t0, 1e-9):.1f} fps)")
    return idx


def stream_synthetic(save_path: str, n_frames: int, hz: float = 10.0,
                     height: int = 120, width: int = 160,
                     n_per_wall: int = 2500, device="cuda"):
    """Writer side of the demo: streams the synthetic scene (n_per_wall
    Gaussians a wall) into a capture directory at `hz` (stands in for the
    phone), then writes `done`."""
    from ..datasets.synthetic import SyntheticDataset
    ds = SyntheticDataset(num_frames=n_frames, height=height, width=width,
                          n_per_wall=n_per_wall, device=device)
    K = ds.get_cam_K()
    for i in range(n_frames):
        color, depth, _, c2w = ds[i]
        write_capture_frame(save_path, i, np.clip(color, 0, 255),
                            depth[..., 0], c2w, K)
        time.sleep(1.0 / hz)
    open(os.path.join(save_path, "done"), "w").close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str, nargs="?", default=None,
                   help="experiment config providing workdir/run_name")
    p.add_argument("--source", type=str, default="dds",
                   choices=["dds", "dir"])
    p.add_argument("--watch", type=str, default=None,
                   help="directory to watch when --source dir")
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--n-frames", type=int, default=120)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--demo-synthetic", action="store_true",
                   help="no capture: write a synthetic stream to --save")
    p.add_argument("--device", type=str, default="cuda",
                   help="device that renders --demo-synthetic (cuda or "
                        "cpu)")
    args = p.parse_args(argv)

    save = args.save
    if save is None and args.config:
        from ..slam.config import load_experiment_config
        cfg = load_experiment_config(args.config)
        save = os.path.join(cfg["workdir"], cfg["run_name"])
    if save is None:
        raise SystemExit("need --save or a config")

    if args.demo_synthetic:
        if os.path.exists(save) and args.overwrite:
            shutil.rmtree(save)
        stream_synthetic(save, args.n_frames, device=args.device)
        print(f"synthetic capture written to {save}")
        return

    source = make_source(args.source, path=args.watch)
    capture_loop(source, save, args.n_frames, args.overwrite)


if __name__ == "__main__":
    main()
