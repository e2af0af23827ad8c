"""The timed work: whole SLAM jobs through the port's entry
(`SLAM(config, dataset=...).run()`), one after another.

A job is what `python -m isogs_slam_tpu_torch.scripts.splatam <config>`
does with a sequence: a fresh SLAM object over the configuration as
shipped (device, work directory and frame count overridden), the frames
handed over as the loaders hand them (host arrays: colour H x W x 3 at
0-255, depth H x W x 1 in metres, 4 x 4 intrinsics, c2w relative to the
first frame), so the upload is part of the job.
"""
from __future__ import annotations

import copy
import os
import shutil
import time

import numpy as np


class FrameSource:
    """The loaders' indexable frame interface over host arrays."""

    def __init__(self, colour, depth, c2w, K):
        self.colour = colour            # [n, H, W, 3] float32, 0..255
        self.depth = depth              # [n, H, W, 1] float32, metres
        self.c2w = c2w                  # [n, 4, 4] float64
        self.K = np.eye(4, dtype=np.float32)
        self.K[:3, :3] = K

    def __len__(self):
        return self.colour.shape[0]

    def __getitem__(self, i):
        return self.colour[i], self.depth[i], self.K, \
            self.c2w[i].astype(np.float32)


def job_config(template: dict, workdir: str, run_name: str, seed: int,
               frames: int, device: str = "cuda") -> dict:
    cfg = copy.deepcopy(template)
    cfg["primary_device"] = device
    cfg["workdir"] = workdir
    cfg["run_name"] = run_name
    cfg["seed"] = int(seed)
    cfg["data"]["num_frames"] = int(frames)
    return cfg


def run_job(template: dict, source: FrameSource, workdir: str,
            run_name: str, seed: int, device: str = "cuda") -> dict:
    """One SLAM job. Returns what the benchmark reads of it: the frame
    count, its per-frame stage times, its output directory and the wall
    seconds."""
    from isogs_slam_tpu_torch.slam.pipeline import SLAM
    t0 = time.time()
    cfg = job_config(template, workdir, run_name, seed, len(source), device)
    slam = SLAM(cfg, dataset=source)
    stats = slam.run()
    out = {"frames": len(source), "dir": slam.output_dir,
           "tracking_s": float(np.sum(stats["tracking_frame_time"])),
           "mapping_s": float(np.sum(stats["mapping_frame_time"]))}
    del slam, stats
    out["wall_s"] = time.time() - t0
    return out


def final_checkpoint(job_dir: str) -> str:
    """Path of the job's last params<frame>.npz."""
    best, path = -1, None
    for f in os.listdir(job_dir):
        if f.startswith("params") and f.endswith(".npz"):
            n = int(f[len("params"):-len(".npz")])
            if n > best:
                best, path = n, os.path.join(job_dir, f)
    if path is None:
        raise FileNotFoundError(f"no params*.npz in {job_dir}")
    return path


def remove(path: str):
    shutil.rmtree(path, ignore_errors=True)
