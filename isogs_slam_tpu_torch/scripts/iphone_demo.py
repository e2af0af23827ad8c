"""Online SLAM on a live RGB-D stream (counterpart of
isogs_slam_tpu/scripts/iphone_demo.py): receive NeRFCapture frames, run
full tracking + mapping per frame, save the final map and evaluate.

Transport is a FrameSource: CycloneDDS (gated on the package) or a watched
capture directory (any push mechanism). The SLAM engine is the standard
pipeline; the dataset is a blocking stream adapter, so online behaviour
needs no SLAM changes.

    # terminal A (the "phone"): stream the synthetic scene
    python -m isogs_slam_tpu_torch.scripts.nerfcapture2dataset \\
        --demo-synthetic --save /tmp/live_capture --n-frames 15

    # terminal B: online SLAM over the growing capture, on the card
    python -m isogs_slam_tpu_torch.scripts.iphone_demo \\
        configs/synthetic/online_demo.py --source dir \\
        --watch /tmp/live_capture --n-frames 15 --device cuda
"""
from __future__ import annotations

import argparse
import threading

import numpy as np

from ..ingest.sources import make_source
from ..slam.config import load_experiment_config
from ..slam.pipeline import SLAM, primary_device
from ..utils.common import seed_everything


class StreamDataset:
    """RGBDDataset-compatible adapter over a FrameSource: __getitem__
    blocks until the frame arrives; poses are normalized to frame 0.

    The pipeline's Prefetcher calls __getitem__ from its own thread while
    the SLAM loop calls it too: frames are pulled from the source under a
    lock, one caller at a time, so they keep the source's order (and frame
    0 stays the pose origin); a frame already pulled is returned without
    waiting for the lock."""

    def __init__(self, source, max_frames: int, timeout: float = 120.0):
        self.source = source
        self.max_frames = max_frames
        self.timeout = timeout
        self.frames = []
        self.first_c2w = None
        self.ended = False
        self._pull_lock = threading.Lock()

    def __len__(self):
        return self.max_frames

    def _pull_until(self, index: int):
        with self._pull_lock:
            while len(self.frames) <= index and not self.ended:
                got = self.source.next_frame(timeout=self.timeout)
                if got is None:
                    self.ended = True
                    break
                color, depth, c2w, K = got
                if self.first_c2w is None:
                    self.first_c2w = c2w
                rel = np.linalg.inv(self.first_c2w) @ c2w
                intr = np.eye(4, dtype=np.float32)
                intr[:3, :3] = K
                self.frames.append(
                    (color.astype(np.float32),
                     depth[:, :, None].astype(np.float32), intr,
                     rel.astype(np.float32)))

    def __getitem__(self, index: int):
        if index >= len(self.frames):
            self._pull_until(index)
        if index >= len(self.frames):
            raise IndexError(
                f"stream ended after {len(self.frames)} frames")
        return self.frames[index]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("experiment", type=str)
    p.add_argument("--source", type=str, default="dds",
                   choices=["dds", "dir"])
    p.add_argument("--watch", type=str, default=None)
    p.add_argument("--n-frames", type=int, default=None)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="Override config['primary_device'] (cuda or cpu)")
    args = p.parse_args(argv)

    config = dict(load_experiment_config(args.experiment))
    if args.device is not None:
        config["primary_device"] = args.device
    primary_device(config)     # refuse a device before waiting on a stream
    seed_everything(config.get("seed", 0))
    source = make_source(args.source, path=args.watch)

    n = args.n_frames or config["data"].get("num_frames", 300)
    if n <= 0:
        n = 300
    stream = StreamDataset(source, n, timeout=args.timeout)
    # first frame defines the camera; blocks until the stream starts
    color0, _, intr0, _ = stream[0]
    config["data"] = dict(config["data"])
    config["data"]["num_frames"] = n
    config["data"]["desired_image_height"] = color0.shape[0]
    config["data"]["desired_image_width"] = color0.shape[1]

    slam = SLAM(config, dataset=stream)
    slam.run()
    slam.save_checkpoint(slam.num_frames - 1)
    if not args.no_eval:
        from ..eval.eval_helpers import eval_sequence
        slam.eval_results = eval_sequence(
            slam.dataset, slam, slam.eval_dir,
            sil_thres=config["mapping"]["sil_thres"],
            mapping_iters=config["mapping"]["num_iters"],
            add_new_gaussians=True, eval_every=config.get("eval_every", 5))
    return slam


if __name__ == "__main__":
    main()
