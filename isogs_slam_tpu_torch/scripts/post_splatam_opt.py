"""Post-SLAM map optimization (counterpart of
isogs_slam_tpu/scripts/post_splatam_opt.py): load a SLAM checkpoint and
re-optimize its Gaussian map against the frames, with the ESTIMATED
trajectory as fixed poses.

    python -m isogs_slam_tpu_torch.scripts.post_splatam_opt \\
        isogs_slam_tpu_torch/configs/synthetic/post_splatam_opt.py \\
        [--device cpu] [--no-eval]

The checkpoint is data.param_ckpt_path, else <workdir>/<data.param_run_name>;
config["checkpoint_time_idx"] picks params<idx>.npz (-1: the latest).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import gaussians as G
from ..io import checkpoints as ckpt_io
from .gaussian_splatting import OfflineGS, _cli_config, evaluate


class PostSLAMOpt(OfflineGS):
    """OfflineGS with the map and the trajectory seeded from a SLAM
    checkpoint instead of an initialisation sweep and ground-truth
    poses."""

    def __init__(self, config: dict):
        super().__init__(config)
        ckpt_dir = config["data"].get("param_ckpt_path") or os.path.join(
            config["workdir"], config["data"]["param_run_name"])
        want = config.get("checkpoint_time_idx", -1)
        if want < 0:
            frame, path = ckpt_io.latest_checkpoint(ckpt_dir)
        else:
            frame, path = want, os.path.join(ckpt_dir, f"params{want}.npz")
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"No SLAM checkpoint in {ckpt_dir}")
        print(f"[post-opt] loading SLAM checkpoint {path}")
        data = ckpt_io.load_checkpoint(path)

        n = data["means3D"].shape[0]
        capacity = G.round_capacity(int(n * 1.25),
                                    config.get("capacity_granule", 65536))
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        st = G.empty_state(capacity, dev)
        rows = G.GaussianParams(
            means3d=f32(data["means3D"]), rgb_colors=f32(data["rgb_colors"]),
            unnorm_rotations=f32(data["unnorm_rotations"]),
            logit_opacities=f32(data["logit_opacities"]),
            log_scales=f32(data["log_scales"]))
        st = G.append_rows(st, rows,
                           torch.ones(n, dtype=torch.bool, device=dev), 0)
        _, depth0, _, _ = self.dataset[0]
        self.state = st._replace(scene_radius=torch.tensor(
            float(np.max(depth0)) / config["scene_radius_depth_ratio"],
            dtype=torch.float32, device=dev))

        # the estimated trajectory replaces the ground-truth poses. A SLAM
        # run allocates its pose arrays at its num_frames but optimizes
        # them only through the checkpoint's frame: clamp to frame + 1 so
        # an interrupted run's unvisited tail never enters the optimization
        est_rots = np.asarray(data["cam_unnorm_rots"])[0]
        est_trans = np.asarray(data["cam_trans"])[0]
        T = min(self.num_frames, est_rots.shape[1], frame + 1)
        self.num_frames = T
        self.cam_rots = est_rots[:, :T] / np.linalg.norm(
            est_rots[:, :T], axis=0, keepdims=True)
        self.cam_trans = est_trans[:, :T]

    def init_sweep(self):  # the map comes from the checkpoint
        print(f"[post-opt] map seeded from checkpoint: "
              f"{int(self.state.num_alive())} Gaussians")


def main(argv=None):
    args, config = _cli_config(argv, "Post-SLAM map optimization")
    runner = PostSLAMOpt(config)
    runner.init_sweep()
    runner.optimize()
    runner.save()
    if not args.no_eval:
        evaluate(runner, config)
    return runner


if __name__ == "__main__":
    main()
