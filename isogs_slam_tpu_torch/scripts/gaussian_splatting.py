"""Offline 3D Gaussian Splatting trainer (counterpart of
isogs_slam_tpu/scripts/gaussian_splatting.py): ground-truth-pose multi-view
training with silhouette-driven initialisation and gradient-driven
densification.

    python -m isogs_slam_tpu_torch.scripts.gaussian_splatting \\
        isogs_slam_tpu_torch/configs/synthetic/gaussian_splatting.py \\
        [--device cpu] [--no-eval]

Phase 1 walks the scan once with the ground-truth poses, adding Gaussians
where the silhouette leaves the frame unexplained; phase 2 optimizes the
whole map for train.num_iters_mapping iterations with random frames, an
exponentially decaying means3D learning rate and clone / split
densification (slam/offline.py). Runs on config["primary_device"]: "cuda"
unless the config or `--device cpu` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core import gaussians as G
from ..core import optim
from ..core.camera import Camera
from ..io import checkpoints as ckpt_io
from ..ops.rasterize import RasterConfig
from ..slam.config import copy_config_for_provenance, load_experiment_config
from ..slam.densify import DensifyConfig
from ..slam.offline import OfflineConfig, expon_lr, offline_chunk
from ..slam.pipeline import (_dataset_from_config, _to_chw_frame,
                             primary_device)
from ..slam.pointcloud import add_new_gaussians, initialize_first_frame
from ..utils.common import seed_everything
from ..utils.transforms import rotmat_to_quat
from .splatam import apply_overrides


class OfflineGS:
    """The trainer. It also carries what eval/eval_helpers.eval_sequence
    reads of a SLAM object: device, cam, rcfg, state, cam_rots, cam_trans,
    first_frame_w2c and num_frames.

    Random streams, both from config["seed"]: a numpy default_rng for the
    host draws (each chunk's frames and each iteration's frame) and a
    torch.Generator on the device for the device draws (the log-scale noise
    of new Gaussians and the split noise)."""

    def __init__(self, config: dict):
        self.config = config
        tr = config["train"]
        dc = config["data"]
        self.device = primary_device(config)
        self.output_dir = os.path.join(config["workdir"], config["run_name"])
        self.eval_dir = os.path.join(self.output_dir, "eval")
        os.makedirs(self.eval_dir, exist_ok=True)

        init_h = dc.get("desired_image_height_init",
                        dc["desired_image_height"])
        init_w = dc.get("desired_image_width_init", dc["desired_image_width"])
        self.init_dataset = _dataset_from_config(config, init_h, init_w,
                                                 self.device)
        self.dataset = _dataset_from_config(
            config, dc["desired_image_height"], dc["desired_image_width"],
            self.device)
        self.num_frames = dc.get("num_frames", -1)
        if self.num_frames == -1:
            self.num_frames = len(self.dataset)

        c0, _, intr0, p0 = self.dataset[0]
        self.intrinsics = np.asarray(intr0)[:3, :3]
        self.cam = Camera.from_intrinsics(self.intrinsics, c0.shape[1],
                                          c0.shape[0])
        ci, _, intri, _ = self.init_dataset[0]
        self.init_cam = Camera.from_intrinsics(
            np.asarray(intri)[:3, :3], ci.shape[1], ci.shape[0])
        self.first_frame_w2c = np.linalg.inv(np.asarray(p0, np.float64))

        r = config.get("raster", {})
        self.rcfg = RasterConfig(
            max_per_tile=r.get("max_per_tile", 512),
            isect_per_gaussian=r.get("isect_per_gaussian", 2.5),
            tile_chunk=r.get("tile_chunk", 256))

        dd = tr.get("densify_dict", {})
        lrs = tr["lrs_mapping"]
        self.ocfg = OfflineConfig(
            num_iters=tr["num_iters_mapping"],
            lr_means3d=lrs["means3D"], lr_rgb_colors=lrs["rgb_colors"],
            lr_unnorm_rotations=lrs["unnorm_rotations"],
            lr_logit_opacities=lrs["logit_opacities"],
            lr_log_scales=lrs["log_scales"],
            lr_means3d_final=tr.get("lrs_mapping_means3D_final", 3.2e-6),
            lr_delay_mult=tr.get("lr_delay_mult", 0.01),
            w_im=tr["loss_weights"].get("im", 1.0),
            w_depth=tr["loss_weights"].get("depth", 1.0),
            use_densification=tr.get(
                "use_gaussian_splatting_densification", True),
            densify=DensifyConfig(
                start_after=dd.get("start_after", 500),
                remove_big_after=dd.get("remove_big_after", 3000),
                stop_after=dd.get("stop_after", 5000),
                densify_every=dd.get("densify_every", 100),
                grad_thresh=dd.get("grad_thresh", 0.0002),
                num_to_split_into=dd.get("num_to_split_into", 2),
                removal_opacity_threshold=dd.get(
                    "removal_opacity_threshold", 0.005),
                final_removal_opacity_threshold=dd.get(
                    "final_removal_opacity_threshold", 0.005),
                reset_opacities_every=dd.get("reset_opacities_every", 3000),
                reset_opacities=True),
            chunk_iters=tr.get("chunk_iters", 100),
            frames_per_chunk=tr.get("frames_per_chunk", 16))
        self.sil_thres = tr.get("sil_thres", 0.5)
        seed = int(config.get("seed", 0))
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        # ground-truth poses as (quat, trans) per frame
        self.cam_rots = np.zeros((4, self.num_frames), np.float32)
        self.cam_trans = np.zeros((3, self.num_frames), np.float32)
        self.gt_w2c_all = []
        for t in range(self.num_frames):
            _, _, _, pose = self.dataset[t]
            w2c = np.linalg.inv(np.asarray(pose, np.float64))
            self.gt_w2c_all.append(w2c)
            self.cam_rots[:, t] = rotmat_to_quat(torch.as_tensor(
                w2c[:3, :3], dtype=torch.float32)).numpy()
            self.cam_trans[:, t] = w2c[:3, 3]

        self.state: G.MapState | None = None
        # what optimize() did: per-chunk logs, densification counts, time
        self.stats = {"chunk_loss": [], "densify_counts": [],
                      "chunk_time": [], "n_alive": []}

    # phase 1: silhouette-driven initialisation sweep (ground-truth poses)
    def init_sweep(self):
        cfg = self.config
        granule = cfg.get("capacity_granule", 65536)
        every = cfg["train"].get("add_gaussians_every", 1)
        dist = cfg.get("gaussian_distribution", "isotropic")
        print(f"[offline] init sweep over {self.num_frames} frames")
        for t in range(0, self.num_frames, every):
            color, depth, _, _ = self.init_dataset[t]
            im, d = _to_chw_frame(color, depth, self.device)
            if t == 0:
                n_px = self.init_cam.width * self.init_cam.height
                capacity = G.round_capacity(int(n_px * 2.5), granule)
                self.state = initialize_first_frame(
                    im, d, self.init_cam, capacity,
                    cfg["scene_radius_depth_ratio"],
                    gaussian_distribution=dist, generator=self.gen,
                    device=self.device)
                continue
            used = int(self.state.hwm)
            if used + self.init_cam.width * self.init_cam.height \
                    > self.state.capacity:
                self.state = G.grow_capacity(self.state, G.round_capacity(
                    int(self.state.capacity * 1.5), granule))
            q = torch.as_tensor(self.cam_rots[:, t], device=self.device)
            tr = torch.as_tensor(self.cam_trans[:, t], device=self.device)
            self.state = add_new_gaussians(
                self.state, im, d, q, tr, float(t), self.init_cam, self.rcfg,
                sil_thres=self.sil_thres, gaussian_distribution=dist,
                generator=self.gen)
        print(f"[offline] init done: {int(self.state.num_alive())} "
              f"Gaussians (capacity {self.state.capacity})")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # phase 2: full-map optimization
    def optimize(self, progress_every: int = 10):
        ocfg = self.ocfg
        n_chunks = max(1, ocfg.num_iters // ocfg.chunk_iters)
        opt = optim.init(self.state.params)
        t0 = time.time()
        for ci in range(n_chunks):
            tc = time.time()
            fsel = self.rng.integers(
                0, self.num_frames,
                size=min(ocfg.frames_per_chunk, self.num_frames))
            cols, deps = [], []
            for f in fsel:
                color, depth, _, _ = self.dataset[int(f)]
                cols.append(np.clip(color, 0, 255).astype(np.uint8))
                deps.append(np.asarray(depth[..., 0], np.float32))
            dev = self.device
            frame_colors = torch.as_tensor(np.stack(cols), device=dev)
            frame_depths = torch.as_tensor(np.stack(deps), device=dev)
            frame_quats = torch.as_tensor(self.cam_rots[:, fsel].T,
                                          device=dev)
            frame_trans = torch.as_tensor(self.cam_trans[:, fsel].T,
                                          device=dev)
            it0 = ci * ocfg.chunk_iters
            iter_frames = self.rng.integers(0, len(fsel),
                                            size=ocfg.chunk_iters)
            lr_sched = expon_lr(
                np.arange(it0 + 1, it0 + ocfg.chunk_iters + 1),
                ocfg.lr_means3d, ocfg.lr_means3d_final, ocfg.lr_delay_mult,
                ocfg.num_iters)
            self.state, opt, log, counts = offline_chunk(
                self.state, opt, frame_colors, frame_depths, frame_quats,
                frame_trans, iter_frames, lr_sched, it0, self.cam, self.rcfg,
                ocfg, generator=self.gen)
            ln = log.cpu().numpy()
            self._sync()
            self.stats["chunk_time"].append(time.time() - tc)
            self.stats["chunk_loss"].append(ln)
            self.stats["densify_counts"].append(
                [int(x) for x in counts.cpu()])
            self.stats["n_alive"].append(int(self.state.num_alive()))
            if (ci + 1) % progress_every == 0 or ci == n_chunks - 1:
                print(f"[offline] iter {it0 + ocfg.chunk_iters}/"
                      f"{ocfg.num_iters} loss {ln[-1, 0]:.4f} "
                      f"(im {ln[-1, 1]:.4f} d {ln[-1, 2]:.4f}) "
                      f"n={self.stats['n_alive'][-1]} "
                      f"[{time.time() - t0:.0f}s]")
        if ocfg.use_densification:
            c = np.sum(self.stats["densify_counts"], axis=0)
            print(f"[offline] densification: {int(c[0])} cloned, "
                  f"{int(c[1])} split, {int(c[2])} rows dropped at capacity "
                  f"{self.state.capacity} (high-water mark "
                  f"{int(self.state.hwm)})")

    def save(self):
        st = G.compact(self.state)
        n = int(st.hwm)
        p = st.params

        def host(a):
            return a[:n].cpu().numpy()

        params = {"means3D": host(p.means3d),
                  "rgb_colors": host(p.rgb_colors),
                  "unnorm_rotations": host(p.unnorm_rotations),
                  "logit_opacities": host(p.logit_opacities),
                  "log_scales": host(p.log_scales)}
        dc = self.config["data"]
        ckpt_io.save_checkpoint(
            self.output_dir, self.num_frames - 1, params,
            self.cam_rots[None], self.cam_trans[None], host(st.timestep),
            self.intrinsics, self.first_frame_w2c,
            dc["desired_image_width"], dc["desired_image_height"],
            self.gt_w2c_all, [])
        print(f"[offline] checkpoint saved to {self.output_dir}")


def offline_splatting(config: dict) -> OfflineGS:
    runner = OfflineGS(config)
    runner.init_sweep()
    runner.optimize()
    runner.save()
    return runner


def _cli_config(argv, description):
    """Parse `experiment [--no-eval] [--device D] [--set KEY=VALUE ...]`;
    returns (args, config) with the overrides and the device applied."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("experiment", type=str,
                        help="Path to experiment config .py")
    parser.add_argument("--no-eval", action="store_true",
                        help="Skip the final evaluation pass")
    parser.add_argument("--device", type=str, default=None,
                        help="Override config['primary_device'] "
                             "(cuda or cpu)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", dest="overrides",
                        help="Override a config entry by dotted path, as "
                             "the SLAM CLI's --set (e.g. --set "
                             "train.num_iters_mapping=300). Repeatable.")
    args = parser.parse_args(argv)
    config = load_experiment_config(args.experiment)
    apply_overrides(config, args.overrides)
    if args.device is not None:
        config["primary_device"] = args.device
    config.setdefault("primary_device", "cuda")
    seed_everything(config.get("seed", 0))
    results_dir = os.path.join(config["workdir"], config["run_name"])
    copy_config_for_provenance(args.experiment, results_dir)
    return args, config


def evaluate(runner, config):
    """eval_sequence of a trained runner into its eval directory."""
    from ..eval.eval_helpers import eval_sequence
    runner.eval_results = eval_sequence(
        runner.dataset, runner, runner.eval_dir, sil_thres=runner.sil_thres,
        mapping_iters=1, add_new_gaussians=True,
        eval_every=config.get("eval_every", 5), num_frames=runner.num_frames)
    return runner.eval_results


def main(argv=None):
    args, config = _cli_config(argv, "Offline 3DGS trainer")
    runner = offline_splatting(config)
    if not args.no_eval:
        evaluate(runner, config)
    return runner


if __name__ == "__main__":
    main()
