"""Synthetic -> Replica disk-format bridge (counterpart of
isogs_slam_tpu/tools/synth_to_replica.py).

Writes the synthetic multi-view sequence, rendered by this package's
`datasets/synthetic.py`, in the Replica on-disk layout
(gradslam_datasets/replica.py:22-38):

    <root>/<sequence>/results/frame%06d.jpg     RGB, JPEG
    <root>/<sequence>/results/depth%06d.png     uint16, depth * 6553.5
    <root>/<sequence>/traj.txt                  flattened 4x4 c2w per line
    <root>/synthetic_replica.yaml               camera YAML (dataconfig
                                                schema)

so the shipped `configs/replica/splatam.py` runs against it unmodified
(overriding only data.basedir / data.gradslam_data_cfg, path knobs), through
the config loader, the YAML intrinsics and `ReplicaDataset`.

Usage:
  python -m isogs_slam_tpu_torch.tools.synth_to_replica \\
      --out /tmp/synth_replica --frames 30 --height 680 --width 1200
  SPLATAM_SCENE_INDEX=0 python -m isogs_slam_tpu_torch.scripts.splatam \\
      configs/replica/splatam.py --device cuda --end-at 29 \\
      --set data.basedir=/tmp/synth_replica \\
      --set data.gradslam_data_cfg=/tmp/synth_replica/synthetic_replica.yaml
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..datasets.synthetic import SyntheticDataset
from ..io.images import imwrite


def write_replica_layout(out_root: str, sequence: str = "room0",
                         num_frames: int = 30, height: int = 680,
                         width: int = 1200, traj_step: float = 0.004,
                         seed: int = 0, n_per_wall: int | None = None,
                         quality: int = 95, device="cuda"):
    """Render the synthetic scene on `device` and write it in Replica
    layout. Returns the path of the camera YAML."""
    ds = SyntheticDataset(
        num_frames=num_frames, height=height, width=width, seed=seed,
        n_per_wall=n_per_wall or max(400, (height * width) // 40),
        traj_step=traj_step, device=device)
    seq_dir = os.path.join(out_root, sequence)
    res_dir = os.path.join(seq_dir, "results")
    os.makedirs(res_dir, exist_ok=True)

    scale = ds.png_depth_scale  # 6553.5, the Replica convention
    lines = []
    for i in range(num_frames):
        color, depth, _, c2w = ds[i]
        imwrite(os.path.join(res_dir, f"frame{i:06d}.jpg"),
                np.clip(color, 0, 255).astype(np.uint8), quality=quality)
        d16 = np.clip(depth[:, :, 0] * scale, 0, 65535).astype(np.uint16)
        imwrite(os.path.join(res_dir, f"depth{i:06d}.png"), d16)
        lines.append(" ".join(f"{x:.9f}" for x in
                              np.asarray(c2w, np.float64).reshape(-1)))
    with open(os.path.join(seq_dir, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    cam = ds.cam
    yaml_path = os.path.join(out_root, "synthetic_replica.yaml")
    with open(yaml_path, "w") as f:
        f.write(
            "# Synthetic scene written in Replica layout "
            "(tools/synth_to_replica.py)\n"
            "dataset_name: replica\n"
            "camera_params:\n"
            f"  image_height: {height}\n"
            f"  image_width: {width}\n"
            f"  fx: {cam.fx}\n"
            f"  fy: {cam.fy}\n"
            f"  cx: {cam.cx}\n"
            f"  cy: {cam.cy}\n"
            f"  png_depth_scale: {scale}\n"
            "  crop_edge: 0\n")
    return yaml_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="dataset root to create")
    ap.add_argument("--sequence", default="room0")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--traj-step", type=float, default=0.004)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device that renders the frames (cuda or cpu)")
    args = ap.parse_args(argv)
    yaml_path = write_replica_layout(
        args.out, args.sequence, args.frames, args.height, args.width,
        args.traj_step, args.seed, device=args.device)
    print(f"wrote {args.frames} frames to {args.out}/{args.sequence}")
    print("run the Replica config against it with:")
    print(f"  SPLATAM_SCENE_INDEX=0 python -m isogs_slam_tpu_torch.scripts."
          f"splatam configs/replica/splatam.py --device cuda --end-at "
          f"{args.frames - 1} \\\n      --set data.basedir={args.out} "
          f"\\\n      --set data.gradslam_data_cfg={yaml_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
