"""Export a checkpoint's Gaussians to a 3DGS-viewer-compatible PLY
(counterpart of isogs_slam_tpu/scripts/export_ply.py; numpy only): RGB ->
SH0 via C0 = 0.28209..., fields x,y,z,nx,ny,nz,f_dc_0..2,opacity,
scale_0..2,rot_0..3 (log scales and logit opacities stored raw, as 3DGS
viewers expect).

    python -m isogs_slam_tpu_torch.scripts.export_ply <config.py>
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.checkpoints import latest_checkpoint, load_checkpoint
from ..mesh.meshio import write_ply_points
from ..slam.config import load_experiment_config

C0 = 0.28209479177387814


def rgb_to_spherical_harmonic(rgb):
    return (rgb - 0.5) / C0


def spherical_harmonic_to_rgb(sh):
    return sh * C0 + 0.5


def save_ply(path, means, scales, rotations, rgbs, opacities):
    if scales.shape[1] == 1:
        scales = np.tile(scales, (1, 3))
    colors = rgb_to_spherical_harmonic(rgbs)
    normals = np.zeros_like(means)
    props = {}
    for i, n in enumerate("xyz"):
        props[n] = means[:, i]
    for i, n in enumerate(("nx", "ny", "nz")):
        props[n] = normals[:, i]
    for i in range(3):
        props[f"f_dc_{i}"] = colors[:, i]
    props["opacity"] = opacities[:, 0]
    for i in range(3):
        props[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        props[f"rot_{i}"] = rotations[:, i]
    write_ply_points(path, props)
    print(f"Saved PLY format Splat to {path}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", type=str)
    args = p.parse_args(argv)
    config = load_experiment_config(args.config)
    result_dir = os.path.join(config["workdir"], config["run_name"])
    final = os.path.join(result_dir, "params.npz")
    if os.path.exists(final):
        params_path, ply_name = final, "splat.ply"
    else:
        frame, params_path = latest_checkpoint(result_dir)
        if params_path is None:
            raise FileNotFoundError(f"No params file found in {result_dir}")
        ply_name = f"splat_{frame}.ply"
    print(f"Loading: {params_path}")
    params = load_checkpoint(params_path)
    out = os.path.join(result_dir, ply_name)
    save_ply(out, params["means3D"], params["log_scales"],
             params["unnorm_rotations"], params["rgb_colors"],
             params["logit_opacities"])
    return out


if __name__ == "__main__":
    main()
