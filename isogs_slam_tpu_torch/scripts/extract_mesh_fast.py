"""Fast mesh extraction from an IsoGS checkpoint (counterpart of
isogs_slam_tpu/scripts/extract_mesh_fast.py): block-tiled density grid on
the card (mesh/density.py) + tetrahedral isosurface extraction + largest
component cleaning + PLY/OBJ/STL/TXT export.

    python -m isogs_slam_tpu_torch.scripts.extract_mesh_fast <config.py> \\
        [--checkpoint params800.npz] [--voxel-size 0.02] [--iso-level 1.0]
        [--padding 0.5] [--block-size 16] [--truncate-sigma 3.0]
        [--no-cleaning] [--output mesh.ply] [--device cpu]
        [--shard-devices N]

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m isogs_slam_tpu_torch.scripts.extract_mesh_fast <config.py> \
        --shard-devices 2

The density pass runs on config["primary_device"]: "cuda" unless the
config or `--device cpu` says otherwise. A relative `--output` is joined
onto the run directory, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from ..io.checkpoints import latest_checkpoint, load_checkpoint
from ..mesh.density import compute_density
from ..mesh.marching import (largest_component, marching_tetrahedra,
                             mesh_stats, vertex_normals)
from ..mesh.meshio import write_obj, write_ply_mesh, write_stl
from ..parallel import dist as pdist
from ..slam.config import load_experiment_config
from ..slam.pipeline import primary_device


def resolve_checkpoint(config: dict, checkpoint: str | None):
    """params.npz if present, else the highest params{N}.npz."""
    result_dir = os.path.join(config["workdir"], config["run_name"])
    frame = None
    if checkpoint is None:
        final = os.path.join(result_dir, "params.npz")
        if os.path.exists(final):
            path = final
        else:
            frame, path = latest_checkpoint(result_dir)
            if path is None:
                raise FileNotFoundError(
                    f"No checkpoint found in {result_dir} "
                    f"(expected params.npz or params*.npz)")
            print(f"Auto-selected latest checkpoint: {path} (frame {frame})")
    else:
        path = (checkpoint if os.path.isabs(checkpoint)
                else os.path.join(result_dir, checkpoint))
        m = re.match(r"^params(\d+)\.npz$", os.path.basename(path))
        if m:
            frame = int(m.group(1))
    return path, result_dir, frame


def extract_mesh_from_params(params: dict, voxel_size=0.02, iso_level=1.0,
                             padding=0.5, block_size=16, truncate_sigma=3.0,
                             clean=True, max_per_block=256,
                             shard_devices=0, device="cuda"):
    """checkpoint params dict -> (verts, faces, density_stats dict); the
    density pass runs on `device` (sharded over `shard_devices` ranks of
    the process group when > 1). Rank 0 alone marches the grid: the other
    ranks of a sharded pass return (None, None, stats)."""
    # anti-pancaking: min scale = half voxel
    dens, spec = compute_density(
        params, voxel_size=voxel_size, padding=padding,
        block_size=block_size, truncate_sigma=truncate_sigma,
        min_scale_limit=voxel_size * 0.5, max_per_block=max_per_block,
        shard_devices=shard_devices, device=device)
    stats = {"density_min": float(dens.min()),
             "density_max": float(dens.max()),
             "density_mean": float(dens.mean()),
             "dims": list(spec.dims)}
    if not pdist.is_main():
        return None, None, stats
    verts, faces = marching_tetrahedra(dens, iso_level,
                                       spacing=spec.spacing,
                                       origin=spec.origin)
    if clean and faces.shape[0]:
        verts, faces = largest_component(verts, faces)
    return verts, faces, stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Fast mesh extraction from IsoGS checkpoint")
    p.add_argument("config", type=str)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--iso-level", type=float, default=1.0)
    p.add_argument("--padding", type=float, default=0.5)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--truncate-sigma", type=float, default=3.0)
    p.add_argument("--max-per-block", type=int, default=256)
    p.add_argument("--shard-devices", type=int, default=0,
                   help="shard the density block axis over this many "
                        "ranks (launch with python -m "
                        "torch.distributed.run --nproc-per-node N; "
                        "clamped to the world size, rank 0 writes the "
                        "mesh)")
    p.add_argument("--no-cleaning", action="store_true")
    p.add_argument("--no-show", action="store_true",
                   help="accepted for CLI parity; no interactive viewer")
    p.add_argument("--device", type=str, default=None,
                   help="Override config['primary_device'] (cuda or cpu)")
    args = p.parse_args(argv)

    config = load_experiment_config(args.config)
    if args.device is not None:
        config["primary_device"] = args.device
    dev = primary_device(config)
    if args.shard_devices > 1:
        dev = pdist.init_distributed(dev)
    main_rank = pdist.is_main()
    ckpt_path, result_dir, frame = resolve_checkpoint(config,
                                                      args.checkpoint)
    if main_rank:
        print(f"Loading checkpoint: {ckpt_path}")
    params = load_checkpoint(ckpt_path)
    if main_rank:
        print(f"Loaded {params['means3D'].shape[0]} Gaussians")

    t0 = time.time()
    verts, faces, dstats = extract_mesh_from_params(
        params, voxel_size=args.voxel_size, iso_level=args.iso_level,
        padding=args.padding, block_size=args.block_size,
        truncate_sigma=args.truncate_sigma, clean=not args.no_cleaning,
        max_per_block=args.max_per_block, shard_devices=args.shard_devices,
        device=dev)
    dt = time.time() - t0
    if not main_rank:
        # the other ranks computed their share of the grid; rank 0 writes
        pdist.shutdown()
        return None
    st = mesh_stats(verts, faces)
    print(f"Density stats: {dstats}")
    print(f"Extracted mesh: {st['vertices']} vertices, {st['faces']} faces "
          f"in {dt:.1f}s")

    base_name = (f"mesh_thickened_{frame}" if frame is not None
                 else "mesh_fast")
    if args.output is None:
        out_ply = os.path.join(result_dir, f"{base_name}.ply")
    else:
        out_ply = (args.output if os.path.isabs(args.output)
                   else os.path.join(result_dir, args.output))
        base_name = os.path.splitext(os.path.basename(out_ply))[0]
    out_dir = os.path.dirname(out_ply) or "."
    os.makedirs(out_dir, exist_ok=True)

    vn = vertex_normals(verts, faces) if len(verts) else None
    write_ply_mesh(out_ply, verts, faces, vertex_normals=vn)
    print(f"Mesh saved to: {out_ply}")
    obj_path = os.path.join(out_dir, f"{base_name}.obj")
    stl_path = os.path.join(out_dir, f"{base_name}.stl")
    write_obj(obj_path, verts, faces, vertex_normals=vn)
    write_stl(stl_path, verts, faces)
    print(f"Exported OBJ: {obj_path}\nExported STL: {stl_path}")

    txt_path = os.path.join(out_dir, f"{base_name}.txt")
    with open(txt_path, "w") as f:
        f.write("python " + " ".join(sys.argv) + "\n\n")
        f.write(f"Checkpoint: {ckpt_path}\n")
        if frame is not None:
            f.write(f"Checkpoint frame: {frame}\n")
        f.write(f"Voxel size: {args.voxel_size}\n")
        f.write(f"Iso level: {args.iso_level}\n")
        f.write(f"Block size: {args.block_size}\n")
        f.write(f"No cleaning: {args.no_cleaning}\n")
        f.write(f"Extraction time (s): {dt:.2f}\n")
        for k, v in st.items():
            f.write(f"{k}: {v}\n")
        f.write(json.dumps(dstats) + "\n")
    print(f"Exported log TXT: {txt_path}")
    pdist.shutdown()
    return out_ply


if __name__ == "__main__":
    main()
