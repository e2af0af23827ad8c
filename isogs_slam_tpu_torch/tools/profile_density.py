"""Steady-state profile of the mesh density pass on the card (counterpart
of isogs_slam_tpu/tools/profile_density.py).

Synthesizes a surface-like Gaussian cloud at the requested scale, runs
mesh.density.density_grid once (allocator and cuBLAS warm-up), grows the
expansion capacity and the per-block list length as compute_density does
(both, at most 6 rounds: the overflow counts both truncations, so growing
the expansion capacity alone need not end it), then reports the MINIMUM
of N timed repeats (the steady state) and the share of voxels above 0.5.
Every clock reading follows a torch.cuda.synchronize().

    python -m isogs_slam_tpu_torch.tools.profile_density \\
        [--n 500000] [--voxel 0.02] [--reps 3] [--device cuda]

Prints one JSON line: the reference's keys, with "backend": "cuda" and the
card's name ("device_name").
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..mesh.density import density_grid, make_grid


def _surface_cloud(n: int, seed: int = 0):
    """Gaussians on the walls of a room-like box (the density workload is
    surface-dominated after IsoGS flattening, not volumetric)."""
    rng = np.random.default_rng(seed)
    per = -(-n // 6)
    pts = []
    for axis in range(3):
        for side in (-1.0, 1.0):
            m = max(per, 1)
            p = rng.uniform(-2.0, 2.0, (m, 3))
            p[:, axis] = side * 2.0 + rng.normal(0, 0.01, m)
            pts.append(p)
    pts = np.concatenate(pts)[:n].astype(np.float32)
    return pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500000)
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-isect-per-gauss", type=float, default=8.0)
    ap.add_argument("--block-chunk", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n = args.n
    means = _surface_cloud(n)
    rng = np.random.default_rng(1)
    log_scales = np.log(rng.uniform(0.01, 0.03, (n, 3))).astype(np.float32)
    log_scales[:, 2] = np.log(0.004)  # flattened flakes (post-IsoGS)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    logit_op = np.full((n, 1), 2.0, np.float32)

    spec = make_grid(means, voxel_size=args.voxel, padding=0.3)
    dims = spec.dims
    max_isect = int(args.max_isect_per_gauss * n)
    max_per_block = 256                     # density_grid's default
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"grid {dims} = {np.prod(dims) / 1e6:.1f}M voxels, "
          f"{spec.num_blocks} blocks, {n} gaussians, "
          f"max_isect {max_isect / 1e6:.1f}M, backend {dev.type} ({name})")

    a = tuple(torch.as_tensor(x, device=dev)
              for x in (means, log_scales, quats, logit_op)) + (
        torch.ones(n, dtype=torch.bool, device=dev),)

    def run():
        sync()
        t0 = time.perf_counter()
        out = density_grid(*a, spec, max_isect=max_isect,
                           max_per_block=max_per_block,
                           block_chunk=args.block_chunk)
        sync()
        return out, time.perf_counter() - t0

    (dens, ovf), t_first = run()
    print(f"first call (warm-up + run): {t_first:.2f}s, "
          f"overflow={int(ovf)}")
    # demand-driven capacity, as compute_density: a truncated density pass
    # under-reports density near block borders
    for _ in range(6):
        if int(ovf) <= 0:
            break
        max_isect = int((max_isect + int(ovf)) * 1.25)
        max_per_block *= 2
        print(f"overflow {int(ovf)}: growing max_isect -> "
              f"{max_isect / 1e6:.1f}M, max_per_block -> {max_per_block}")
        (dens, ovf), t_first = run()

    ts = []
    for _ in range(args.reps):
        (dens, ovf), t = run()
        ts.append(t)
    steady = min(ts)
    occ = float((dens > 0.5).float().mean())
    res = {
        "n_gauss": n, "voxel": args.voxel, "dims": list(dims),
        "blocks": int(spec.num_blocks), "max_isect": max_isect,
        "max_per_block": max_per_block,
        "backend": dev.type, "device_name": name,
        "first_call_s": round(t_first, 4),
        "steady_state_s": round(steady, 4),
        "reps_s": [round(t, 4) for t in ts],
        "overflow": int(ovf),
        "occupied_voxel_frac": round(occ, 4),
    }
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
