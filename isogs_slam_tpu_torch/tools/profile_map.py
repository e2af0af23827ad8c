"""Profile the mapping / tracking step at bench scale (counterpart of
isogs_slam_tpu/tools/profile_map.py).

Builds the JAX tool's synthetic scene (first-frame init, densified from two
more views, a 4-keyframe window) through this package's modules, runs
--phases mapping phases (or, with --track, one tracking frame) under
torch.profiler after a warm-up, and prints the top ops by device time
(CUDA time on the card, CPU time on the CPU), the counterpart of the JAX
tool's top XLA ops; --trace-dir writes the Chrome trace.

Usage:
  python -m isogs_slam_tpu_torch.tools.profile_map [--h 680 --w 1200]
      [--phases 2] [--track] [--top 40] [--trace-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import time

import torch


def build_scene(H, W, map_iters, tile_sub=1, cull=False, tight_rect=False,
                isect_per_gaussian=2.5, isect_cap=0, vmap_bins=False,
                device="cuda"):
    import numpy as np

    from ..core import gaussians as G
    from ..datasets.synthetic import SyntheticDataset
    from ..ops.rasterize import RasterConfig
    from ..slam.losses import LossConfig
    from ..slam.mapping import MappingConfig, PruneConfig
    from ..slam.pointcloud import add_new_gaussians, initialize_first_frame
    from ..utils.transforms import rotmat_to_quat

    dev = torch.device(device)
    n_wall = max(400, (H * W) // 40)
    ds = SyntheticDataset(num_frames=8, height=H, width=W,
                          n_per_wall=n_wall, device=dev)
    cam = ds.cam
    rcfg = RasterConfig(tile_cull=cull, tight_rect=tight_rect,
                        isect_per_gaussian=isect_per_gaussian,
                        max_isect_cap=isect_cap)
    lcfg = LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=50.0, w_iso=2.0, iso_sample_size=8192, iso_k=16,
        calc_iso=True, knn_block=8192)
    mcfg = MappingConfig(
        num_iters=map_iters, lr_means3d=0.0001, lr_rgb_colors=0.0025,
        lr_unnorm_rotations=0.001, lr_logit_opacities=0.05,
        lr_log_scales=0.001,
        prune=PruneConfig(True, 0, 0, 20, 20, 0.005, 0.005, False, 500),
        tile_subsample=tile_sub, vmap_bins=vmap_bins)
    gen = torch.Generator(device=dev).manual_seed(0)

    def frame(i):
        color, depth, _, pose = ds[i]
        im = torch.as_tensor(np.asarray(color, np.float32), device=dev
                             ).permute(2, 0, 1) / 255.0
        d = torch.as_tensor(np.asarray(depth, np.float32), device=dev
                            ).permute(2, 0, 1)
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = rotmat_to_quat(torch.as_tensor(w2c[:3, :3], dtype=torch.float32))
        return (im, d, q.to(dev),
                torch.as_tensor(w2c[:3, 3], dtype=torch.float32, device=dev))

    im0, d0, _, _ = frame(0)
    capacity = G.round_capacity(int(H * W * 1.5), 65536)
    state = initialize_first_frame(im0, d0, cam, capacity, 3.0,
                                   generator=gen, device=dev)
    # densify from a couple more views to reach bench-scale N
    for i in (2, 4):
        im, d, q, t = frame(i)
        state = add_new_gaussians(state, im, d, q, t, float(i), cam, rcfg,
                                  sil_thres=0.5, generator=gen)
    S = 4
    frames = [frame(i) for i in range(S)]
    kf_colors = torch.stack([(f[0].permute(1, 2, 0) * 255).to(torch.uint8)
                             for f in frames])
    kf_depths = torch.stack([f[1][0] for f in frames])
    kf_quats = torch.stack([f[2] for f in frames])
    kf_trans = torch.stack([f[3] for f in frames])
    return (state, kf_colors, kf_depths, kf_quats, kf_trans, cam, rcfg,
            lcfg, mcfg, frame, gen)


def top_ops(prof, top=40, cuda=True):
    """Rows (name, ms, share) of the profile's largest items, largest
    first, and their total: on the card the device's own events (kernels,
    copies) by name and CUDA time (an operator's row would count its
    kernels a second time), without one the operators by self CPU time."""
    by = {}
    if cuda:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3
    else:
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0:
                by[e.key] = e.self_cpu_time_total / 1e3
    total = sum(by.values())
    rows = sorted(by.items(), key=lambda r: -r[1])[:top]
    return [(n, ms, ms / max(total, 1e-12)) for n, ms in rows], total


# the device lanes of a torch.profiler Chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_trace(trace_dir, top=40):
    """Sum device time by op name from the newest Chrome trace under
    trace_dir (`--trace-dir`'s trace.json, or a .json.gz), print the top
    ops and return {name: ms}; None when there is no trace."""
    paths = [p for ext in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", ext), recursive=True)]
    if not paths:
        print("no trace.json found under", trace_dir)
        return None
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    by_op = {}
    total = 0.0
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        dur = e.get("dur", 0) / 1e3  # us -> ms
        name = e.get("name", "?")
        by_op[name] = by_op.get(name, 0.0) + dur
        total += dur
    print(f"\n=== device op time (total {total:.1f} ms) "
          f"from {os.path.basename(path)} ===")
    for name, ms in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:10.2f} ms  {100*ms/max(total,1e-9):5.1f}%  {name[:110]}")
    return by_op


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--track", action="store_true",
                    help="profile tracking instead of mapping")
    ap.add_argument("--trace-dir", default=None,
                    help="write the Chrome trace (trace.json) here")
    ap.add_argument("--tile-sub", type=int, default=1,
                    help="mapping.tile_subsample (fast-mapping mode); with "
                         "--track, tracking.tile_subsample")
    ap.add_argument("--tight-rect", action="store_true",
                    help="enable raster.tight_rect")
    ap.add_argument("--isect-per-gaussian", type=float, default=2.5,
                    help="static intersection capacity multiplier")
    ap.add_argument("--cull", action="store_true",
                    help="enable raster.tile_cull")
    ap.add_argument("--isect-cap", type=int, default=0,
                    help="static isect capacity override in rows "
                         "(raster.max_isect_cap; 0 = N-proportional)")
    ap.add_argument("--vmap-bins", action="store_true",
                    help="bin the phase's slots with one batched sort "
                         "(mapping.vmap_bins)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    (state, kf_colors, kf_depths, kf_quats, kf_trans, cam, rcfg, lcfg,
     mcfg, frame, gen) = build_scene(
        args.h, args.w, args.iters, args.tile_sub, args.cull,
        args.tight_rect, args.isect_per_gaussian, args.isect_cap,
        args.vmap_bins, dev)
    print("n_gaussians:", int(state.num_alive()), flush=True)
    rng = np.random.default_rng(0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])

    if args.track:
        from ..slam.tracking import TrackingConfig, track_frame
        rcfg_t = rcfg._replace(max_per_tile=256)
        lcfg_t = lcfg._replace(tracking=True, use_sil_for_loss=True,
                               sil_thres=0.99, w_flat=0.0, w_iso=0.0,
                               calc_iso=False)
        tcfg = TrackingConfig(num_iters=10, lr_quat=0.0004, lr_trans=0.002,
                              tile_subsample=args.tile_sub)
        im, d, q, t = frame(1)

        def run():
            res = track_frame(state.params, state.alive, q, t, im, d, cam,
                              rcfg_t, lcfg_t, tcfg)
            sync()
            return res
        run()   # warm-up (kernel build, allocator)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run()
        dt = time.perf_counter() - t0
        print(f"1 tracking frame x {tcfg.num_iters} iters: {dt:.3f}s "
              f"(profiler on)")
    else:
        from ..slam.mapping import map_frame

        def run(st):
            slots = rng.integers(0, kf_quats.shape[0], size=args.iters)
            st, mlog, _ = map_frame(st, kf_colors, kf_depths, kf_quats,
                                    kf_trans, slots, cam, rcfg, lcfg, mcfg,
                                    generator=gen)
            sync()
            return st
        state = run(state)   # warm-up
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(args.phases):
                state = run(state)
        dt = time.perf_counter() - t0
        print(f"{args.phases} phases x {args.iters} iters: {dt:.3f}s "
              f"({dt / args.phases / args.iters * 1000:.1f} ms/iter incl. "
              f"fixed, profiler on)")

    rows, total = top_ops(prof, args.top, cuda)
    if cuda:
        print(f"\n=== device time by kernel (total {total:.1f} ms = "
              f"{total / 1e3 / dt:.3f} of the {dt:.3f} s wall time, "
              f"profiler on) ===")
    else:
        print(f"\n=== CPU (no card) op time (total {total:.1f} ms) ===")
    for name, ms, share in rows:
        print(f"{ms:10.2f} ms  {100 * share:5.1f}%  {name[:110]}")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print("trace written to:", path)
    return rows


if __name__ == "__main__":
    main()
