"""Multi-rank SHARDING-OVERHEAD shape of the view-parallel mapping phase
and the tile-sharded tracker (counterpart of
isogs_slam_tpu/tools/multichip_scaling.py).

THIS MEASURES OVERHEAD, NOT SPEEDUP, wherever the ranks share one card (the
one-card machine this package is checked on: B processes take turns on the
same card, over gloo): the content is the per-step cost of the collectives
and the replicated glue. The JSON says so in its "environment" block, with
the card's name and power limit and the backend.

Times the view-parallel mapping phase (parallel/sharded.py, the program
config["parallel"]["map_views"] = B runs) at B in --ranks with a FIXED
total view-render budget, against the serial map_frame on the same budget,
and the tile-sharded tracker (parallel/track_sharded.py) against the serial
track_frame. Each B > 1 runs as B processes under torch.distributed.run;
B = 1 and the serial baselines run in this process.

  overhead_vs_Bx1(B) = t_step(B) / (B * t_step(1)): the share of a B-view
      step not explained by B one-view steps on one rank;
  overhead_vs_serial(B) = t(B) / t(serial) for the same view budget (the
      tracker: the same frame).

Run:  python -m isogs_slam_tpu_torch.tools.multichip_scaling \\
        [--ranks 1,2,4] [--views 16] [--n-gauss 20000] [--device cuda] \\
        [--out experiments/multichip_scaling.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _scene(n: int, H: int, W: int, dev, seed: int = 0):
    import torch
    from ..core.camera import Camera
    from ..core.gaussians import append_rows, empty_state, new_gaussian_rows
    cam = Camera(width=W, height=H, fx=H, fy=H, cx=W / 2 - 0.5,
                 cy=H / 2 - 0.5)
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cap = 1 << (n - 1).bit_length()
    state = empty_state(max(cap, 2 * n), dev)
    state = append_rows(
        state, new_gaussian_rows(torch.as_tensor(means, device=dev),
                                 torch.as_tensor(rgb, device=dev),
                                 torch.full((n,), 4e-4, device=dev)),
        torch.ones(n, dtype=torch.bool, device=dev), 0)
    S = 8  # keyframe slots
    rng = np.random.default_rng(1)
    kf = dict(
        colors=torch.as_tensor(rng.integers(0, 255, (S, H, W, 3),
                                            dtype=np.uint8), device=dev),
        depths=torch.as_tensor(rng.uniform(1.5, 3.5, (S, H, W)).astype(
            np.float32), device=dev),
        quats=torch.tensor([[1.0, 0, 0, 0]] * S, device=dev),
        trans=torch.as_tensor(rng.uniform(-0.05, 0.05, (S, 3)).astype(
            np.float32), device=dev))
    track = dict(
        gt_im=torch.as_tensor(rng.uniform(0, 1, (3, H, W)).astype(
            np.float32), device=dev),
        gt_d=torch.as_tensor(rng.uniform(1.5, 3.5, (1, H, W)).astype(
            np.float32), device=dev),
        q0=torch.tensor([1.0, 0.002, 0, 0], device=dev),
        t0=torch.tensor([0.01, 0, 0], device=dev))
    return cam, state, kf, track


def _configs(n_iso: int):
    from ..ops.rasterize import RasterConfig
    from ..slam.losses import LossConfig
    from ..slam.mapping import MappingConfig, PruneConfig
    from ..slam.tracking import TrackingConfig
    rcfg = RasterConfig(max_per_tile=128, tile_chunk=48)
    lcfg = LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=50.0, w_iso=2.0, iso_sample_size=1024, iso_k=16,
        calc_iso=True, knn_block=4096, iso_pool_size=n_iso)
    lcfg_t = lcfg._replace(tracking=True, use_sil_for_loss=True, w_flat=0.0,
                           w_iso=0.0, calc_iso=False)
    tcfg = TrackingConfig(num_iters=10, lr_quat=4e-4, lr_trans=2e-3)

    def mk(iters):
        return MappingConfig(
            num_iters=iters, lr_means3d=1e-4, lr_rgb_colors=2.5e-3,
            lr_unnorm_rotations=1e-3, lr_logit_opacities=0.05,
            lr_log_scales=1e-3,
            prune=PruneConfig(False, 0, 0, 10 ** 6, 20, 0.005, 0.005, False,
                              3000))
    return rcfg, lcfg, lcfg_t, tcfg, mk


def _timer(dev, reps):
    import torch

    def timed(fn):
        fn()   # warm-up (kernel build, allocator)
        ts = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts)
    return timed


def _fresh(state):
    return type(state)(*[type(x)(*[p.clone() for p in x])
                         if isinstance(x, tuple) else x.clone()
                         for x in state])


def _sharded_rows(args, dev, B):
    """The rows of B ranks (this process is one of them, or the only one
    at B = 1): the view-parallel phase and the tile-sharded tracker."""
    from ..parallel.dist import barrier, make_mesh
    from ..parallel.sharded import make_multiview_map_phase, replicate
    from ..parallel.track_sharded import make_tracking_frame_sharded
    cam, state0, kf, tr = _scene(args.n_gauss, args.height, args.width, dev)
    rcfg, lcfg, lcfg_t, tcfg, mk = _configs(4096)
    timed = _timer(dev, args.reps)
    mesh = make_mesh(B, dev)
    state0 = replicate(mesh, state0)
    n_steps = max(args.views // B, 1)
    phase = make_multiview_map_phase(mesh, cam, rcfg, lcfg, mk(n_steps * B))
    step_slots = np.arange(n_steps * B).reshape(n_steps, B) % 8

    def run_phase():
        phase(_fresh(state0), kf["colors"], kf["depths"], kf["quats"],
              kf["trans"], step_slots, 0)
        barrier()
    t = timed(run_phase)
    fn = make_tracking_frame_sharded(make_mesh(B, dev), cam, rcfg, lcfg_t,
                                     tcfg)

    def run_track():
        fn(state0.params, state0.alive, tr["q0"], tr["t0"], tr["gt_im"],
           tr["gt_d"])
        barrier()
    t_tr = timed(run_track)
    return {"B": B, "steps": n_steps, "phase_s": t, "step_s": t / n_steps,
            "views_per_s": n_steps * B / t, "track_frame_s": t_tr}


def _card():
    """(name, power limit) as nvidia-smi reports them, else None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
        return out
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="1,2,4",
                    help="comma list of rank counts B")
    ap.add_argument("--views", type=int, default=16,
                    help="total view renders per timed phase")
    ap.add_argument("--n-gauss", type=int, default=20000)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each B > 1 run may take")
    ap.add_argument("--out", default=os.path.join(
        "experiments", "multichip_scaling.json"))
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    from .. import resolve_device
    from ..parallel import dist as pdist
    dev = resolve_device(args.device)

    if args.worker_out is not None:
        # one rank of a B-rank run under torch.distributed.run
        dev = pdist.init_distributed(dev)
        row = _sharded_rows(args, dev, pdist.world_size())
        row["backend"] = pdist.make_mesh(None, dev).backend
        if pdist.is_main():
            with open(args.worker_out, "w") as f:
                json.dump(row, f)
        pdist.shutdown()
        return 0

    card = _card() if dev.type == "cuda" else None
    ranks = [int(b) for b in args.ranks.split(",") if b]
    V = args.views
    results = {
        "WHAT_THIS_MEASURES": (
            "SHARDING OVERHEAD: where the ranks share one device (one "
            "card, or the CPU) the B processes take turns on it, so no "
            "speedup can be measured and the content is overhead_vs_Bx1 / "
            "overhead_vs_serial."),
        "environment": {
            "device": str(dev),
            "card": card,
            "cards_visible": (torch.cuda.device_count()
                              if dev.type == "cuda" else 0),
            "ranks_share_one_device": (dev.type != "cuda" or max(ranks)
                                       > torch.cuda.device_count()),
            "backend": None,   # the B > 1 runs' (below)
            "launcher": "python -m torch.distributed.run --standalone",
            "physical_cpu_cores": os.cpu_count(),
            "torch": torch.__version__,
            "measured": "overhead, not speedup",
        },
        "total_views": V, "n_gauss": args.n_gauss,
        "image": [args.height, args.width], "rows": []}

    # serial baselines in this process
    from ..slam.mapping import map_frame
    from ..slam.tracking import track_frame
    cam, state0, kf, tr = _scene(args.n_gauss, args.height, args.width, dev)
    rcfg, lcfg, lcfg_t, tcfg, mk = _configs(4096)
    timed = _timer(dev, args.reps)
    gen = torch.Generator(device=dev).manual_seed(0)
    slots = (np.arange(V) % 8).tolist()
    t_serial = timed(lambda: map_frame(
        _fresh(state0), kf["colors"], kf["depths"], kf["quats"], kf["trans"],
        slots, cam, rcfg, lcfg, mk(V), generator=gen))
    results["rows"].append({"mode": "serial_map_frame", "B": 1, "steps": V,
                            "phase_s": t_serial,
                            "views_per_s": V / t_serial})
    print(f"serial map_frame: {t_serial:.4f}s for {V} views")
    t_ts = timed(lambda: track_frame(
        state0.params, state0.alive, tr["q0"], tr["t0"], tr["gt_im"],
        tr["gt_d"], cam, rcfg, lcfg_t, tcfg))
    results["rows"].append({"mode": "serial_track_frame", "B": 1,
                            "frame_s": t_ts})
    print(f"serial track_frame: {t_ts:.4f}s/frame")
    del state0, kf, tr

    t1 = None
    for B in ranks:
        if B == 1:
            row = _sharded_rows(args, dev, 1)
            row["backend"] = None
        else:
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "row.json")
                cmd = [sys.executable, "-m", "torch.distributed.run",
                       "--standalone", f"--nproc-per-node={B}", "-m",
                       "isogs_slam_tpu_torch.tools.multichip_scaling",
                       "--worker-out", out, "--views", str(V),
                       "--n-gauss", str(args.n_gauss), "--height",
                       str(args.height), "--width", str(args.width),
                       "--reps", str(args.reps), "--device", args.device]
                subprocess.run(cmd, check=True, timeout=args.timeout)
                with open(out) as f:
                    row = json.load(f)
        if B == 1:
            t1 = row["step_s"]
        mv = {"mode": "multiview_phase", "B": B, "steps": row["steps"],
              "phase_s": row["phase_s"], "step_s": row["step_s"],
              "views_per_s": row["views_per_s"],
              "overhead_vs_serial": row["phase_s"] / t_serial,
              "backend": row["backend"]}
        if t1:
            mv["overhead_vs_Bx1"] = row["step_s"] / (B * t1)
        results["rows"].append(mv)
        results["rows"].append({
            "mode": "track_tiles", "B": B, "frame_s": row["track_frame_s"],
            "overhead_vs_serial": row["track_frame_s"] / t_ts,
            "backend": row["backend"]})
        print(f"B={B} ({row['backend'] or 'one process'}): mapping phase "
              f"{row['phase_s']:.4f}s / {row['steps']} steps "
              f"(overhead vs serial {mv['overhead_vs_serial']:.3f}"
              + (f", vs B x one-view step {mv['overhead_vs_Bx1']:.3f}"
                 if t1 else "")
              + f"); tracking {row['track_frame_s']:.4f}s/frame "
              f"(overhead vs serial {row['track_frame_s'] / t_ts:.3f})")

    results["environment"]["backend"] = next(
        (r["backend"] for r in results["rows"] if r.get("backend")), None)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
