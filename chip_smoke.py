#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isogs_slam_tpu_torch) on one
NVIDIA card.

Phases, in order (each prints its elapsed time; any failure exits non-zero
before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (one process per source,
     all at once) and print ptxas' registers / shared memory / spills;
  3. hold every kernel against its plain PyTorch version at the shapes the
     paths below give it, on inputs from a real render of the synthetic
     room at 1200x680: composite forward/backward at K = 256 (tracking),
     K = 512 (mapping, bf16 backward), K = 768 and 1024 (the slot counts
     the pipeline escalates to), at the 600x340 camera of the tracking
     pyramid (836 tiles, partial tiles on both edges), and on the virtual
     single-row grids of the fast modes (tiles_x = T): every 4th tile of
     both tracking cameras (T = 806 and 209) and a mapping stripe of 13
     tile rows (T = 975, bf16 backward) at K = 512, 768 and 1024; the
     cameras only 5g-5i render at (EXTRA_CAMERAS): the live demo's 480x360
     (T = 690, a half-empty last tile row) at K = 256 (f32 backward), 512,
     768 and 1024, the viewers' 600x340 and 240x180 at K = 512 (T = 836,
     180) and test_installation's 64x48 at K = 128 (T = 12); the
     tile-to-image crop at three cameras; segment reduce at N = capacity on
     all tiles' rows and on a stripe's rows only; also the plain PyTorch
     form of the backward kernel's algebra against autograd through the
     plain forward; time kernel, plain version and (segment reduce)
     torch.segment_reduce;
  3b. "subset route": render_tiles_subset's two backward routes (index_add_
     of the rows against expansion scatter + segment reduce) at the
     stripe's shape and at a quarter of it: same gradients, both times,
     and the route "auto" takes at each (kernel C from 256 Ki rows, the
     reference's crossover: the stripe, not the quarter);
  3c. "cull": tile_cull and tight_rect on the full-width scene give the
     plain binning's image and gradients; intersection counts, summed
     tile counts and the compositing kernels' times with and without;
  4. the per-frame step driven by hand (the earlier path, cut in depth):
     first-frame init, two tracking frames from the ground-truth pose, one
     more tracking frame for each tracking refinement (GN polish, fan,
     Polyak, early stop, rebin_every_iter), densify + 10 mapping
     iterations, then 10 more with in-mapping clone / split densification
     every 5th iteration (threshold: the 90th percentile of the rows'
     |d loss / d(u, v)| at this size), with the kernels' launch counters
     set to 0 before and read after;
  5. the pipeline paths: the port's CLI (scripts.splatam.main) in-process
     at 1200x680 with evaluation and checkpoints into a temporary run
     directory, launch counters set to 0 before and read after each: the
     exact configuration (configs/synthetic/full_res.py, `--end-at 15`)
     and the fast one (configs/synthetic/full_res_fastlegal.py,
     `--end-at 30`); prints timings, tile-list reuse, cap escalations,
     capacity growths, peak memory, the quality metrics and the launch
     counters, and fails on a kernel that was not launched, a non-finite
     loss or parameter, a tracking mask under 0.1, ATE >= 2 cm or
     PSNR <= 25 dB; between the two, on the exact run's last checkpoint:
  5c. post-SLAM optimization (scripts.post_splatam_opt.PostSLAMOpt on
     configs/synthetic/post_splatam_opt_fullres.py, 400 iterations at
     1200x680 on the SLAM run's poses, then eval): fails on non-finite
     values, PSNR <= 25 dB or an ATE that is not the SLAM run's;
  5d. the offline trainer (scripts.gaussian_splatting.offline_splatting on
     configs/synthetic/gaussian_splatting.py at 1200x680, 16 frames, 300
     iterations, clone / split at 100 and 200 above the 90th percentile of
     the rows' |d loss / d(u, v)| at this size, then eval): fails unless it
     densified and its loss fell, on non-finite values or PSNR <= 25 dB;
  5e. novel views (scripts.eval_novel_view.main on 5c's checkpoint);
  5f. the mesh path on 5c's checkpoint: scripts.extract_mesh_fast.main
     (--device cuda, 2 cm voxel, iso 1.0, the per-block lists starting at
     4096 candidates), the density pass timed alone
     (first and second call) with its grid held against a float64
     evaluation of the same truncated sum on 16 sampled non-empty blocks
     (fails above mesh.density.DENSITY_F64_RTOL of the grid's max), the
     marching and largest-component routes (native library, built with
     native/build.sh at first use when g++ is there, else numpy) and
     times, a ground-truth room from tools.synth_gt_mesh, and
     scripts.eval_mesh_geometry.main --render-eval on 4 poses (fails on an
     empty or non-finite mesh, accuracy >= 5 cm or a z-buffer footprint
     warning), then tools.profile_density at 500,000 Gaussians; the mesh
     path launches none of the kernels (the render eval's dataset frames
     are rendered with the compositing forward, not counted);
  after the fast pipeline path, a second run of it with the same seed:
     both ATEs and their difference (kernel C carries the mapping
     stripe's backward; the launch counts must show it);
  5g. the shipped configs/replica/splatam.py as it is (1200x680, 10
     tracking and 40 mapping iterations) through the CLI on 16 frames that
     tools.synth_to_replica writes in Replica layout (JPEG, uint16 PNG,
     traj.txt, camera YAML), with eval and the phase-5 gates (the mask's
     at the pipeline's own 1%: this config tracks at sil_thres 0.99); then
     tools.compare_expected against configs/replica/expected_metrics.json
     (real room0 numbers: information, not a gate);
  5h. the live demo at configs/iphone/online_demo.py's 480x360: a writer
     thread streams the synthetic scene at 10 Hz into a capture directory
     while scripts.iphone_demo runs SLAM on it (30 frames, eval; finite
     values, quality printed), then viz_scripts.online_recon on its
     checkpoints;
  5i. the viewers on 5g's checkpoint: viz_scripts.final_recon (replay,
     8-frame orbit, depth mode) at --downscale 2, one pose at downscale 1
     against the SLAM object's own render, --sh on a copy with random
     higher bands (SH colours card against CPU, the frame against the
     card's render of the CPU's colours), scripts.test_installation and
     scripts.model_browser --text over 5g's and 5h's runs;
  6. the `kernels` JSON line;
  7. the result line {"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py
(`--profile` adds, after each pipeline path, a torch.profiler table of one
more tracking frame and mapping phase of that path, and after 5c one of
one more post-opt chunk.)
"""
from __future__ import annotations

import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

H, W = 680, 1200
TRACK_ITERS, MAP_ITERS, N_FRAMES = 10, 10, 2     # the hand-driven path
END_AT_EXACT, END_AT_FAST = 15, 30             # the pipeline paths
N_REPLICA = 16                  # 5g: frames of the Replica-layout bridge
# the shipped configs track at sil_thres 0.99, where the synthetic scene's
# single-sheet walls leave a small mask by design (the iso target holds the
# silhouette near 0.9-0.99: NOTES.md:1358-1362; 5g measured a minimum of
# 0.051 at ATE 0.18 cm on the H100): 5g fails at the pipeline's own
# frozen-pose line, a mask under 1% (slam/pipeline.py's warning), not at
# the 0.1 that the sil_thres-0.5 configs of phase 5 meet
REPLICA_MIN_MASK = 0.01
LIVE_H, LIVE_W, LIVE_HZ, N_LIVE = 360, 480, 10.0, 30   # 5h: the live demo
SUB = 4                     # the fast configuration's tile_subsample
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SOURCES = {"composite_fwd": "isogs_slam_tpu_torch/csrc/composite.cu",
           "composite_bwd": "isogs_slam_tpu_torch/csrc/composite.cu",
           "segreduce": "isogs_slam_tpu_torch/csrc/segreduce.cu"}
REPLACES = {
    "composite_fwd": "isogs_slam_tpu/ops/pallas_composite.py:498",
    "composite_bwd": "isogs_slam_tpu/ops/pallas_composite.py:539",
    "segreduce": "isogs_slam_tpu/ops/segreduce.py:88"}


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps, warm=1):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pair_counts(gdata, counts, tiles_x, chunk=32):
    """(evaluated, included, evaluated by the backward) (slot, pixel) pairs
    of this input: the forward evaluates a pixel's slots up to its
    termination slot (or its tile's count); the backward up to the pixel's
    last included slot, since it must evaluate `power` for a pair to know
    that it does not contribute."""
    import torch
    from isogs_slam_tpu_torch.ops.composite import (ALPHA_MAX, ALPHA_MIN,
                                                    T_EPS, TILE)
    T, K, _ = gdata.shape
    ev = inc = ev_b = 0
    ks = torch.arange(1, K + 1, device=gdata.device)[None, :, None]
    px = torch.arange(TILE, device=gdata.device, dtype=torch.float32)
    for s in range(0, T, chunk):
        g = gdata[s:s + chunk]
        tid = torch.arange(s, s + g.shape[0], device=gdata.device)
        x = ((tid % tiles_x) * TILE)[:, None] + px.repeat(TILE)[None]
        y = ((tid // tiles_x) * TILE)[:, None] + px.repeat_interleave(
            TILE)[None]
        dx = g[..., 0:1] - x[:, None, :]
        dy = g[..., 1:2] - y[:, None, :]
        power = (-0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy)
                 - g[..., 3:4] * dx * dy)
        alpha = torch.clamp(g[..., 5:6] * torch.exp(power), max=ALPHA_MAX)
        cnt = counts[s:s + chunk].long()
        valid = torch.arange(K, device=g.device)[None, :] < cnt[:, None]
        contrib = (power <= 0) & (alpha >= ALPHA_MIN) & valid[..., None]
        one_m = 1 - torch.where(contrib, alpha, torch.zeros_like(alpha))
        t_excl = torch.cumprod(one_m, 1) / one_m
        include = contrib & (t_excl * one_m >= T_EPS)
        fail = contrib & ~include
        first = torch.where(fail.any(1), fail.float().argmax(1) + 1,
                            cnt[:, None].expand(-1, fail.shape[2]))
        ev += int(first.sum())
        inc += int(include.sum())
        ev_b += int((include * ks).amax(1).sum())
    return ev, inc, ev_b


def scene(dev, n_frames=N_FRAMES):
    """The Replica-config slice (bench.py:99-150): dataset, camera, map
    capacity and the mapping / tracking raster configs."""
    from isogs_slam_tpu_torch.core.gaussians import round_capacity
    from isogs_slam_tpu_torch.datasets.synthetic import SyntheticDataset
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    ds = SyntheticDataset(num_frames=n_frames + 2, height=H, width=W,
                          n_per_wall=max(400, (H * W) // 40), device=dev)
    capacity = round_capacity(int(H * W * 1.5), 65536)
    rcfg = RasterConfig(max_per_tile=512)
    return ds, ds.cam, capacity, rcfg, rcfg._replace(max_per_tile=256)


def load_frame(ds, i, dev):
    """(image [3,H,W] in 0..1, depth [1,H,W], w2c quaternion, w2c
    translation) of frame i, on the card."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.utils.transforms import rotmat_to_quat
    color, depth, _, pose = ds[i]
    im = torch.as_tensor(color, device=dev).permute(2, 0, 1) / 255.0
    d = torch.as_tensor(depth, device=dev).permute(2, 0, 1)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    q = rotmat_to_quat(torch.as_tensor(w2c[:3, :3], dtype=torch.float32))
    return (im.contiguous(), d.contiguous(), q.to(dev),
            torch.as_tensor(w2c[:3, 3], dtype=torch.float32, device=dev))


def composite_inputs(frames, cam, capacity, rcfg, rcfg_track, dev):
    """The compositing kernels' inputs at the paths' shapes, from a real
    render, as {tag: dict(g=records, cnt=counts, tiles_x=, bdt=backward
    dtype, desc=)}: "track": frame 1's slot table [T, 256, 10] at its
    ground-truth pose; "pyramid": the same at the 600x340 camera of pyramid
    level 1; "map", "map768", "map1024": the fused table at keyframe 0's
    pose gathered by bins of K = 512, 768 and 1024; "track_sub",
    "pyramid_sub": every SUB-th tile of the two tracking cameras, and
    "stripe", "stripe768", "stripe1024": a mapping stripe of the three
    mapping binnings, each cut by the port's own subset functions onto a
    virtual single-row grid (tiles_x = T). Also returns what the later
    phases reuse: {"state": the map, "table": the fused table, "proj":
    its projection, "bins": {K: binning}}."""
    import torch
    from isogs_slam_tpu_torch.ops.rasterize import (
        _slot_gdata, _virtual_row_shift, bin_gaussians, gather_raw_table,
        project_gaussians)
    from isogs_slam_tpu_torch.slam.mapping import select_stripe, stripe_shape
    from isogs_slam_tpu_torch.slam.pointcloud import initialize_first_frame
    from isogs_slam_tpu_torch.slam.tracking import bin_at_pose, pyramid_cam
    from isogs_slam_tpu_torch.utils.transforms import transform_to_frame
    gen = torch.Generator(device=dev).manual_seed(0)
    im0, d0, q0, t0_ = frames[0]
    state0 = initialize_first_frame(im0, d0, cam, capacity, 3.0,
                                    generator=gen, device=dev)
    p0 = state0.params
    with torch.no_grad():
        # tracking records (K = 256): frame 1's slot table at its GT pose
        q1, t1 = frames[1][2], frames[1][3]
        out = {}
        for tag, c in (("track", cam), ("pyramid", pyramid_cam(cam, 1))):
            b = bin_at_pose(p0, state0.alive, q1, t1, 8.0, c, rcfg_track)
            g = _slot_gdata(gather_raw_table(p0, b.tile_gauss), q1, t1,
                            c).contiguous()
            out[tag] = dict(g=g, cnt=b.tile_count, tiles_x=c.tiles_x,
                            bdt=torch.float32, bins=b,
                            desc=f"camera {c.width}x{c.height}")
            # the fast tracker's strided subset on its virtual row
            ts = max(c.num_tiles // SUB, 1)
            sel = torch.arange(ts, device=dev) * SUB
            gs = _slot_gdata(gather_raw_table(p0, b.tile_gauss[sel]), q1,
                             t1, c, tile_ids=sel)
            gs = (gs + _virtual_row_shift(sel, c, 10, gs.dtype)).contiguous()
            out[tag + "_sub"] = dict(
                g=gs, cnt=b.tile_count[sel].contiguous(), tiles_x=ts,
                bdt=torch.float32, bins=None,
                desc=f"every {SUB}th tile of {c.width}x{c.height} on a "
                     f"virtual row")
        # mapping records (K = 512): the fused table at keyframe 0's pose
        mc, qc = transform_to_frame(p0.means3d, p0.unnorm_rotations, q0,
                                    t0_, gaussians_grad=False,
                                    camera_grad=False)
        proj = project_gaussians(mc, qc, p0.log_scales, state0.alive, cam)
        op = torch.where(proj.valid,
                         torch.sigmoid(p0.logit_opacities[:, 0]),
                         torch.zeros_like(proj.u))
        table = torch.stack([proj.u, proj.v, proj.conic[:, 0],
                             proj.conic[:, 1], proj.conic[:, 2], op,
                             p0.rgb_colors[:, 0], p0.rgb_colors[:, 1],
                             p0.rgb_colors[:, 2], mc[:, 2]], dim=1)
        rows_core, rows_w, _, _ = stripe_shape(cam.tiles_y, cam.tiles_x, SUB)
        sel, _ = select_stripe(1, cam.tiles_y, cam.tiles_x, rows_core,
                               rows_w, dev)
        shift = _virtual_row_shift(sel, cam, 10, table.dtype)
        bins = {}
        for tag, k in (("", rcfg.max_per_tile), ("768", 768),
                       ("1024", 1024)):
            b = bin_gaussians(proj, cam, rcfg._replace(max_per_tile=k),
                              emit_exp=True)
            bins[k] = b
            out["map" + tag] = dict(
                g=table[b.tile_gauss].contiguous(), cnt=b.tile_count,
                tiles_x=cam.tiles_x, bdt=torch.bfloat16, bins=b,
                desc=f"camera {cam.width}x{cam.height}")
            out["stripe" + tag] = dict(
                g=(table[b.tile_gauss[sel]] + shift).contiguous(),
                cnt=b.tile_count[sel].contiguous(), tiles_x=sel.shape[0],
                bdt=torch.bfloat16, bins=None,
                desc=f"stripe of {rows_w} tile rows on a virtual row")
    return out, dict(state=state0, table=table, proj=proj, bins=bins,
                     stripe_sel=sel, pose0=(q0, t0_))


# the cameras that only phases 5g-5i render at, as (tag, width, height,
# ((K, backward dtype), ...)): the live demo at 480x360 (30 x 23 tiles, the
# last row half empty; tracking K = 256, mapping 512 and the escalations),
# the viewers at the default --downscale 2 of 1200x680 and of 480x360, and
# test_installation's 64x48 scene at K = 128; intrinsics of the synthetic
# dataset at that size
EXTRA_CAMERAS = (
    ("live", 480, 360, ((256, "f32"), (512, "bf16"), (768, "bf16"),
                        (1024, "bf16"))),
    ("viewer", 600, 340, ((512, "bf16"),)),
    ("online", 240, 180, ((512, "bf16"),)),
    ("install", 64, 48, ((128, "bf16"),)),
)


def camera_inputs(ctx, rcfg, dev):
    """Phase 3's inputs at EXTRA_CAMERAS, in composite_inputs' format: the
    fused table of the frame-0 map at keyframe 0's pose, projected through
    each camera and gathered by bins of each K."""
    import torch
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (bin_gaussians,
                                                    project_gaussians)
    from isogs_slam_tpu_torch.utils.transforms import transform_to_frame
    p0, alive = ctx["state"].params, ctx["state"].alive
    q0, t0_ = ctx["pose0"]
    out = {}
    with torch.no_grad():
        mc, qc = transform_to_frame(p0.means3d, p0.unnorm_rotations, q0,
                                    t0_, gaussians_grad=False,
                                    camera_grad=False)
        for tag, w, h, ks in EXTRA_CAMERAS:
            c = Camera(width=w, height=h, fx=0.75 * w, fy=0.75 * w,
                       cx=w / 2 - 0.5, cy=h / 2 - 0.5)
            proj = project_gaussians(mc, qc, p0.log_scales, alive, c)
            op = torch.where(proj.valid,
                             torch.sigmoid(p0.logit_opacities[:, 0]),
                             torch.zeros_like(proj.u))
            table = torch.stack([proj.u, proj.v, proj.conic[:, 0],
                                 proj.conic[:, 1], proj.conic[:, 2], op,
                                 p0.rgb_colors[:, 0], p0.rgb_colors[:, 1],
                                 p0.rgb_colors[:, 2], mc[:, 2]], dim=1)
            for k, bdt in ks:
                b = bin_gaussians(proj, c, rcfg._replace(max_per_tile=k),
                                  emit_exp=True)
                out[f"{tag}{k}"] = dict(
                    g=table[b.tile_gauss].contiguous(), cnt=b.tile_count,
                    tiles_x=c.tiles_x, bins=b, desc=f"camera {w}x{h}",
                    bdt=torch.float32 if bdt == "f32" else torch.bfloat16)
    return out


def check_tile_crop(cam, dev):
    """_tiles_to_image against direct indexing: pixel (y, x) is entry
    (y % 16) * 16 + x % 16 of tile (y // 16) * tiles_x + x // 16."""
    import torch
    from isogs_slam_tpu_torch.ops.rasterize import TILE, _tiles_to_image
    tiles = torch.arange(cam.num_tiles * TILE * TILE * 2, device=dev,
                         dtype=torch.float32).reshape(cam.num_tiles,
                                                      TILE * TILE, 2)
    img = _tiles_to_image(tiles, cam)
    ys = torch.arange(cam.height, device=dev)[:, None]
    xs = torch.arange(cam.width, device=dev)[None, :]
    want = tiles[(ys // TILE) * cam.tiles_x + xs // TILE,
                 (ys % TILE) * TILE + xs % TILE].permute(2, 0, 1)
    if img.shape != (2, cam.height, cam.width) or not torch.equal(img, want):
        raise AssertionError(f"_tiles_to_image crops {cam.width}x"
                             f"{cam.height} wrongly")
    print(f"tile crop {cam.width}x{cam.height}: {cam.tiles_x}x{cam.tiles_y} "
          f"tiles -> image {tuple(img.shape)} equal to direct indexing")


def _render_loss_grads(params, alive, pose, cam, cfg, binning, sel=None):
    """Loss and parameter gradients of a fused render against a frozen
    binning (the whole image, or the tiles `sel` through
    render_tiles_subset), with the test suite's loss."""
    import torch
    from isogs_slam_tpu_torch.core.gaussians import GaussianParams
    from isogs_slam_tpu_torch.ops.rasterize import (MAPPING_LIVE_COLS,
                                                    render_rgbd_sil,
                                                    render_tiles_subset)
    from isogs_slam_tpu_torch.utils.transforms import transform_to_frame
    leaves = GaussianParams(*[p.detach().requires_grad_(True)
                              for p in params])
    with torch.enable_grad():
        mc, qc = transform_to_frame(leaves.means3d, leaves.unnorm_rotations,
                                    pose[0], pose[1], gaussians_grad=True,
                                    camera_grad=False)
        if sel is None:
            im, depth, sil, dsq, _ = render_rgbd_sil(
                mc, qc, leaves.log_scales, leaves.logit_opacities,
                leaves.rgb_colors, alive, cam, cfg, binning=binning,
                live_grad_cols=MAPPING_LIVE_COLS)
            loss = ((im * im).sum() + depth.abs().sum() + (sil ** 3).sum()
                    + dsq.sum())
            image = torch.cat([im, depth, sil[None], dsq]).detach()
        else:
            out, ft, _ = render_tiles_subset(
                mc, qc, leaves.log_scales, leaves.logit_opacities,
                leaves.rgb_colors, alive, sel, binning, cam, cfg,
                live_grad_cols=MAPPING_LIVE_COLS)
            loss = ((out[..., :3] ** 2).sum() + out[..., 3].abs().sum()
                    + ((1 - ft) ** 3).sum() + out[..., 4].sum())
            image = out.detach()
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, image


def _max_rel(grads, ref):
    """Largest |g - ref| over each parameter's max |ref|."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(grads, ref))


def subset_routes(inputs, ctx, cam, capacity, rcfg, dev):
    """Phase 3b: the scatter route (index_add_ of the live columns) against
    the segment-reduce route (expansion scatter + kernel C) of
    render_tiles_subset, at the mapping stripe's shape and at a quarter of
    it: same gradients within the bf16 tolerance, the whole render's time
    by either route, and the two aggregations alone on kernel B's rows, at
    the intersection capacity this configuration starts with and at the
    one a run grows to."""
    import torch
    from isogs_slam_tpu_torch.ops.rasterize import (
        SUBSET_SEGREDUCE_MIN_ROWS, _expansion_reduce, _index_add_rows,
        subset_uses_segreduce)
    t0 = time.perf_counter()
    st = ctx["state"]
    K = rcfg.max_per_tile
    b = ctx["bins"][K]
    sel_full = ctx["stripe_sel"]
    dg_full = inputs["stripe"]["dg"]
    n = st.params.means3d.shape[0]
    live = tuple(range(10))
    for sel, name in ((sel_full, "stripe"),
                      (sel_full[: sel_full.shape[0] // 4], "quarter stripe")):
        rows = sel.shape[0] * K
        # one untimed call of each route first: the allocator's warm-up
        for route in ("scatter", "segreduce"):
            _render_loss_grads(st.params, st.alive, ctx["pose0"], cam,
                               rcfg._replace(bwd_mode=route), b, sel)
        got = {}
        for route in ("scatter", "segreduce"):
            cfg = rcfg._replace(bwd_mode=route)
            fn = lambda: _render_loss_grads(st.params, st.alive,
                                            ctx["pose0"], cam, cfg, b, sel)
            got[route] = fn()
            got[route + "_ms"] = cuda_ms(fn, 10)
        f32 = _render_loss_grads(st.params, st.alive, ctx["pose0"], cam,
                                 rcfg._replace(bwd_mode="segreduce",
                                               grad_scatter_bf16=False), b,
                                 sel)
        rel = _max_rel(got["scatter"][1], got["segreduce"][1])
        rel32 = _max_rel(got["segreduce"][1], f32[1])
        # both routes round kernel B's rows to bf16 once, and the scatter
        # route also accumulates in bf16: the segment-reduce route is held
        # to one bf16 rounding of the parameter's max from its f32 form,
        # the two routes to two roundings (one of each) from one another
        print(f"[subset route] {name}: {sel.shape[0]} tiles x K {K} = "
              f"{rows} rows; gradients scatter vs segreduce max error / "
              f"parameter max {rel:.3e} (tol 1.6e-02), segreduce vs its f32 "
              f"form {rel32:.3e} (tol 7.8e-03); loss equal: "
              f"{float(got['scatter'][0]) == float(got['segreduce'][0])}")
        if not (rel < 2 ** -6 and rel32 < 2 ** -7):
            raise AssertionError(f"the subset routes disagree ({name})")
        auto = subset_uses_segreduce(rcfg._replace(bwd_mode="auto"),
                                     sel.shape[0])
        print(f"[subset route] {name}: \"auto\" takes "
              f"{'expansion scatter + kernel C' if auto else 'index_add_'}"
              f" at {rows} rows (crossover {SUBSET_SEGREDUCE_MIN_ROWS})")
        if auto != (name == "stripe"):
            raise AssertionError(f"\"auto\" takes the wrong route at the "
                                 f"{name}'s {rows} rows")
        print(f"[subset route] {name}: whole render forward + backward "
              f"scatter {got['scatter_ms']:.3f} ms, segreduce "
              f"{got['segreduce_ms']:.3f} ms")
    # the two aggregations alone, each as its Function's backward runs it,
    # on kernel B's rows as they cross the autograd boundary (f32), for a
    # quarter stripe, the stripe and every tile, at the intersection
    # capacity this configuration starts with and at the one a run grows to
    sizes = (("quarter stripe", sel_full[: sel_full.shape[0] // 4],
              dg_full[: sel_full.shape[0] // 4]),
             ("stripe", sel_full, dg_full),
             ("all tiles", torch.arange(cam.num_tiles, device=dev),
              inputs["map"]["dg"]))
    for name, sel, dg in sizes:
        dg = dg[:, :K].float().contiguous()
        idx, pos = b.tile_gauss[sel], b.slot_exp_pos[sel]
        ms_s = cuda_ms(lambda: _index_add_rows(dg, idx, n, live, True), 20)
        line = (f"[subset route] aggregation alone, {name} "
                f"({sel.shape[0] * K} rows): index_add_ {ms_s:.4f} ms")
        for cap in (rcfg.max_isect(capacity), 14417920):
            ms_r = cuda_ms(lambda: _expansion_reduce(
                dg.to(torch.bfloat16), pos, b.exp_offsets, cap, n, live), 20)
            line += (f"; expansion scatter + kernel C {ms_r:.4f} ms at "
                     f"intersection capacity {cap}")
        print(line)
    phase("subset route", t0)


def cull_phase(ctx, cam, rcfg, dev):
    """Phase 3c: tile_cull and tight_rect on the full-width scene. With no
    drift budget (cull_q_slack 1) each gives the plain binning's image
    (1e-5 of its range) and parameter gradients (1e-4 of each parameter's
    max, f32 rows); prints the intersection count, the summed tile counts
    and kernel A's and B's times with and without, also under the
    budgets the mapper passes (cull_q_slack 1.5, logit drift 6.4)."""
    import torch
    from isogs_slam_tpu_torch.ops import composite as comp
    from isogs_slam_tpu_torch.ops.rasterize import bin_gaussians
    t0 = time.perf_counter()
    st, proj, table = ctx["state"], ctx["proj"], ctx["table"]
    op = torch.sigmoid(st.params.logit_opacities[:, 0]).detach()
    # K = 1024 holds every candidate of every tile: under a smaller cap the
    # tight rects, which shrink the expansion, would also change which true
    # candidates the cap drops
    base = rcfg._replace(grad_scatter_bf16=False, max_per_tile=1024)
    rng = torch.Generator(device=dev).manual_seed(2)
    ref = None
    for name, knobs, budget in (
            ("plain", {}, {}),
            ("tile_cull", dict(tile_cull=True, cull_q_slack=1.0), {}),
            ("tight_rect", dict(tight_rect=True, cull_q_slack=1.0), {}),
            ("tile_cull, mapping budget", dict(tile_cull=True),
             dict(cull_logit_drift=3.2 * 0.05 * 40)),
            ("tight_rect, mapping budget", dict(tight_rect=True),
             dict(cull_logit_drift=3.2 * 0.05 * 40))):
        cfg = base._replace(**knobs)
        with torch.no_grad():
            b = bin_gaussians(proj, cam, cfg, emit_exp=True, opacity=op,
                              **budget)
        loss, grads, image = _render_loss_grads(st.params, st.alive,
                                                ctx["pose0"], cam, cfg, b)
        if ref is None:
            ref = (loss, grads, image)
        img_err = float((image - ref[2]).abs().max()
                        / ref[2].abs().max().clamp(min=1.0))
        rel = _max_rel(grads, ref[1])
        with torch.no_grad():
            g = table[b.tile_gauss].contiguous()
            out, ft, last, tend = comp.composite_fwd_cuda(g, b.tile_count, 4,
                                                          cam.tiles_x, 3)
            gout = torch.randn(out.shape, generator=rng, device=dev)
            dfin = torch.randn(ft.shape, generator=rng, device=dev)
            ms_a = cuda_ms(lambda: comp.composite_fwd_cuda(
                g, b.tile_count, 4, cam.tiles_x, 3), 20)
            ms_b = cuda_ms(lambda: comp.composite_bwd_cuda(
                g, b.tile_count, gout, dfin, last, tend, 4, cam.tiles_x, 3,
                torch.bfloat16), 20)
        print(f"[cull] {name}: {int(b.n_isect)} intersections, "
              f"{int(b.tile_count.sum())} slots in the tile lists (max "
              f"{int(b.tile_count.max())}), {int(b.n_overflow)} dropped by "
              f"the caps; image max error {img_err:.3e} (tol 1e-5), "
              f"gradient max error / parameter max {rel:.3e} (tol 1e-4); "
              f"A {ms_a:.4f} ms, B (bf16) {ms_b:.4f} ms")
        if not (img_err < 1e-5 and rel < 1e-4):
            raise AssertionError(f"{name} changes the render")
        del g, out, ft, last, tend, gout, dfin
    phase("cull", t0)


def pipeline_path(root, config_name, end_at, extra_args=(), keep=False):
    """Phase 5: the port's CLI in-process on configs/synthetic/<config_name>
    with evaluation and checkpoints (one at end_at), into a temporary run
    directory; see cli_path."""
    return cli_path(
        os.path.join(root, "isogs_slam_tpu_torch", "configs", "synthetic",
                     config_name), config_name, end_at,
        ["--set", "save_checkpoints=True",
         "--set", f"checkpoint_interval={end_at}", *extra_args], keep)


def cli_path(config_path, name, end_at, extra_args=(), keep=False,
             run_dir=None, min_mask=0.1):
    """The port's CLI (scripts.splatam.main) in-process on `config_path`
    with evaluation, `--end-at end_at` and `--set workdir=run_dir` (a new
    temporary directory unless given); the launch counters are set to 0
    before and read after. Prints the run's numbers and checks them
    (report_run, with min_mask); returns (launch counts, seconds of each tracking frame,
    seconds of each mapping phase, the SLAM object). keep=True leaves the
    run directory (slam.output_dir holds the checkpoints) for the caller to
    delete."""
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import splatam
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    run_dir = run_dir or tempfile.mkdtemp(prefix="isogs_smoke_")
    try:
        slam = splatam.main([
            config_path, "--end-at", str(end_at),
            "--set", f"workdir={run_dir}", *extra_args])
        torch.cuda.synchronize()
        launches_cli = dict(_cuda.LAUNCHES)
        tr, mp = report_run(slam, name, end_at, t0, launches_cli, min_mask)
    except BaseException:
        shutil.rmtree(run_dir, ignore_errors=True)
        raise
    if not keep:
        shutil.rmtree(run_dir, ignore_errors=True)
    return launches_cli, tr, mp, slam


def report_run(slam, name, end_at, t0, launches, min_mask=0.1):
    """Print a finished SLAM run's numbers (timings, tile-list reuse, cap
    escalations, capacity, peak memory, quality, launches) and fail on a
    last checkpoint that is not frame end_at's map or a non-finite loss,
    parameter or pose; unless min_mask is None, also on a tracking mask
    under min_mask, ATE >= 2 cm or PSNR <= 25 dB. Returns (seconds of each
    tracking frame after the first, seconds of each mapping phase)."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.io.checkpoints import (latest_checkpoint,
                                                     load_checkpoint)
    t_cli = time.perf_counter() - t0
    with open(os.path.join(slam.output_dir, "metrics_log.csv")) as f:
        rows = list(csv.DictReader(f))
    ckpts = sorted(os.listdir(slam.output_dir))
    ck_frame, ck_path = latest_checkpoint(slam.output_dir)
    ck = load_checkpoint(ck_path)
    st, ev, res = slam.stats, slam.events, slam.eval_results
    tr, mp = st["tracking_frame_time"][1:], st["mapping_frame_time"]
    n_alive = int(slam.state.num_alive())
    print(f"pipeline {name}: frames 0-{end_at} + eval in {t_cli:.1f} "
          f"s at {slam.cam.width}x{slam.cam.height}; "
          f"tracking.tile_subsample {slam.tcfg.tile_subsample}, "
          f"mapping.tile_subsample {slam.mcfg.tile_subsample}, "
          f"exact_polish_iters {slam.mcfg.exact_polish_iters} (frames are "
          f"loaded by the dataset's prefetch thread, the synthetic ones "
          f"rendered on the same stream, inside these times)")
    print(f"tracking s/frame: mean {np.mean(tr):.4f} min {np.min(tr):.4f} "
          f"max {np.max(tr):.4f} over {len(tr)} frames "
          f"({np.mean(st['tracking_iters_run']):.1f} iterations each)")
    print(f"mapping s/phase: mean {np.mean(mp):.4f} min {np.min(mp):.4f} "
          f"max {np.max(mp):.4f} over {len(mp)} phases "
          f"({slam.mcfg.num_iters} iterations each); each: "
          f"{[round(x, 3) for x in mp]}")
    print(f"BinningReuse: {slam._track_bins.n_rebins} rebins, "
          f"{slam._track_bins.n_reuses} reuses")
    print(f"max_per_tile escalations (frame, old, new): "
          f"{ev['max_per_tile']}; isect-cap changes: {ev['isect_cap']}")
    print(f"capacity growths (frame, old, new): {ev['capacity']}; "
          f"compactions at frames {ev['compactions']}; capacity now "
          f"{slam.state.capacity}")
    print(f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"Gaussians: {n_alive} alive, high-water mark "
          f"{int(slam.state.hwm)}")
    print(f"ATE RMSE {res['Final Average ATE RMSE (cm)']:.4f} cm, PSNR "
          f"{res['Average PSNR']:.3f} dB, MS-SSIM "
          f"{res['Average MS-SSIM']:.4f}, depth L1 "
          f"{res['Average Depth L1 (cm)']:.4f} cm, LPIPS "
          f"({res['LPIPS Variant']}) {res['Average LPIPS']:.5f}")
    print(f"tracking mask_frac: min {min(st['tracking_mask_frac']):.3f} "
          f"at sil_thres {slam.lcfg_track.sil_thres}, each frame "
          f"{[round(x, 3) for x in st['tracking_mask_frac']]}; checkpoint "
          f"files {[c for c in ckpts if c.startswith('params')]}")
    print(f"launches on the pipeline path {launches}")
    phase(f"pipeline path ({name}, {end_at + 1} frames + eval)", t0)
    if ck_frame != end_at or ck["means3D"].shape[0] != n_alive:
        raise AssertionError("the last checkpoint does not hold the map")
    vals = np.array([[float(r[k]) for k in ("loss", "image_loss",
                                            "depth_loss", "flat_loss",
                                            "iso_loss", "mean_density",
                                            "mask_frac")] for r in rows])
    if not (np.isfinite(vals).all()
            and all(bool(torch.isfinite(p).all())
                    for p in slam.state.params)
            and np.isfinite(slam.cam_trans[:, :end_at + 1]).all()):
        raise AssertionError("non-finite losses, parameters or poses")
    if min_mask is not None:
        if min(st["tracking_mask_frac"]) < min_mask:
            raise AssertionError("the tracking mask collapsed")
        if not (res["Final Average ATE RMSE (cm)"] < 2.0
                and res["Average PSNR"] > 25.0):
            raise AssertionError(f"the run collapsed: {res}")
    elif not all(np.isfinite(v) for v in res.values()
                 if isinstance(v, float)):
        raise AssertionError(f"non-finite eval metrics: {res}")
    if "--profile" in sys.argv[1:] and end_at + 1 < len(slam.dataset):
        profile_pipeline(slam, end_at + 1)
    return list(tr), list(mp)


def uv_grad_quantile(state, im, depth, quat, trans, cam, rcfg, q=0.9):
    """The q-quantile, over the rendered rows, of |d loss / d(u, v)| of one
    offline loss at a frame: a densification threshold that makes about
    1 - q of the rows hot at this resolution (the configs' grad_thresh is
    set for their own image size; the per-Gaussian gradient of a loss that
    is a mean over pixels shrinks with the pixel count)."""
    import torch
    from isogs_slam_tpu_torch.core.gaussians import GaussianParams
    from isogs_slam_tpu_torch.slam.offline import offline_loss
    leaves = GaussianParams(*[p.detach().requires_grad_(True)
                              for p in state.params])
    m2d = torch.zeros((state.capacity, 2), device=im.device,
                      requires_grad=True)
    with torch.enable_grad():
        total, _, _, aux = offline_loss(leaves, state.alive, quat, trans, im,
                                        depth, cam, rcfg, 1.0, 1.0, m2d)
        (g,) = torch.autograd.grad(total, m2d)
    norms = g.norm(dim=1)[aux["radii"] > 0]
    return float(torch.quantile(norms, q)), float(norms.median())


def _config_file(config, directory, name):
    """Write an experiment config module holding `config` (a dict of
    literals) and return its path: how the CLIs of phase 5e are given a
    config with a temporary workdir."""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(f"config = {config!r}\n")
    return path


def _finite_state(state):
    import torch
    return all(bool(torch.isfinite(p[state.alive]).all())
               for p in state.params)


def _offline_numbers(runner, name, t_run):
    """Print an offline runner's per-chunk losses, densification counts,
    Gaussians, capacity, peak memory and s/iteration; return the
    iteration count."""
    import numpy as np
    import torch
    st = runner.stats
    n_iter = sum(len(c) for c in st["chunk_loss"])
    first = float(np.mean(st["chunk_loss"][0][:, 0]))
    last = float(np.mean(st["chunk_loss"][-1][:, 0]))
    c = np.sum(st["densify_counts"], axis=0)
    # the first chunk also pays the allocator's warm-up
    s_it = float(np.sum(st["chunk_time"][1:]) / max(
        n_iter - len(st["chunk_loss"][0]), 1))
    print(f"{name}: {n_iter} iterations in {len(st['chunk_loss'])} chunks, "
          f"{t_run:.1f} s for the whole phase; {s_it:.4f} s/iteration over "
          f"the chunks after the first; chunk-mean loss first {first:.5f} "
          f"last {last:.5f}; Gaussians alive per chunk {st['n_alive']}")
    over = max(int(np.max(ln[:, 3])) for ln in st["chunk_loss"])
    print(f"{name}: most intersections one binning dropped at its caps "
          f"{over} (intersection capacity "
          f"{runner.rcfg.max_isect(runner.state.capacity)})")
    print(f"{name}: densification {int(c[0])} cloned, {int(c[1])} split, "
          f"{int(c[2])} rows dropped at capacity {runner.state.capacity} "
          f"(high-water mark {int(runner.state.hwm)}); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return n_iter, first, last, c


def postopt_path(root, slam, tmp):
    """Phase 5c: PostSLAMOpt in process on the port's
    post_splatam_opt_fullres.py seeded from the exact pipeline run's last
    checkpoint, then save and eval_sequence. The poses are the SLAM run's
    (clamped to its checkpoint frame), so the ATE must equal its ATE; the
    PSNR is printed beside the SLAM map's. Returns (launch counts, the
    runner)."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import gaussian_splatting as GS
    from isogs_slam_tpu_torch.scripts.post_splatam_opt import PostSLAMOpt
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    config = load_experiment_config(os.path.join(
        root, "isogs_slam_tpu_torch", "configs", "synthetic",
        "post_splatam_opt_fullres.py"))
    config["workdir"] = tmp
    config["data"]["param_ckpt_path"] = slam.output_dir
    runner = PostSLAMOpt(config)
    runner.init_sweep()
    runner.optimize()
    runner.save()
    res = GS.evaluate(runner, config)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    t_run = time.perf_counter() - t0
    tr = config["train"]
    print(f"post-SLAM optimization: post_splatam_opt_fullres.py, "
          f"{runner.cam.width}x{runner.cam.height}, {runner.num_frames} "
          f"frames after the clamp to the checkpoint frame, "
          f"{tr['num_iters_mapping']} iterations in chunks of "
          f"{tr['chunk_iters']} over {tr['frames_per_chunk']} frames, "
          f"densification {tr['use_gaussian_splatting_densification']}")
    _offline_numbers(runner, "post-opt", t_run)
    slam_res = slam.eval_results
    print(f"post-opt PSNR {res['Average PSNR']:.3f} dB against the SLAM "
          f"map's {slam_res['Average PSNR']:.3f} dB (same frames, same "
          f"poses); MS-SSIM {res['Average MS-SSIM']:.4f} against "
          f"{slam_res['Average MS-SSIM']:.4f}; depth L1 "
          f"{res['Average Depth L1 (cm)']:.4f} against "
          f"{slam_res['Average Depth L1 (cm)']:.4f} cm; ATE "
          f"{res['Final Average ATE RMSE (cm)']:.6f} against "
          f"{slam_res['Final Average ATE RMSE (cm)']:.6f} cm")
    print(f"launches on the post-opt path {launches}")
    phase("post-SLAM optimization (5c)", t0)
    losses = np.concatenate(runner.stats["chunk_loss"])[:, :3]
    if not (np.isfinite(losses).all() and _finite_state(runner.state)):
        raise AssertionError("post-opt: non-finite losses or parameters")
    if not res["Average PSNR"] > 25.0:
        raise AssertionError(f"post-opt collapsed: {res}")
    if abs(res["Final Average ATE RMSE (cm)"]
           - slam_res["Final Average ATE RMSE (cm)"]) > 1e-3:
        raise AssertionError("post-opt moved the poses: its ATE is not the "
                             "SLAM run's")
    if "--profile" in sys.argv[1:]:
        profile_offline_chunk(runner)
    return launches, runner


def offline_path(root, tmp):
    """Phase 5d: offline_splatting in process on the port's
    gaussian_splatting.py at 680x1200 with the raster block of full_res.py,
    16 frames, 300 iterations densifying at 100 and 200. Fails unless the
    map densified (the high-water mark grew, rows were cloned or split),
    the loss fell and the eval's PSNR is above 25 dB. Returns the launch
    counts."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import gaussian_splatting as GS
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    from isogs_slam_tpu_torch.slam.pipeline import _to_chw_frame
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    config = load_experiment_config(os.path.join(
        root, "isogs_slam_tpu_torch", "configs", "synthetic",
        "gaussian_splatting.py"))
    config["workdir"] = tmp
    config["capacity_granule"] = 65536
    config["raster"] = dict(max_per_tile=512, isect_per_gaussian=2.5,
                            tile_chunk=256)
    config["data"].update(desired_image_height=H, desired_image_width=W,
                          num_frames=16)
    tr = config["train"]
    tr.update(num_iters_mapping=300, add_gaussians_every=2)
    tr["densify_dict"].update(start_after=100, densify_every=100,
                              stop_after=200)
    print(f"offline trainer: gaussian_splatting.py with data "
          f"{W}x{H}, 16 frames, raster {config['raster']}, "
          f"add_gaussians_every 2, 300 iterations in chunks of "
          f"{tr['chunk_iters']} over {tr['frames_per_chunk']} frames, "
          f"densify_dict {tr['densify_dict']}")
    runner = GS.OfflineGS(config)
    runner.init_sweep()
    hwm0, n0 = int(runner.state.hwm), int(runner.state.num_alive())
    color, depth, _, _ = runner.dataset[0]
    im, d = _to_chw_frame(color, depth, runner.device)
    thresh, med = uv_grad_quantile(
        runner.state, im, d, torch.as_tensor(runner.cam_rots[:, 0],
                                              device=runner.device),
        torch.as_tensor(runner.cam_trans[:, 0], device=runner.device),
        runner.cam, runner.rcfg)
    runner.ocfg = runner.ocfg._replace(
        densify=runner.ocfg.densify._replace(grad_thresh=thresh))
    print(f"offline: |d loss / d(u, v)| over the rendered rows at frame 0 "
          f"after the sweep: median {med:.3e}, 90th percentile {thresh:.3e}"
          f"; grad_thresh {tr['densify_dict']['grad_thresh']} (set for "
          f"the config's 120x160) -> {thresh:.3e}")
    runner.optimize()
    runner.save()
    res = GS.evaluate(runner, config)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    t_run = time.perf_counter() - t0
    _, first, last, c = _offline_numbers(runner, "offline", t_run)
    print(f"offline: Gaussians {n0} after the sweep (high-water mark "
          f"{hwm0}) -> {int(runner.state.num_alive())} (high-water mark "
          f"{int(runner.state.hwm)}); PSNR {res['Average PSNR']:.3f} dB, "
          f"MS-SSIM {res['Average MS-SSIM']:.4f}, depth L1 "
          f"{res['Average Depth L1 (cm)']:.4f} cm, LPIPS "
          f"{res['Average LPIPS']:.5f}")
    print(f"launches on the offline path {launches}")
    phase("offline trainer (5d)", t0)
    losses = np.concatenate(runner.stats["chunk_loss"])[:, :3]
    if not (np.isfinite(losses).all() and _finite_state(runner.state)):
        raise AssertionError("offline: non-finite losses or parameters")
    if not (int(runner.state.hwm) > hwm0 and c[0] + c[1] > 0):
        raise AssertionError("offline: densification did not fire")
    if not last < first:
        raise AssertionError("offline: the loss did not fall")
    if not res["Average PSNR"] > 25.0:
        raise AssertionError(f"offline trainer collapsed: {res}")
    return launches


def nvs_path(root, ckpt_path, tmp):
    """Phase 5e: eval_novel_view.main on 5c's checkpoint at 1200x680, with
    a copy of post_splatam_opt_fullres.py whose workdir is temporary.
    Returns the launch counts."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import eval_novel_view
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    t0 = time.perf_counter()
    _cuda.reset_launches()
    config = load_experiment_config(os.path.join(
        root, "isogs_slam_tpu_torch", "configs", "synthetic",
        "post_splatam_opt_fullres.py"))
    config["workdir"] = tmp
    path = _config_file(config, tmp, "nvs_config.py")
    res = eval_novel_view.main([path, "--checkpoint", ckpt_path])
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"novel views (frames 1-{res['Frames']} of "
          f"{config['data']['num_frames']}, the map trained on frames 0-15): "
          f"PSNR {res['Average NVS PSNR']:.3f} dB, MS-SSIM "
          f"{res['Average NVS MS-SSIM']:.4f}, LPIPS "
          f"({res['LPIPS Variant']}) {res['Average NVS LPIPS']:.5f}, depth "
          f"RMSE {res['Average NVS Depth RMSE (cm)']:.4f} cm, L1 "
          f"{res['Average NVS Depth L1 (cm)']:.4f} cm")
    print(f"launches on the NVS path {launches}")
    phase("novel view (5e)", t0)
    if not all(np.isfinite(v) for k, v in res.items()
               if isinstance(v, float)):
        raise AssertionError(f"novel-view metrics not finite: {res}")
    return launches


def replica_path(root, tmp, dev):
    """Phase 5g: the shipped configs/replica/splatam.py at its own 1200x680,
    10 tracking and 40 mapping iterations, through the port's CLI on the
    synthetic scene written in Replica layout by tools.synth_to_replica
    (JPEG colour, uint16 PNG depth, traj.txt, camera YAML), with only the
    data paths, --end-at, the workdir and --device overridden; eval
    included, then tools.compare_expected against
    configs/replica/expected_metrics.json (real room0 numbers: printed as
    information, not a gate). Returns (launch counts, the SLAM object); its
    run directory under tmp/experiments stays for 5i."""
    from isogs_slam_tpu_torch.tools import compare_expected, synth_to_replica
    t0 = time.perf_counter()
    data_root = os.path.join(tmp, "replica_data")
    yaml_path = synth_to_replica.write_replica_layout(
        data_root, "room0", num_frames=N_REPLICA, height=H, width=W,
        device=dev)
    print(f"Replica bridge: {N_REPLICA} frames at {W}x{H} written in "
          f"{time.perf_counter() - t0:.1f} s")
    os.environ["SPLATAM_SCENE_INDEX"] = "0"
    launches, _, _, slam = cli_path(
        os.path.join(root, "configs", "replica", "splatam.py"),
        "configs/replica/splatam.py", N_REPLICA - 1,
        ["--device", str(dev), "--set", f"data.basedir={data_root}",
         "--set", f"data.gradslam_data_cfg={yaml_path}"], keep=True,
        run_dir=os.path.join(tmp, "experiments", "Replica"),
        min_mask=REPLICA_MIN_MASK)
    print(f"Replica config as shipped: {slam.cam.width}x{slam.cam.height}, "
          f"{type(slam.dataset).__name__}, tracking {slam.tcfg.num_iters} "
          f"iterations (sil_norm_render {slam.lcfg_track.sil_norm_render}), "
          f"mapping {slam.mcfg.num_iters} every {slam.config['map_every']} "
          f"frames, max_per_tile {slam.rcfg.max_per_tile} now")
    if not (type(slam.dataset).__name__ == "ReplicaDataset"
            and (slam.cam.width, slam.cam.height) == (W, H)
            and slam.tcfg.num_iters == 10 and slam.mcfg.num_iters == 40
            and slam.lcfg_track.sil_norm_render):
        raise AssertionError("the Replica config was not run as shipped")
    rc = compare_expected.main([
        os.path.join(root, "configs", "replica", "expected_metrics.json"),
        "room0=" + os.path.join(slam.eval_dir, "eval_summary.json")])
    print(f"compare_expected exit code {rc} (information, not a gate: "
          f"synthetic frames against the real room0 numbers)")
    phase("Replica config (5g)", t0)
    return launches, slam


def live_path(root, tmp, dev):
    """Phase 5h: the live demo at configs/iphone/online_demo.py's size. A
    writer thread streams the synthetic scene (at the bridge's density for
    its size, as 5g) at 480x360 and 10 Hz into a capture directory
    (scripts.nerfcapture2dataset.stream_synthetic, the port's
    write_capture_frame) and then writes `done`, while
    scripts.iphone_demo.main runs SLAM on that directory (a copy of the
    shipped config with its workdir in tmp/experiments; --device) and
    evaluates; then viz_scripts.online_recon renders its newest
    checkpoint. Fails on a crash, a non-finite value, a missing checkpoint
    or online_recon frame; the quality numbers are printed, not gated (a
    phone's config tracking the synthetic stand-in at sil_thres 0.99).
    Launch counters from 0 before the writer, read after online_recon.
    Returns the launch counts."""
    import threading
    import traceback
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import iphone_demo, nerfcapture2dataset
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    from isogs_slam_tpu_torch.viz_scripts import online_recon
    t0 = time.perf_counter()
    config = load_experiment_config(
        os.path.join(root, "configs", "iphone", "online_demo.py"))
    config["workdir"] = os.path.join(tmp, "experiments", "iPhone_Captures")
    path = _config_file(config, tmp, "online_demo.py")
    cap = os.path.join(tmp, "live_capture")
    writer_error = []

    def writer():
        try:
            nerfcapture2dataset.stream_synthetic(
                cap, N_LIVE, hz=LIVE_HZ, height=LIVE_H, width=LIVE_W,
                n_per_wall=max(400, LIVE_H * LIVE_W // 40), device=dev)
        except BaseException as e:      # reported by the caller
            traceback.print_exc()
            writer_error.append(e)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        slam = iphone_demo.main([path, "--source", "dir", "--watch", cap,
                                 "--n-frames", str(N_LIVE), "--timeout",
                                 "60", "--device", str(dev)])
    finally:
        th.join(timeout=120)
    if writer_error or th.is_alive():
        raise AssertionError(f"the capture writer failed: {writer_error}")
    tr, _ = report_run(slam, "iphone_demo configs/iphone/online_demo.py",
                       N_LIVE - 1, t0, dict(_cuda.LAUNCHES), min_mask=None)
    print(f"live demo: tracking {np.mean(tr):.4f} s/frame "
          f"({slam.tcfg.num_iters} iterations) against the "
          f"{1 / LIVE_HZ:.3f} s a {LIVE_HZ:.0f} Hz stream allows; mapping "
          f"every {slam.config['map_every']} frames")
    t1 = time.perf_counter()
    frames = online_recon.main([path, "--poll", "0.05", "--max-wait", "0.5",
                                "--device", str(dev)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"online_recon: {len(frames)} frame(s) of "
          f"{frames[0].shape if frames else None} in "
          f"{time.perf_counter() - t1:.2f} s; launches on the live path "
          f"{launches}")
    if len(frames) != 1 or frames[0].shape != (LIVE_H // 2, LIVE_W // 2, 3):
        raise AssertionError("online_recon did not render the checkpoint")
    phase("live demo (5h)", t0)
    return launches


def _tile_depth(state, w2c, cam, rcfg):
    """(most candidates any tile has, true candidates the K cap drops) of
    a map seen from w2c."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.ops.rasterize import (bin_gaussians,
                                                    project_gaussians)
    from isogs_slam_tpu_torch.utils.transforms import (rotmat_to_quat,
                                                       transform_to_frame)
    dev = state.alive.device
    q = rotmat_to_quat(torch.as_tensor(w2c[:3, :3], dtype=torch.float32))
    with torch.no_grad():
        mc, qc = transform_to_frame(
            state.params.means3d, state.params.unnorm_rotations,
            (q / q.norm()).to(dev),
            torch.as_tensor(np.asarray(w2c[:3, 3]), dtype=torch.float32,
                            device=dev), gaussians_grad=False,
            camera_grad=False)
        proj = project_gaussians(mc, qc, state.params.log_scales,
                                 state.alive, cam)
        b = bin_gaussians(proj, cam, rcfg._replace(max_per_tile=4096))
        deepest = int(b.tile_count.max())
        b = bin_gaussians(proj, cam, rcfg)
    return deepest, int(b.n_true_overflow)


def _flips(a, b, tol):
    """(max |a - b|, pixels where any channel differs by more than tol) of
    two [C, H, W] images."""
    err = (a - b).abs()
    return float(err.max()), int((err > tol).any(0).sum())


def viewer_path(root, tmp, dev, slam):
    """Phase 5i: the viewers on 5g's final checkpoint. final_recon.main at
    the default --downscale 2 (replay every 5th pose and an 8-frame orbit
    in colour, the replay in depth); one pose at --downscale 1 against the
    SLAM object's own map rendered at that pose with the viewers'
    RasterConfig (1e-5 of the image; a pixel whose threshold test flips
    between the two nearly equal poses may differ by one slot's weight,
    as in phase 3); --sh on a copy of the checkpoint given random
    higher-band sh_coeffs_flat, its frame on the card against the CPU's
    (the same rule); scripts.test_installation (rc 0); model_browser --text
    over tmp/experiments, which must list 5g's and 5h's runs. Returns the
    launch counts."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch.eval.eval_helpers import render_at_pose
    from isogs_slam_tpu_torch.io.images import imread
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.scripts import model_browser, test_installation
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    from isogs_slam_tpu_torch.viz_scripts import final_recon
    from isogs_slam_tpu_torch.viz_scripts.common import (
        frame_to_uint8, load_scene, make_render_fn, render_w2c)
    t0 = time.perf_counter()
    _cuda.reset_launches()
    config = load_experiment_config(
        os.path.join(root, "configs", "replica", "splatam.py"))
    config["workdir"] = os.path.dirname(slam.output_dir)
    path = _config_file(config, tmp, "replica_viewer.py")
    final_recon.main([path, "--orbit-frames", "8", "--device", str(dev)])
    final_recon.main([path, "--mode", "depth", "--device", str(dev)])
    viz = os.path.join(slam.output_dir, "viz")
    n_replay = len(range(0, N_REPLICA, 5))
    for sub, n in (("replay_color", n_replay), ("orbit", 8),
                   ("replay_depth", n_replay)):
        names = sorted(os.listdir(os.path.join(viz, sub)))
        shape = imread(os.path.join(viz, sub, names[0])).shape
        print(f"final_recon {sub}: {len(names)} frames of {shape}")
        if len(names) != n or shape != (H // 2, W // 2, 3):
            raise AssertionError(f"final_recon wrote {sub} wrongly")
    t_viz = time.perf_counter() - t0

    # one pose at --downscale 1: the checkpoint through load_scene and
    # render_w2c against the SLAM object's own map and pose
    rcfg = final_recon.viewer_raster_config(config)
    st, cam, est, _, ckpt = load_scene(slam.output_dir, device=dev)
    t_last = N_REPLICA - 1
    im_v, d_v, s_v = render_w2c(make_render_fn(cam, rcfg), st, est[t_last])
    q = slam.cam_rots[:, t_last] / np.linalg.norm(slam.cam_rots[:, t_last])
    im_s, d_s, s_s = make_render_fn(slam.cam, rcfg)(
        slam.state.params, slam.state.alive,
        torch.as_tensor(q, dtype=torch.float32, device=dev),
        torch.as_tensor(slam.cam_trans[:, t_last], dtype=torch.float32,
                        device=dev))
    tol = 1e-5 * max(1.0, float(im_s.abs().max()))
    err, bad = _flips(im_v, im_s, tol)
    err_d, _ = _flips(d_v, d_s, tol)
    err_s, _ = _flips(s_v[None], s_s[None], tol)
    im_e = render_at_pose(slam, q, slam.cam_trans[:, t_last])[0]
    err_e, bad_e = _flips(im_v, im_e, tol)
    deepest, dropped = _tile_depth(st, est[t_last], cam, rcfg)
    print(f"viewer at --downscale 1, pose {t_last}, against the SLAM "
          f"object's render with the viewers' RasterConfig (K = "
          f"{rcfg.max_per_tile}): image max err {err:.3e} (pixels over "
          f"{tol:.1e}: {bad} of {W * H}), depth {err_d:.3e}, silhouette "
          f"{err_s:.3e}; against its eval render at K = "
          f"{slam.rcfg.max_per_tile}: max err {err_e:.3e}, {bad_e} pixels "
          f"over (the viewers' fixed K: the deepest tile has {deepest} "
          f"candidates, the cap drops {dropped})")
    if bad > max(2, 1e-5 * W * H) or not np.isfinite(err):
        raise AssertionError("the viewer's frame is not the SLAM map's")

    # --sh on a copy of the checkpoint with random higher bands, at the
    # default --downscale 2. The SH pre-pass is held on the card against
    # the CPU (the tolerance of test_eval_sh_cuda_matches_cpu), and the
    # card's frame against the card's render of the CPU's colours (1e-5,
    # as above). A whole frame rendered on the CPU is printed, not held:
    # the walls' Gaussians lie at depths a few float roundings apart, the
    # two devices round the camera transform differently, and a pair that
    # sorts the other way changes a pixel by a1 * a2 * (c2 - c1)
    from isogs_slam_tpu_torch.ops.sh import sh_colors_for_pose
    sh_run = os.path.join(tmp, "sh_experiments", "room0_0")
    os.makedirs(sh_run)
    data = dict(np.load(ckpt))
    shf = data["sh_coeffs_flat"].copy()
    shf[:, 3:] = 0.3 * np.random.default_rng(0).standard_normal(
        shf[:, 3:].shape)
    data["sh_coeffs_flat"] = shf.astype(np.float32)
    np.savez(os.path.join(sh_run, os.path.basename(ckpt)), **data)
    path_sh = _config_file(dict(config, workdir=os.path.dirname(sh_run)),
                           tmp, "replica_viewer_sh.py")
    final_recon.main([path_sh, "--sh", "--every", str(N_REPLICA),
                      "--device", str(dev)])
    st, cam, est, _, _, shf_t = load_scene(sh_run, return_sh=True,
                                           device=dev)
    cam = cam.scaled(cam.width // 2, cam.height // 2)
    fn = make_render_fn(cam, rcfg)
    center = -est[0][:3, :3].T @ est[0][:3, 3]
    cols = sh_colors_for_pose(
        shf_t, st.params.means3d,
        torch.as_tensor(center, dtype=torch.float32, device=dev))
    cols_cpu = sh_colors_for_pose(
        shf_t.cpu(), st.params.means3d.cpu(),
        torch.as_tensor(center, dtype=torch.float32))
    sh_ok = bool(torch.allclose(cols.cpu(), cols_cpu, rtol=2 ** -22,
                                atol=1e-6))
    sh_err = float((cols.cpu() - cols_cpu).abs().max())
    im_sh = render_w2c(fn, st, est[0], sh_flat=shf_t)[0]
    im_cpu_cols = render_w2c(fn, st._replace(params=st.params._replace(
        rgb_colors=cols_cpu.to(dev))), est[0])[0]
    tol = 1e-5 * max(1.0, float(im_cpu_cols.abs().max()))
    err, bad = _flips(im_sh, im_cpu_cols, tol)
    rgb = frame_to_uint8(render_w2c(fn, st, est[0])[0])
    png = imread(os.path.join(sh_run, "viz", "replay_color", "00000.png"))
    same_png = bool(np.array_equal(png, frame_to_uint8(im_sh)))
    st_c, cam_c, est_c, _, _, shf_c = load_scene(sh_run, return_sh=True,
                                                 device="cpu")
    im_c = render_w2c(make_render_fn(cam_c.scaled(cam.width, cam.height),
                                     rcfg), st_c, est_c[0], sh_flat=shf_c)[0]
    err_c, bad_c = _flips(im_sh.cpu(), im_c, tol)
    print(f"--sh at {cam.width}x{cam.height}: SH colours on the card "
          f"against the CPU max err {sh_err:.3e} (within rtol 2^-22 + "
          f"1e-6: {sh_ok}); the frame against the card's render of the "
          f"CPU's colours max err {err:.3e}, pixels over {tol:.1e}: {bad} "
          f"of {cam.width * cam.height}; the CLI's PNG is the card's frame: "
          f"{same_png}; mean |SH - stored RGB| "
          f"{np.abs(png.astype(int) - rgb).mean():.2f} levels; the whole "
          f"frame rendered on the CPU (information): max err {err_c:.3e}, "
          f"{bad_c} pixels over")
    if not (sh_ok and same_png and np.isfinite(err)
            and bad <= max(2, 1e-5 * cam.width * cam.height)):
        raise AssertionError("the --sh frame differs between card and CPU")

    rc = test_installation.main(["--device", str(dev)])
    if rc != 0:
        raise AssertionError("test_installation failed")
    exp_root = os.path.join(tmp, "experiments")
    model_browser.main(["--root", exp_root, "--text"])
    runs = sorted(os.path.relpath(r[0], exp_root)
                  for r in model_browser.scan_runs(exp_root))
    if runs != [os.path.join("Replica", "room0_0"),
                os.path.join("iPhone_Captures", "online_demo_0")]:
        raise AssertionError(f"model_browser lists {runs}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"viewers: final_recon x2 in {t_viz:.1f} s; launches on the "
          f"viewers' path (with test_installation) {launches}")
    phase("viewers (5i)", t0)
    return launches


class _Tee:
    """A stdout that also keeps what was written (to read warnings)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, x):
        self.text.append(x)
        return self.out.write(x)

    def flush(self):
        self.out.flush()


VOXEL, ISO, Z_CAP = 0.02, 1.0, 8    # the CLIs' defaults; the z-buffer cap
# the per-block list length the density pass starts from: the CLI's
# default of 256 doubles 6 times to 16,384, and the post-opt map (~0.9 M
# Gaussians in 60 non-empty blocks) needs 32,768: from 256 the pass drops
# 419,345 candidates there and the grid is 0.81 of its max off float64
MAX_PER_BLOCK = 4096


def _mesh_f64_check(dens, spec, params, n_blocks=16, n_voxels=256):
    """The card's density grid against mesh.density.density_reference (the
    same truncated sum in float64) at n_voxels sampled voxels of each of
    n_blocks sampled non-empty blocks. Returns (max abs error / grid max,
    seconds, non-empty blocks)."""
    import numpy as np
    from isogs_slam_tpu_torch.mesh import density as D
    t0 = time.perf_counter()
    B, bd = spec.block, spec.block_dims
    full = np.zeros([b * B for b in bd], np.float32)
    full[: dens.shape[0], : dens.shape[1], : dens.shape[2]] = dens
    bmax = full.reshape(bd[0], B, bd[1], B, bd[2], B).max(axis=(1, 3, 5))
    rng = np.random.default_rng(0)
    live = np.argwhere(bmax > 0)
    pick = live[rng.choice(len(live), min(n_blocks, len(live)),
                           replace=False)]
    err = 0.0
    for b in pick:
        lo = b * B
        hi = np.minimum(lo + B, spec.dims)
        ii = np.stack([rng.integers(lo[k], hi[k], n_voxels)
                       for k in range(3)], -1)
        pos = np.asarray(spec.origin) + ii * np.asarray(spec.spacing)
        ref = D.density_reference(
            pos, params["means3D"], params["log_scales"],
            params["unnorm_rotations"], params["logit_opacities"],
            max(1e-5, VOXEL / 2))
        err = max(err, float(np.abs(dens[tuple(ii.T)] - ref).max()))
    return err / float(dens.max()), time.perf_counter() - t0, len(live)


def _render_eval_size(ds, frames, verts, gt_verts):
    """(image scale, GT subdivision, nearest depth, fx) for the render
    eval: a marching face spans at most a voxel cell's diagonal,
    sqrt(3) x 2 cm, so the images are scaled down until such a face at the
    nearest depth any rendered pose sees (the mesh's or the ground
    truth's), stretched by up to 1.5 off the optical axis, stays within
    Z_CAP - 2 pixels (the z-buffer's per-face window); the ground-truth
    walls are cut into squares for which the same holds."""
    import numpy as np
    z_near, fx = np.inf, None
    for fi in frames:
        _, depth, intr, pose = ds[fi]
        h, w = depth.shape[:2]
        fx = float(intr[0, 0])
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        for v in (verts, gt_verts):
            c = v @ w2c[:3, :3].T + w2c[:3, 3]
            z = c[:, 2]
            zs = np.where(z > 1e-3, z, 1e-3)
            u = fx * c[:, 0] / zs + intr[0, 2]
            y = intr[1, 1] * c[:, 1] / zs + intr[1, 2]
            seen = ((z > 0.01) & (u > -8) & (u < w + 8) & (y > -8)
                    & (y < h + 8))
            if seen.any():
                z_near = min(z_near, float(z[seen].min()))
    px = Z_CAP - 2
    scale = min(1.0, px * z_near / (1.5 * fx * np.sqrt(3) * VOXEL))
    subdiv = int(np.ceil(1.5 * fx * scale * 4.0 * np.sqrt(2)
                         / (z_near * px)))
    return scale, subdiv, z_near, fx


def mesh_path(root, ckpt_path, tmp):
    """Phase 5f: the mesh path on 5c's checkpoint (see the module
    docstring). Raises on a failed check."""
    import numpy as np
    import torch
    from isogs_slam_tpu_torch import native_ext
    from isogs_slam_tpu_torch.io.checkpoints import load_checkpoint
    from isogs_slam_tpu_torch.mesh import density as D
    from isogs_slam_tpu_torch.mesh.marching import (largest_component,
                                                    marching_tetrahedra)
    from isogs_slam_tpu_torch.mesh.meshio import read_ply
    from isogs_slam_tpu_torch.scripts import (eval_mesh_geometry,
                                              extract_mesh_fast)
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    from isogs_slam_tpu_torch.slam.pipeline import _dataset_from_config
    from isogs_slam_tpu_torch.tools import profile_density, synth_gt_mesh
    t0 = time.perf_counter()
    lib = os.path.join(root, "native", "build_out", "libisogs_native.so")
    if not os.path.exists(lib) and shutil.which("g++"):
        tb = time.perf_counter()
        r = subprocess.run(["bash", os.path.join(root, "native", "build.sh")],
                           capture_output=True, text=True, timeout=600)
        print(f"native library: native/build.sh in "
              f"{time.perf_counter() - tb:.1f} s, rc {r.returncode}: "
              f"{(r.stdout + r.stderr).strip()[-300:]}")
    route = "native" if native_ext.available() else "numpy"
    config = load_experiment_config(os.path.join(
        root, "isogs_slam_tpu_torch", "configs", "synthetic",
        "post_splatam_opt_fullres.py"))
    config["workdir"] = tmp
    cfg_path = _config_file(config, tmp, "mesh_config.py")
    out_ply = os.path.join(tmp, "mesh", "mesh_post.ply")

    # the CLI as a user runs it
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ply = extract_mesh_fast.main([
        cfg_path, "--checkpoint", ckpt_path, "--device", "cuda",
        "--voxel-size", str(VOXEL), "--iso-level", str(ISO),
        "--max-per-block", str(MAX_PER_BLOCK), "--output", out_ply])
    t_cli = time.perf_counter() - t1
    peak_cli = torch.cuda.max_memory_allocated() / 2 ** 30
    if ply != out_ply or not all(os.path.exists(out_ply[:-3] + e)
                                 for e in ("ply", "obj", "stl", "txt")):
        raise AssertionError(f"extract_mesh_fast wrote {ply}, not the "
                             f"PLY/OBJ/STL/TXT set at {out_ply}")

    # the density pass alone: grown capacities, then two timed calls
    params = load_checkpoint(ckpt_path)
    n = params["means3D"].shape[0]
    info = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dens, spec = D.compute_density(params, voxel_size=VOXEL,
                                   min_scale_limit=VOXEL / 2,
                                   max_per_block=MAX_PER_BLOCK,
                                   device="cuda", info=info)
    torch.cuda.synchronize()
    t_cd = time.perf_counter() - t1

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    args = (dev32(params["means3D"]), dev32(params["log_scales"]),
            dev32(params["unnorm_rotations"]),
            dev32(params["logit_opacities"]),
            torch.ones(n, dtype=torch.bool, device="cuda"))
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g, _ = D.density_grid(*args, spec, info["max_isect"],
                              max_per_block=info["max_per_block"],
                              min_scale=VOXEL / 2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    peak_d = torch.cuda.max_memory_allocated() / 2 ** 30
    same = bool(torch.equal(g.cpu(), torch.as_tensor(dens)))
    del g, args
    torch.cuda.empty_cache()
    print(f"mesh: {n} Gaussians; grid {list(spec.dims)} = "
          f"{int(np.prod(spec.dims)):,} voxels in {spec.num_blocks} blocks "
          f"of {spec.block}^3 {spec.block_dims}; after {info['rounds']} "
          f"growth rounds max_isect {info['max_isect']}, max_per_block "
          f"{info['max_per_block']}, overflow {info['overflow']}")
    print(f"mesh: density min {float(dens.min()):.4f} max "
          f"{float(dens.max()):.4f} mean {float(dens.mean()):.5f}, voxels "
          f">= iso {ISO}: {int((dens >= ISO).sum()):,}")
    print(f"mesh: density pass at the grown capacities {times[0]:.4f} s "
          f"(first call), {times[1]:.4f} s (second), the grid equal to "
          f"compute_density's: {same}; compute_density with its growth "
          f"rounds and the host copies {t_cd:.3f} s; peak allocated "
          f"{peak_d:.3f} GiB (the CLI's whole run: {peak_cli:.3f} GiB, "
          f"{t_cli:.1f} s)")
    rel, t_ref, n_live = _mesh_f64_check(dens, spec, params)
    print(f"mesh: the card's grid against float64 at 256 voxels of each "
          f"of 16 sampled non-empty blocks (of {n_live}): max abs error / "
          f"grid max {rel:.3e} (tol {D.DENSITY_F64_RTOL:.0e}, what the "
          f"reference's own CPU grid meets at room coordinates; "
          f"{t_ref:.1f} s)")
    if info["overflow"] or not rel < D.DENSITY_F64_RTOL:
        raise AssertionError(f"the density grid is off float64 by {rel}")

    t1 = time.perf_counter()
    verts, faces = marching_tetrahedra(dens, ISO, spacing=spec.spacing,
                                       origin=spec.origin)
    t_mt = time.perf_counter() - t1
    t1 = time.perf_counter()
    lv, lf = largest_component(verts, faces)
    t_lc = time.perf_counter() - t1
    print(f"mesh: marching tetrahedra ({route}) {t_mt:.3f} s: "
          f"{len(verts):,} vertices, {len(faces):,} faces; "
          f"largest_component ({route}) {t_lc:.3f} s: {len(lv):,} "
          f"vertices, {len(lf):,} faces")
    mesh = read_ply(out_ply)
    if not (len(lf) > 0 and np.isfinite(lv).all()
            and len(mesh["faces"]) == len(lf)
            and np.isfinite(mesh["vertices"]).all()):
        raise AssertionError("the mesh is empty, not finite, or not the "
                             "CLI's")
    del dens, verts, faces

    # geometry eval against the analytic room, with the render eval
    dc = config["data"]
    ds = _dataset_from_config(config, dc["desired_image_height"],
                              dc["desired_image_width"], "cuda")
    frames = list(range(0, len(ds), 5))[:4]
    coarse = synth_gt_mesh.gt_room_mesh(2.0, 64)[0]
    scale, subdiv, z_near, fx = _render_eval_size(ds, frames, lv, coarse)
    eh = int(round(dc["desired_image_height"] * scale / 2)) * 2
    ew = int(round(dc["desired_image_width"] * scale / 2)) * 2
    print(f"mesh: nearest surface a rendered pose sees {z_near:.3f} m at "
          f"fx {fx:.1f}: render eval at {ew}x{eh}, ground truth subdivided "
          f"{subdiv} x {subdiv} per wall")
    gt = os.path.join(tmp, "mesh", "gt_room.ply")
    synth_gt_mesh.main(["--out", gt, "--subdiv", str(subdiv)])
    cfg_eval = dict(config, data=dict(dc, desired_image_height=eh,
                                      desired_image_width=ew))
    eval_path = _config_file(cfg_eval, tmp, "mesh_eval_config.py")
    tee = _Tee(sys.stdout)
    t1 = time.perf_counter()
    old, sys.stdout = sys.stdout, tee
    try:
        res = eval_mesh_geometry.main([
            eval_path, "--gt-mesh", gt, "--pred-mesh", out_ply,
            "--render-eval", "--render-every", "5", "--render-max-frames",
            "4", "--device", "cuda"])
    finally:
        sys.stdout = old
    t_eval = time.perf_counter() - t1
    rev = res["render_eval"]
    print(f"mesh geometry (eval {t_eval:.1f} s): accuracy "
          f"{res['accuracy'] * 100:.3f} cm, completion "
          f"{res['completion'] * 100:.3f} cm, chamfer "
          f"{res['chamfer_distance'] * 100:.3f} cm, F-score@5cm "
          f"{res['f_score']:.4f} (P {res['precision']:.4f} / R "
          f"{res['recall']:.4f}), hausdorff_95 "
          f"{res['hausdorff_95'] * 100:.3f} cm, completion ratio "
          f"{res['completion_ratio']:.4f}; render eval over frames "
          f"{rev['frames']}: depth L1 {rev['depth_l1_cm']:.4f} cm, RMSE "
          f"{rev['depth_rmse_cm']:.4f} cm, overlap "
          f"{rev['mean_overlap']:.4f}")
    if "[zbuffer]" in "".join(tee.text):
        raise AssertionError("a face exceeded the z-buffer's footprint cap")
    if not res["accuracy"] < 0.05:
        raise AssertionError(f"mesh accuracy {res['accuracy']} m: the "
                             f"mesh collapsed")

    t1 = time.perf_counter()
    profile_density.main(["--n", "500000", "--reps", "3"])
    print(f"profile_density: {time.perf_counter() - t1:.1f} s")
    phase("mesh (5f)", t0)


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import isogs_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run "
              f"from a checkout of the repository", file=sys.stderr)
        return 3
    import numpy as np
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.ops import composite as comp
    from isogs_slam_tpu_torch.ops.segreduce import (
        segment_reduce_rows_cuda, segment_reduce_rows_plain)
    from isogs_slam_tpu_torch.slam.densify import DensifyConfig
    from isogs_slam_tpu_torch.slam.losses import LossConfig
    from isogs_slam_tpu_torch.slam.keyframes import KeyframeLibrary
    from isogs_slam_tpu_torch.slam.mapping import (MappingConfig,
                                                   PruneConfig, map_frame)
    from isogs_slam_tpu_torch.slam.pointcloud import (add_new_gaussians,
                                                      initialize_first_frame)
    from isogs_slam_tpu_torch.slam.tracking import (TrackingConfig,
                                                    pyramid_cam, track_frame)
    dev = torch.device("cuda")

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    phase("card", t0)

    # 2. build
    t0 = time.perf_counter()
    logs = _cuda.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "smem")):
                print(f"[ptxas {name}] {line.strip()}")
    phase("build", t0)

    ds, cam, capacity, rcfg, rcfg_track = scene(dev)
    lcfg_track = LossConfig(
        tracking=True, use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0, w_flat=0.0,
        w_iso=0.0, calc_iso=False, sil_norm_render=True)
    lcfg_map = LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0, w_flat=50.0,
        w_iso=2.0, iso_sample_size=8192, iso_k=16, calc_iso=True,
        knn_block=8192)
    tcfg = TrackingConfig(num_iters=TRACK_ITERS, lr_quat=0.0004,
                          lr_trans=0.002)
    mcfg = MappingConfig(
        num_iters=MAP_ITERS, lr_means3d=0.0001, lr_rgb_colors=0.0025,
        lr_unnorm_rotations=0.001, lr_logit_opacities=0.05,
        lr_log_scales=0.001,
        prune=PruneConfig(True, 0, 0, 20, 20, 0.005, 0.005, False, 500))

    t0 = time.perf_counter()
    frames = [load_frame(ds, i, dev) for i in range(N_FRAMES + 1)]
    torch.cuda.synchronize()
    phase("dataset render", t0)

    # 3. each kernel against its plain version on a real render's inputs
    t0 = time.perf_counter()
    inputs, ctx = composite_inputs(frames, cam, capacity, rcfg, rcfg_track,
                                   dev)
    inputs.update(camera_inputs(ctx, rcfg, dev))
    results = {}
    rng = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        # the live demo's 480x360: a half-empty last tile row
        for c in (cam, pyramid_cam(cam, 1), cam.scaled(480, 360)):
            check_tile_crop(c, dev)
        for tag, rec in inputs.items():
            g, cnt, tx, bdt, b = (rec["g"], rec["cnt"], rec["tiles_x"],
                                  rec["bdt"], rec["bins"])
            T, K, C = g.shape
            print(f"[{tag}] {rec['desc']}: tiles_x {tx}, gdata "
                  f"{tuple(g.shape)} slots {int(cnt.sum())} max count "
                  f"{int(cnt.max())}, u up to {float(g[..., 0].max()):.1f}"
                  + ("" if b is None else
                     f"; binning: {int(b.n_isect)} intersections, "
                     f"{int(b.n_overflow)} dropped by the caps "
                     f"({int(b.n_true_overflow)} of them true candidates)"))
            out, ft, last, tend = comp.composite_fwd_cuda(g, cnt, 4, tx, 3)
            out_p, ft_p = comp.composite_fwd_plain(g, cnt, 4, tx, 3,
                                                   chunk=32)
            err_o = (out - out_p).abs()
            err_f = (ft - ft_p).abs()
            fwd_err = max(float(err_o.max()), float(err_f.max()))
            # images 1e-5 of their range; a pixel where a threshold test
            # (alpha >= 1/255, T (1 - alpha) >= 1e-4) flips between the
            # two summation orders may differ by that one slot's weight
            tol = 1e-5 * max(1.0, float(out_p.abs().max()))
            bad = int((err_o > tol).any(-1).sum() + (err_f > 1e-5).sum())
            print(f"[{tag}] composite_fwd max_abs_err {fwd_err:.3e} "
                  f"(tol {tol:.1e}); pixels over tol {bad} of {T * 256}")
            rec["flipped"] = bad
            if bad > max(2, 1e-5 * T * 256) or not np.isfinite(fwd_err):
                raise AssertionError(f"composite_fwd disagrees ({tag})")

            gout = torch.randn(out.shape, generator=rng, device=dev)
            dfin = torch.randn(ft.shape, generator=rng, device=dev)
            dg = comp.composite_bwd_cuda(g, cnt, gout, dfin, last, tend, 4,
                                         tx, 3, bdt)
            dg_p = comp.composite_bwd_plain(g, cnt, gout, dfin, 4, tx, 3,
                                            chunk=32)
            diff = (dg.float() - dg_p.to(bdt).float()).abs()
            bwd_err = float(diff.max())
            scale = dg_p.abs().amax(dim=(0, 1))
            rel = float((diff.amax(dim=(0, 1)) / scale.clamp(min=1e-30))
                        .max())
            # f32: 1e-4 of each column's max (the reference's gradient
            # tolerance); bf16: one bf16 rounding (2^-8) of the column max
            btol = 1e-4 if bdt == torch.float32 else 2 ** -7
            print(f"[{tag}] composite_bwd ({bdt}) max_abs_err "
                  f"{bwd_err:.3e}; max error / column max {rel:.3e} "
                  f"(tol {btol:.1e})")
            if not rel < btol:
                raise AssertionError(f"composite_bwd disagrees ({tag})")

            if tag in ("track", "map"):
                # kernel B's algebra in plain PyTorch (block cull, exp-free
                # reject test, two per-pair scalars, 11 sums in tile-local
                # coordinates) against autograd through the plain forward
                dg_m = comp.composite_bwd_moments(g, cnt, gout, dfin, 4, tx,
                                                  3, chunk=32)
                rel_m = float(((dg_m - dg_p).abs().amax(dim=(0, 1))
                               / scale.clamp(min=1e-30)).max())
                print(f"[{tag}] composite_bwd_moments (plain algebra of "
                      f"kernel B) max error / column max {rel_m:.3e} (tol "
                      f"1.0e-04)")
                if not rel_m < 1e-4:
                    raise AssertionError(
                        f"the moments algebra disagrees ({tag})")
                del dg_m

            ev, inc, ev_b = pair_counts(g, cnt, tx)
            slots_b = int(cnt.sum()) * C * 4
            fo = 5
            fwd_bytes = slots_b + T * 4 + T * 256 * (fo + 1) * 4
            fwd_ops = 15 * ev + (5 + 2 * fo) * inc
            bwd_bytes = (slots_b + T * 4 + T * 256 * (fo + 1) * 4
                         + T * K * C * dg.element_size())
            # 15 operations of `power` for every pair up to each pixel's
            # last included slot, and the gradient arithmetic of the
            # included ones
            bwd_ops = 15 * ev_b + (45 + 3 * fo + C) * inc
            ms_f = cuda_ms(lambda: comp.composite_fwd_cuda(g, cnt, 4, tx, 3),
                           20)
            pms_f = cuda_ms(lambda: comp.composite_fwd_plain(
                g, cnt, 4, tx, 3, chunk=32), 2)
            ms_b = cuda_ms(lambda: comp.composite_bwd_cuda(
                g, cnt, gout, dfin, last, tend, 4, tx, 3, bdt), 20)
            pms_b = cuda_ms(lambda: comp.composite_bwd_plain(
                g, cnt, gout, dfin, 4, tx, 3, chunk=32), 2)
            print(f"[{tag}] pairs evaluated {ev} included {inc}; evaluated "
                  f"by the backward {ev_b}")
            for name, err, ms, pms, nb, no in (
                    ("composite_fwd", fwd_err, ms_f, pms_f, fwd_bytes,
                     fwd_ops),
                    ("composite_bwd", bwd_err, ms_b, pms_b, bwd_bytes,
                     bwd_ops)):
                bms, by = bound(nb, no)
                results[f"{name}[T={T},K={K}]"] = dict(
                    kernel=name, max_abs_err=err, ms=ms, plain_ms=pms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    flipped_pixels=bad, tiles_x=tx)
                print(f"[{tag}] {name}[T={T},K={K}] {ms:.4f} ms (plain "
                      f"{pms:.2f} ms, bound {bms:.4f} ms by {by})")
            if tag in ("map", "stripe"):
                rec["dg"] = dg
            del out, ft, last, tend, out_p, ft_p, gout, dfin, dg_p, diff

        # segment reduce at N = capacity on kernel B's bf16 rows written
        # back in expansion order: every tile's rows (the exact mapping
        # backward's input), then a stripe's rows only (the fast mode's)
        M = rcfg.max_isect(capacity)
        b_map = ctx["bins"][rcfg.max_per_tile]
        offs = b_map.exp_offsets
        E = int(offs[-1])
        lengths = (offs[1:] - offs[:-1]).long()
        n_seg = offs.shape[0] - 1
        for key, pos, dg_rows in (
                ("segreduce", b_map.slot_exp_pos, inputs["map"]["dg"]),
                ("segreduce[stripe rows]",
                 b_map.slot_exp_pos[ctx["stripe_sel"]],
                 inputs["stripe"]["dg"])):
            d_exp = torch.zeros((M + 1, 10), dtype=torch.bfloat16,
                                device=dev)
            d_exp[pos.reshape(-1)] = dg_rows[:, :pos.shape[1]].reshape(-1,
                                                                       10)
            seg = segment_reduce_rows_cuda(d_exp, offs)
            seg_p = segment_reduce_rows_plain(d_exp, offs)
            seg_err = float((seg - seg_p).abs().max())
            # f32 sums in another order: within a few f32 roundings of each
            # segment's absolute sum
            abs_sum = segment_reduce_rows_plain(d_exp.float().abs(), offs)
            seg_ok = bool(torch.all((seg - seg_p).abs() <= 1e-6 * abs_sum
                                    + 1e-7))
            print(f"{key} N {n_seg} rows {E} ("
                  f"{int((d_exp[:E] != 0).any(1).sum())} non-zero) "
                  f"max_abs_err {seg_err:.3e} (tol 1e-6 of each segment's "
                  f"absolute sum)")
            if not seg_ok:
                raise AssertionError(f"{key} disagrees")
            ms_c = cuda_ms(lambda: segment_reduce_rows_cuda(d_exp, offs), 20)
            pms_c = cuda_ms(lambda: segment_reduce_rows_plain(d_exp, offs),
                            5)
            lib_in = d_exp[:E]
            try:
                torch.segment_reduce(lib_in, "sum", lengths=lengths, axis=0)
                lib_note = "bf16 input"
            except RuntimeError:
                lib_in = lib_in.float()
                lib_note = "f32 copy of the input (bf16 not supported)"
            lib_c = cuda_ms(lambda: torch.segment_reduce(
                lib_in, "sum", lengths=lengths, axis=0), 20)
            bms, by = bound(E * 10 * 2 + (n_seg + 1) * 4 + 10 * n_seg * 4,
                            E * 10)
            results[key] = dict(
                kernel="segreduce", max_abs_err=seg_err, ms=ms_c,
                plain_ms=pms_c, bound_ms=bms, bound_by=by, library_ms=lib_c)
            print(f"{key} {ms_c:.4f} ms (plain {pms_c:.2f} ms, "
                  f"torch.segment_reduce {lib_c:.4f} ms on {lib_note}, "
                  f"bound {bms:.4f} ms by {by})")
    flips = {t: r["flipped"] for t, r in inputs.items()}
    print(f"pixels over tolerance per input (threshold flips): {flips}")
    del g, b, dg, d_exp, seg, seg_p, abs_sum, lib_in, rec, dg_rows, pos
    torch.cuda.synchronize()
    phase("kernels vs plain", t0)

    # 3b, 3c: the two subset routes, and the output-preserving binnings
    subset_routes(inputs, ctx, cam, capacity, rcfg, dev)
    cull_phase(ctx, cam, rcfg, dev)
    t0 = time.perf_counter()
    del inputs, ctx, b_map
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. the per-frame step driven by hand, launch counters from 0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(0)
    rng_np = np.random.default_rng(0)
    im0, d0, q0, t0_ = frames[0]
    state = initialize_first_frame(im0, d0, cam, capacity, 3.0,
                                   generator=gen, device=dev)
    kf = KeyframeLibrary(2, H, W, dev)
    kf.add_keyframe(0, im0, d0, q0, t0_, np.eye(4))
    torch.cuda.synchronize()
    print(f"init: {int(state.num_alive())} Gaussians, capacity {capacity}")
    for i in range(1, N_FRAMES + 1):
        im, d, q_gt, t_gt = frames[i]
        tf = time.perf_counter()
        res = track_frame(state.params, state.alive, q_gt, t_gt, im, d, cam,
                          rcfg_track, lcfg_track, tcfg)
        torch.cuda.synchronize()
        t_track = time.perf_counter() - tf
        last_track = res.loss_log[res.iters_run - 1]
        qn = res.quat / res.quat.norm()
        ang = 2 * torch.acos(torch.clamp(torch.abs(torch.dot(
            qn, q_gt / q_gt.norm())), max=1.0))
        terr = float((res.trans - t_gt).norm())
        print(f"frame {i}: track {t_track:.3f} s, pose error "
              f"{terr * 100:.4f} cm / {float(ang) * 180 / np.pi:.5f} deg, "
              f"tracking loss {float(last_track[0]):.4f} "
              f"(mask {float(last_track[6]):.3f})")
    # one more tracking frame for each tracking refinement, from the same
    # ground-truth pose: a finite pose no farther from the ground truth
    # than the plain tracker's plus one Adam step
    step_t, step_q = tcfg.lr_trans * 3 ** 0.5, tcfg.lr_quat * 2.0
    qerr_plain = float((qn - q_gt / q_gt.norm()).norm())
    for name, kw in (("gn_iters=3", dict(gn_iters=3)),
                     ("fan_rounds=2", dict(fan_rounds=2)),
                     ("polyak_rho=0.8", dict(polyak_rho=0.8)),
                     ("early_stop_patience=3", dict(early_stop_patience=3)),
                     ("rebin_every_iter", dict(rebin_every_iter=True))):
        tf = time.perf_counter()
        r = track_frame(state.params, state.alive, q_gt, t_gt, im, d, cam,
                        rcfg_track, lcfg_track, tcfg._replace(**kw))
        torch.cuda.synchronize()
        t_r = time.perf_counter() - tf
        rq = r.quat / r.quat.norm()
        e_t = float((r.trans - t_gt).norm())
        e_q = float((rq - q_gt / q_gt.norm()).norm())
        print(f"refinement {name}: {t_r:.3f} s, {r.iters_run} iterations, "
              f"pose error {e_t * 100:.4f} cm / quaternion {e_q:.2e} (plain "
              f"{terr * 100:.4f} cm / {qerr_plain:.2e}), GN verdict "
              f"{int(r.gn_accepted)}")
        if not (bool(torch.isfinite(r.quat).all())
                and bool(torch.isfinite(r.trans).all())
                and e_t <= terr + step_t and e_q <= qerr_plain + step_q):
            raise AssertionError(f"tracking with {name} left the pose "
                                 f"farther than one Adam step beyond the "
                                 f"plain tracker's")
    tm = time.perf_counter()
    state = add_new_gaussians(state, im, d, res.quat, res.trans,
                              float(N_FRAMES), cam, rcfg, sil_thres=0.5,
                              generator=gen)
    kf.add_keyframe(N_FRAMES, im, d, res.quat, res.trans, np.eye(4))
    iter_slots = rng_np.integers(0, 2, size=MAP_ITERS)
    state, mlog, bstats = map_frame(state, kf.colors, kf.depths, kf.quats,
                                    kf.trans, iter_slots, cam, rcfg,
                                    lcfg_map, mcfg, generator=gen)
    torch.cuda.synchronize()
    last_map = mlog[-1]
    print(f"mapping ({MAP_ITERS} iterations over 2 keyframes): "
          f"{time.perf_counter() - tm:.3f} s, {int(state.num_alive())} "
          f"Gaussians, bin stats (true overflow, isect, max isect) "
          f"{[int(x) for x in bstats]}")
    # one more mapping phase with in-mapping densification (clone / split
    # from the gradient in (u, v), every 5th iteration)
    thresh, med = uv_grad_quantile(state, im0, d0, q0, t0_, cam, rcfg)
    print(f"|d loss / d(u, v)| over the rendered rows at frame 0: median "
          f"{med:.3e}, 90th percentile {thresh:.3e} (the densification "
          f"threshold below)")
    tm = time.perf_counter()
    dcfg = DensifyConfig(start_after=0, remove_big_after=10 ** 9,
                         stop_after=10 ** 9, densify_every=5,
                         grad_thresh=thresh, reset_opacities=False)
    hwm_d = int(state.hwm)
    state, dlog, dstats = map_frame(
        state, kf.colors, kf.depths, kf.quats, kf.trans, iter_slots, cam,
        rcfg, lcfg_map, mcfg._replace(use_densification=True, densify=dcfg),
        generator=gen)
    torch.cuda.synchronize()
    n_clone, n_split, n_drop = (int(x) for x in dstats[3:6])
    print(f"mapping with densification ({MAP_ITERS} iterations, "
          f"densify_every 5): {time.perf_counter() - tm:.3f} s; {n_clone} "
          f"cloned, {n_split} split, {n_drop} rows dropped at capacity "
          f"{state.capacity}; high-water mark {hwm_d} -> {int(state.hwm)}, "
          f"{int(state.num_alive())} Gaussians")
    if not (n_clone + n_split > 0 and int(state.hwm) > hwm_d
            and bool(torch.isfinite(dlog).all())):
        raise AssertionError("in-mapping densification did not run")
    launches_hand = dict(_cuda.LAUNCHES)
    print(f"final mapping loss terms (loss, im, depth, flat, iso, "
          f"density, mask) {[round(float(x), 6) for x in last_map]}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB; launches on the hand-driven path {launches_hand}")
    phase(f"hand-driven path (init + {N_FRAMES} frames + mapping)", t0)
    finite = (torch.isfinite(last_track).all()
              and torch.isfinite(last_map).all()
              and all(torch.isfinite(p).all() for p in state.params))
    if not finite:
        raise AssertionError("non-finite losses or parameters")
    del state, kf, frames, ds, res, mlog
    torch.cuda.empty_cache()

    # 5. the pipeline paths: the port's CLI at full width, counters from 0;
    # the exact run's directory stays for 5c
    launches_cli, tr_exact, mp_exact, slam = pipeline_path(
        root, "full_res.py", END_AT_EXACT, keep=True)
    slam_dir = os.path.dirname(slam.output_dir)
    tmp = tempfile.mkdtemp(prefix="isogs_offline_")
    try:
        # 5c, 5d, 5e: post-SLAM optimization, the offline trainer and the
        # novel-view evaluation, counters from 0 before each
        torch.cuda.empty_cache()
        launches_post, post = postopt_path(root, slam, tmp)
        ckpt_post = os.path.join(post.output_dir,
                                 f"params{post.num_frames - 1}.npz")
        del post, slam
        torch.cuda.empty_cache()
        launches_offline = offline_path(root, tmp)
        torch.cuda.empty_cache()
        launches_nvs = nvs_path(root, ckpt_post, tmp)
        # 5f: the mesh path launches none of the kernels, so it is not
        # among the paths of the kernels line
        torch.cuda.empty_cache()
        mesh_path(root, ckpt_post, tmp)
    finally:
        shutil.rmtree(slam_dir, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    launches_fast, tr_fast, mp_fast, slam_fast = pipeline_path(
        root, "full_res_fastlegal.py", END_AT_FAST)
    ates = [slam_fast.eval_results["Final Average ATE RMSE (cm)"]]
    del slam_fast
    torch.cuda.empty_cache()
    # the same run again, same seed: the mapping stripe's backward goes
    # through kernel C (f32 sums in a fixed order), as in the reference
    _, _, _, slam_fast = pipeline_path(root, "full_res_fastlegal.py",
                                       END_AT_FAST)
    ates.append(slam_fast.eval_results["Final Average ATE RMSE (cm)"])
    del slam_fast
    print(f"fast run twice, same seed: ATE {ates[0]:.6f} and {ates[1]:.6f}"
          f" cm, difference {ates[1] - ates[0]:.6f} cm")
    n_c = launches_fast.get("segreduce", 0)
    n_stripe = sum(v for k, v in launches_fast.items()
                   if k.startswith("composite_bwd[T=975,"))
    n_exact = sum(v for k, v in launches_fast.items()
                  if k.startswith("composite_bwd[T=3225,")
                  and int(k.split("K=")[1].rstrip("]")) >= 512)
    print(f"fast run: kernel C launched {n_c} times for {n_stripe} stripe "
          f"backwards (T=975) and {n_exact} exact mapping backwards")
    if not (n_stripe > 0 and n_c >= n_stripe + n_exact):
        raise AssertionError("the mapping stripe's backward did not go "
                             "through kernel C")
    nt, nm = len(tr_exact), len(mp_exact)
    print(f"fast against exact, same call, over the frames both ran (1-"
          f"{nt}; mapping phases 1-{nm}): tracking "
          f"{np.mean(tr_fast[:nt]):.4f} s/frame against "
          f"{np.mean(tr_exact):.4f}; mapping {np.mean(mp_fast[:nm]):.4f} "
          f"s/phase against {np.mean(mp_exact):.4f}; the fast run's whole "
          f"{len(tr_fast)} frames: {np.mean(tr_fast):.4f} s/frame, "
          f"{np.mean(mp_fast):.4f} s/phase")
    sub_shapes = [k for k, n in launches_fast.items()
                  if n > 0 and any(f"[T={t}," in k for t in (806, 209, 975))]
    if not (any("fwd[T=806," in k for k in sub_shapes)
            and any("bwd[T=209," in k for k in sub_shapes)
            and any("bwd[T=975," in k for k in sub_shapes)):
        raise AssertionError(f"the fast path launched no virtual-row shape: "
                             f"{launches_fast}")

    # 5g, 5h, 5i: the shipped Replica config, the live demo, the viewers;
    # the runs share one experiments root (tmp/experiments) for the browser
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="isogs_front_")
    try:
        launches_replica, slam = replica_path(root, tmp, dev)
        torch.cuda.empty_cache()
        launches_live = live_path(root, tmp, dev)
        torch.cuda.empty_cache()
        launches_viewers = viewer_path(root, tmp, dev, slam)
        del slam
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # 6. kernels line: launches of the paths, each read after its run
    paths = (("hand-driven", launches_hand), ("pipeline", launches_cli),
             ("post-opt", launches_post), ("offline", launches_offline),
             ("novel view", launches_nvs), ("fast pipeline", launches_fast),
             ("Replica config", launches_replica),
             ("live demo", launches_live), ("viewers", launches_viewers))
    kernels = []
    forward_only = ("novel view",)
    for path_name, launches in paths:
        for kname in SOURCES:
            if path_name in forward_only and kname != "composite_fwd":
                continue
            if not any(k.startswith(kname) and n > 0
                       for k, n in launches.items()):
                raise AssertionError(f"{kname} was not launched on the "
                                     f"{path_name} path")
        unchecked = [k for k in launches if k not in results]
        if unchecked:
            raise AssertionError(f"shapes launched on the {path_name} path "
                                 f"but not held against the plain version: "
                                 f"{unchecked}")
    for key, r in results.items():
        n = sum(launches.get(key, 0) for _, launches in paths)
        if n <= 0:
            print(f"[kernels] {key}: held against its plain version "
                  f"({r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms) but "
                  f"launched on no path in this run (the launch counter "
                  f"does not tell a stripe's rows from all rows)"
                  if "stripe rows" in key else
                  f"[kernels] {key}: held against its plain version "
                  f"({r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms) but "
                  f"launched on no path in this run")
            continue
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[r["kernel"]],
            "replaces": REPLACES[r["kernel"]], "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the forward's pixels over tolerance against the plain version
            # (threshold flips) on this shape's input; null for segreduce
            "flipped_pixels": r.get("flipped_pixels"),
            "tiles_x": r.get("tiles_x")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    phase("total", t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_offline_chunk(runner):
    """torch.profiler over one more chunk of the post-opt runner (not part
    of the default run): the device's busy share of the chunk."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from isogs_slam_tpu_torch.core import optim
    from isogs_slam_tpu_torch.slam.offline import expon_lr, offline_chunk
    t0 = time.perf_counter()
    ocfg, dev = runner.ocfg, runner.device
    fsel = np.arange(min(ocfg.frames_per_chunk, runner.num_frames))
    cols = [np.clip(runner.dataset[int(f)][0], 0, 255).astype(np.uint8)
            for f in fsel]
    deps = [runner.dataset[int(f)][1][..., 0] for f in fsel]
    frames = (torch.as_tensor(np.stack(cols), device=dev),
              torch.as_tensor(np.stack(deps), device=dev),
              torch.as_tensor(runner.cam_rots[:, fsel].T, device=dev),
              torch.as_tensor(runner.cam_trans[:, fsel].T, device=dev))
    iters = np.arange(ocfg.chunk_iters) % len(fsel)
    lrs = expon_lr(np.arange(1, ocfg.chunk_iters + 1), ocfg.lr_means3d,
                   ocfg.lr_means3d_final, ocfg.lr_delay_mult, ocfg.num_iters)
    opt = optim.init(runner.state.params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        offline_chunk(runner.state, opt, *frames, iters, lrs, 0, runner.cam,
                      runner.rcfg, ocfg)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - tw
    dev_s = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20,
                                    max_name_column_width=60))
    print(f"profile: one post-opt chunk of {ocfg.chunk_iters} iterations "
          f"{t_c:.3f} s (wall, profiler on); device time {dev_s:.3f} s = "
          f"{dev_s / t_c:.3f} of the wall time")
    phase("profile (post-opt chunk)", t0)


def profile_pipeline(slam, time_idx):
    """torch.profiler over one more tracking frame and one more densify +
    mapping phase of the pipeline's SLAM object (not part of the default
    run): kernel time by name and the device's busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    color, depth, _, pose = slam.dataset[time_idx]
    slam.gt_w2c_all.append(np.linalg.inv(np.asarray(pose, np.float64)))
    im, d = slam._to_chw_frame(color, depth)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        slam.track(time_idx, im, d)
        torch.cuda.synchronize()
        t_tr = time.perf_counter() - tw
        tw = time.perf_counter()
        slam.densify(time_idx, im, d)
        slam.map(time_idx, im, d)
        torch.cuda.synchronize()
        t_mp = time.perf_counter() - tw
    # device busy time: the kernels' own events (an operator's row would
    # count its kernels a second time)
    dev_s = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30,
                                    max_name_column_width=60))
    print(f"profile: tracking frame {t_tr:.3f} s, densify + mapping phase "
          f"{t_mp:.3f} s (wall, profiler on); device time {dev_s:.3f} s = "
          f"{dev_s / (t_tr + t_mp):.3f} of the wall time")
    phase("profile", t0)


if __name__ == "__main__":
    sys.exit(main())
