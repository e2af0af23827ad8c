"""The graft entry points of the port (counterpart of the repository's root
__graft_entry__.py): the flagship forward step with example arguments, and
a dry run of the multi-device programs on tiny shapes.

`entry()` returns the fused mapping-loss forward (6-channel differentiable
rasterization through kernel A, masked L1 / SSIM, IsoGS flat and iso-surface
regularizers), the port's analog of the reference's `get_loss`
(scripts/splatam.py:494-760).

`dryrun_multichip(n)` runs, on the n ranks of a torch.distributed world,
the view-parallel mapping phase (render B = n views, mean loss, gradient
all_reduce, Adam, the prune schedule), the tile-sharded render and its
loss's gradient, the tile-sharded tracker and the block-sharded density
grid, and checks that every result is finite.

Run:
  python -m isogs_slam_tpu_torch.graft_entry [--device cuda|cpu]
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m isogs_slam_tpu_torch.graft_entry --dryrun 2 [--device cpu]
(gloo when the ranks share one card or run on the CPU; parallel/dist.py).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import resolve_device


def _tiny_scene(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    log_scales = np.full((n, 3), np.log(0.08), np.float32)
    logit_op = np.full((n, 1), 1.5, np.float32)
    return means, rgb, quats, logit_op, log_scales


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) is the mapping loss (a 0-d
    tensor) of a 2,048-Gaussian scene at 128x96. The last argument is the
    torch.Generator the iso loss draws its sample rows from; fn's keyword
    `iso_sel` hands it the rows instead."""
    from .core.camera import Camera
    from .core.gaussians import GaussianParams
    from .ops.rasterize import RasterConfig
    from .slam.losses import LossConfig, compute_loss

    dev = resolve_device(device)
    n = 2048
    cam = Camera(width=128, height=96, fx=96.0, fy=96.0, cx=63.5, cy=47.5)
    rcfg = RasterConfig(max_per_tile=128, tile_chunk=48)
    lcfg = LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=50.0, w_iso=2.0, iso_sample_size=256, iso_k=8,
        calc_iso=True, knn_block=2048)
    alive = torch.ones(n, dtype=torch.bool, device=dev)

    def fn(means3d, rgb_colors, unnorm_rotations, logit_opacities,
           log_scales, cam_quat, cam_trans, gt_im, gt_depth, generator,
           iso_sel=None):
        params = GaussianParams(
            means3d=means3d, rgb_colors=rgb_colors,
            unnorm_rotations=unnorm_rotations,
            logit_opacities=logit_opacities, log_scales=log_scales)
        out = compute_loss(params, alive, cam_quat, cam_trans, gt_im,
                           gt_depth, cam, rcfg, lcfg, iso_sel=iso_sel,
                           generator=generator)
        return out.loss

    example_args = (
        *[torch.as_tensor(a, device=dev) for a in _tiny_scene(n)],
        torch.tensor([1.0, 0, 0, 0], device=dev),
        torch.zeros(3, device=dev),
        torch.full((3, cam.height, cam.width), 0.5, device=dev),
        torch.full((1, cam.height, cam.width), 2.5, device=dev),
        torch.Generator(device=dev).manual_seed(0),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-device programs on the first n_devices ranks of the
    world (this process is one rank; at world size 1, n_devices = 1 runs
    them unsharded), on tiny shapes; raises on a non-finite result."""
    from .core.camera import Camera
    from .core.gaussians import append_rows, empty_state, new_gaussian_rows
    from .mesh.density import density_grid_sharded, make_grid
    from .ops.rasterize import RasterConfig
    from .parallel.dist import init_distributed, make_mesh
    from .parallel.sharded import make_multiview_map_phase, replicate
    from .parallel.tile_sharded import make_tile_mesh, render_tiles_sharded
    from .parallel.track_sharded import make_tracking_frame_sharded
    from .slam.losses import LossConfig
    from .slam.mapping import MappingConfig, PruneConfig
    from .slam.tracking import TrackingConfig

    dev = init_distributed(resolve_device(device))
    mesh = make_mesh(n_devices, dev)

    n = 1024
    cam = Camera(width=64, height=48, fx=48.0, fy=48.0, cx=31.5, cy=23.5)
    rcfg = RasterConfig(max_per_tile=64, tile_chunk=12)
    lcfg = LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=50.0, w_iso=2.0, iso_sample_size=128, iso_k=8,
        calc_iso=True, knn_block=1024)
    mcfg = MappingConfig(
        num_iters=2, lr_means3d=1e-4, lr_rgb_colors=2.5e-3,
        lr_unnorm_rotations=1e-3, lr_logit_opacities=0.05,
        lr_log_scales=1e-3,
        prune=PruneConfig(True, 0, 0, 20, 20, 0.005, 0.005, True, 8))

    means, rgb, _, _, _ = _tiny_scene(n, seed=1)
    state = empty_state(2048, dev)
    state = append_rows(
        state,
        new_gaussian_rows(torch.as_tensor(means, device=dev),
                          torch.as_tensor(rgb, device=dev),
                          torch.full((n,), 4e-4, device=dev)),
        torch.ones(n, dtype=torch.bool, device=dev), 0)
    state = replicate(mesh, state)

    # the view-parallel mapping phase: B = n views a step, 2 steps
    B = n_devices
    S = B + 2  # window slots
    kf_colors = torch.full((S, cam.height, cam.width, 3), 128,
                           dtype=torch.uint8, device=dev)
    kf_depths = torch.full((S, cam.height, cam.width), 2.5, device=dev)
    kf_quats = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(S, 1)
    kf_transl = torch.zeros((S, 3), device=dev)
    n_steps = 2
    step_slots = np.arange(n_steps * B).reshape(n_steps, B) % S
    phase = make_multiview_map_phase(mesh, cam, rcfg, lcfg, mcfg)
    new_state, mlog, _ = phase(state, kf_colors, kf_depths, kf_quats,
                               kf_transl, step_slots, 0)
    loss = float(mlog[-1, 0])
    if not np.isfinite(loss):
        raise AssertionError("multi-device mapping phase produced NaN")
    p, alive = new_state.params, new_state.alive

    # tile-parallel rasterization and its gradient (the features are the
    # kernels' four: r, g, b, z)
    tmesh = make_tile_mesh(n_devices, dev)
    leaves = [x.detach().requires_grad_(True)
              for x in (p.means3d, p.unnorm_rotations, p.log_scales,
                        p.logit_opacities, p.rgb_colors)]
    m, q, s, o, c = leaves
    img, _ = render_tiles_sharded(tmesh, m, q, s, o,
                                  torch.cat([c, m[:, 2:3]], dim=-1), alive,
                                  cam, rcfg)
    tl = torch.sum(img ** 2)
    tg = torch.autograd.grad(tl, leaves)
    tl = float(tl.detach())
    if not (np.isfinite(tl)
            and all(bool(torch.isfinite(g).all()) for g in tg)):
        raise AssertionError("tile-sharded render produced NaN")

    # tile-sharded tracking: the per-frame Adam pose loop with the tiles
    # split over the ranks (loss pieces and pose gradients all-reduced)
    lcfg_track = LossConfig(
        tracking=True, use_sil_for_loss=True, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        calc_iso=False)
    tcfg = TrackingConfig(num_iters=3, lr_quat=2e-3, lr_trans=1e-2)
    track_fn = make_tracking_frame_sharded(tmesh, cam, rcfg, lcfg_track,
                                           tcfg)
    tr = track_fn(p, alive, torch.tensor([1.0, 0.002, 0, 0], device=dev),
                  torch.tensor([0.01, 0, 0], device=dev),
                  torch.full((3, cam.height, cam.width), 0.5, device=dev),
                  torch.full((1, cam.height, cam.width), 2.5, device=dev))
    if not bool(torch.isfinite(tr.quat).all()):
        raise AssertionError("tile-sharded tracking produced NaN")

    # block-sharded mesh density
    spec = make_grid(p.means3d[:n].cpu().numpy(), voxel_size=0.15,
                     padding=0.3)
    dens, _ = density_grid_sharded(
        p.means3d[:n], p.log_scales[:n], p.unnorm_rotations[:n],
        p.logit_opacities[:n], alive[:n], spec, max_isect=8 * n,
        mesh=make_mesh(n_devices, dev))
    dsum = float(torch.sum(dens))
    if not np.isfinite(dsum):
        raise AssertionError("sharded density produced NaN")
    print(f"dryrun_multichip({n_devices}) rank {mesh.rank}: dp-map "
          f"loss={loss:.6f}, tile-sharded render loss={tl:.4f}, "
          f"tile-sharded tracking iters={int(tr.iters_run)}, sharded "
          f"density sum={dsum:.2f} OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="run dryrun_multichip(N) on this process's "
                         "torch.distributed world instead of entry()")
    args = ap.parse_args(argv)
    if args.dryrun:
        from .parallel.dist import shutdown
        try:
            dryrun_multichip(args.dryrun, args.device)
        finally:
            shutdown()
        return 0
    fn, example_args = entry(args.device)
    print("entry loss:", float(fn(*example_args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
