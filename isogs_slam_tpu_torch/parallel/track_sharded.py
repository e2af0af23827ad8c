"""Tile-parallel tracking over the ranks of a mesh (counterpart of
isogs_slam_tpu/parallel/track_sharded.py).

The whole per-frame Adam pose loop (slam/tracking.adam_pose_loop) runs on
every rank with the compositing tiles sharded:

  * projection + binning at the initial pose run replicated,
  * each rank gathers the frozen slot table of its own tile block only,
  * per iteration each rank composites its tiles (kernels A and B on the
    virtual single-row grid of the tile-subset renders) and computes its
    local masked sums; one all_reduce of a packed tensor (loss pieces,
    masked and valid pixel counts, pose gradients) makes every rank take
    the identical Adam step.

The pose gradients are reduced explicitly (adam_pose_loop's
value_and_grad_fn hook): differentiating a reduced forward would leave each
rank with only its local partial gradient.

Semantics: the serial frozen-slot-table path (slam/tracking.track_frame
with reference-parity knobs) up to float reassociation of the pixel sums.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import TILE, Camera
from ..core.gaussians import GaussianParams
from ..ops.rasterize import (RasterConfig, gather_raw_table, image_to_tiles,
                             tile_pixel_validity)
from ..slam.losses import (LossConfig, _zero_outputs,
                           compute_loss_slots_subset)
from ..slam.tracking import (TrackingConfig, TrackResult, adam_pose_loop,
                             bin_at_pose)
from .dist import Mesh, all_reduce_, shard_range
from .tile_sharded import TILE_AXIS, make_tile_mesh  # noqa: F401 (re-export)


def make_tracking_frame_sharded(mesh: Mesh, cam: Camera, rcfg: RasterConfig,
                                lcfg: LossConfig, tcfg: TrackingConfig):
    """Build the tile-sharded tracking program for one camera.

    Returns fn(params, alive, init_quat, init_trans, gt_im [3,H,W],
    gt_depth [1,H,W]) -> TrackResult, the same on every rank. The GN
    polish and the perturbation fan are serial-path features; coarse
    pyramid levels are handled by the caller building one program per
    level camera (slam/pipeline wiring)."""
    if tcfg.gn_iters > 0 or tcfg.fan_rounds > 0:
        raise NotImplementedError(
            "tile-sharded tracking supports the Adam loop only "
            "(gn_iters=0, fan_rounds=0)")
    if lcfg.ignore_outlier_depth_loss:
        raise NotImplementedError(
            "ignore_outlier_depth_loss needs a global median; not "
            "supported on the tile-sharded path")
    if tcfg.tile_subsample > 1:
        raise NotImplementedError(
            "combine one fast mode at a time: tile-sharded tracking "
            "already shrinks per-device work by the mesh size")
    T = cam.num_tiles
    lo, hi, per = shard_range(T, mesh)
    n_pad = per * mesh.size
    dev = mesh.device
    # padded tiles point at tile 0 for pixel coordinates; their counts are
    # zero and their valid mask is all-False, so they contribute nothing
    valid_np = np.zeros((n_pad, TILE * TILE), bool)
    valid_np[:T] = tile_pixel_validity(cam)
    sel_np = np.zeros(n_pad, np.int64)
    sel_np[:T] = np.arange(T)
    valid_l = torch.as_tensor(valid_np[lo:hi], device=dev)
    sel_l = torch.as_tensor(sel_np[lo:hi], device=dev)
    real_l = torch.as_tensor(np.arange(lo, hi) < T, device=dev)
    n_loc = float(valid_np[lo:hi].sum())

    def fn(params: GaussianParams, alive, init_quat, init_trans, gt_im,
           gt_depth) -> TrackResult:
        params = GaussianParams(*[p.detach() for p in params])
        # replicated per-frame binning at the initial pose (same margin +
        # cull contract as the serial path, slam/tracking.track_frame)
        b = bin_at_pose(params, alive, init_quat, init_trans,
                        tcfg.bin_margin_px, cam, rcfg)
        if hi > lo:
            raw_l = gather_raw_table(params, b.tile_gauss[sel_l])
            cnt_l = torch.where(real_l, b.tile_count[sel_l],
                                torch.zeros_like(b.tile_count[sel_l]))
            gt_l = image_to_tiles(torch.cat([gt_im, gt_depth], dim=0),
                                  cam)[sel_l]

        def value_and_grad_fn(pose):
            if hi > lo:
                with torch.enable_grad():
                    out_l = compute_loss_slots_subset(
                        raw_l, cnt_l, sel_l, pose[0], pose[1], gt_l,
                        valid_l, cam, rcfg, lcfg, scale=1.0)
                    g_l = torch.autograd.grad(out_l.loss, pose)
                pieces = torch.stack([
                    out_l.loss.detach(), out_l.im.detach(),
                    out_l.depth.detach(),
                    # compute_loss_slots_subset normalises mask_frac by the
                    # local valid-pixel count: recover the count, and
                    # renormalise by the global one after the sum
                    out_l.mask_frac * max(n_loc, 1.0),
                    torch.tensor(n_loc, device=dev)])
                pack = torch.cat([pieces, g_l[0], g_l[1]])
            else:
                pack = torch.zeros(5 + 4 + 3, device=dev)
            all_reduce_(pack, mesh)
            loss, im, depth, mask_cnt, n_tot = pack[:5]
            grads = (pack[5:9], pack[9:12])
            out = _zero_outputs(
                dev, loss=loss, im=im, depth=depth,
                mask_frac=mask_cnt / torch.clamp(n_tot, min=1.0))
            return (loss, out), grads

        final = adam_pose_loop(None, (init_quat, init_trans), tcfg,
                               value_and_grad_fn=value_and_grad_fn)
        bq, bt = (final.polyak_pose() if tcfg.polyak_rho > 0
                  else final.best_pose)
        return TrackResult(quat=bq, trans=bt, iters_run=final.it,
                           loss_log=final.log,
                           gn_accepted=torch.tensor(-1, dtype=torch.int32,
                                                    device=dev))

    return fn
