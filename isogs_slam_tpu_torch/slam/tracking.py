"""Per-frame camera tracking (counterpart of
isogs_slam_tpu/slam/tracking.py, default branch of `track_frame`).

The map is binned once per frame at the initial pose with a pixel margin;
the per-slot raw table is gathered once; each iteration re-projects it per
slot, composites (kernels A and B) and takes an Adam step on the pose.
The loop keeps the best candidate on the device: no host synchronisation
per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..ops.rasterize import (RasterConfig, bin_gaussians, gather_raw_table,
                             project_gaussians)
from ..utils.transforms import transform_to_frame
from .losses import LossConfig, compute_loss_slots

N_LOG = 7  # loss, im, depth, flat, iso, mean_density, mask_frac


class TrackingConfig(NamedTuple):
    num_iters: int
    lr_quat: float
    lr_trans: float
    use_depth_loss_thres: bool = False
    depth_loss_thres: float = 100000.0
    eps: float = 1e-8
    bin_margin_px: float = 8.0
    mask_norm_candidate: bool = True
    lr_decay: float = 1.0
    # the reference's opt-in knobs below are not ported yet; a config that
    # sets one raises NotImplementedError
    rebin_every_iter: bool = False
    reuse_binning: bool = False
    gn_iters: int = 0
    tile_subsample: int = 1
    pyramid_levels: int = 1
    fan_rounds: int = 0
    polyak_rho: float = 0.0
    early_stop_patience: int = 0

    def check_ported(self):
        off = {"rebin_every_iter": False, "reuse_binning": False,
               "gn_iters": 0, "tile_subsample": 1, "pyramid_levels": 1,
               "fan_rounds": 0, "polyak_rho": 0.0, "early_stop_patience": 0}
        for knob, default in off.items():
            if getattr(self, knob) != default:
                raise NotImplementedError(
                    f"TrackingConfig.{knob} is not ported to the PyTorch "
                    f"package yet")


class TrackResult(NamedTuple):
    quat: torch.Tensor       # [4] best candidate
    trans: torch.Tensor      # [3]
    iters_run: int
    loss_log: torch.Tensor   # [max_iters, N_LOG], nan-padded


def adam_pose_loop(loss_fn, pose0: tuple, tcfg: TrackingConfig):
    """Adam on (quat, trans) with best-candidate selection under the
    (optionally mask-normalized) metric, per-iteration lr decay and the
    depth_loss_thres doubling rule. `loss_fn(pose) -> (loss, LossOutputs)`.
    The candidate stored is the pose *after* the step whose pre-step loss
    improved (splatam.py:1281-1290). Returns (best_pose, iters, log)."""
    max_iters = tcfg.num_iters * (2 if tcfg.use_depth_loss_thres else 1)
    pose = tuple(p.detach().clone() for p in pose0)
    best = pose
    opt = optim.init(pose)
    dev = pose[0].device
    min_loss = torch.tensor(1e20, dtype=torch.float32, device=dev)
    log = torch.full((max_iters, N_LOG), float("nan"), device=dev)
    it, cur_max, doubled = 0, tcfg.num_iters, False
    while True:
        leaves = tuple(p.requires_grad_(True) for p in pose)
        with torch.enable_grad():
            loss, out = loss_fn(leaves)
            grads = torch.autograd.grad(loss, leaves)
        decay = tcfg.lr_decay ** it
        lrs = (tcfg.lr_quat * decay, tcfg.lr_trans * decay)
        with torch.no_grad():
            new_pose, opt = optim.step(tuple(p.detach() for p in leaves),
                                       grads, opt, lrs, eps=tcfg.eps)
            metric = loss.detach()
            if tcfg.mask_norm_candidate:
                metric = metric / torch.clamp(out.mask_frac, min=1e-6)
            improved = metric < min_loss
            best = tuple(torch.where(improved, n, b)
                         for b, n in zip(best, new_pose))
            min_loss = torch.minimum(metric, min_loss)
            log[it] = torch.stack([out.loss, out.im, out.depth, out.flat,
                                   out.iso, out.mean_density,
                                   out.mask_frac]).detach()
        pose = new_pose
        it += 1
        if it < cur_max:
            continue
        if (tcfg.use_depth_loss_thres and not doubled
                and not bool(out.depth < tcfg.depth_loss_thres)):
            cur_max, doubled = 2 * tcfg.num_iters, True
            continue
        return best, it, log


def track_frame(params: GaussianParams, alive, init_quat, init_trans, gt_im,
                gt_depth, cam: Camera, rcfg: RasterConfig, lcfg: LossConfig,
                tcfg: TrackingConfig, binning=None) -> TrackResult:
    """Track one frame from (init_quat, init_trans). Tensors live on the
    map's device; gt_im [3,H,W] in [0,1], gt_depth [1,H,W]."""
    assert lcfg.tracking
    tcfg.check_ported()
    params = GaussianParams(*[p.detach() for p in params])
    with torch.no_grad():
        if binning is None:
            mc0, qc0 = transform_to_frame(params.means3d,
                                          params.unnorm_rotations, init_quat,
                                          init_trans, gaussians_grad=False,
                                          camera_grad=False)
            proj0 = project_gaussians(mc0, qc0, params.log_scales, alive,
                                      cam, margin_px=tcfg.bin_margin_px)
            binning = bin_gaussians(proj0, cam, rcfg)
        raw = gather_raw_table(params, binning.tile_gauss)
    counts = binning.tile_count

    def loss_fn(pose):
        out = compute_loss_slots(raw, counts, pose[0], pose[1], gt_im,
                                 gt_depth, cam, rcfg, lcfg)
        return out.loss, out

    (best_q, best_t), iters, log = adam_pose_loop(
        loss_fn, (init_quat, init_trans), tcfg)
    return TrackResult(quat=best_q, trans=best_t, iters_run=iters,
                       loss_log=log)


def initialize_camera_pose(cam_rots, cam_trans, time_idx: int,
                           forward_prop: bool):
    """Constant-velocity pose initialization (splatam.py:844-863).
    cam_rots [4, T], cam_trans [3, T]; returns (quat, trans)."""
    if time_idx > 1 and forward_prop:
        r1 = cam_rots[:, time_idx - 1]
        r1 = r1 / torch.linalg.norm(r1)
        r2 = cam_rots[:, time_idx - 2]
        r2 = r2 / torch.linalg.norm(r2)
        new_rot = r1 + (r1 - r2)
        new_rot = new_rot / torch.linalg.norm(new_rot)
        t1 = cam_trans[:, time_idx - 1]
        t2 = cam_trans[:, time_idx - 2]
        return new_rot, t1 + (t1 - t2)
    return cam_rots[:, time_idx - 1], cam_trans[:, time_idx - 1]
