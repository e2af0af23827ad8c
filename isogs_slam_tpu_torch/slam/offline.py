"""Offline 3DGS training core (counterpart of isogs_slam_tpu/slam/offline.py),
behind scripts/gaussian_splatting.py and scripts/post_splatam_opt.py.

Full-map optimization at fixed poses: every iteration renders one frame
(drawn by the caller) with a fresh whole-image binning, takes the loss
w_im (0.8 L1 + 0.2 (1 - SSIM)) + w_depth L1(depth * valid, gt), one Adam
step with an exponentially decaying means3D learning rate and, optionally,
Inria clone / split densification from the gradient in (u, v).

The work comes in chunks of `chunk_iters` iterations over a subset of
frames held on the device as uint8 colour and f32 depth; the caller draws
the subset and the frame of each iteration on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams, MapState
from ..ops.rasterize import RasterConfig, render_rgbd_sil
from ..ops.ssim import calc_ssim
from ..utils.transforms import transform_to_frame
from .densify import DensifyConfig, accumulate_mean2d_gradient, densify_step

# loss, im, depth, and the intersections the binning's caps dropped (the
# render bins with the fixed capacity RasterConfig.max_isect(capacity))
N_LOG = 4


class OfflineConfig(NamedTuple):
    num_iters: int
    lr_means3d: float
    lr_rgb_colors: float
    lr_unnorm_rotations: float
    lr_logit_opacities: float
    lr_log_scales: float
    lr_means3d_final: float = 3.2e-6
    lr_delay_mult: float = 0.01
    w_im: float = 1.0
    w_depth: float = 1.0
    use_densification: bool = True
    densify: DensifyConfig = DensifyConfig()
    eps: float = 1e-8
    chunk_iters: int = 100
    frames_per_chunk: int = 16

    def lrs(self) -> tuple:
        return (self.lr_means3d, self.lr_rgb_colors, self.lr_unnorm_rotations,
                self.lr_logit_opacities, self.lr_log_scales)


def expon_lr(step, lr_init, lr_final, lr_delay_mult, max_steps):
    """Inria's get_expon_lr_func in f32, as the reference computes it:
    log-linear from lr_init to lr_final over max_steps, scaled by a sine
    warm-up from lr_delay_mult over the first 1% of the steps. `step` is
    an array of steps; returns an f32 array."""
    f = np.float32
    step = np.asarray(step, f)
    t = np.clip(step / f(max_steps), f(0), f(1))
    warm = np.clip(step / f(0.01 * max_steps + 1e-8), f(0), f(1))
    delay = f(lr_delay_mult) + (f(1) - f(lr_delay_mult)) * np.sin(
        f(0.5 * np.pi) * warm)
    return (delay * np.exp(np.log(f(lr_init)) * (f(1) - t)
                           + np.log(f(lr_final)) * t)).astype(f)


def offline_loss(params: GaussianParams, alive, quat, trans, gt_im, gt_depth,
                 cam: Camera, rcfg: RasterConfig, w_im, w_depth,
                 means2d_offset=None):
    """get_loss_gs: no silhouette masking, 0.8 L1 + 0.2 DSSIM colour, depth
    L1 over validity-zeroed depth. The render bins the whole image itself.
    Returns (total, loss_im, loss_depth, aux) with aux the render's (radii,
    n_overflow, ...)."""
    means_cam, quats_cam = transform_to_frame(
        params.means3d, params.unnorm_rotations, quat, trans,
        gaussians_grad=True, camera_grad=False)
    im, depth, _, _, aux = render_rgbd_sil(
        means_cam, quats_cam, params.log_scales, params.logit_opacities,
        params.rgb_colors, alive, cam, rcfg, means2d_offset=means2d_offset)
    depth = depth * (gt_depth != 0.0)
    loss_im = (0.8 * torch.abs(im - gt_im).mean()
               + 0.2 * (1.0 - calc_ssim(im, gt_im)))
    loss_depth = torch.abs(depth - gt_depth).mean()
    return w_im * loss_im + w_depth * loss_depth, loss_im, loss_depth, aux


def offline_chunk(state: MapState, opt: optim.AdamState, frame_colors_u8,
                  frame_depths, frame_quats, frame_trans, iter_frames,
                  lr_means3d, it0: int, cam: Camera, rcfg: RasterConfig,
                  ocfg: OfflineConfig,
                  generator: torch.Generator | None = None,
                  split_noise=None):
    """len(iter_frames) optimization steps over device-resident frames:
    frame_colors_u8 [F, H, W, 3] uint8, frame_depths [F, H, W], frame_quats
    [F, 4], frame_trans [F, 3]; iter_frames: the frame of each iteration
    (host ints in [0, F)); lr_means3d: each iteration's means3D learning
    rate; it0: the global index of the first iteration (the densification
    schedule). The split noise of an iteration that densifies is
    split_noise[i] when given, else drawn with `generator`.

    Returns (state, opt, log [chunk, N_LOG] = (loss, im, depth,
    intersections dropped), densify counts [3] = (rows cloned, rows split,
    rows dropped at capacity))."""
    base_lrs = ocfg.lrs()
    dev = state.alive.device
    logs = []
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    for i, fidx in enumerate(iter_frames):
        fidx = int(fidx)
        step = it0 + i
        im = (frame_colors_u8[fidx].to(torch.float32) / 255.0
              ).permute(2, 0, 1)
        depth = frame_depths[fidx][None]
        leaves = GaussianParams(*[p.detach().requires_grad_(True)
                                  for p in state.params])
        m2d = (torch.zeros((state.capacity, 2), device=dev,
                           requires_grad=True)
               if ocfg.use_densification else None)
        with torch.enable_grad():
            total, l_im, l_d, aux = offline_loss(
                leaves, state.alive, frame_quats[fidx], frame_trans[fidx],
                im, depth, cam, rcfg, ocfg.w_im, ocfg.w_depth, m2d)
            grads = torch.autograd.grad(
                total, tuple(leaves) + ((m2d,) if m2d is not None else ()))
        with torch.no_grad():
            if m2d is not None:
                state = accumulate_mean2d_gradient(state, aux["radii"],
                                                   grads[-1])
                state, opt, c = densify_step(
                    state, opt, step, ocfg.densify, generator=generator,
                    split_noise=None if split_noise is None
                    else split_noise[i])
                counts += c
                grads = grads[:-1]
            lrs = (float(lr_means3d[i]),) + base_lrs[1:]
            new_params, opt = optim.step(state.params, grads, opt, lrs,
                                         eps=ocfg.eps)
            state = state._replace(params=new_params)
            logs.append(torch.stack([
                total, l_im, l_d,
                aux["n_overflow"].to(total.dtype)]).detach())
    return state, opt, torch.stack(logs), counts
