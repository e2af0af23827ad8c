"""Per-frame camera tracking (counterpart of
isogs_slam_tpu/slam/tracking.py: `track_frame` with its opt-in refinements,
the cross-frame tile-list cache and the coarse-to-fine pyramid).

The map is binned once per frame at the initial pose with a pixel margin
(or the caller hands in a binning it keeps across frames, `BinningReuse`);
the per-slot raw table is gathered once; each iteration re-projects it per
slot, composites (kernels A and B) and takes an Adam step on the pose.
The loop keeps the best candidate on the device: no host synchronisation
per iteration (early_stop_patience, a data-dependent exit, costs one).

Opt-in: a strided tile subset (tile_subsample), fresh tile lists every
iteration (rebin_every_iter), Polyak averaging of the iterates, early stop,
a forward-only pattern search around the result (fan_rounds) and the
Gauss-Newton depth polish of slam/icp.py (gn_iters).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..ops.rasterize import (NEAR_CULL_Z, RasterConfig, bin_gaussians,
                             gather_raw_table, image_to_tiles,
                             project_gaussians, tile_pixel_validity)
from ..utils import spans
from ..utils.transforms import (normalize, pose_to_w2c, transform_points,
                                transform_to_frame)
from .icp import GNConfig, gn_depth_polish
from .losses import (LossConfig, compute_loss, compute_loss_slots,
                     compute_loss_slots_subset)

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
    # cross-frame reuse of the tracking tile lists (read by the pipeline,
    # which owns the BinningReuse): one binning widened to
    # cross_frame_margin_px serves the frames between map edits, until the
    # predicted pose drifts more than cross_frame_margin_px - bin_margin_px;
    # off by default as in the reference (the pipeline's config turns it
    # on)
    reuse_binning: bool = False
    cross_frame_margin_px: float = 16.0
    # coarse-to-fine tracking (track_frame_pyramid): pyramid_levels - 1
    # passes on 2^k-downsampled frames before the full-resolution pass,
    # pyramid_iters iterations each (0 = num_iters), learning rates times
    # pyramid_lr_scale^k at level k
    pyramid_levels: int = 1
    pyramid_iters: int = 0
    pyramid_lr_scale: float = 1.0
    # rebuild the tile lists at the current pose every iteration (the
    # per-Gaussian render, no frozen slot table)
    rebin_every_iter: bool = False
    # point-to-plane / coloured ICP Gauss-Newton polish after the Adam
    # loop (slam/icp.py), accepted only if its cost fell and the
    # mask-normalised tracking loss did not rise by more than gn_phot_tol
    gn_iters: int = 0
    gn_damping: float = 1e-3
    gn_phot_weight: float = 0.3
    gn_max_step: float = 0.05
    gn_phot_tol: float = 0.05
    # evaluate the loss on every tile_subsample-th tile only: a strided
    # subset fixed for the frame, masked sums rescaled to full-image
    # magnitude
    tile_subsample: int = 1
    # forward-only pattern search after the loop: fan_rounds rounds of 14
    # probes (+/- eps on each quat / trans component), eps halving each
    # round, by the loop's candidate metric; eps seeds 0 = the lrs
    fan_rounds: int = 0
    fan_trans_eps: float = 0.0
    fan_quat_eps: float = 0.0
    # return the bias-corrected exponential moving average of the pose
    # iterates (decay polyak_rho) instead of the best candidate
    polyak_rho: float = 0.0
    # leave the loop when the best-candidate metric has not improved for
    # this many consecutive iterations; takes precedence over the
    # depth_loss_thres doubling rule. With polyak_rho > 0 it truncates the
    # average as well.
    early_stop_patience: int = 0


class TrackResult(NamedTuple):
    quat: torch.Tensor       # [4] best candidate
    trans: torch.Tensor      # [3]
    iters_run: int
    loss_log: torch.Tensor   # [max_iters, N_LOG], nan-padded
    # GN polish outcome: -1 = off, 0 = rejected, 1 = accepted (0-d int32)
    gn_accepted: torch.Tensor | None = None


@spans.fine_call("tracking.bin")
@torch.no_grad()
def bin_at_pose(params: GaussianParams, alive, quat, trans, margin_px: float,
                cam: Camera, rcfg: RasterConfig):
    """Tile lists for the map as seen from (quat, trans), widened by
    margin_px."""
    mc, qc = transform_to_frame(params.means3d, params.unnorm_rotations,
                                quat, trans, gaussians_grad=False,
                                camera_grad=False)
    proj = project_gaussians(mc, qc, params.log_scales, alive, cam,
                             margin_px=float(margin_px))
    # the map is frozen during tracking, so the cull needs no opacity
    # drift; margin_px covers the pose's drift in pixels
    return bin_gaussians(
        proj, cam, rcfg, opacity=torch.sigmoid(params.logit_opacities[:, 0]),
        cull_slack_px=float(margin_px))


@torch.no_grad()
def max_pixel_drift(means3d, alive, q0, t0, q1, t1, cam: Camera,
                    stride: int = 16) -> torch.Tensor:
    """Max screen-space displacement (pixels, Chebyshev) of every
    `stride`-th map point between two camera poses, over points within a
    48 px band of the screen in either view: the cheap validity test for
    reusing frozen tile lists across frames. inf when a point crosses the
    near plane. Returns a 0-d tensor (no host synchronisation here)."""
    pts = means3d.detach()[::stride]
    al = alive[::stride]

    def uv(q, t):
        pc = transform_points(pose_to_w2c(normalize(q), t), pts)
        z = torch.where(pc[:, 2] > 0, pc[:, 2],
                        torch.full_like(pc[:, 2], 1e-6))
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        onscreen = ((u > -48.0) & (u < cam.width + 48.0)
                    & (v > -48.0) & (v < cam.height + 48.0))
        return u, v, pc[:, 2] > NEAR_CULL_Z, onscreen

    u0, v0, m0, on0 = uv(q0, t0)
    u1, v1, m1, on1 = uv(q1, t1)
    # points that left/entered the near frustum force a rebin too
    changed_vis = (m0 ^ m1) & (on0 | on1) & al
    ok = al & m0 & m1 & (on0 | on1)
    d = torch.maximum(torch.abs(u0 - u1), torch.abs(v0 - v1))
    drift = torch.max(torch.where(ok, d, torch.zeros_like(d)))
    return torch.where(changed_vis.any(),
                       torch.full_like(drift, float("inf")), drift)


class BinningReuse:
    """Host-side cache of tracking tile lists across frames.

    The map only changes on map_every frames; between map edits the same
    (margin-widened) binning serves every tracking frame. The owner calls
    `invalidate()` whenever the map state changes (densify, a mapping
    phase, compaction, capacity growth, a changed intersection cap:
    anything that edits rows, their order or the binning's configuration)
    and `get()` per frame; `get` rebins when the predicted pose has drifted
    beyond the margin budget. The drift test is the one host
    synchronisation per frame.
    """

    def __init__(self, cam: Camera, rcfg: RasterConfig,
                 margin_px: float = 16.0, slack_px: float = 8.0):
        self.cam = cam
        self.rcfg = rcfg
        self.margin_px = float(margin_px)
        # pixels reserved for within-frame optimizer motion
        self.slack_px = float(slack_px)
        self._binning = None
        self._pose = None
        self.n_rebins = 0
        self.n_reuses = 0

    def invalidate(self):
        self._binning = None

    def get(self, params: GaussianParams, alive, quat, trans):
        if self._binning is not None:
            bq, bt = self._pose
            drift = max_pixel_drift(params.means3d, alive, bq, bt, quat,
                                    trans, self.cam)
            with spans.span("sync.bin_drift"):
                drift = float(drift)
            if drift <= self.margin_px - self.slack_px:
                self.n_reuses += 1
                return self._binning
        self._binning = bin_at_pose(params, alive, quat, trans,
                                    self.margin_px, self.cam, self.rcfg)
        self._pose = (quat, trans)
        self.n_rebins += 1
        return self._binning


class PoseLoopState(NamedTuple):
    """What adam_pose_loop leaves behind."""
    best_pose: tuple
    it: int
    log: torch.Tensor
    # Polyak tail (polyak_rho > 0): unnormalised EMA of the pose iterates
    # and its weight sum (the bias correction's divisor)
    ema: tuple = ()
    ema_w: torch.Tensor | None = None
    # iteration of the last best-candidate improvement (0-d int64)
    best_it: torch.Tensor | None = None

    def polyak_pose(self) -> tuple:
        """Bias-corrected EMA pose (only with polyak_rho > 0)."""
        w = torch.clamp(self.ema_w, min=1e-20)
        return tuple(e / w for e in self.ema)


def _cand_metric(loss, out, tcfg: TrackingConfig):
    """The best-candidate metric: the loss per masked pixel, so that a
    pose which merely shrank the silhouette mask does not look better."""
    if tcfg.mask_norm_candidate:
        return loss / torch.clamp(out.mask_frac, min=1e-6)
    return loss


def adam_pose_loop(loss_fn, pose0: tuple, tcfg: TrackingConfig,
                   value_and_grad_fn=None) -> PoseLoopState:
    """Adam on (quat, trans) with best-candidate selection under the
    (optionally mask-normalized) metric, per-iteration lr decay, the
    depth_loss_thres doubling rule, Polyak averaging and early stop.
    `loss_fn(pose) -> (loss, LossOutputs)`; or `value_and_grad_fn(pose)
    -> ((loss, LossOutputs), pose gradients)` in its place, for a caller
    that reduces the pieces across ranks itself (parallel/track_sharded).
    The candidate stored is the pose *after* the step whose pre-step loss
    improved (splatam.py:1281-1290)."""
    max_iters = tcfg.num_iters * (2 if tcfg.use_depth_loss_thres else 1)
    pose = tuple(p.detach().clone() for p in pose0)
    best = pose
    opt = optim.init(pose)
    dev = pose[0].device
    with spans.span("sync.loop_init"):
        min_loss = torch.tensor(1e20, dtype=torch.float32, device=dev)
    log = torch.full((max_iters, N_LOG), float("nan"), device=dev)
    best_it = torch.zeros((), dtype=torch.int64, device=dev)
    ema = tuple(torch.zeros_like(p) for p in pose)
    ema_w = torch.zeros((), device=dev)
    rho = float(tcfg.polyak_rho)
    it, cur_max, doubled = 0, tcfg.num_iters, False
    while True:
        leaves = tuple(p.requires_grad_(True) for p in pose)
        if value_and_grad_fn is not None:
            (loss, out), grads = value_and_grad_fn(leaves)
        else:
            with torch.enable_grad():
                with spans.fine("tracking.forward"):
                    loss, out = loss_fn(leaves)
                with spans.fine("tracking.backward"):
                    grads = torch.autograd.grad(loss, leaves)
        decay = tcfg.lr_decay ** it
        lrs = (tcfg.lr_quat * decay, tcfg.lr_trans * decay)
        with torch.no_grad(), spans.fine("tracking.step"):
            new_pose, opt = optim.step(tuple(p.detach() for p in leaves),
                                       grads, opt, lrs, eps=tcfg.eps)
            metric = _cand_metric(loss.detach(), out, tcfg)
            improved = metric < min_loss
            best = tuple(torch.where(improved, n, b)
                         for b, n in zip(best, new_pose))
            min_loss = torch.minimum(metric, min_loss)
            best_it = torch.where(improved, torch.full_like(best_it, it),
                                  best_it)
            log[it] = torch.stack([out.loss, out.im, out.depth, out.flat,
                                   out.iso, out.mean_density,
                                   out.mask_frac]).detach()
            if rho > 0:
                ema = tuple(rho * e + (1 - rho) * p
                            for e, p in zip(ema, new_pose))
                ema_w = rho * ema_w + (1 - rho)
        pose = new_pose
        it += 1
        stop = it >= cur_max
        if stop and tcfg.use_depth_loss_thres and not doubled:
            with spans.span("sync.depth_thres"):
                met = bool(out.depth < tcfg.depth_loss_thres)
            if not met:
                cur_max, doubled, stop = 2 * tcfg.num_iters, True, False
                spans.count("tracking.doubled")
        # it - 1 is the iteration just evaluated; a stall is `patience`
        # evaluated iterations in a row without a new best (the one read
        # of the device per iteration that this knob costs)
        if tcfg.early_stop_patience > 0:
            with spans.span("sync.early_stop"):
                stalled = it - 1 - int(best_it)
            if stalled >= tcfg.early_stop_patience:
                stop = True
        if stop:
            return PoseLoopState(best_pose=best, it=it, log=log, ema=ema,
                                 ema_w=ema_w, best_it=best_it)


def _fan_search(loss_fn, best_q, best_t, tcfg: TrackingConfig):
    """Forward-only pattern search below Adam's bounce floor: probe
    +/- eps on each pose component, keep the best probe by the loop's
    candidate metric if it beats the incumbent, halve eps, repeat. No
    backward pass and no host synchronisation; a rejected round leaves
    the pose untouched."""
    dev = best_q.device

    def metric(q, t):
        loss, out = loss_fn((q, t))
        return _cand_metric(loss, out, tcfg)

    eps_t0 = float(tcfg.fan_trans_eps or tcfg.lr_trans)
    eps_q0 = float(tcfg.fan_quat_eps or tcfg.lr_quat)
    eye4, eye3 = torch.eye(4, device=dev), torch.eye(3, device=dev)
    dirs_q = torch.cat([eye4, -eye4, torch.zeros((6, 4), device=dev)])
    dirs_t = torch.cat([torch.zeros((8, 3), device=dev), eye3, -eye3])
    bm = metric(best_q, best_t)
    for r in range(tcfg.fan_rounds):
        s = 0.5 ** r
        qs = best_q[None] + dirs_q * (eps_q0 * s)
        ts = best_t[None] + dirs_t * (eps_t0 * s)
        ms = torch.stack([metric(q, t) for q, t in zip(qs, ts)])
        i = torch.argmin(ms)
        better = ms[i] < bm
        best_q = torch.where(better, qs[i], best_q)
        best_t = torch.where(better, ts[i], best_t)
        bm = torch.minimum(ms[i], bm)
    return best_q, best_t


def track_frame(params: GaussianParams, alive, init_quat, init_trans, gt_im,
                gt_depth, cam: Camera, rcfg: RasterConfig, lcfg: LossConfig,
                tcfg: TrackingConfig, binning=None) -> TrackResult:
    """Track one frame from (init_quat, init_trans). Tensors live on the
    map's device; gt_im [3,H,W] in [0,1], gt_depth [1,H,W]."""
    assert lcfg.tracking
    if tcfg.rebin_every_iter and tcfg.tile_subsample > 1:
        raise ValueError(
            "tracking.tile_subsample requires the frozen-slot-table path; "
            "it cannot be combined with tracking.rebin_every_iter")
    params = GaussianParams(*[p.detach() for p in params])
    raw = counts = None

    if tcfg.rebin_every_iter:
        # per-Gaussian re-projection and fresh tile lists every iteration
        def loss_fn(pose):
            out = compute_loss(params, alive, pose[0], pose[1], gt_im,
                               gt_depth, cam, rcfg, lcfg, binning=None)
            return out.loss, out
    else:
        if binning is None:
            binning = bin_at_pose(params, alive, init_quat, init_trans,
                                  tcfg.bin_margin_px, cam, rcfg)
        counts = binning.tile_count
        # the GN polish renders the whole image from the frozen table, so
        # all T tiles are gathered only when it will run or no subset is
        # taken
        if tcfg.tile_subsample <= 1 or tcfg.gn_iters > 0:
            with spans.fine("tracking.gather"):
                raw = gather_raw_table(params, binning.tile_gauss)

        if tcfg.tile_subsample > 1:
            # strided tile subset, fixed for the frame
            T_tiles = cam.num_tiles
            Ts = max(T_tiles // tcfg.tile_subsample, 1)
            sel = torch.arange(Ts, device=alive.device) * tcfg.tile_subsample
            with spans.fine("tracking.gather"):
                raw_sub = (raw[sel] if raw is not None else
                           gather_raw_table(params, binning.tile_gauss[sel]))
            counts_sub = counts[sel]
            gt_tiles = image_to_tiles(torch.cat([gt_im, gt_depth], dim=0),
                                      cam)[sel]
            with spans.span("sync.tile_validity"):
                valid_px = torch.as_tensor(tile_pixel_validity(cam),
                                           device=alive.device)[sel]
            scale = float(T_tiles) / float(Ts)

            def loss_fn(pose):
                out = compute_loss_slots_subset(
                    raw_sub, counts_sub, sel, pose[0], pose[1], gt_tiles,
                    valid_px, cam, rcfg, lcfg, scale=scale)
                return out.loss, out
        else:
            def loss_fn(pose):
                out = compute_loss_slots(raw, counts, pose[0], pose[1],
                                         gt_im, gt_depth, cam, rcfg, lcfg)
                return out.loss, out

    final = adam_pose_loop(loss_fn, (init_quat, init_trans), tcfg)
    best_q, best_t = (final.polyak_pose() if tcfg.polyak_rho > 0
                      else final.best_pose)
    with spans.span("sync.gn_flag"):
        gn_accepted = torch.tensor(-1, dtype=torch.int32,
                                   device=alive.device)

    with torch.no_grad():
        if tcfg.fan_rounds > 0:
            best_q, best_t = _fan_search(loss_fn, best_q, best_t, tcfg)

        if tcfg.gn_iters > 0:
            if tcfg.rebin_every_iter:
                # that path built no slot table: bin and gather once at the
                # converged pose for the polish's renders
                b1 = bin_at_pose(params, alive, best_q, best_t,
                                 tcfg.bin_margin_px, cam, rcfg)
                raw, counts = (gather_raw_table(params, b1.tile_gauss),
                               b1.tile_count)

                def metric(pose):
                    out = compute_loss_slots(raw, counts, pose[0], pose[1],
                                             gt_im, gt_depth, cam, rcfg,
                                             lcfg)
                    return out.loss / torch.clamp(out.mask_frac, min=1e-6)
            else:
                def metric(pose):
                    loss, out = loss_fn(pose)
                    return loss / torch.clamp(out.mask_frac, min=1e-6)

            # GN keeps its own 0.9 confidence gate whatever the tracking
            # loss's sil_thres: pixels of low silhouette have the least
            # reliable normalised depth
            gcfg = GNConfig(iters=tcfg.gn_iters, damping=tcfg.gn_damping,
                            phot_weight=tcfg.gn_phot_weight,
                            max_step=tcfg.gn_max_step)
            pq, pt, c0, c1 = gn_depth_polish(raw, counts, best_q, best_t,
                                             gt_depth, cam, rcfg, gcfg,
                                             gt_im=gt_im)
            phot_ok = (metric((pq, pt)) <= metric((best_q, best_t))
                       * (1.0 + tcfg.gn_phot_tol))
            accept = (c1 < c0) & phot_ok
            best_q = torch.where(accept, pq, best_q)
            best_t = torch.where(accept, pt, best_t)
            gn_accepted = accept.to(torch.int32)

    return TrackResult(quat=best_q, trans=best_t, iters_run=final.it,
                       loss_log=final.log, gn_accepted=gn_accepted)


def pyramid_cam(cam: Camera, k: int) -> Camera:
    """Camera for pyramid level k (2^k downsample), intrinsics scaled the
    way the dataset layer scales them on a resize."""
    s = 1 << k
    return Camera(width=cam.width // s, height=cam.height // s,
                  fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s,
                  cy=cam.cy / s, near=cam.near, far=cam.far)


def downsample_frame(gt_im, gt_depth, k: int):
    """[3,H,W] + [1,H,W] -> level-k pyramid frame: colour 2^k
    average-pooled, depth stride-subsampled (no edge mixing; zeros stay
    exact zeros for the valid-depth mask)."""
    s = 1 << k
    H, W = gt_im.shape[-2], gt_im.shape[-1]
    h, w = H // s, W // s
    im = gt_im[:, : h * s, : w * s].reshape(3, h, s, w, s).mean((2, 4))
    d = gt_depth[:, : h * s: s, : w * s: s]
    return im, d.contiguous()


def track_frame_pyramid(params: GaussianParams, alive, init_quat, init_trans,
                        gt_im, gt_depth, cam: Camera, rcfg: RasterConfig,
                        lcfg: LossConfig, tcfg: TrackingConfig,
                        binning=None, track_fn=None) -> TrackResult:
    """Coarse-to-fine tracking: pyramid_levels - 1 coarse passes (each bins
    the map at its own camera) feed the full-resolution track_frame, which
    takes `binning`. The pose carries across levels; the best-candidate
    bookkeeping restarts per level (loss scales differ across levels).
    Returns the full-resolution result with iters_run accumulated and the
    levels' logs concatenated. `track_fn` (track_frame's signature) runs
    each level in track_frame's place (the tile-sharded tracker)."""
    track_fn = track_fn or track_frame
    q, t = init_quat, init_trans
    coarse_logs = []
    coarse_iters = tcfg.pyramid_iters or tcfg.num_iters
    for k in range(tcfg.pyramid_levels - 1, 0, -1):
        cam_k = pyramid_cam(cam, k)
        im_k, d_k = downsample_frame(gt_im, gt_depth, k)
        lr_k = tcfg.pyramid_lr_scale ** k
        # the GN polish and the fan are sub-pixel refinements and a coarse
        # pass is still converging (an EMA would lag the hand-off pose):
        # all three run at full resolution only; tile_subsample carries
        # through
        tcfg_k = tcfg._replace(num_iters=coarse_iters, pyramid_levels=1,
                               use_depth_loss_thres=False, gn_iters=0,
                               fan_rounds=0, polyak_rho=0.0,
                               lr_quat=tcfg.lr_quat * lr_k,
                               lr_trans=tcfg.lr_trans * lr_k)
        res = track_fn(params, alive, q, t, im_k, d_k, cam_k, rcfg, lcfg,
                       tcfg_k)
        q, t = res.quat, res.trans
        coarse_logs.append(res.loss_log[: res.iters_run])
    res = track_fn(params, alive, q, t, gt_im, gt_depth, cam, rcfg, lcfg,
                   tcfg._replace(pyramid_levels=1), binning=binning)
    # one contiguous log so iters_run always indexes valid rows
    extra = sum(r.shape[0] for r in coarse_logs)
    return res._replace(iters_run=res.iters_run + extra,
                        loss_log=torch.cat(coarse_logs + [res.loss_log]))


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
