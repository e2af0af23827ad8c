"""The tracking/mapping loss (counterpart of isogs_slam_tpu/slam/losses.py),
on the whole image and on a tile subset.

tracking: masked L1 *sums* over {valid depth & not nan & silhouette > thres}
mapping:  depth L1 mean over the valid mask; im = 0.8 L1 + 0.2 (1 - SSIM);
          + IsoGS flat (w=50) and iso (w=2) regularizers
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..ops.iso_loss import IsoKnnPool, flat_loss, iso_surface_loss
from ..ops.rasterize import (MAPPING_LIVE_COLS, TRACKING_LIVE_COLS,
                             RasterConfig, render_rgbd_sil,
                             render_rgbd_sil_slots,
                             render_rgbd_sil_slots_subset,
                             render_tiles_subset, tiles_to_image)
from ..ops.ssim import calc_ssim, ssim_map
from ..utils import spans
from ..utils.transforms import transform_to_frame


class LossConfig(NamedTuple):
    tracking: bool
    use_sil_for_loss: bool
    sil_thres: float
    use_l1: bool
    ignore_outlier_depth_loss: bool
    w_im: float
    w_depth: float
    w_flat: float = 50.0
    w_iso: float = 2.0
    iso_sample_size: int = 8192
    iso_k: int = 16
    iso_target: float = 1.0
    calc_iso: bool = True
    knn_block: int = 8192
    knn_method: str = "hash"   # "hash" (spatial hash) or "exact"
    hash_cap: int = 24
    hash_table_size: int = 0
    # per-phase frozen KNN pool of this many queries; 0 = a fresh KNN per
    # iteration (the reference's semantics)
    iso_pool_size: int = 32768
    # silhouette-normalized tracking render (rgb, depth, depth^2 divided
    # by max(silhouette, 1e-6)), the reference's tracking default
    sil_norm_render: bool = False


class LossOutputs(NamedTuple):
    loss: torch.Tensor
    im: torch.Tensor
    depth: torch.Tensor
    flat: torch.Tensor
    iso: torch.Tensor
    mean_density: torch.Tensor
    radii: torch.Tensor
    n_overflow: torch.Tensor
    mask_frac: torch.Tensor


@spans.fine_call("loss.photometric")
def _photometric_terms(im, depth, silhouette, depth_sq, gt_im, gt_depth,
                       lcfg: LossConfig):
    """Masks + RGB/depth loss terms. Returns (loss_im, loss_depth, mask)."""
    tracking = lcfg.tracking
    if tracking and lcfg.sil_norm_render:
        s = torch.clamp(silhouette, min=1e-6)[None]
        im = im / s
        depth = depth / s
        depth_sq = depth_sq / s
    mask = _loss_mask(depth, depth_sq, gt_depth, lcfg)
    if tracking and lcfg.use_sil_for_loss:
        mask = mask & (silhouette > lcfg.sil_thres)[None]

    zero_d = torch.zeros_like(depth)
    d_abs = torch.abs(gt_depth - depth)
    if lcfg.use_l1:
        if tracking:
            loss_depth = torch.sum(torch.where(mask, d_abs, zero_d))
        else:
            cnt = torch.clamp(torch.sum(mask.to(d_abs.dtype)), min=1.0)
            loss_depth = torch.sum(torch.where(mask, d_abs, zero_d)) / cnt
    else:
        loss_depth = torch.zeros((), device=d_abs.device)

    im_abs = torch.abs(gt_im - im)
    if tracking and (lcfg.use_sil_for_loss or lcfg.ignore_outlier_depth_loss):
        color_mask = mask.expand(im.shape)
        loss_im = torch.sum(torch.where(color_mask, im_abs,
                                        torch.zeros_like(im_abs)))
    elif tracking:
        loss_im = torch.sum(im_abs)
    else:
        loss_im = 0.8 * im_abs.mean() + 0.2 * (1.0 - calc_ssim(im, gt_im))
    return loss_im, loss_depth, mask


def _loss_mask(depth, depth_sq, gt_depth, lcfg: LossConfig, px_mask=None):
    """The detached mask of the pixels a loss counts, in the caller's
    layout (the image's [1, H, W], a tile subset's [Ts, P]): gt depth
    present, the rendered depth and its uncertainty not NaN, inside
    px_mask where given and, under lcfg.ignore_outlier_depth_loss, a depth
    error under 10x the median error over every entry (zero outside
    px_mask)."""
    uncertainty = (depth_sq - depth * depth).detach()
    nan_mask = (~torch.isnan(depth)) & (~torch.isnan(uncertainty))
    if lcfg.ignore_outlier_depth_loss:
        with spans.fine("loss.outlier_mask"):
            depth_error = torch.abs(gt_depth - depth) * (gt_depth > 0)
            if px_mask is not None:
                depth_error = depth_error * px_mask
            mask = ((depth_error < 10 * _median(depth_error))
                    & (gt_depth > 0))
    else:
        mask = gt_depth > 0
    mask = mask & nan_mask
    if px_mask is not None:
        mask = mask & px_mask
    return mask.detach()


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy/jnp median: the mean of the two middle values for even n
    (torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def compute_loss_slots(raw, counts, cam_quat, cam_trans, gt_im, gt_depth,
                       cam: Camera, rcfg: RasterConfig,
                       lcfg: LossConfig) -> LossOutputs:
    """Tracking loss via the frozen slot-table render (pose is the only
    gradient leaf)."""
    assert lcfg.tracking
    im, depth, silhouette, depth_sq, _ = render_rgbd_sil_slots(
        raw, counts, cam_quat, cam_trans, cam, rcfg)
    loss_im, loss_depth, mask = _photometric_terms(
        im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg)
    return _zero_outputs(
        im.device, loss=lcfg.w_im * loss_im + lcfg.w_depth * loss_depth,
        im=lcfg.w_im * loss_im, depth=lcfg.w_depth * loss_depth,
        mask_frac=torch.mean(mask.to(torch.float32)))


def _zero_outputs(dev, **kw) -> LossOutputs:
    """LossOutputs with the mapping-only fields zero."""
    z = torch.zeros((), device=dev)
    base = dict(flat=z, iso=z, mean_density=z,
                radii=torch.zeros(1, dtype=torch.int32, device=dev),
                n_overflow=torch.zeros((), dtype=torch.int64, device=dev))
    base.update(kw)
    return LossOutputs(**base)


def compute_loss_slots_subset(raw_sub, counts_sub, sel, cam_quat, cam_trans,
                              gt_tiles, valid_px, cam: Camera,
                              rcfg: RasterConfig, lcfg: LossConfig,
                              scale: float = 1.0) -> LossOutputs:
    """Tracking loss on a tile subset via the slot-table render
    (tracking.tile_subsample > 1). gt_tiles [Ts, P, 4] = (r, g, b, depth)
    of the selected tiles; valid_px [Ts, P] in-image mask; `scale`
    (~ num_tiles / Ts) brings the masked sums to full-image magnitude, so
    depth_loss_thres and the best-candidate metric keep their meaning."""
    assert lcfg.tracking
    out, silhouette = render_rgbd_sil_slots_subset(
        raw_sub, counts_sub, sel, cam_quat, cam_trans, cam, rcfg)
    im = out[..., 0:3]                                     # [Ts, P, 3]
    depth = out[..., 3]
    depth_sq = out[..., 4]
    gt_im = gt_tiles[..., 0:3]
    gt_depth = gt_tiles[..., 3]

    if lcfg.sil_norm_render:
        s = torch.clamp(silhouette, min=1e-6)
        im = im / s[..., None]
        depth = depth / s
        depth_sq = depth_sq / s
    mask = _loss_mask(depth, depth_sq, gt_depth, lcfg, valid_px)
    if lcfg.use_sil_for_loss:
        mask = mask & (silhouette > lcfg.sil_thres)

    d_abs = torch.abs(gt_depth - depth)
    loss_depth = (torch.sum(torch.where(mask, d_abs,
                                        torch.zeros_like(d_abs))) * scale
                  if lcfg.use_l1 else torch.zeros((), device=im.device))
    im_abs = torch.abs(gt_im - im)
    sum_mask = (mask if lcfg.use_sil_for_loss
                or lcfg.ignore_outlier_depth_loss else valid_px)
    loss_im = torch.sum(torch.where(sum_mask[..., None], im_abs,
                                    torch.zeros_like(im_abs))) * scale

    n_px = torch.clamp(torch.sum(valid_px.to(torch.float32)), min=1.0)
    return _zero_outputs(
        im.device, loss=lcfg.w_im * loss_im + lcfg.w_depth * loss_depth,
        im=lcfg.w_im * loss_im, depth=lcfg.w_depth * loss_depth,
        mask_frac=torch.sum(mask.to(torch.float32)) / n_px)


def _isogs_terms(params: GaussianParams, alive, lcfg: LossConfig,
                 iso_pool: IsoKnnPool | None, iso_sel, generator,
                 iso_grid=None):
    """Flat + iso regularizers; the iso loss reads `iso_pool` when given,
    else finds its queries' neighbours afresh (on `iso_grid` by hash)."""
    with spans.fine("loss.flat"):
        loss_flat = flat_loss(params.log_scales, alive)
    if lcfg.calc_iso:
        with spans.fine("loss.iso"):
            loss_iso, mean_density = iso_surface_loss(
                params.means3d, params.unnorm_rotations, params.log_scales,
                params.logit_opacities, alive, iso_pool,
                sample_size=lcfg.iso_sample_size,
                target_saturation=lcfg.iso_target, sel=iso_sel,
                generator=generator, k=lcfg.iso_k,
                knn_method=lcfg.knn_method, hash_cap=lcfg.hash_cap,
                hash_table_size=lcfg.hash_table_size,
                knn_block=lcfg.knn_block, grid=iso_grid)
    else:
        loss_iso = torch.zeros((), device=alive.device)
        mean_density = torch.zeros((), device=alive.device)
    return loss_flat, loss_iso, mean_density


def compute_loss_subsampled(params: GaussianParams, alive, cam_quat,
                            cam_trans, gt_tiles, valid_px, core_tiles, sel,
                            binning, cam: Camera, rcfg: RasterConfig,
                            lcfg: LossConfig,
                            iso_pool: IsoKnnPool | None = None, iso_sel=None,
                            generator: torch.Generator | None = None,
                            means2d_offset=None, iso_grid=None
                            ) -> LossOutputs:
    """Mapping loss on a contiguous stripe of tile rows
    (mapping.tile_subsample > 1).

    sel [Ts] are the tile ids of a full-width band of tile rows: a core of
    ~tiles_y / sub rows plus one halo tile row above and below
    (mapping.select_stripe). gt_tiles [Ts, P, 4] = (r, g, b, depth) of
    those tiles; valid_px [Ts, P] in-image pixel mask; core_tiles [Ts]
    marks the core rows.

    L1 and depth are masked means over the core. SSIM reassembles the
    whole stripe into an image band, zeroes out-of-image pixels and runs
    the same zero-padded filter over it: a window centred in the core
    reads true rendered neighbours from the halo (or the zero padding the
    full-image filter also sees at the image's borders), so the core's
    SSIM values equal the full-image computation's and the estimator is an
    exact partition of the full SSIM mean."""
    assert not lcfg.tracking
    means_cam, quats_cam = transform_to_frame(
        params.means3d, params.unnorm_rotations, cam_quat, cam_trans,
        gaussians_grad=True, camera_grad=False)
    out, _, aux = render_tiles_subset(
        means_cam, quats_cam, params.log_scales, params.logit_opacities,
        params.rgb_colors, alive, sel, binning, cam, rcfg,
        live_grad_cols=MAPPING_LIVE_COLS, means2d_offset=means2d_offset)
    im = out[..., 0:3]                                    # [Ts, P, 3]
    depth = out[..., 3]
    depth_sq = out[..., 4]
    gt_im = gt_tiles[..., 0:3]
    gt_depth = gt_tiles[..., 3]

    core_px = core_tiles[:, None] & valid_px              # [Ts, P]
    mask = _loss_mask(depth, depth_sq, gt_depth, lcfg, core_px)

    d_abs = torch.abs(gt_depth - depth)
    if lcfg.use_l1:
        cnt = torch.clamp(torch.sum(mask.to(d_abs.dtype)), min=1.0)
        loss_depth = torch.sum(torch.where(mask, d_abs,
                                           torch.zeros_like(d_abs))) / cnt
    else:
        loss_depth = torch.zeros((), device=d_abs.device)

    im_abs = torch.abs(gt_im - im)
    core_f = core_px.to(im_abs.dtype)
    vcnt = torch.clamp(3.0 * torch.sum(core_f), min=1.0)
    l1 = torch.sum(torch.where(core_px[..., None], im_abs,
                               torch.zeros_like(im_abs))) / vcnt
    band = torch.cat([im, gt_im], dim=-1)
    band = torch.where(valid_px[..., None], band, torch.zeros_like(band))
    band = tiles_to_image(band, cam.tiles_x)              # [6, Hs, Ws]
    pos = tiles_to_image(core_f[..., None], cam.tiles_x)[0]   # [Hs, Ws]
    m = ssim_map(band[0:3], band[3:6])                    # [3, Hs, Ws]
    ssim_mean = (torch.sum(m * pos[None])
                 / torch.clamp(3.0 * torch.sum(pos), min=1.0))
    loss_im = 0.8 * l1 + 0.2 * (1.0 - ssim_mean)

    loss_flat, loss_iso, mean_density = _isogs_terms(
        params, alive, lcfg, iso_pool, iso_sel, generator, iso_grid)
    wim = lcfg.w_im * loss_im
    wdepth = lcfg.w_depth * loss_depth
    wflat = lcfg.w_flat * loss_flat
    wiso = lcfg.w_iso * loss_iso
    return LossOutputs(
        loss=wim + wdepth + wflat + wiso, im=wim, depth=wdepth, flat=wflat,
        iso=wiso, mean_density=mean_density, radii=aux["radii"],
        n_overflow=torch.zeros((), dtype=torch.int64, device=im.device),
        mask_frac=(torch.sum(mask.to(torch.float32))
                   / torch.clamp(torch.sum(core_f), min=1.0)))


def compute_loss(params: GaussianParams, alive, cam_quat, cam_trans, gt_im,
                 gt_depth, cam: Camera, rcfg: RasterConfig, lcfg: LossConfig,
                 binning=None, iso_pool: IsoKnnPool | None = None,
                 iso_sel=None, generator: torch.Generator | None = None,
                 means2d_offset=None, iso_grid=None) -> LossOutputs:
    """gt_im [3,H,W] in [0,1]; gt_depth [1,H,W] meters. Mapping draws the
    iso loss's sample rows with `generator` unless `iso_sel` is given;
    without `iso_pool` the iso loss finds its neighbours afresh (on
    `iso_grid` by hash). means2d_offset: a zero [N, 2] leaf whose gradient
    is d loss / d(u, v) (densification)."""
    tracking = lcfg.tracking
    means_cam, quats_cam = transform_to_frame(
        params.means3d, params.unnorm_rotations, cam_quat, cam_trans,
        gaussians_grad=not tracking, camera_grad=tracking)
    live_cols = TRACKING_LIVE_COLS if tracking else MAPPING_LIVE_COLS
    im, depth, silhouette, depth_sq, aux = render_rgbd_sil(
        means_cam, quats_cam, params.log_scales, params.logit_opacities,
        params.rgb_colors, alive, cam, rcfg, binning,
        live_grad_cols=live_cols, means2d_offset=means2d_offset)
    loss_im, loss_depth, mask = _photometric_terms(
        im, depth, silhouette, depth_sq, gt_im, gt_depth, lcfg)

    z = torch.zeros((), device=im.device)
    if not tracking:
        loss_flat, loss_iso, mean_density = _isogs_terms(
            params, alive, lcfg, iso_pool, iso_sel, generator, iso_grid)
        w_flat, w_iso = lcfg.w_flat, lcfg.w_iso
    else:
        loss_flat = loss_iso = mean_density = z
        w_flat = w_iso = 0.0
    wim = lcfg.w_im * loss_im
    wdepth = lcfg.w_depth * loss_depth
    wflat = w_flat * loss_flat
    wiso = w_iso * loss_iso
    return LossOutputs(loss=wim + wdepth + wflat + wiso, im=wim, depth=wdepth,
                       flat=wflat, iso=wiso, mean_density=mean_density,
                       radii=aux["radii"], n_overflow=aux["n_overflow"],
                       mask_frac=torch.mean(mask.to(torch.float32)))
