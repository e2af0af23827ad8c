"""Keyframe mapping (counterpart of isogs_slam_tpu/slam/mapping.py, exact
branch of `map_frame`).

Per phase: each sampled keyframe slot is binned once (margin-free tile
lists, expansion order kept for the backward's segment reduce), the iso
hash grid and KNN pool are built once. Per iteration: the mapping loss
(L1 + SSIM colour, masked depth L1, IsoGS flat + iso), pruning, the opacity
reset and one Adam step (eps 1e-15) on every Gaussian parameter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams, MapState, prune
from ..ops.iso_loss import build_iso_knn_pool
from ..ops.rasterize import RasterConfig, bin_gaussians, project_gaussians
from ..ops.spatial_hash import build_hash_grid, default_cell_size
from ..utils.transforms import transform_to_frame
from .losses import LossConfig, compute_loss

N_LOG = 7  # loss, im, depth, flat, iso, mean_density, mask_frac


class PruneConfig(NamedTuple):
    enabled: bool
    start_after: int
    remove_big_after: int
    stop_after: int
    prune_every: int
    removal_opacity_threshold: float
    final_removal_opacity_threshold: float
    reset_opacities: bool
    reset_opacities_every: int


class MappingConfig(NamedTuple):
    num_iters: int
    lr_means3d: float
    lr_rgb_colors: float
    lr_unnorm_rotations: float
    lr_logit_opacities: float
    lr_log_scales: float
    prune: PruneConfig
    eps: float = 1e-15
    bin_margin_px: float = 0.0
    # the reference's opt-in knobs below are not ported yet; a config that
    # sets one raises NotImplementedError
    use_densification: bool = False
    tile_subsample: int = 1
    exact_polish_iters: int = 0
    force_subset: bool = False
    lazy_adam: bool = False
    vmap_bins: bool = False

    def lrs(self) -> tuple:
        return (self.lr_means3d, self.lr_rgb_colors, self.lr_unnorm_rotations,
                self.lr_logit_opacities, self.lr_log_scales)

    def check_ported(self):
        off = {"use_densification": False, "tile_subsample": 1,
               "exact_polish_iters": 0, "force_subset": False,
               "lazy_adam": False, "vmap_bins": False}
        for knob, default in off.items():
            if getattr(self, knob) != default:
                raise NotImplementedError(
                    f"MappingConfig.{knob} is not ported to the PyTorch "
                    f"package yet")


def _prune_mask(params: GaussianParams, alive, scene_radius, it: int,
                pc: PruneConfig):
    """Row-removal mask for iteration `it` (prune_gaussians semantics)."""
    do = (pc.enabled and pc.start_after <= it <= pc.stop_after
          and it % max(pc.prune_every, 1) == 0)
    if not do:
        return torch.zeros_like(alive)
    thres = (pc.final_removal_opacity_threshold if it == pc.stop_after
             else pc.removal_opacity_threshold)
    remove = torch.sigmoid(params.logit_opacities[:, 0]) < thres
    if it >= pc.remove_big_after:
        big = (torch.max(torch.exp(params.log_scales), dim=1).values
               > 0.1 * scene_radius)
        remove = remove | big
    return remove & alive


def map_frame(state: MapState, kf_colors_u8, kf_depths, kf_quats, kf_transl,
              iter_slots, cam: Camera, rcfg: RasterConfig, lcfg: LossConfig,
              mcfg: MappingConfig, generator: torch.Generator | None = None,
              pool_q_idx=None, iso_sels=None):
    """One mapping phase of mcfg.num_iters iterations.

    kf_colors_u8 [S, H, W, 3] uint8, kf_depths [S, H, W] f32, kf_quats
    [S, 4], kf_transl [S, 3]: the keyframe window on the map's device;
    iter_slots: the keyframe slot of each iteration (host ints). The
    random draws — the iso pool's query rows and each iteration's iso
    sample — are `pool_q_idx` and `iso_sels[i]` when given, else drawn
    with `generator`.

    Returns (new MapState, loss_log [num_iters, N_LOG], bin_stats [3] =
    [true-candidate intersections dropped by the per-tile cap, total and
    max intersections over the binned slots])."""
    assert not lcfg.tracking
    mcfg.check_ported()
    lcfg.check_ported()
    pc = mcfg.prune
    iter_slots = [int(s) for s in iter_slots]
    p0 = GaussianParams(*[p.detach() for p in state.params])
    alive0 = state.alive

    bins = {}
    with torch.no_grad():
        for slot in sorted(set(iter_slots)):
            mc, qc = transform_to_frame(p0.means3d, p0.unnorm_rotations,
                                        kf_quats[slot], kf_transl[slot],
                                        gaussians_grad=False,
                                        camera_grad=False)
            proj = project_gaussians(mc, qc, p0.log_scales, alive0, cam,
                                     margin_px=mcfg.bin_margin_px)
            bins[slot] = bin_gaussians(proj, cam, rcfg, emit_exp=True)
        n_isect = torch.stack([b.n_isect for b in bins.values()])
        bin_stats = torch.stack([
            sum(b.n_true_overflow for b in bins.values()),
            n_isect.sum(), n_isect.max()])

        iso_pool = None
        if lcfg.calc_iso:
            cell = default_cell_size(p0.log_scales, alive0)
            grid = build_hash_grid(p0.means3d, alive0, cell,
                                   lcfg.hash_table_size)
            iso_pool = build_iso_knn_pool(
                p0.means3d, p0.log_scales, alive0, lcfg.iso_pool_size,
                lcfg.iso_k, hash_cap=lcfg.hash_cap, grid=grid,
                q_idx=pool_q_idx, generator=generator)

    lrs = mcfg.lrs()
    # log(0.01 / 0.99) in f32, as the reference computes it
    reset_val = float(torch.log(torch.tensor(0.01 / 0.99)))
    st, opt = state, optim.init(state.params)
    logs = []
    for it, slot in enumerate(iter_slots):
        gt_im = (kf_colors_u8[slot].to(torch.float32) / 255.0
                 ).permute(2, 0, 1)
        gt_depth = kf_depths[slot][None]
        leaves = GaussianParams(*[p.detach().requires_grad_(True)
                                  for p in st.params])
        with torch.enable_grad():
            out = compute_loss(
                leaves, st.alive, kf_quats[slot], kf_transl[slot], gt_im,
                gt_depth, cam, rcfg, lcfg, binning=bins[slot],
                iso_pool=iso_pool,
                iso_sel=None if iso_sels is None else iso_sels[it],
                generator=generator)
            grads = torch.autograd.grad(out.loss, leaves)
        with torch.no_grad():
            # seen / max_2D_radius bookkeeping (splatam.py:751-753)
            radii = out.radii.to(st.max_2d_radius.dtype)
            max_r = torch.where(out.radii > 0,
                                torch.maximum(radii, st.max_2d_radius),
                                st.max_2d_radius)
            st = st._replace(max_2d_radius=max_r)
            # prune before the optimizer step (splatam.py:1461-1467)
            st = prune(st, _prune_mask(st.params, st.alive,
                                       st.scene_radius, it, pc))
            params = GaussianParams(*[p.detach() for p in leaves])
            if pc.reset_opacities and it > 0 and \
                    it % max(pc.reset_opacities_every, 1) == 0:
                # the parameter is replaced and its moments zeroed
                # (slam_external.py:183-186)
                params = params._replace(logit_opacities=torch.full_like(
                    params.logit_opacities, reset_val))
                j = GaussianParams._fields.index("logit_opacities")
                mu, nu = list(opt.mu), list(opt.nu)
                mu[j] = torch.zeros_like(mu[j])
                nu[j] = torch.zeros_like(nu[j])
                opt = opt._replace(mu=tuple(mu), nu=tuple(nu))
            new_params, opt = optim.step(params, grads, opt, lrs,
                                         eps=mcfg.eps)
            st = st._replace(params=new_params)
            logs.append(torch.stack([out.loss, out.im, out.depth, out.flat,
                                     out.iso, out.mean_density,
                                     out.mask_frac]).detach())
    return st, torch.stack(logs), bin_stats
