"""Keyframe mapping (counterpart of isogs_slam_tpu/slam/mapping.py).

Per phase: each sampled keyframe slot is binned once (margin-free tile
lists, expansion order kept for the backward's segment reduce), the iso
hash grid and KNN pool are built once (or the pipeline hands in a pool it
keeps for several phases). Per iteration: the mapping loss (L1 + SSIM
colour, masked depth L1, IsoGS flat + iso), optionally Inria clone / split
densification from the loss's gradient in (u, v) (slam/densify.py),
pruning, the opacity reset and one Adam step (eps 1e-15) on every Gaussian
parameter. Tile lists and the hash grid stay frozen for the phase, so rows
cloned or split mid-phase get render gradients from the next phase on; the
Adam state is capacity-shaped, so they start with zero moments.

Opt-in fast mode (tile_subsample > 1): an iteration renders the loss on one
full-width stripe of tile rows (a core of ~tiles_y / sub rows and a halo
row on each side), the stripes of a keyframe cycling through a permutation;
the last exact_polish_iters iterations run on the whole image with the same
Adam state and the same frozen tile lists.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams, MapState, prune
from ..ops.iso_loss import IsoKnnPool, build_iso_knn_pool
from ..ops.rasterize import (MAPPING_LIVE_COLS, RasterConfig, _table_route,
                             bin_gaussians, bin_gaussians_batched,
                             image_to_tiles, project_gaussians,
                             tile_pixel_validity)
from ..ops.spatial_hash import build_hash_grid, default_cell_size
from ..utils import spans
from ..utils.transforms import transform_to_frame
from .losses import LossConfig, compute_loss, compute_loss_subsampled

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
    # Inria clone / split densification during mapping (slam/densify.py)
    use_densification: bool = False
    densify: tuple | None = None   # DensifyConfig when enabled
    # fast mode (1 = off): the loss of an iteration is rendered on a
    # 1/tile_subsample full-width stripe of tile rows
    # (losses.compute_loss_subsampled)
    tile_subsample: int = 1
    # True: a keyframe's iterations walk a permutation of the disjoint
    # stripes, a new one per cycle (every tile rendered once per
    # tile_subsample visits); False: independent random stripes
    tile_cycle: bool = True
    # lazy (per-row) Adam on the stripe iterations: a Gaussian's moments,
    # step count and parameters advance only when its stripe gave it a
    # gradient (optim.init(lazy=True))
    lazy_adam: bool = False
    # the last exact_polish_iters iterations of a subsampled phase run on
    # the exact full-image loss (same optimizer state, same tile lists)
    exact_polish_iters: int = 0
    # route through the stripe loss even at tile_subsample = 1 (the one
    # stripe is the whole image: loss-equivalent to the exact path)
    force_subset: bool = False
    # bin the phase's keyframe slots with one batched sort
    # (rasterize.bin_gaussians_batched) instead of one sort per slot
    vmap_bins: bool = False

    def lrs(self) -> tuple:
        return (self.lr_means3d, self.lr_rgb_colors, self.lr_unnorm_rotations,
                self.lr_logit_opacities, self.lr_log_scales)


def stripe_shape(gy: int, gx: int, sub: int):
    """Stripe geometry of the fast mode: core rows per stripe, window rows
    (core + up to one halo tile row on each side), stripe count, and the
    rendered tile count Ts."""
    rows_core = -(-gy // sub)
    rows_w = min(rows_core + 2, gy)
    n_stripes = -(-gy // rows_core)
    return rows_core, rows_w, n_stripes, rows_w * gx


def select_stripe(si: int, gy: int, gx: int, rows_core: int, rows_w: int,
                  device=None):
    """Tile ids and core mask of stripe `si`: a full-width band of rows_w
    tile rows holding the core rows [si * rows_core, + rows_core) and a
    halo row above and below where the image has one. When rows_core does
    not divide gy the last stripe is shifted up to stay in range (a few
    rows visited twice a cycle, none missed). Returns (sel [rows_w * gx]
    ascending tile ids, core [rows_w * gx] bool)."""
    r0 = min(int(si) * rows_core, gy - rows_core)
    ws = min(max(r0 - 1, 0), gy - rows_w)
    rows = ws + torch.arange(rows_w, device=device)
    core_row = (rows >= r0) & (rows < r0 + rows_core)
    sel = (rows[:, None] * gx
           + torch.arange(gx, device=device)[None, :]).reshape(-1)
    return sel, torch.repeat_interleave(core_row, gx)


def draw_stripes(iter_slots, n_stripes: int, tile_cycle: bool,
                 generator: torch.Generator | None, device) -> list:
    """The stripe index of each iteration. Cycling: each keyframe slot's own
    visits walk a permutation of the stripes, drawn anew for every cycle of
    n_stripes visits (with one cycle shared by all slots, a slot seen a few
    times could miss a stripe for the whole phase). Else independent
    uniform draws. One transfer to the host for the whole phase."""
    n = len(iter_slots)
    if not tile_cycle:
        with spans.span("sync.stripes"):
            return torch.randint(0, n_stripes, (n,), generator=generator,
                                 device=device).tolist()
    seen, pairs = {}, []
    for s in iter_slots:
        v = seen.get(s, 0)
        seen[s] = v + 1
        pairs.append((s, v // n_stripes, v % n_stripes))
    cycles = sorted({(s, c) for s, c, _ in pairs})
    with spans.span("sync.stripes"):
        perms = torch.argsort(torch.rand((len(cycles), n_stripes),
                                         generator=generator, device=device),
                              dim=1).tolist()
    row = {sc: perms[i] for i, sc in enumerate(cycles)}
    return [row[(s, c)][j] for s, c, j in pairs]


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


def build_phase_iso(params: GaussianParams, alive, lcfg: LossConfig,
               generator: torch.Generator | None = None, q_idx=None,
               pool: bool = True):
    """A phase's iso hash grid (when the KNN is the hash) and KNN pool
    (when `pool`), built once at the phase's start: Gaussian drift within
    a phase is far below the cell size."""
    grid = None
    if lcfg.knn_method == "hash":
        cell = default_cell_size(params.log_scales, alive)
        grid = build_hash_grid(params.means3d, alive, cell,
                               lcfg.hash_table_size)
    if not pool:
        return grid, None
    return grid, build_iso_knn_pool(
        params.means3d, params.log_scales, alive, lcfg.iso_pool_size,
        lcfg.iso_k, hash_cap=lcfg.hash_cap,
        hash_table_size=lcfg.hash_table_size, grid=grid, q_idx=q_idx,
        generator=generator, knn_method=lcfg.knn_method,
        knn_block=lcfg.knn_block)


@torch.no_grad()
def build_phase_iso_pool(params: GaussianParams, alive, lcfg: LossConfig,
                         generator: torch.Generator | None = None,
                         q_idx=None) -> IsoKnnPool:
    """A mapping phase's iso-KNN pool built on its own (hash grid, when
    the KNN is the hash, and one batched KNN), for a pipeline that keeps
    one pool for several phases (mapping.iso_pool_refresh_phases > 1):
    both queries and neighbours are alive-masked when the loss reads
    them, so a kept pool only leaves rows added since out of the sample."""
    return build_phase_iso(params, alive, lcfg, generator, q_idx)[1]


@torch.no_grad()
def bin_phase_slots(p0: GaussianParams, alive0, kf_quats, kf_transl, slots,
                    cam: Camera, rcfg: RasterConfig, mcfg: MappingConfig,
                    emit: bool) -> dict:
    """{slot: Binning}: the frozen tile lists of a phase's keyframe slots,
    binned once at the phase's start map p0. While a binning is reused
    for the phase the cull budgets are the rect margin in pixels, and an
    opacity logit rises by at most 3.2 lr per Adam step ((1 - b1) /
    sqrt(1 - b2): a sign flip after near-zero gradients)."""
    projs = []
    for slot in slots:
        mc, qc = transform_to_frame(p0.means3d, p0.unnorm_rotations,
                                    kf_quats[slot], kf_transl[slot],
                                    gaussians_grad=False, camera_grad=False)
        projs.append(project_gaussians(mc, qc, p0.log_scales, alive0, cam,
                                       margin_px=mcfg.bin_margin_px))
    budget = dict(
        emit_exp=emit, opacity=torch.sigmoid(p0.logit_opacities[:, 0]),
        cull_slack_px=mcfg.bin_margin_px,
        cull_logit_drift=3.2 * mcfg.lr_logit_opacities * mcfg.num_iters)
    if mcfg.vmap_bins:
        return dict(zip(slots, bin_gaussians_batched(projs, cam, rcfg,
                                                     **budget)))
    return {slot: bin_gaussians(proj, cam, rcfg, **budget)
            for slot, proj in zip(slots, projs)}


def phase_bin_stats(bins, device) -> torch.Tensor:
    """[true-candidate intersections dropped by the per-tile cap, total
    and max intersections] over the binnings `bins` (int64)."""
    if not bins:
        return torch.zeros(3, dtype=torch.int64, device=device)
    n_isect = torch.stack([b.n_isect.to(torch.int64) for b in bins])
    return torch.stack([
        sum(b.n_true_overflow.to(torch.int64) for b in bins),
        n_isect.sum(), n_isect.max()])


def merge_max_radius(st: MapState, radii) -> MapState:
    """seen / max_2D_radius bookkeeping (splatam.py:751-753): the rows a
    render saw (radius > 0) keep the larger of their radii."""
    max_r = torch.where(radii > 0,
                        torch.maximum(radii.to(st.max_2d_radius.dtype),
                                      st.max_2d_radius),
                        st.max_2d_radius)
    return st._replace(max_2d_radius=max_r)


def prune_and_reset(st: MapState, opt, view_it: int, pc: PruneConfig,
                    n_views: int = 1):
    """The schedule's prune at view count `view_it` (before the optimizer
    step, splatam.py:1461-1467), then the opacity reset when a multiple of
    reset_opacities_every falls in [view_it, view_it + n_views): the
    parameter is replaced and its Adam moments zeroed
    (slam_external.py:183-186). -> (state, opt)."""
    st = prune(st, _prune_mask(st.params, st.alive, st.scene_radius,
                               view_it, pc))
    if pc.reset_opacities and view_it > 0 and \
            view_it % max(pc.reset_opacities_every, 1) < n_views:
        # log(0.01 / 0.99) in f32, as the reference computes it
        reset_val = float(torch.log(torch.tensor(0.01 / 0.99)))
        st = st._replace(params=st.params._replace(
            logit_opacities=torch.full_like(st.params.logit_opacities,
                                            reset_val)))
        j = GaussianParams._fields.index("logit_opacities")
        mu, nu = list(opt.mu), list(opt.nu)
        mu[j] = torch.zeros_like(mu[j])
        nu[j] = torch.zeros_like(nu[j])
        opt = opt._replace(mu=tuple(mu), nu=tuple(nu))
    return st, opt


def map_frame(state: MapState, kf_colors_u8, kf_depths, kf_quats, kf_transl,
              iter_slots, cam: Camera, rcfg: RasterConfig, lcfg: LossConfig,
              mcfg: MappingConfig, generator: torch.Generator | None = None,
              pool_q_idx=None, iso_sels=None, stripe_idx=None, iso_pool=None,
              split_noise=None):
    """One mapping phase of mcfg.num_iters iterations.

    kf_colors_u8 [S, H, W, 3] uint8, kf_depths [S, H, W] f32, kf_quats
    [S, 4], kf_transl [S, 3]: the keyframe window on the map's device;
    iter_slots: the keyframe slot of each iteration (host ints). The
    random draws — the iso pool's query rows, each iteration's iso
    sample (pool rows, or with lcfg.iso_pool_size = 0 the query rows), in
    the fast mode each stripe iteration's stripe index and, with
    densification, the split noise of the iterations that densify — are
    `pool_q_idx`, `iso_sels[i]`, `stripe_idx[i]` and `split_noise[i]`
    ([num_to_split_into, C, 3] normals) when given, else drawn with
    `generator`. `iso_pool`: a prebuilt pool (build_phase_iso_pool) used
    instead of one built here.

    Returns (new MapState, loss_log [num_iters, N_LOG], phase stats: [true-
    candidate intersections dropped by the per-tile cap, total and max
    intersections over the binned slots], and with densification three
    more: rows cloned, rows split and rows dropped at capacity)."""
    assert not lcfg.tracking
    pc = mcfg.prune
    dens = mcfg.densify if mcfg.use_densification else None
    if mcfg.use_densification and dens is None:
        raise ValueError("MappingConfig.use_densification needs "
                         "MappingConfig.densify (a DensifyConfig)")
    if dens is not None:
        from .densify import accumulate_mean2d_gradient, densify_step
    iter_slots = [int(s) for s in iter_slots]
    p0 = GaussianParams(*[p.detach() for p in state.params])
    alive0 = state.alive
    dev = alive0.device

    subsample = mcfg.tile_subsample > 1 or mcfg.force_subset
    polish = (min(int(mcfg.exact_polish_iters), mcfg.num_iters)
              if subsample else 0)
    n_sub = len(iter_slots) - polish if subsample else 0
    # the expansion positions are kept only when a backward will use them:
    # the whole image's (with a stripe, the closing exact iterations'), the
    # stripe's (by the row crossover)
    emit = _table_route(rcfg, MAPPING_LIVE_COLS, None,
                        True)[0] == "segreduce"
    if subsample:
        rows_core, rows_w, n_stripes, t_sub = stripe_shape(
            cam.tiles_y, cam.tiles_x, mcfg.tile_subsample)
        emit = (polish > 0 and emit) or _table_route(
            rcfg, MAPPING_LIVE_COLS, t_sub, True)[0] == "segreduce"

    with torch.no_grad():
        with spans.fine("mapping.bin"):
            bins = bin_phase_slots(p0, alive0, kf_quats, kf_transl,
                                   sorted(set(iter_slots)), cam, rcfg, mcfg,
                                   emit)
            bin_stats = phase_bin_stats(list(bins.values()), dev)
        # none when a prebuilt pool is given (the pool path never consults
        # the grid)
        iso_grid = None
        if iso_pool is None and lcfg.calc_iso:
            with spans.fine("mapping.iso_pool"):
                iso_grid, iso_pool = build_phase_iso(
                    p0, alive0, lcfg, generator, pool_q_idx,
                    pool=lcfg.iso_pool_size > 0)

        if n_sub:
            # the phase's keyframes in the compositor's tile layout, once;
            # an iteration gathers its stripe's rows
            gt_tiles_all = {
                slot: image_to_tiles(torch.cat([
                    (kf_colors_u8[slot].to(torch.float32) / 255.0
                     ).permute(2, 0, 1), kf_depths[slot][None]]), cam)
                for slot in set(iter_slots[:n_sub])}
            with spans.span("sync.tile_validity"):
                valid_px_full = torch.as_tensor(tile_pixel_validity(cam),
                                                device=dev)
            if stripe_idx is None:
                stripe_idx = draw_stripes(iter_slots[:n_sub], n_stripes,
                                          mcfg.tile_cycle, generator, dev)
            stripes = {si: select_stripe(si, cam.tiles_y, cam.tiles_x,
                                         rows_core, rows_w, dev)
                       for si in set(int(i) for i in stripe_idx[:n_sub])}

    def loss_exact(leaves, m2d, alive, slot, it):
        gt_im = (kf_colors_u8[slot].to(torch.float32) / 255.0
                 ).permute(2, 0, 1)
        return compute_loss(
            leaves, alive, kf_quats[slot], kf_transl[slot], gt_im,
            kf_depths[slot][None], cam, rcfg, lcfg, binning=bins[slot],
            iso_pool=iso_pool,
            iso_sel=None if iso_sels is None else iso_sels[it],
            generator=generator, means2d_offset=m2d, iso_grid=iso_grid)

    def loss_sub(leaves, m2d, alive, slot, it):
        sel, core = stripes[int(stripe_idx[it])]
        return compute_loss_subsampled(
            leaves, alive, kf_quats[slot], kf_transl[slot],
            gt_tiles_all[slot][sel], valid_px_full[sel], core, sel,
            bins[slot], cam, rcfg, lcfg, iso_pool=iso_pool,
            iso_sel=None if iso_sels is None else iso_sels[it],
            generator=generator, means2d_offset=m2d, iso_grid=iso_grid)

    lrs = mcfg.lrs()
    st = state
    opt = optim.init(state.params, lazy=subsample and mcfg.lazy_adam)
    logs = []
    dens_counts = torch.zeros(3, dtype=torch.int64, device=dev)
    for it, slot in enumerate(iter_slots):
        leaves = GaussianParams(*[p.detach().requires_grad_(True)
                                  for p in st.params])
        # the zero (u, v) offset whose gradient drives densification
        m2d = (torch.zeros((st.capacity, 2), device=dev, requires_grad=True)
               if dens is not None else None)
        with torch.enable_grad():
            with spans.fine("mapping.forward"):
                out = (loss_sub if it < n_sub else loss_exact)(
                    leaves, m2d, st.alive, slot, it)
            with spans.fine("mapping.backward"):
                grads = torch.autograd.grad(
                    out.loss, tuple(leaves) + ((m2d,) if m2d is not None
                                               else ()))
        with torch.no_grad():
            if dens is not None:
                with spans.fine("mapping.densify_step"):
                    st = accumulate_mean2d_gradient(st, out.radii,
                                                    grads[-1])
                    st, opt, c = densify_step(
                        st, opt, it, dens, generator=generator,
                        split_noise=None if split_noise is None
                        else split_noise[it])
                    dens_counts += c
                grads = grads[:-1]
            with spans.fine("mapping.prune"):
                st = merge_max_radius(st, out.radii)
                st, opt = prune_and_reset(st, opt, it, pc)
            with spans.fine("mapping.adam"):
                new_params, opt = optim.step(st.params, grads, opt, lrs,
                                             eps=mcfg.eps)
            st = st._replace(params=new_params)
            logs.append(torch.stack([out.loss, out.im, out.depth, out.flat,
                                     out.iso, out.mean_density,
                                     out.mask_frac]).detach())
    if dens is not None:
        bin_stats = torch.cat([bin_stats, dens_counts])
    return st, torch.stack(logs), bin_stats


def estimated_pose(cam_rots: torch.Tensor, cam_trans: torch.Tensor,
                   time_idx: int):
    """Normalized (quat, trans) at a frame index; cam_rots [4,T]."""
    q = cam_rots[:, time_idx]
    return q / torch.linalg.norm(q), cam_trans[:, time_idx]
