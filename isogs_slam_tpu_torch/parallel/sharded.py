"""View-parallel mapping over the ranks of a mesh (counterpart of
isogs_slam_tpu/parallel/sharded.py).

Each mapping step renders a batch of B keyframe views, one per rank, and
takes ONE Adam step on the mean loss over the views: every rank renders and
differentiates its own view, the per-view gradients are summed by one
all_reduce and divided by B, and every rank then takes the identical Adam
step on its copy of the replicated map. The view-independent IsoGS
regularizers (flat + iso) are evaluated once per step, on rank 0, and their
gradient joins rank 0's share of the same all_reduce, so the replicas never
depend on a per-rank evaluation that could round differently.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import optim
from ..core.camera import Camera
from ..core.gaussians import GaussianParams, MapState
from ..ops.rasterize import RasterConfig
from ..slam.losses import LossConfig, compute_loss
from ..slam.mapping import (MappingConfig, bin_phase_slots,
                            build_phase_iso, merge_max_radius,
                            phase_bin_stats, prune_and_reset)
from .dist import Mesh, all_reduce_, broadcast_, make_mesh

VIEW_AXIS = "view"

__all__ = ["VIEW_AXIS", "make_mesh", "batched_map_loss",
           "make_sharded_map_step", "shard_view_batch", "replicate",
           "make_multiview_map_phase", "MultiviewMapPhase"]


def batched_map_loss(params: GaussianParams, alive, kf_quats, kf_transl,
                     gt_ims, gt_depths, generators, cam: Camera,
                     rcfg: RasterConfig, lcfg: LossConfig):
    """Mean mapping loss over a batch of views (leading axis = view) on
    this rank; `generators[v]` draws view v's iso sample."""
    losses = [compute_loss(params, alive, q.detach(), t.detach(), im, d,
                           cam, rcfg, lcfg, generator=g).loss
              for q, t, im, d, g in zip(kf_quats, kf_transl, gt_ims,
                                        gt_depths, generators)]
    return torch.stack(losses).mean()


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like) -> tuple:
    out, o = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[o:o + n].reshape(t.shape))
        o += n
    return tuple(out)


def make_sharded_map_step(mesh: Mesh, cam: Camera, rcfg: RasterConfig,
                          lcfg: LossConfig, mcfg: MappingConfig):
    """The multi-rank mapping train step.

    Returns step(params, alive, opt, kf_quats [b,4], kf_transl [b,3],
    gt_ims [b,3,H,W], gt_depths [b,1,H,W], generators [b]) -> (new_params,
    new_opt, loss), where the b views are this rank's share of the batch
    (shard_view_batch) and params / opt are replicated. The loss is the
    mean over all B views; the gradient is the all-reduced sum of the
    per-view gradients divided by B."""
    lrs = mcfg.lrs()

    def step(params, alive, opt, kf_quats, kf_transl, gt_ims, gt_depths,
             generators):
        leaves = GaussianParams(*[p.detach().requires_grad_(True)
                                  for p in params])
        b = len(kf_quats)
        with torch.enable_grad():
            if b:
                loss_sum = batched_map_loss(
                    leaves, alive, kf_quats, kf_transl, gt_ims, gt_depths,
                    generators, cam, rcfg, lcfg) * b
                grads = torch.autograd.grad(loss_sum, tuple(leaves))
            else:
                loss_sum = torch.zeros((), device=mesh.device)
                grads = tuple(torch.zeros_like(p) for p in leaves)
        pack = torch.cat([_flat(grads),
                          torch.stack([loss_sum.detach(),
                                       torch.tensor(float(b),
                                                    device=mesh.device)])])
        all_reduce_(pack, mesh)
        n_views = pack[-1]
        grads = _unflat(pack[:-2] / n_views, leaves)
        with torch.no_grad():
            new_params, new_opt = optim.step(
                GaussianParams(*[p.detach() for p in params]), grads, opt,
                lrs, eps=mcfg.eps)
        return new_params, new_opt, pack[-2] / n_views

    return step


def shard_view_batch(mesh: Mesh, *arrays):
    """This rank's contiguous share of per-view batched arrays (leading
    axis B) on its device; lists (the per-view generators) are sliced."""
    B = len(arrays[0])
    per = -(-B // mesh.size)
    lo = min(mesh.rank * per, B) if mesh.rank < mesh.size else B
    hi = min(lo + per, B)
    return tuple(a[lo:hi] if isinstance(a, list) else
                 torch.as_tensor(a)[lo:hi].to(mesh.device) for a in arrays)


def replicate(mesh: Mesh, tree):
    """Replicate a tuple of tensors (the Gaussian map state, an Adam state)
    over the ranks: rank 0's copy on every rank's device. Non-tensor leaves
    (the Adam step count) pass through."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return broadcast_(a.detach().to(mesh.device).clone(), mesh)
        if isinstance(a, tuple):
            vals = [one(x) for x in a]
            return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
        return a
    return one(tree)


# ---------------------------------------------------------------------------
# The multi-rank mapping PHASE: the pipeline-integrated version of the train
# step above. One phase = n_steps steps; each step renders B keyframe views
# (B = mesh size, one per rank), takes ONE Adam step on the mean loss, and
# applies the per-phase machinery of slam.mapping.map_frame through its own
# helpers: frozen per-slot tile binning (each rank bins the slots it
# renders), the iso hash grid and KNN pool (rank 0, which evaluates the
# regularizers), the prune schedule, the opacity reset and the seen /
# max-radius bookkeeping. The prune / reset schedules are indexed by
# cumulative VIEW count (step * B), so a multi-rank run follows the schedule
# of the serial reading of mapping.num_iters.

_LOG_TERMS = ("loss", "im", "depth", "mask", "flat", "iso", "dens")


class MultiviewMapPhase:
    """phase(state, kf_colors_u8 [S,H,W,3], kf_depths [S,H,W],
    kf_quats [S,4], kf_transl [S,3], step_slots [n_steps, B] (host ints,
    keyframe slots), seed) -> (new state, loss_log [n_steps, N_LOG],
    bin_stats [3]: true-candidate intersections dropped by the per-tile
    cap, total and max intersections over the distinct slots the phase
    renders, as map_frame counts them; the reference bins and counts every
    slot of its padded window). Identical on every rank. `last_opt` keeps
    the phase's final Adam state (the replicas' check reads it)."""

    def __init__(self, mesh: Mesh, cam: Camera, rcfg: RasterConfig,
                 lcfg: LossConfig, mcfg: MappingConfig):
        assert not lcfg.tracking
        assert not mcfg.use_densification, \
            "clone/split densification is not supported in multiview mapping"
        self.mesh, self.cam, self.rcfg = mesh, cam, rcfg
        self.lcfg, self.mcfg = lcfg, mcfg
        self.B = mesh.size
        self.last_opt = None

    def _bins(self, p0, alive0, kf_quats, kf_transl, step_slots):
        """This rank's frozen tile lists {slot: Binning} and the phase's
        bin_stats, each distinct slot counted once (on the lowest rank
        that renders it)."""
        mesh, B = self.mesh, self.B
        mine = (sorted(set(step_slots[:, mesh.rank].tolist()))
                if mesh.rank < B else [])
        first = {}
        for r in range(B):
            for s in step_slots[:, r].tolist():
                first.setdefault(s, r)
        bins = bin_phase_slots(p0, alive0, kf_quats, kf_transl, mine,
                               self.cam, self.rcfg, self.mcfg,
                               self.rcfg.resolve_bwd_mode() == "segreduce")
        stats = phase_bin_stats([b for s, b in bins.items()
                                 if first[s] == mesh.rank],
                                alive0.device)
        sums, peak = stats[:2].contiguous(), stats[2:].contiguous()
        all_reduce_(sums, mesh)
        all_reduce_(peak, mesh, op="max")
        return bins, torch.cat([sums, peak])

    def _regularizers(self, leaves, alive, iso_pool, iso_grid, gen):
        """rank 0's view-independent IsoGS terms (w_flat flat, w_iso iso,
        mean density), evaluated once per Adam step; zeros elsewhere."""
        from ..ops.iso_loss import flat_loss, iso_surface_loss
        lcfg = self.lcfg
        z = torch.zeros((), device=alive.device)
        wflat = wiso = dens = z
        if self.mesh.rank != 0:
            return wflat, wiso, dens
        if lcfg.w_flat != 0.0:
            wflat = lcfg.w_flat * flat_loss(leaves.log_scales, alive)
        if lcfg.calc_iso and lcfg.w_iso != 0.0:
            iso, dens = iso_surface_loss(
                leaves.means3d, leaves.unnorm_rotations, leaves.log_scales,
                leaves.logit_opacities, alive, iso_pool,
                sample_size=lcfg.iso_sample_size,
                target_saturation=lcfg.iso_target, generator=gen,
                k=lcfg.iso_k, knn_method=lcfg.knn_method,
                hash_cap=lcfg.hash_cap, hash_table_size=lcfg.hash_table_size,
                knn_block=lcfg.knn_block, grid=iso_grid)
            wiso = lcfg.w_iso * iso
        return wflat, wiso, dens

    def __call__(self, state: MapState, kf_colors_u8, kf_depths, kf_quats,
                 kf_transl, step_slots, seed: int):
        mesh, cam, rcfg, lcfg, mcfg, B = (self.mesh, self.cam, self.rcfg,
                                          self.lcfg, self.mcfg, self.B)
        step_slots = np.asarray(step_slots, np.int64).reshape(-1, B)
        dev = state.alive.device
        p0 = GaussianParams(*[p.detach() for p in state.params])
        # rows past the high-water mark are dead for the whole phase (no
        # densification here): the gradient all_reduce carries [:hwm] only
        n_rows = int(state.hwm)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            bins, bin_stats = self._bins(p0, state.alive, kf_quats,
                                         kf_transl, step_slots)
            iso_grid = iso_pool = None
            if mesh.rank == 0 and lcfg.calc_iso:
                iso_grid, iso_pool = build_phase_iso(
                    p0, state.alive, lcfg, gen,
                    pool=lcfg.iso_pool_size > 0)

        # the IsoGS regularizers do not depend on the view: evaluated ONCE
        # per Adam step (rank 0) instead of once per view
        lcfg_view = lcfg._replace(calc_iso=False, w_flat=0.0, w_iso=0.0)
        lrs = mcfg.lrs()
        st = state
        opt = optim.init(state.params)
        logs = []
        for it in range(step_slots.shape[0]):
            leaves = GaussianParams(*[p.detach().requires_grad_(True)
                                      for p in st.params])
            z = torch.zeros((), device=dev)
            terms = dict.fromkeys(_LOG_TERMS, z)
            radii = torch.zeros_like(st.max_2d_radius, dtype=torch.int32)
            with torch.enable_grad():
                total = z
                if mesh.rank < B:
                    slot = int(step_slots[it, mesh.rank])
                    out = compute_loss(
                        leaves, st.alive, kf_quats[slot].detach(),
                        kf_transl[slot].detach(),
                        (kf_colors_u8[slot].to(torch.float32) / 255.0
                         ).permute(2, 0, 1),
                        kf_depths[slot][None], cam, rcfg, lcfg_view,
                        binning=bins[slot])
                    total = out.loss / B
                    terms.update(loss=out.loss, im=out.im, depth=out.depth,
                                 mask=out.mask_frac)
                    radii = out.radii.to(torch.int32)
                wflat, wiso, dens = self._regularizers(
                    leaves, st.alive, iso_pool, iso_grid, gen)
                total = total + wflat + wiso
                terms.update(flat=wflat, iso=wiso, dens=dens)
                grads = (torch.autograd.grad(total, tuple(leaves),
                                             allow_unused=True)
                         if total.requires_grad else (None,) * len(leaves))
                grads = tuple(torch.zeros_like(p) if g is None else g
                              for g, p in zip(grads, leaves))
            with torch.no_grad():
                # one all_reduce: the live rows' gradients and the step's
                # log pieces (per-view sums; rank 0's regularizer terms)
                scal = torch.stack([terms[k].detach() for k in _LOG_TERMS])
                pack = torch.cat([_flat(g[:n_rows] for g in grads), scal])
                all_reduce_(pack, mesh)
                g_rows = _unflat(pack[:-len(_LOG_TERMS)],
                                 [g[:n_rows] for g in grads])
                grads = tuple(torch.cat([gr, torch.zeros_like(g[n_rows:])])
                              for gr, g in zip(g_rows, grads))
                v_loss, v_im, v_depth, v_mask, wflat, wiso, dens = \
                    pack[-len(_LOG_TERMS):]
                # seen / max_2D_radius over the whole view batch
                st = merge_max_radius(
                    st, all_reduce_(radii.contiguous(), mesh, op="max"))
                st, opt = prune_and_reset(st, opt, it * B, mcfg.prune, B)
                new_params, opt = optim.step(st.params, grads, opt, lrs,
                                             eps=mcfg.eps)
                st = st._replace(params=new_params)
                logs.append(torch.stack([v_loss / B + wflat + wiso,
                                         v_im / B, v_depth / B, wflat, wiso,
                                         dens, v_mask / B]))
        self.last_opt = opt
        return st, torch.stack(logs), bin_stats


def make_multiview_map_phase(mesh: Mesh, cam: Camera, rcfg: RasterConfig,
                             lcfg: LossConfig, mcfg: MappingConfig
                             ) -> MultiviewMapPhase:
    return MultiviewMapPhase(mesh, cam, rcfg, lcfg, mcfg)
