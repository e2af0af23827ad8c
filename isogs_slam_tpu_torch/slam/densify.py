"""Inria-style gradient-driven densification (clone and split) with Adam
state surgery on the fixed-capacity map (counterpart of
isogs_slam_tpu/slam/densify.py).

  * accumulate_mean2d_gradient: per seen Gaussian, the norm of
    d loss / d(u, v) is added to an accumulator and a counter;
  * densify_step, every densify_every iterations in [start_after,
    stop_after]: clone (mean gradient >= grad_thresh, max scale <= 0.01
    scene radius) or split (larger: num_to_split_into copies at
    mean + R N(0, scale), scales / (0.8 n), originals removed), then
    opacity / size pruning; the opacity reset on its own schedule zeroes
    the opacities' Adam moments.

Appends write into slots [hwm, ...) (gaussians.append_rows) and drop the
rows past capacity; removals clear `alive` bits. The Adam moments are
capacity-shaped, so a new row starts with zero moments as long as slots are
written once per optimizer lifetime (no compaction while the optimizer
state lives). The schedule is known on the host, so an off-schedule call
does nothing to the state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import optim
from ..core.gaussians import GaussianParams, MapState, append_rows
from ..utils.transforms import quat_to_rotmat
from .mapping import PruneConfig, _prune_mask


class DensifyConfig(NamedTuple):
    """densify_dict of the configs."""

    start_after: int = 500
    remove_big_after: int = 3000
    stop_after: int = 5000
    densify_every: int = 100
    grad_thresh: float = 0.0002
    num_to_split_into: int = 2
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities_every: int = 3000
    reset_opacities: bool = True


def accumulate_mean2d_gradient(state: MapState, radii,
                               means2d_grad) -> MapState:
    """radii [C] int32 from the render; means2d_grad [C, 2] = d loss /
    d means2d_offset. Seen rows (radius > 0) add their gradient norm and
    one count, and raise their max 2-D radius."""
    seen = radii > 0
    gnorm = torch.sqrt(torch.sum(means2d_grad * means2d_grad, dim=-1))
    accum = torch.where(seen, state.means2d_grad_accum + gnorm,
                        state.means2d_grad_accum)
    denom = torch.where(seen, state.denom + 1.0, state.denom)
    max_r = torch.where(seen, torch.maximum(
        radii.to(state.max_2d_radius.dtype), state.max_2d_radius),
        state.max_2d_radius)
    return state._replace(means2d_grad_accum=accum, denom=denom,
                          max_2d_radius=max_r)


def _split_rows(params: GaussianParams, noise, n_copies: int
                ) -> GaussianParams:
    """One perturbed copy of every row: means += R (scales * noise) with
    noise [C, 3] standard normals, scales /= 0.8 n."""
    scales = torch.exp(params.log_scales)
    R = quat_to_rotmat(params.unnorm_rotations)
    offset = torch.sum(R * (scales * noise)[:, None, :], dim=-1)
    return params._replace(means3d=params.means3d + offset,
                           log_scales=torch.log(scales / (0.8 * n_copies)))


def is_densify_iter(it: int, dcfg: DensifyConfig) -> bool:
    """Does densify_step clone / split / prune at iteration `it`?"""
    return (dcfg.start_after <= it <= dcfg.stop_after
            and it % max(dcfg.densify_every, 1) == 0)


@torch.no_grad()
def densify_step(state: MapState, opt: optim.AdamState, it: int,
                 dcfg: DensifyConfig, generator: torch.Generator | None = None,
                 split_noise=None):
    """One densify() call at iteration `it`. Returns (state, opt, counts)
    with counts an int64 tensor [3] = (rows cloned, rows split, rows
    dropped at capacity). The split noise is `split_noise`
    [num_to_split_into, C, 3] standard normals when given, else drawn with
    `generator` (only on an iteration that densifies)."""
    dev = state.alive.device
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    if is_densify_iter(it, dcfg):
        C = state.capacity
        grads = state.means2d_grad_accum / torch.clamp(state.denom,
                                                       min=1e-12)
        grads = torch.where(torch.isnan(grads), torch.zeros_like(grads),
                            grads)
        max_scale = max_scale_now(state)
        hot = (grads >= dcfg.grad_thresh) & state.alive
        small = max_scale <= 0.01 * state.scene_radius
        to_clone = hot & small
        to_split = hot & ~small
        n_split = int(dcfg.num_to_split_into)
        n_clone_rows = to_clone.sum()
        n_split_rows = to_split.sum()
        dropped = torch.clamp(state.hwm + n_clone_rows - C, min=0)
        # clone: exact copies (fresh slots: zero Adam moments); append_rows
        # also resets the densification stats, as the reference does
        state = append_rows(state, state.params, to_clone, state.timestep)
        if split_noise is None:
            split_noise = [torch.randn(state.params.means3d.shape,
                                       generator=generator, device=dev)
                           for _ in range(n_split)]
        src = state.params
        for i in range(n_split):
            rows = _split_rows(src, split_noise[i], n_split)
            dropped = dropped + torch.clamp(state.hwm + n_split_rows - C,
                                            min=0)
            state = append_rows(state, rows, to_split, state.timestep)
        state = state._replace(alive=state.alive & ~to_split)
        counts = torch.stack([n_clone_rows, n_split_rows, dropped])

        # opacity / big pruning right after densify
        thres = (dcfg.final_removal_opacity_threshold
                 if it == dcfg.stop_after else dcfg.removal_opacity_threshold)
        remove = torch.sigmoid(state.params.logit_opacities[:, 0]) < thres
        if it >= dcfg.remove_big_after:
            remove = remove | (max_scale_now(state)
                               > 0.1 * state.scene_radius)
        state = state._replace(alive=state.alive & ~remove)

    # opacity reset on its own schedule, with zeroed moments
    if (dcfg.reset_opacities and 0 < it <= dcfg.stop_after
            and it % max(dcfg.reset_opacities_every, 1) == 0):
        # log(0.01 / 0.99) in f32, as the reference computes it
        reset_val = float(torch.log(torch.tensor(0.01 / 0.99)))
        params = state.params
        state = state._replace(params=params._replace(
            logit_opacities=torch.full_like(params.logit_opacities,
                                            reset_val)))
        j = GaussianParams._fields.index("logit_opacities")
        mu, nu = list(opt.mu), list(opt.nu)
        mu[j] = torch.zeros_like(mu[j])
        nu[j] = torch.zeros_like(nu[j])
        opt = opt._replace(mu=tuple(mu), nu=tuple(nu))
    return state, opt, counts


def max_scale_now(state: MapState) -> torch.Tensor:
    return torch.max(torch.exp(state.params.log_scales), dim=1).values


def prune_step(state: MapState, it: int, pc: PruneConfig) -> MapState:
    """The prune_gaussians schedule as an alive-mask update (mapping.py
    applies the same mask inline)."""
    remove = _prune_mask(state.params, state.alive, state.scene_radius, it,
                         pc)
    return state._replace(alive=state.alive & ~remove)
