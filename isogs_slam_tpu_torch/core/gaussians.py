"""Fixed-capacity Gaussian map state (counterpart of
isogs_slam_tpu/core/gaussians.py).

Arrays have capacity C; `hwm` is the used-slot high-water mark and `alive`
marks live rows (pruning clears bits). The functions return new states and
leave their inputs untouched, like the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..utils import spans


class GaussianParams(NamedTuple):
    means3d: torch.Tensor           # [C, 3]
    rgb_colors: torch.Tensor        # [C, 3]
    unnorm_rotations: torch.Tensor  # [C, 4] (w, x, y, z)
    logit_opacities: torch.Tensor   # [C, 1]
    log_scales: torch.Tensor        # [C, 3]


class MapState(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor             # [C] bool
    hwm: torch.Tensor               # [] int64 used slots (alive or dead)
    timestep: torch.Tensor          # [C] f32 creation frame
    max_2d_radius: torch.Tensor     # [C] f32
    means2d_grad_accum: torch.Tensor  # [C] f32
    denom: torch.Tensor             # [C] f32
    scene_radius: torch.Tensor      # [] f32

    @property
    def capacity(self) -> int:
        return self.params.means3d.shape[0]

    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int64))


def empty_state(capacity: int, device="cuda",
                dtype=torch.float32) -> MapState:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params = GaussianParams(
        means3d=z(capacity, 3), rgb_colors=z(capacity, 3),
        unnorm_rotations=z(capacity, 4), logit_opacities=z(capacity, 1),
        log_scales=z(capacity, 3))
    return MapState(params=params,
                    alive=torch.zeros(capacity, dtype=torch.bool, device=dev),
                    hwm=torch.zeros((), dtype=torch.int64, device=dev),
                    timestep=z(capacity), max_2d_radius=z(capacity),
                    means2d_grad_accum=z(capacity), denom=z(capacity),
                    scene_radius=torch.ones((), dtype=dtype, device=dev))


def new_gaussian_rows(points: torch.Tensor, colors: torch.Tensor,
                      mean3_sq_dist: torch.Tensor, perturb=None
                      ) -> GaussianParams:
    """Parameter init for back-projected points: identity quats, logit
    opacity 0, log-scale = log(sqrt(mean3_sq_dist)) on all 3 axes.

    perturb: None, or [n, 3] standard normals; the log-scales then get
    0.01 * perturb (the "isotropic" init's symmetry breaking for the
    flatness loss)."""
    n = points.shape[0]
    log_scales = (0.5 * torch.log(mean3_sq_dist))[:, None].expand(n, 3)
    if perturb is not None:
        log_scales = log_scales + 0.01 * perturb
    quats = torch.zeros((n, 4), dtype=points.dtype, device=points.device)
    quats[:, 0] = 1.0
    return GaussianParams(
        means3d=points, rgb_colors=colors, unnorm_rotations=quats,
        logit_opacities=torch.zeros((n, 1), dtype=points.dtype,
                                    device=points.device),
        log_scales=log_scales.contiguous())


def append_rows(state: MapState, rows: GaussianParams, valid: torch.Tensor,
                time_idx) -> MapState:
    """Write rows[valid] into slots [hwm, hwm + sum(valid)); rows whose
    destination exceeds capacity are dropped. time_idx: one creation frame
    for every row, or a tensor of one per row of `rows`. The densification
    stats are zeroed globally (splatam.py:835-837)."""
    C = state.capacity
    v = valid.to(torch.int64)
    dest = state.hwm + torch.cumsum(v, 0) - v
    keep = valid & (dest < C)
    # boolean masks size their results on the host: each waits for the card
    with spans.span("sync.append_rows"):
        idx = dest[keep]
        params = GaussianParams(*[p.index_put((idx,), r[keep])
                                  for p, r in zip(state.params, rows)])
    alive = state.alive.index_fill(0, idx, True)
    if torch.is_tensor(time_idx) and time_idx.dim() > 0:
        with spans.span("sync.append_rows"):
            kept_t = time_idx[keep]
        timestep = state.timestep.index_put(
            (idx,), kept_t.to(state.timestep.dtype))
    else:
        timestep = state.timestep.index_fill(0, idx, float(time_idx))
    n_add = torch.minimum(torch.sum(v), C - state.hwm)
    z = torch.zeros_like(state.max_2d_radius)
    return state._replace(params=params, alive=alive, hwm=state.hwm + n_add,
                          timestep=timestep, max_2d_radius=z,
                          means2d_grad_accum=z.clone(), denom=z.clone())


def prune(state: MapState, remove: torch.Tensor) -> MapState:
    """Mark rows dead (physical compaction is deferred to `compact`)."""
    return state._replace(alive=state.alive & ~remove)


def compact(state: MapState) -> MapState:
    """Re-pack alive rows into a dense prefix. A stable sort on the dead
    flag keeps creation order; dead rows keep their values behind the new
    high-water mark."""
    order = torch.sort((~state.alive).to(torch.int8), stable=True).indices
    n_alive = torch.sum(state.alive.to(torch.int64))
    params = GaussianParams(*[p[order] for p in state.params])
    alive = torch.arange(state.capacity, device=order.device) < n_alive
    return state._replace(
        params=params, alive=alive, hwm=n_alive,
        timestep=state.timestep[order],
        max_2d_radius=state.max_2d_radius[order],
        means2d_grad_accum=state.means2d_grad_accum[order],
        denom=state.denom[order])


def grow_capacity(state: MapState, new_capacity: int) -> MapState:
    """Extend every per-row array with zero (dead) rows."""
    C = state.capacity
    assert new_capacity >= C

    def pad(a):
        return torch.cat([a, a.new_zeros((new_capacity - C,) + a.shape[1:])])

    return state._replace(
        params=GaussianParams(*[pad(p) for p in state.params]),
        alive=pad(state.alive), timestep=pad(state.timestep),
        max_2d_radius=pad(state.max_2d_radius),
        means2d_grad_accum=pad(state.means2d_grad_accum),
        denom=pad(state.denom))


def round_capacity(n: int, granule: int = 65536) -> int:
    """Capacity buckets: multiples of `granule`."""
    return max(granule, (n + granule - 1) // granule * granule)
