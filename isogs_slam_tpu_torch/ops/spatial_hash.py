"""Uniform-grid spatial hash KNN (counterpart of
isogs_slam_tpu/ops/spatial_hash.py).

build: hash each point's integer cell into a power-of-two table, sort point
ids by hash (stable), bucket ranges from a histogram + cumsum.
query: up to `cap` candidates from each of the 27 neighbouring cells, hash
collisions rejected by comparing packed cell coords, exact top-k.

The reference hashes in int32 with wrap-around products; here the
products are int64 and the hash keeps the low bits (& table_size-1), which
are the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import spans

_P1, _P2, _P3 = 73856093, 19349663, 83492791


class HashGrid(NamedTuple):
    order: torch.Tensor      # [C] int64 point ids sorted by hash bucket
    cell_of: torch.Tensor    # [C] int64 packed cell of each sorted point
    starts: torch.Tensor     # [H] int64 bucket start in `order`
    ends: torch.Tensor       # [H] int64 bucket end
    cell_size: torch.Tensor  # [] f32
    table_size: int
    points: torch.Tensor     # [C, 3] f32 positions in sorted order


def _cell_coords(points, cell_size):
    return torch.floor(points / cell_size).to(torch.int64)


def _hash_cells(cells, table_size: int):
    h = (cells[..., 0] * _P1) ^ (cells[..., 1] * _P2) ^ (cells[..., 2] * _P3)
    return h & (table_size - 1)


def _pack_cells(cells):
    """10 bits per axis, +512 offset (cells outside [-512, 511] alias)."""
    c = torch.clamp(cells + 512, 0, 1023)
    return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)


def median_alive(values, alive):
    """values[alive][n // 2] of the sorted live values (dead sort to +inf)
    — the reference's lower-median definition, with static shapes."""
    v = torch.sort(torch.where(alive, values,
                               torch.full_like(values, float("inf")))).values
    n = torch.sum(alive.to(torch.int64))
    idx = torch.clamp(n // 2, 0, values.shape[0] - 1)
    # indexing by a 0-d tensor reads the index back
    with spans.span("sync.median_index"):
        return v[idx]


def default_cell_size(log_scales, alive, factor: float = 2.5):
    mean_scale = torch.exp(torch.mean(log_scales, dim=1))
    return torch.clamp(factor * median_alive(mean_scale, alive), 1e-4, 1e3)


def auto_table_size(n_points: int) -> int:
    n = max(min(int(n_points), 1 << 21), 1 << 16)
    return 1 << (n - 1).bit_length()


def build_hash_grid(points, alive, cell_size, table_size: int = 0
                    ) -> HashGrid:
    """table_size 0 = auto_table_size of the point capacity."""
    if not table_size:
        table_size = auto_table_size(points.shape[0])
    cells = _cell_coords(points, cell_size)
    h = _hash_cells(cells, table_size)
    h = torch.where(alive, h, torch.full_like(h, table_size))
    order = torch.sort(h, stable=True).indices
    # bincount on the card sizes its output from the largest key: a read
    with spans.span("sync.hash_grid"):
        counts = torch.bincount(h, minlength=table_size + 1)[:table_size]
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    return HashGrid(order=order, cell_of=_pack_cells(cells)[order],
                    starts=starts, ends=ends, cell_size=cell_size,
                    table_size=table_size,
                    points=points[order].to(torch.float32))


def knn_hash(grid: HashGrid, queries, k: int, cap: int = 24):
    """K nearest hashed points of queries [Q, 3]: (sq_dists [Q, k],
    indices [Q, k] into the original point array). Missing neighbours
    have sq_dist = +inf."""
    dev = queries.device
    Q = queries.shape[0]
    qcells = _cell_coords(queries, grid.cell_size)
    d = torch.arange(-1, 2, device=dev)
    off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                      dim=-1).reshape(-1, 3)                  # [27, 3]
    ncells = qcells[:, None, :] + off[None, :, :]              # [Q, 27, 3]
    nh = _hash_cells(ncells, grid.table_size)
    s = grid.starts[nh]
    e = grid.ends[nh]
    slots = s[..., None] + torch.arange(cap, device=dev)       # [Q, 27, cap]
    in_bucket = slots < e[..., None]
    C = grid.order.shape[0]
    # the cap pad rows carry cell -1, which never matches a packed cell
    slots = torch.clamp(slots, max=C + cap - 1)
    cell_pad = torch.cat([grid.cell_of,
                          grid.cell_of.new_full((cap,), -1)])
    order_pad = torch.cat([grid.order, grid.order.new_zeros(cap)])
    pts_pad = torch.cat([grid.points, grid.points.new_zeros((cap, 3))])
    same_cell = cell_pad[slots] == _pack_cells(ncells)[:, :, None]
    valid = (in_bucket & same_cell).reshape(Q, -1)
    cand_idx = order_pad[slots].reshape(Q, -1)
    diff = pts_pad[slots].reshape(Q, -1, 3) - queries[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    neg_top, arg = torch.topk(-d2, k, dim=1)
    return -neg_top, torch.gather(cand_idx, 1, arg)
