"""Uniform-grid spatial hash KNN (counterpart of
isogs_slam_tpu/ops/spatial_hash.py).

build: hash each point's integer cell into a power-of-two table, sort point
ids by hash (stable), bucket ranges from a histogram + cumsum.
query: up to `cap` candidates from each of the 27 neighbouring cells, hash
collisions rejected by comparing packed cell coords, exact top-k. On the
card kernel K (csrc/knn.cu) answers it with only the [Q, k] outputs in
memory; elsewhere the plain eager chain (knn_hash_plain) does, which lays
out every query's 27 cap candidates.

The reference hashes in int32 with wrap-around products; here the
products are int64 and the hash keeps the low bits (& table_size-1), which
are the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import spans
from . import _cuda

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


# the most neighbours kernel K keeps a query (one warp's lanes)
KNN_KMAX = 32


def knn_hash(grid: HashGrid, queries, k: int, cap: int = 24):
    """K nearest hashed points of queries [Q, 3]: (sq_dists [Q, k],
    indices [Q, k] into the original point array), ascending. Missing
    neighbours have sq_dist = +inf (their rows are arbitrary). Kernel K on
    CUDA tensors, else the plain chain; counted by path in the tracer's
    `iso.knn.kernel` / `iso.knn.eager`."""
    with spans.fine("iso.knn"):
        if queries.is_cuda:
            spans.count("iso.knn.kernel")
            return knn_hash_cuda(grid, queries, k, cap)
        spans.count("iso.knn.eager")
        return knn_hash_plain(grid, queries, k, cap)


def knn_hash_cuda(grid: HashGrid, queries, k: int, cap: int = 24):
    """Kernel K: knn_hash_plain's answer on the card, bit for bit, for k
    <= KNN_KMAX: tied and missing neighbours in the order and with the
    rows that torch.topk gives them there. The queries' cells are
    floor(q / cell_size) with the grid's cell size as a float32 on the
    card, as default_cell_size gives it."""
    if k > KNN_KMAX:
        raise ValueError(f"knn_hash on the card keeps at most {KNN_KMAX} "
                         f"neighbours a query (k={k}); use "
                         f'knn_method="exact" for more')
    if k < 1 or cap < 1:
        raise ValueError(f"knn_hash needs k >= 1 and cap >= 1 (k={k}, "
                         f"cap={cap})")
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    dev = queries.device
    Q = queries.shape[0]
    q = queries.contiguous()
    cell = torch.as_tensor(grid.cell_size, dtype=torch.float32,
                           device=dev).reshape(())
    pts = grid.points.contiguous()
    order, cell_of = grid.order.contiguous(), grid.cell_of.contiguous()
    starts, ends = grid.starts.contiguous(), grid.ends.contiguous()
    if not all(t.dtype == torch.int64 for t in (order, cell_of, starts,
                                                ends)):
        raise TypeError("the grid's order, cell_of, starts and ends must "
                        "be int64")
    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int64, device=dev)
    err = _cuda.library("knn").knn_hash(
        _cuda.ptr(q), Q, _cuda.ptr(pts), _cuda.ptr(order), order.shape[0],
        _cuda.ptr(cell_of), _cuda.ptr(starts), _cuda.ptr(ends),
        _cuda.ptr(cell), grid.table_size, cap, k, _cuda.ptr(d2),
        _cuda.ptr(idx), _cuda.stream_ptr())
    _cuda.check(err, "knn_hash")
    _cuda.count_launch("knn_hash")
    return d2, idx


def knn_hash_plain(grid: HashGrid, queries, k: int, cap: int = 24):
    """knn_hash as an eager chain over [Q, 27 cap] candidate tensors (the
    counterpart of the reference's query, op for op)."""
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
