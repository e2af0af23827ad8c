"""IsoGS regularizers: flatness loss and the sampled iso-surface density
loss (counterpart of isogs_slam_tpu/ops/iso_loss.py).

iso loss: query points are Gaussian centres, either drawn from a per-phase
pool whose K nearest neighbours were found once, or drawn afresh with a
KNN per call (iso_pool_size = 0); the KNN is the spatial hash ("hash") or
the exact streaming top-k over capacity blocks ("exact", knn_blocked). The
density D(p) = sum_j alpha_j exp(-0.5 d^T Sigma_j^-1 d) is evaluated at the
current parameters and the loss is mean((D - target)^2). Gradients flow
into both queries and neighbours.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.transforms import normalize


def flat_loss(log_scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean over alive Gaussians of min(exp(log_scales)), clamped at 1e-5.
    At a tie (an isotropic Gaussian's three equal scales) the gradient is
    split evenly among the tied axes, as jnp.min's is (torch.amin; the
    indices of torch.min would give it all to one axis)."""
    scales = torch.clamp(torch.exp(log_scales), min=1e-5)
    mins = torch.amin(scales, dim=1)
    n = torch.clamp(torch.sum(alive.to(mins.dtype)), min=1.0)
    return torch.sum(torch.where(alive, mins, torch.zeros_like(mins))) / n


def knn_blocked(queries: torch.Tensor, points: torch.Tensor,
                valid: torch.Tensor, k: int, block: int = 8192):
    """K nearest neighbours of `queries` [Q, 3] among the `valid` rows of
    `points` [C, 3]: (sq_dists [Q, k] clamped at 0, indices [Q, k] int64).
    A streaming top-k merge over blocks of `block` points keeps the peak at
    [Q, block]. The distances are q^2 + p^2 - 2 q.p as the reference forms
    them, with the cross term summed from three f32 products (no matmul, so
    no TF32 on the card: a rounded product would reorder neighbours)."""
    Q, C = queries.shape[0], points.shape[0]
    dev = queries.device
    block = min(block, C)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)      # [Q, 1]
    best_d = torch.full((Q, k), float("inf"), dtype=queries.dtype,
                        device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    for base in range(0, C, block):
        p = points[base:base + block]
        cross = (queries[:, 0:1] * p[None, :, 0]
                 + queries[:, 1:2] * p[None, :, 1]
                 + queries[:, 2:3] * p[None, :, 2])                # [Q, B]
        d2 = q_sq + torch.sum(p * p, dim=-1)[None, :] - 2.0 * cross
        d2 = torch.where(valid[base:base + block][None, :], d2,
                         torch.full_like(d2, float("inf")))
        idx = torch.arange(base, base + p.shape[0], device=dev)
        cand_d = torch.cat([best_d, d2], dim=1)
        cand_i = torch.cat([best_i, idx[None, :].expand(Q, -1)], dim=1)
        best_d, arg = torch.topk(cand_d, k, dim=1, largest=False)
        best_i = torch.gather(cand_i, 1, arg)
    return torch.clamp(best_d, min=0.0), best_i


def _knn(means_sg, queries_sg, log_scales, alive, k: int, knn_method: str,
         hash_cap: int, hash_table_size: int, knn_block: int, grid):
    """(sq_dists, indices) of the queries' k nearest alive Gaussians by the
    spatial hash (the grid built here unless given) or exactly."""
    if knn_method == "hash":
        from .spatial_hash import build_hash_grid, default_cell_size, knn_hash
        if grid is None:
            cell = default_cell_size(log_scales.detach(), alive)
            grid = build_hash_grid(means_sg, alive, cell, hash_table_size)
        return knn_hash(grid, queries_sg, k, hash_cap)
    if knn_method == "exact":
        return knn_blocked(queries_sg, means_sg, alive, k, knn_block)
    raise ValueError(f"knn_method={knn_method!r}: 'hash' or 'exact'")


class IsoKnnPool(NamedTuple):
    q_idx: torch.Tensor    # [P] int64 pooled query ids (Gaussian rows)
    nbr: torch.Tensor      # [P, k] int64 neighbour ids
    nbr_ok: torch.Tensor   # [P, k] bool neighbour exists


def sample_pool_queries(alive: torch.Tensor, pool_size: int,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """`pool_size` distinct random rows, alive ones first (uniform scores
    plus 2 for dead rows, smallest first)."""
    C = alive.shape[0]
    scores = torch.rand(C, generator=generator, device=alive.device)
    scores = scores + torch.where(alive, 0.0, 2.0)
    return torch.topk(-scores, min(pool_size, C)).indices


def build_iso_knn_pool(means, log_scales, alive, pool_size: int, k: int,
                       hash_cap: int = 24, hash_table_size: int = 0,
                       grid=None, q_idx=None,
                       generator: torch.Generator | None = None,
                       knn_method: str = "hash", knn_block: int = 8192
                       ) -> IsoKnnPool:
    """One batched KNN (knn_method "hash" or "exact") for the pool's
    queries. q_idx: precomputed query rows (else drawn with
    `generator`)."""
    means_sg = means.detach()
    if q_idx is None:
        q_idx = sample_pool_queries(alive, pool_size, generator)
    d2, nbr = _knn(means_sg, means_sg[q_idx], log_scales, alive, k,
                   knn_method, hash_cap, hash_table_size, knn_block, grid)
    return IsoKnnPool(q_idx=q_idx, nbr=nbr, nbr_ok=torch.isfinite(d2))


def iso_surface_loss(means, unnorm_rotations, log_scales, logit_opacities,
                     alive, pool: IsoKnnPool | None, sample_size: int = 8192,
                     target_saturation: float = 1.0, sel=None,
                     generator: torch.Generator | None = None, k: int = 16,
                     knn_method: str = "hash", hash_cap: int = 24,
                     hash_table_size: int = 0, knn_block: int = 8192,
                     grid=None):
    """Sampled iso-surface density loss. Returns (loss, mean_density).

    With a pool: `sample_size` pool rows, drawn with replacement (`sel`
    precomputed or drawn with `generator`). Without (pool=None): a fresh
    set of min(sample_size, C) distinct rows, alive ones first (`sel`
    precomputed or drawn with `generator`), and their k nearest alive
    Gaussians by knn_method ("hash" on `grid`, built here unless given, or
    "exact")."""
    if pool is not None:
        P = pool.q_idx.shape[0]
        if sel is None:
            sel = torch.randint(0, P, (min(sample_size, P),),
                                generator=generator, device=means.device)
        q_idx = pool.q_idx[sel]
        nbr = pool.nbr[sel]
        nbr_ok = pool.nbr_ok[sel]
    else:
        q_idx = (sel if sel is not None
                 else sample_pool_queries(alive, sample_size, generator))
        means_sg = means.detach()
        d2, nbr = _knn(means_sg, means_sg[q_idx], log_scales, alive, k,
                       knn_method, hash_cap, hash_table_size, knn_block,
                       grid)
        nbr_ok = torch.isfinite(d2)
    q_valid = alive[q_idx]
    queries = means[q_idx]

    tbl = torch.cat([means, unnorm_rotations, log_scales, logit_opacities,
                     alive.detach()[:, None].to(means.dtype)], dim=1)
    rec = tbl[nbr]                                            # [Q, K, 12]
    n_means = rec[..., 0:3]
    n_quats = normalize(rec[..., 3:7])
    n_scales = torch.clamp(torch.exp(rec[..., 7:10]), min=1e-5)
    n_op = torch.sigmoid(rec[..., 10])
    n_valid = (rec[..., 11] > 0.5) & nbr_ok

    s_inv_sq = 1.0 / (n_scales ** 2 + 1e-8)
    delta = queries[:, None, :] - n_means
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    r, x, y, z = (n_quats[..., 0], n_quats[..., 1], n_quats[..., 2],
                  n_quats[..., 3])
    c0 = ((1 - 2 * (y * y + z * z)) * dx + 2 * (x * y + r * z) * dy
          + 2 * (x * z - r * y) * dz)
    c1 = (2 * (x * y - r * z) * dx + (1 - 2 * (x * x + z * z)) * dy
          + 2 * (y * z + r * x) * dz)
    c2 = (2 * (x * z + r * y) * dx + 2 * (y * z - r * x) * dy
          + (1 - 2 * (x * x + y * y)) * dz)
    quad = (s_inv_sq[..., 0] * c0 * c0 + s_inv_sq[..., 1] * c1 * c1
            + s_inv_sq[..., 2] * c2 * c2)
    dens = torch.where(n_valid, n_op * torch.exp(-0.5 * quad),
                       torch.zeros_like(quad))
    density = torch.sum(dens, dim=-1)
    err = (density - target_saturation) ** 2
    nq = torch.clamp(torch.sum(q_valid.to(err.dtype)), min=1.0)
    zero = torch.zeros_like(err)
    loss = torch.sum(torch.where(q_valid, err, zero)) / nq
    mean_density = torch.sum(torch.where(q_valid, density, zero)) / nq
    return loss, mean_density
