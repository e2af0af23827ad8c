"""IsoGS regularizers: flatness loss and the sampled iso-surface density
loss (counterpart of isogs_slam_tpu/ops/iso_loss.py, pooled-KNN path).

iso loss: query points are Gaussian centres drawn from a per-phase pool
whose K nearest neighbours were found once (hash KNN); the density
D(p) = sum_j alpha_j exp(-0.5 d^T Sigma_j^-1 d) is evaluated at the current
parameters and the loss is mean((D - target)^2). Gradients flow into both
queries and neighbours.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.transforms import normalize


def flat_loss(log_scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean over alive Gaussians of min(exp(log_scales)), clamped at 1e-5."""
    scales = torch.clamp(torch.exp(log_scales), min=1e-5)
    mins = torch.min(scales, dim=1).values
    n = torch.clamp(torch.sum(alive.to(mins.dtype)), min=1.0)
    return torch.sum(torch.where(alive, mins, torch.zeros_like(mins))) / n


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
                       generator: torch.Generator | None = None
                       ) -> IsoKnnPool:
    """One batched hash KNN for the pool's queries. q_idx: precomputed
    query rows (else drawn with `generator`)."""
    from .spatial_hash import build_hash_grid, default_cell_size, knn_hash
    means_sg = means.detach()
    if q_idx is None:
        q_idx = sample_pool_queries(alive, pool_size, generator)
    if grid is None:
        cell = default_cell_size(log_scales.detach(), alive)
        grid = build_hash_grid(means_sg, alive, cell, hash_table_size)
    d2, nbr = knn_hash(grid, means_sg[q_idx], k, hash_cap)
    return IsoKnnPool(q_idx=q_idx, nbr=nbr, nbr_ok=torch.isfinite(d2))


def iso_surface_loss(means, unnorm_rotations, log_scales, logit_opacities,
                     alive, pool: IsoKnnPool, sample_size: int = 8192,
                     target_saturation: float = 1.0, sel=None,
                     generator: torch.Generator | None = None):
    """Sampled iso-surface density loss over `sample_size` pool rows
    (drawn with replacement; `sel` precomputed or drawn with `generator`).
    Returns (loss, mean_density)."""
    P = pool.q_idx.shape[0]
    if sel is None:
        sel = torch.randint(0, P, (min(sample_size, P),),
                            generator=generator, device=means.device)
    q_idx = pool.q_idx[sel]
    nbr = pool.nbr[sel]
    q_valid = alive[q_idx]
    queries = means[q_idx]

    tbl = torch.cat([means, unnorm_rotations, log_scales, logit_opacities,
                     alive.detach()[:, None].to(means.dtype)], dim=1)
    rec = tbl[nbr]                                            # [Q, K, 12]
    n_means = rec[..., 0:3]
    n_quats = normalize(rec[..., 3:7])
    n_scales = torch.clamp(torch.exp(rec[..., 7:10]), min=1e-5)
    n_op = torch.sigmoid(rec[..., 10])
    n_valid = (rec[..., 11] > 0.5) & pool.nbr_ok[sel]

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
