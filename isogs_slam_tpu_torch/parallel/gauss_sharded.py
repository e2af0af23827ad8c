"""Gaussian-axis sharding of the iso-surface density (counterpart of
isogs_slam_tpu/parallel/gauss_sharded.py).

The iso-loss KNN and density are parallel over the Gaussian count N. Each
rank holds a contiguous shard of the Gaussian arrays (padded to a multiple
of the mesh size with dead rows), finds the per-shard k nearest neighbours
of the (replicated) query set and computes their density contributions
locally; an all-gather of the [Q, k] candidate distances (no gradient)
picks the global k nearest, each rank sums the selected contributions it
owns, and an all_reduce of the [Q] partials gives the serial K-nearest
density on every rank. Gradients flow into each shard from its own
contributions only (selection is an order statistic, taken without
gradient).
"""
from __future__ import annotations

import torch

from ..utils.transforms import normalize, quat_to_rotmat
from .dist import (Mesh, all_gather_shards, all_reduce_, make_mesh,
                   replicated_inputs, shard_range)

GAUSS_AXIS = "gauss"


def make_gauss_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    return make_mesh(n_devices, device)


def _local_knn_contrib(queries, means, quats, log_scales, logit_ops, alive,
                       k: int):
    """Per shard: for each query, the k nearest local Gaussians' squared
    distances and density contributions alpha * exp(-0.5 d^T Sigma^-1 d).
    The cross term is summed from three f32 products (no matmul, so no
    TF32 on the card: a rounded product would reorder neighbours)."""
    ms = means.detach()
    cross = (queries[:, 0:1] * ms[None, :, 0] + queries[:, 1:2]
             * ms[None, :, 1] + queries[:, 2:3] * ms[None, :, 2])
    d2_full = (torch.sum(queries * queries, -1, keepdim=True)
               + torch.sum(ms * ms, -1)[None, :] - 2.0 * cross)   # [Q, Ns]
    d2_full = torch.where(alive[None, :], d2_full,
                          torch.full_like(d2_full, float("inf")))
    kk = min(k, means.shape[0])
    d2, idx = torch.topk(d2_full, kk, dim=1, largest=False)     # [Q, kk]
    if kk < k:
        pad = k - kk
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], pad), float("inf"))],
                       1)
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], pad))], 1)

    n_means = means[idx]                                         # [Q,k,3]
    n_quats = normalize(quats[idx])
    n_scales = torch.clamp(torch.exp(log_scales[idx]), min=1e-5)
    n_op = torch.sigmoid(logit_ops[idx][..., 0])
    valid = alive[idx] & torch.isfinite(d2)
    R = quat_to_rotmat(n_quats)
    s_inv_sq = 1.0 / (n_scales ** 2 + 1e-8)
    delta = queries[:, None, :] - n_means
    rtd = torch.einsum("qkji,qkj->qki", R, delta)     # R^T delta
    quad = torch.sum(s_inv_sq * rtd * rtd, dim=-1)
    contrib = torch.where(valid, n_op * torch.exp(-0.5 * quad),
                          torch.zeros_like(quad))
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    return d2, contrib


def iso_density_gauss_sharded(mesh: Mesh, queries, means, quats,
                              log_scales, logit_opacities, alive,
                              k: int = 16):
    """Density at `queries` [Q, 3] from the k globally-nearest Gaussians,
    the Gaussian arrays sharded over the mesh's ranks (every rank passes
    the whole replicated arrays and keeps its own rows). Exact (the serial
    K-NN density); differentiable: every rank ends with the whole
    gradient of each input (the per-rank gradients, each from the rank's
    own contributions, are summed in the backward)."""
    N = means.shape[0]
    lo, hi, per = shard_range(N, mesh)
    queries, means, quats, log_scales, logit_opacities = replicated_inputs(
        [queries, means, quats, log_scales, logit_opacities], mesh)
    hi_r = min(hi, N)

    def shard(a, fill=0.0):
        s = a[lo:hi_r]
        if hi - hi_r > 0:
            s = torch.cat([s, s.new_full((hi - hi_r,) + a.shape[1:], fill)])
        return s

    Q = queries.shape[0]
    if hi > lo:
        d2, contrib = _local_knn_contrib(
            queries, shard(means), shard(quats), shard(log_scales),
            shard(logit_opacities), shard(alive, False), k)
    else:
        d2 = queries.new_full((Q, k), float("inf"))
        # a rank outside the mesh: no rows; zeros keep the graph (its
        # replicated inputs' all_reduce must run on every rank)
        contrib = queries.new_zeros((Q, k)) + 0.0 * sum(
            a.sum() for a in (queries, means, quats, log_scales,
                              logit_opacities))
    # the ranking is global: every shard's candidate distances (order
    # statistics only, no gradient) -> the global top k, then each rank
    # sums the selected contributions it owns
    d2_all = all_gather_shards(d2.detach().T.contiguous(), mesh)  # [D*k, Q]
    _, arg = torch.topk(d2_all.T, k, dim=1, largest=False)        # [Q, k]
    owner = arg // k
    local_slot = arg % k
    mine = owner == mesh.rank
    sel = torch.gather(contrib, 1, local_slot)
    partial = torch.sum(torch.where(mine, sel, torch.zeros_like(sel)), -1)
    return _SumOverRanks.apply(partial, mesh)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) of per-rank partials whose result every rank then
    uses identically: the cotangent of each partial is the result's
    cotangent, unchanged (a psum's transpose under a replicated loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None
