"""Block-tiled Gaussian density grid (counterpart of
isogs_slam_tpu/mesh/density.py), in PyTorch on an explicit device.

  * Sigma^{-1} = R S^{-2} R^T with scales clamped to >= 1e-5 and optionally
    >= voxel/2 (anti-pancaking)
  * density(p) = sum_g sigmoid(op_g) * exp(-0.5 (p-mu)^T Sigma^{-1} (p-mu))
    truncated to ||p-mu|| < truncate_sigma * max_scale_g
  * voxel grid: linspace over the padded bbox, C-order (x, y, z), z fastest

Per-Gaussian 3D boxes are expanded into fixed-capacity per-block candidate
lists (a stable sort by block id, as the rasterizer bins tiles), and the
quadratic form of a block of 16^3 voxels against its K candidates is one
[4096, 10] @ [10, K] product through the lift
phi(p) = [x^2 y^2 z^2 xy xz yz x y z 1]: (p-mu)^T A (p-mu) = phi(p).coeff.
The Euclidean truncation ball is a second coefficient vector of the same
lift. Blocks are evaluated `block_chunk` at a time as one batched matmul.

The lift is in absolute coordinates, as in the reference: products reach
|A| |p|^2 ~ 1e6-1e7 while the result is O(1), so the products must be true
f32 (the package keeps TF32 off; nothing here turns it on) and the residual
cancellation noise is clamped (quad >= 0). The f32 rounding of the table
that remains is a known defect of the reference, reproduced here.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.transforms import normalize, quat_to_rotmat


# Max error of a density grid against density_reference, relative to the
# grid's max, at the synthetic room's coordinates (|p| up to ~4.5 m) and
# the mesh path's 2 cm voxel: the reference's own grid meets it on the
# CPU (4.8e-3; tests/test_torch_mesh.py), and chip_smoke.py holds the
# card's grid to it. Nearer the origin the lift's cancellation is smaller.
DENSITY_F64_RTOL = 1e-2


class GridSpec(NamedTuple):
    """Voxel-grid geometry (host-computed)."""

    origin: tuple          # (3,) world position of voxel (0,0,0)
    spacing: tuple         # (3,) voxel edge lengths
    dims: tuple            # (3,) voxel counts
    block: int = 16        # voxels per block edge

    @property
    def block_dims(self):
        return tuple(-(-d // self.block) for d in self.dims)

    @property
    def num_blocks(self):
        bd = self.block_dims
        return bd[0] * bd[1] * bd[2]


def make_grid(means: np.ndarray, voxel_size: float, padding: float = 0.5,
              block: int = 16) -> GridSpec:
    """Padded bbox -> linspace grid (create_voxel_grid semantics: linspace
    endpoints inclusive, so actual spacing = size/(dims-1))."""
    finite = np.isfinite(means).all(axis=1)
    if not finite.all():
        print(f"[mesh] dropping {int((~finite).sum())} non-finite Gaussians"
              " from the bounding box")
    means = means[finite]
    if means.shape[0] == 0:
        raise ValueError("no finite Gaussian centers; cannot build a grid")
    mn = means.min(axis=0) - padding
    mx = means.max(axis=0) + padding
    size = mx - mn
    dims = np.maximum(np.ceil(size / voxel_size).astype(int), 2)
    spacing = size / (dims - 1)
    return GridSpec(origin=tuple(float(v) for v in mn),
                    spacing=tuple(float(v) for v in spacing),
                    dims=tuple(int(v) for v in dims), block=block)


def density_coefficients(means, log_scales, unnorm_rotations,
                         logit_opacities, min_scale: float = 1e-5):
    """Per-Gaussian data for the quadratic-form matmul.

    Returns (coeff [N,10], op [N], max_scale [N]) where
    phi(p) . coeff = (p-mu)^T Sigma^{-1} (p-mu) for
    phi(p) = [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1].
    """
    if log_scales.shape[1] == 1:
        log_scales = log_scales.expand(-1, 3)
    scales = torch.clamp(torch.exp(log_scales), min=min_scale)
    R = quat_to_rotmat(normalize(unnorm_rotations))
    s_inv_sq = 1.0 / (scales ** 2 + 1e-8)
    A = (R * s_inv_sq[:, None, :]) @ R.transpose(1, 2)       # [N,3,3]
    mu = means
    Amu = (A @ mu[:, :, None])[:, :, 0]                      # [N,3]
    coeff = torch.stack([
        A[:, 0, 0], A[:, 1, 1], A[:, 2, 2],
        2.0 * A[:, 0, 1], 2.0 * A[:, 0, 2], 2.0 * A[:, 1, 2],
        -2.0 * Amu[:, 0], -2.0 * Amu[:, 1], -2.0 * Amu[:, 2],
        torch.sum(mu * Amu, dim=1)], dim=-1)                 # [N,10]
    op = torch.sigmoid(logit_opacities[:, 0])
    max_scale = torch.max(scales, dim=1).values
    return coeff, op, max_scale


def _bin_to_blocks(means, trunc, spec: GridSpec, max_isect: int,
                   max_per_block: int):
    """Fixed-capacity per-block Gaussian candidate lists (3D analog of
    rasterizer tile binning). Expansion slots 0..max_isect-1 take the
    Gaussians' blocks in Gaussian order; slots past the capacity and
    candidates past max_per_block in a block are dropped and counted in
    `overflow`."""
    dev = means.device
    origin = torch.tensor(spec.origin, dtype=torch.float32, device=dev)
    spacing = torch.tensor(spec.spacing, dtype=torch.float32, device=dev)
    bd = spec.block_dims
    bdt = torch.tensor(bd, dtype=torch.int64, device=dev)
    bsize = spacing * spec.block
    lo = torch.floor((means - trunc[:, None] - origin) / bsize).long()
    hi = torch.floor((means + trunc[:, None] - origin) / bsize).long()
    lo = torch.minimum(torch.clamp(lo, min=0), bdt - 1)
    hi = torch.minimum(torch.clamp(hi + 1, min=1), bdt)
    span = torch.clamp(hi - lo, min=0)                       # [N,3]
    counts = span[:, 0] * span[:, 1] * span[:, 2]
    ends_g = torch.cumsum(counts, 0)
    offs = ends_g - counts
    total = ends_g[-1]

    N = means.shape[0]
    M = max_isect
    pos = torch.arange(M, dtype=torch.int64, device=dev)
    # the Gaussian that owns expansion slot pos (the reference's
    # jnp.repeat(..., total_repeat_length=M)); slots past the total are
    # masked below
    src = torch.clamp(torch.searchsorted(ends_g, pos, right=True),
                      max=N - 1)
    local = pos - offs[src]
    sx = torch.clamp(span[src, 0], min=1)
    sy = torch.clamp(span[src, 1], min=1)
    bx = lo[src, 0] + local % sx
    by = lo[src, 1] + (local // sx) % sy
    bz = lo[src, 2] + local // (sx * sy)
    nb = spec.num_blocks
    block_id = (bx * bd[1] + by) * bd[2] + bz
    in_range = pos < torch.clamp(total, max=M)
    block_id = torch.where(in_range, block_id, torch.full_like(block_id, nb))

    # stable, as jnp.argsort: which candidates survive max_per_block and
    # the order of each voxel's sum depend on it
    sorted_block, order = torch.sort(block_id, stable=True)
    sorted_gauss = src[order]
    bids = torch.arange(nb, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_block, bids, right=False)
    ends = torch.searchsorted(sorted_block, bids, right=True)
    count = torch.clamp(ends - starts, max=max_per_block)
    slots = starts[:, None] + torch.arange(max_per_block, device=dev)
    slots = torch.clamp(slots, 0, M - 1)
    lists = sorted_gauss[slots]                              # [NB, K]
    overflow = (torch.clamp(total - M, min=0)
                + torch.sum((ends - starts) - count))
    return lists, count, overflow


def _prep_density_table(means, log_scales, unnorm_rotations,
                        logit_opacities, alive, spec, max_isect,
                        max_per_block, truncate_sigma, min_scale):
    """Coefficient table [N, 21] (quadratic + Euclid-ball + opacity) and
    the per-block Gaussian lists."""
    coeff, op, max_scale = density_coefficients(
        means, log_scales, unnorm_rotations, logit_opacities, min_scale)
    trunc = truncate_sigma * max_scale
    op = torch.where(alive, op, torch.zeros_like(op))
    trunc = torch.where(alive, trunc, torch.zeros_like(trunc))
    lists, count, overflow = _bin_to_blocks(
        means, trunc, spec, max_isect, max_per_block)
    # Euclid-ball coeffs: phi(p).eucl = ||p - mu||^2 - trunc^2
    one, zero = torch.ones_like(op), torch.zeros_like(op)
    eucl = torch.stack([
        one, one, one, zero, zero, zero,
        -2.0 * means[:, 0], -2.0 * means[:, 1], -2.0 * means[:, 2],
        torch.sum(means * means, dim=1) - trunc * trunc], dim=-1)
    table = torch.cat([coeff, eucl, op[:, None]], dim=-1)
    return table, lists, count, overflow


@torch.no_grad()
def density_grid(means, log_scales, unnorm_rotations, logit_opacities,
                 alive, spec: GridSpec, max_isect: int,
                 max_per_block: int = 256, truncate_sigma: float = 3.0,
                 min_scale: float = 1e-5, block_chunk: int = 32):
    """Returns (density [dims], n_overflow) on the inputs' device."""
    table, lists, count, overflow = _prep_density_table(
        means, log_scales, unnorm_rotations, logit_opacities, alive, spec,
        max_isect, max_per_block, truncate_sigma, min_scale)
    dens = _dens_for_blocks(table, lists, count, spec, block_chunk)
    return _assemble(dens, spec), overflow


# most (voxel, candidate) pairs one chunk evaluates: each [chunk, P, K]
# f32 temporary is then at most 1 GiB, whatever K the growth reached
_PAIR_BUDGET = 1 << 28


def _dens_for_blocks(table, lists, count, spec: GridSpec, block_chunk: int,
                     base_block: int = 0):
    """Density of every block, one [P, 10] @ [10, K] product per block,
    up to `block_chunk` blocks per batched matmul. The reference pads every
    block to the full list length K, empty blocks included; here the blocks
    without candidates are left at 0 and the others go in order of their
    candidate count, each chunk only as wide as its longest list and only
    as many blocks as _PAIR_BUDGET allows at that width: the same terms in
    each voxel's sum, without the padded slots' work. `lists` / `count`
    may be a contiguous range of the blocks that starts at block
    `base_block` (density_grid_sharded)."""
    dev = table.device
    B = spec.block
    P = B * B * B
    bd = spec.block_dims
    # voxel offsets within a block, C-order (x, y, z)
    o = torch.arange(P, dtype=torch.int64, device=dev)
    ox, oy, oz = o // (B * B), (o // B) % B, o % B
    origin = torch.tensor(spec.origin, dtype=torch.float32, device=dev)
    spacing = torch.tensor(spec.spacing, dtype=torch.float32, device=dev)

    dens = torch.zeros((lists.shape[0], P), dtype=torch.float32, device=dev)
    live = torch.nonzero(count > 0)[:, 0]
    by_count = torch.sort(count[live], stable=True)
    live = live[by_count.indices]
    widths = by_count.values.tolist()                     # one host read
    L, c0 = len(widths), 0
    while c0 < L:
        kc = widths[min(c0 + block_chunk, L) - 1]
        c = max(1, min(block_chunk, _PAIR_BUDGET // (P * kc)))
        kc = widths[min(c0 + c, L) - 1]
        bidx = live[c0: c0 + c]
        c0 += c
        gidx = bidx + base_block
        bx = (gidx // (bd[1] * bd[2]))[:, None]
        by = ((gidx // bd[2]) % bd[1])[:, None]
        bz = (gidx % bd[2])[:, None]
        px = origin[0] + (bx * B + ox).float() * spacing[0]    # [c, P]
        py = origin[1] + (by * B + oy).float() * spacing[1]
        pz = origin[2] + (bz * B + oz).float() * spacing[2]
        phi = torch.stack([px * px, py * py, pz * pz, px * py, px * pz,
                           py * pz, px, py, pz, torch.ones_like(px)],
                          dim=-1)                               # [c, P, 10]
        data = table[lists[bidx, :kc]]                          # [c, kc, 21]
        quad = torch.bmm(phi, data[..., 0:10].transpose(1, 2))  # [c, P, kc]
        ball = torch.bmm(phi, data[..., 10:20].transpose(1, 2))
        # the form is PSD: clamp away residual f32 cancellation noise so
        # exp <= 1 always (true density at the center is op * 1)
        quad.clamp_(min=0.0).mul_(-0.5).exp_().mul_(data[:, None, :, 20])
        valid = ((torch.arange(kc, device=dev)[None, None, :]
                  < count[bidx][:, None, None]) & (ball < 0.0))
        del ball
        dens[bidx] = quad.masked_fill_(valid.logical_not_(), 0.0).sum(dim=-1)
    return dens


@torch.no_grad()
def density_grid_sharded(means, log_scales, unnorm_rotations,
                         logit_opacities, alive, spec: GridSpec,
                         max_isect: int, mesh, max_per_block: int = 256,
                         truncate_sigma: float = 3.0,
                         min_scale: float = 1e-5, block_chunk: int = 32):
    """density_grid with the block axis sharded over the ranks of `mesh`
    (parallel/dist.py): blocks are independent (the reference's per-block
    host loop, extract_mesh_fast.py:191-386), so each rank evaluates a
    contiguous block range against the replicated coefficient table and
    the grid is reassembled from the all-gathered shards. Binning runs
    replicated (one sort; a small fraction of the density pass)."""
    from ..parallel.dist import all_gather_shards, shard_range
    table, lists, count, overflow = _prep_density_table(
        means, log_scales, unnorm_rotations, logit_opacities, alive, spec,
        max_isect, max_per_block, truncate_sigma, min_scale)
    nb = spec.num_blocks
    lo, hi, per = shard_range(nb, mesh)
    hi_r = min(hi, nb)
    P = spec.block ** 3
    local = torch.zeros((per, P), dtype=torch.float32, device=table.device)
    if hi_r > lo:
        local[: hi_r - lo] = _dens_for_blocks(
            table, lists[lo:hi_r], count[lo:hi_r], spec, block_chunk,
            base_block=lo)
    dens = all_gather_shards(local, mesh)[:nb]
    return _assemble(dens, spec), overflow


def _assemble(dens, spec: GridSpec):
    """[num_blocks, P] block densities -> [dims] grid (pad-cropped)."""
    B = spec.block
    bd = spec.block_dims
    full = dens.reshape(bd[0], bd[1], bd[2], B, B, B)
    full = full.permute(0, 3, 1, 4, 2, 5).reshape(
        bd[0] * B, bd[1] * B, bd[2] * B)
    return full[: spec.dims[0], : spec.dims[1], : spec.dims[2]]


def compute_density(params_np: dict, voxel_size: float = 0.02,
                    padding: float = 0.5, block_size: int = 16,
                    truncate_sigma: float = 3.0,
                    min_scale_limit: float = 0.0,
                    max_per_block: int = 256,
                    isect_per_gaussian: float = 16.0,
                    shard_devices: int = 0, device="cuda",
                    info: dict | None = None):
    """Host-facing wrapper: checkpoint params dict -> (density np [dims],
    GridSpec), computed on `device` ("cuda" unless the caller asks for
    "cpu"). Grows max_isect and max_per_block until nothing overflows (at
    most 6 rounds). shard_devices > 1 shards the block axis over that many
    ranks of the process group (density_grid_sharded), clamped to the
    world size as the reference clamps to its devices; at 1 the serial
    pass runs. `info`, when given, receives the capacities the pass ended
    at (max_isect, max_per_block), its growth rounds, the overflow left
    and the ranks it ran on."""
    from ..parallel.dist import make_mesh, rank_device, world_size
    dev = resolve_device(device)
    nd = min(int(shard_devices), world_size())
    if nd > 1:
        dev = rank_device(dev)
        grid_fn = functools.partial(density_grid_sharded,
                                    mesh=make_mesh(nd, dev))
    else:
        grid_fn = density_grid
    means = np.asarray(params_np["means3D"], np.float32)
    spec = make_grid(means, voxel_size, padding, block_size)
    n = means.shape[0]
    max_isect = int(max(4096, (n * isect_per_gaussian + 1023) // 1024 * 1024))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    args = (f32(means), f32(params_np["log_scales"]),
            f32(params_np["unnorm_rotations"]),
            f32(params_np["logit_opacities"]),
            torch.ones((n,), dtype=torch.bool, device=dev))
    min_scale = max(1e-5, min_scale_limit)
    dens, overflow = grid_fn(*args, spec, max_isect,
                             max_per_block=max_per_block,
                             truncate_sigma=truncate_sigma,
                             min_scale=min_scale)
    # demand-driven capacity: truncated block lists under-report density
    # near block borders and the marching pass then opens seams there. The
    # scalar overflow conflates expansion-slot (max_isect) and per-block
    # (max_per_block) truncation, so grow both geometrically; bounded in
    # case the scene genuinely cannot fit.
    rounds = 0
    for _ in range(6):
        if int(overflow) <= 0:
            break
        rounds += 1
        max_isect = (int((max_isect + int(overflow)) * 1.25) + 1023) \
            // 1024 * 1024
        max_per_block = max_per_block * 2
        print(f"[mesh] {int(overflow)} block-candidate slots overflowed; "
              f"growing max_isect -> {max_isect}, max_per_block -> "
              f"{max_per_block} (recompiling)")
        dens, overflow = grid_fn(*args, spec, max_isect,
                                 max_per_block=max_per_block,
                                 truncate_sigma=truncate_sigma,
                                 min_scale=min_scale)
    if info is not None:
        info.update(max_isect=max_isect, max_per_block=max_per_block,
                    rounds=rounds, overflow=int(overflow),
                    shard_devices=max(nd, 1))
    if int(overflow) > 0:
        print(f"[mesh] WARNING: {int(overflow)} slots still overflow "
              f"after growth; density is truncated near block borders")
    return dens.cpu().numpy(), spec


def density_reference(points, means, log_scales, unnorm_rotations,
                      logit_opacities, min_scale: float = 1e-5,
                      truncate_sigma: float = 3.0,
                      chunk: int = 512) -> np.ndarray:
    """The same truncated sum of Gaussians at `points` [P, 3] in float64
    numpy, centred (p - mu): the f64 yardstick the tests and the card's
    smoke run hold density_grid to. Only the Gaussians whose truncation
    ball reaches the points' bounding box are evaluated, `chunk` points at
    a time."""
    p = np.asarray(points, np.float64)
    mu = np.asarray(means, np.float64)
    ls = np.asarray(log_scales, np.float64)
    if ls.shape[1] == 1:
        ls = np.repeat(ls, 3, axis=1)
    s = np.maximum(np.exp(ls), min_scale)
    trunc = truncate_sigma * s.max(axis=1)
    gap = mu - np.clip(mu, p.min(axis=0), p.max(axis=0))
    near = np.sum(gap * gap, axis=1) < trunc ** 2
    mu, s, trunc = mu[near], s[near], trunc[near]
    q = np.asarray(unnorm_rotations, np.float64)[near]
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    r, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                  2 * (x * z + r * y)], -1),
        np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - r * x)], -1),
        np.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)      # [N, 3, 3]
    A = np.einsum("nij,nj,nkj->nik", R, 1.0 / (s ** 2 + 1e-8), R)
    op = 1.0 / (1.0 + np.exp(-np.asarray(logit_opacities,
                                          np.float64)[near, 0]))
    out = []
    for c in range(0, p.shape[0], chunk):
        d = p[c: c + chunk, None, :] - mu[None, :, :]        # [c, N, 3]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        quad = (A[:, 0, 0] * dx * dx + A[:, 1, 1] * dy * dy
                + A[:, 2, 2] * dz * dz + 2.0 * (A[:, 0, 1] * dx * dy
                                                + A[:, 0, 2] * dx * dz
                                                + A[:, 1, 2] * dy * dz))
        inside = dx * dx + dy * dy + dz * dz < trunc ** 2
        out.append(np.sum(np.where(inside, op * np.exp(-0.5 * quad), 0.0),
                          axis=1))
    return np.concatenate(out) if out else np.zeros(0)
