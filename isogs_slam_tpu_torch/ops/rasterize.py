"""Differentiable 3D Gaussian rasterizer (counterpart of
isogs_slam_tpu/ops/rasterize.py, main path).

Projection and binning are plain PyTorch; compositing runs through the
CUDA kernels of ops/composite.py and, in the mapping backward, the segment
reduce of ops/segreduce.py:

  * EWA projection with the 1.3*tanfov frustum clamp, low-pass 0.3,
    near-plane cull at z <= 0.2, OpenCV pixel convention u = fx*x/z + cx;
  * binning sorts one key per (gaussian, tile) pair,
    tile << db | margin bit | quantized log depth, and keeps the K front-most
    slots per tile; the expansion is gaussian-major, so the expansion
    position of each slot lets the backward write per-slot gradients back
    into contiguous per-Gaussian segments (no atomics, no dedup sort);
  * mapping renders through one autograd Function spanning gather ->
    kernel A, with backward kernel B -> duplicate-free scatter into
    expansion order -> kernel C -> d_table;
  * tracking gathers a frozen per-slot raw table once per frame and
    re-projects it per slot each iteration (pose is the only leaf);
  * opt-in, output-preserving: `tile_cull` drops the slots of a binning
    that reach alpha >= 1/255 in no pixel of their tile, `tight_rect` bins
    by the contribution ellipse's own extents instead of the 3-sigma square;
  * opt-in, fast modes: a subset of tiles is composited on a virtual
    single-row grid (tiles_x = T_sub) by the same kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import TILE, Camera
from ..utils.transforms import normalize, quat_mult
from .composite import (ALPHA_MIN, composite_backward, composite_forward,
                        composite_tiles)
from .segreduce import segment_reduce_rows

NEAR_CULL_Z = 0.2
LOW_PASS = 0.3
CHUNK = 128   # gdata K is padded to a multiple of this (reference layout)


class RasterConfig(NamedTuple):
    max_per_tile: int = 512   # front-most Gaussians composited per tile
    isect_per_gaussian: float = 2.5  # max_isect = N * this
    tile_chunk: int = 256     # tiles per chunk of the plain compositing
    # the mapping backward's per-slot gradients are emitted by kernel B and
    # scattered in bfloat16 (kernel C accumulates in f32)
    grad_scatter_bf16: bool = True
    # backward aggregation of the mapping render's per-slot gradients:
    # "segreduce" = duplicate-free scatter into expansion order + kernel C
    # (needs a binning made with emit_exp), "scatter" = index_add_ of the
    # live columns; "auto" = segreduce, and for a tile subset whichever
    # subset_uses_segreduce picks
    bwd_mode: str = "auto"
    # drop tile slots whose exact minimum of the conic form over the tile
    # box proves alpha < 1/255 at every pixel (cull_tile_slots); output-
    # preserving, needs the opacities and drift budgets at bin_gaussians
    tile_cull: bool = False
    # the bin-time minimum is divided by this before the cut: budget for
    # conic drift while a frozen binning is reused
    cull_q_slack: float = 1.5
    # bin by the per-axis extents of the contribution ellipse q <= qmax,
    # qmax = 2 ln(op_bound * 255), intersected with the 3-sigma radius rect
    tight_rect: bool = False
    max_isect_cap: int = 0    # static intersection capacity override

    def max_isect(self, num_gaussians: int) -> int:
        m = (self.max_isect_cap if self.max_isect_cap > 0
             else int(num_gaussians * self.isect_per_gaussian))
        return max(1024, (m + 1023) // 1024 * 1024)

    def resolve_bwd_mode(self) -> str:
        if self.bwd_mode not in ("auto", "segreduce", "scatter"):
            raise ValueError(f"RasterConfig.bwd_mode={self.bwd_mode!r}")
        return "segreduce" if self.bwd_mode == "auto" else self.bwd_mode


class Projected(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor       # [N, 3] (A, B, C)
    radius: torch.Tensor      # [N] int32 3-sigma pixel radius (0 = culled)
    valid: torch.Tensor       # [N] bool
    rect_min: torch.Tensor    # [N, 2] int64 tile rect (x, y) inclusive
    rect_max: torch.Tensor    # [N, 2] int64 exclusive
    rect_min_true: torch.Tensor  # margin-free rect
    rect_max_true: torch.Tensor


def _ewa_core(means_cam, quats, log_scales, cam: Camera):
    """EWA projection on flat [R] component vectors. Returns
    (u, v, cA, cB, cC, det, radius_f)."""
    tx, ty, tz = means_cam[..., 0], means_cam[..., 1], means_cam[..., 2]
    tz_safe = tz + 1e-7
    u = cam.fx * tx / tz_safe + cam.cx
    v = cam.fy * ty / tz_safe + cam.cy

    qn = quats / torch.sqrt(torch.clamp(
        torch.sum(quats * quats, dim=-1, keepdim=True), min=1e-24))
    r, x, y, z = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = torch.exp(log_scales)
    v0, v1, v2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    s00 = r00 * v0 * r00 + r01 * v1 * r01 + r02 * v2 * r02
    s01 = r00 * v0 * r10 + r01 * v1 * r11 + r02 * v2 * r12
    s02 = r00 * v0 * r20 + r01 * v1 * r21 + r02 * v2 * r22
    s11 = r10 * v0 * r10 + r11 * v1 * r11 + r12 * v2 * r12
    s12 = r10 * v0 * r20 + r11 * v1 * r21 + r12 * v2 * r22
    s22 = r20 * v0 * r20 + r21 * v1 * r21 + r22 * v2 * r22

    # frustum-clamped perspective Jacobian (raw t.z, guarded at z = 0)
    tz_nz = torch.where(tz == 0, torch.full_like(tz, 1e-7), tz)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txc = torch.clamp(tx / tz_nz, -limx, limx) * tz
    tyc = torch.clamp(ty / tz_nz, -limy, limy) * tz
    inv_z = 1.0 / tz_nz
    inv_z2 = inv_z * inv_z
    j00 = cam.fx * inv_z
    j02 = -cam.fx * txc * inv_z2
    j11 = cam.fy * inv_z
    j12 = -cam.fy * tyc * inv_z2
    r0x = j00 * s00 + j02 * s02
    r0z = j00 * s02 + j02 * s22
    r1y = j11 * s11 + j12 * s12
    r1z = j11 * s12 + j12 * s22
    c00 = r0x * j00 + r0z * j02 + LOW_PASS
    c01 = (j00 * s01 + j02 * s12) * j11 + r0z * j12
    c11 = r1y * j11 + r1z * j12 + LOW_PASS

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det != 0, det, torch.ones_like(det))
    cA = c11 / det_safe
    cB = -c01 / det_safe
    cC = c00 / det_safe

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    return u, v, cA, cB, cC, det, radius_f


def _tile_rect(u, v, r, cam: Camera):
    """CUDA getRect semantics: (x0, y0, x1, y1) tile rect, inclusive min,
    exclusive max, clipped to the grid."""
    gx, gy = cam.tiles_x, cam.tiles_y

    def cl(x, hi):
        return torch.clamp(torch.floor(x), 0, hi).to(torch.int64)

    return (cl((u - r) / TILE, gx), cl((v - r) / TILE, gy),
            cl((u + r + TILE - 1) / TILE, gx),
            cl((v + r + TILE - 1) / TILE, gy))


def project_gaussians(means_cam, quats, log_scales, alive, cam: Camera,
                      margin_px: float = 0.0,
                      means2d_offset=None) -> Projected:
    """Per-Gaussian EWA projection. margin_px widens the binning rect only
    (frozen tile lists reused across pose updates stay supersets).
    means2d_offset: optional [N, 2] zero tensor added to (u, v); its
    gradient is the densification signal d loss / d(u, v)."""
    tz = means_cam[:, 2]
    u, v, cA, cB, cC, det, radius_f = _ewa_core(means_cam, quats,
                                                log_scales, cam)
    if means2d_offset is not None:
        u = u + means2d_offset[:, 0]
        v = v + means2d_offset[:, 1]
    conic = torch.stack([cA, cB, cC], dim=-1)
    valid = alive & (tz > NEAR_CULL_Z) & (det != 0)
    ud, vd, rd = u.detach(), v.detach(), radius_f.detach()
    rx0, ry0, rx1, ry1 = _tile_rect(ud, vd, rd + margin_px, cam)
    tx0, ty0, tx1, ty1 = _tile_rect(ud, vd, rd, cam)
    touched = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = valid & (touched > 0) & (rd > 0)
    radius = torch.where(valid, rd, torch.zeros_like(rd)).to(torch.int32)
    return Projected(u=u, v=v, depth=tz, conic=conic, radius=radius,
                     valid=valid,
                     rect_min=torch.stack([rx0, ry0], dim=-1),
                     rect_max=torch.stack([rx1, ry1], dim=-1),
                     rect_min_true=torch.stack([tx0, ty0], dim=-1),
                     rect_max_true=torch.stack([tx1, ty1], dim=-1))


class Binning(NamedTuple):
    tile_gauss: torch.Tensor    # [T, K] int64 gaussian per slot
    tile_count: torch.Tensor    # [T] int32 valid slots (<= K)
    n_isect: torch.Tensor       # [] int64 intersections generated
    n_overflow: torch.Tensor    # [] int64 dropped (isect capacity or K cap)
    n_true_overflow: torch.Tensor  # [] int64 margin-free ones the K cap drops
    # emit_exp=True: expansion position of each slot (sentinel M for
    # padding slots) and the per-Gaussian segment offsets [N+1] (int32,
    # clamped to M) of the gaussian-major expansion order
    slot_exp_pos: torch.Tensor | None = None
    exp_offsets: torch.Tensor | None = None


def _min_q_box(u, v, A, B, C, x0, x1, y0, y1):
    """Exact minimum of q(dx, dy) = A dx^2 + 2 B dx dy + C dy^2 (power =
    -q/2 in the compositor) over the pixel box [x0, x1] x [y0, y1] around
    the centre (u, v). q is positive definite (the low-pass guarantees
    det > 0): 0 when the centre lies in the box, else attained on an edge,
    where q is a 1-D quadratic minimised in closed form and clamped."""
    lx, hx = x0 - u, x1 - u
    ly, hy = y0 - v, y1 - v
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    As = torch.clamp(A, min=1e-12)
    Cs = torch.clamp(C, min=1e-12)

    def q(dx, dy):
        return A * dx * dx + 2.0 * B * dx * dy + C * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    m = torch.minimum(
        torch.minimum(q(lx, clip(-B * lx / Cs, ly, hy)),
                      q(hx, clip(-B * hx / Cs, ly, hy))),
        torch.minimum(q(clip(-B * ly / As, lx, hx), ly),
                      q(clip(-B * hy / As, lx, hx), hy)))
    return torch.where(inside, torch.zeros_like(m), torch.clamp(m, min=0.0))


def _op_bound(opacity, logit_drift: float):
    """Upper bound of the opacity while a binning is reused: sigmoid(l + d)
    <= sigmoid(l) e^d, capped at 1. The compositor tests contribution on
    the clamped alpha, min(0.99, op e^-q/2) >= 1/255, which is the same as
    the test on the unclamped one, so the bound is not clamped at 0.99."""
    return torch.clamp(opacity * float(np.exp(logit_drift)), max=1.0)


def _q_cut(op_bound):
    """q above which op e^(-q/2) < 1/255."""
    return 2.0 * (torch.log(torch.clamp(op_bound, min=1e-12))
                  - float(np.log(ALPHA_MIN)))


@torch.no_grad()
def cull_tile_slots(binning: Binning, proj: Projected, opacity,
                    cam: Camera, cfg: RasterConfig, m_sentinel: int,
                    slack_px=0.0, logit_drift: float = 0.0) -> Binning:
    """Drop tile slots that provably contribute to no pixel of their tile
    and compact the survivors to the front (depth order kept). A slot
    contributes iff min over the tile box of q <= 2 ln(op * 255).
    Conservative under the rect margins' drift contract: `slack_px`
    inflates the box, `logit_drift` bounds opacity growth, and
    cfg.cull_q_slack divides the minimum for conic drift. K stays; only
    tile_count shrinks, and slot_exp_pos follows the same permutation with
    the slots past the new count sent to the sentinel."""
    T, K = binning.tile_gauss.shape
    dev = proj.u.device
    geom = torch.stack([proj.u, proj.v, proj.conic[:, 0], proj.conic[:, 1],
                        proj.conic[:, 2], opacity], dim=-1).detach()
    g = geom[binning.tile_gauss]                             # [T, K, 6]
    tids = torch.arange(T, device=dev)
    tx0 = ((tids % cam.tiles_x) * TILE).to(torch.float32)[:, None]
    ty0 = ((tids // cam.tiles_x) * TILE).to(torch.float32)[:, None]
    # pixel centres span [tx0, tx0 + TILE - 1]
    minq = _min_q_box(g[..., 0], g[..., 1], g[..., 2], g[..., 3], g[..., 4],
                      tx0 - slack_px, tx0 + (TILE - 1) + slack_px,
                      ty0 - slack_px, ty0 + (TILE - 1) + slack_px)
    q_cut = _q_cut(_op_bound(g[..., 5], logit_drift))
    k_idx = torch.arange(K, device=dev)[None, :]
    keep = ((k_idx < binning.tile_count[:, None])
            & (minq / cfg.cull_q_slack <= q_cut))
    # stable partition: keepers first, in their (depth) order
    perm = torch.sort(torch.where(keep, k_idx, K + k_idx), dim=1,
                      stable=True).indices
    new_count = keep.sum(dim=1).to(torch.int32)
    sep = binning.slot_exp_pos
    if sep is not None:
        sep = torch.gather(sep, 1, perm)
        sep = torch.where(k_idx < new_count[:, None], sep,
                          torch.full_like(sep, m_sentinel))
    return binning._replace(
        tile_gauss=torch.gather(binning.tile_gauss, 1, perm),
        tile_count=new_count, slot_exp_pos=sep)


def _tight_rects(proj: Projected, cam: Camera, cfg: RasterConfig, opacity,
                 cull_slack_px, cull_logit_drift: float):
    """(rect_min, rect_max, rect_min_true, rect_max_true, valid) with the
    radius rects intersected with the tile AABB of the contribution
    ellipse q <= qmax (half-extents sqrt(qmax * cov_xx), cov = conic^-1).
    The exclusive max is floor((u + rx) / TILE) + 1: the last covered
    pixel floor(u + rx) lives in that tile. getRect's
    floor((x + TILE - 1) / TILE) under-counts a tile for fractional
    extents."""
    cA, cB, cC = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    detc = torch.clamp(cA * cC - cB * cB, min=1e-24)
    op_bound = _op_bound(opacity, cull_logit_drift)
    qmax = torch.clamp(_q_cut(op_bound) * cfg.cull_q_slack, min=0.0)
    radius_f = proj.radius.to(torch.float32)
    # + 0.01 px absorbs rounding in the covariance recovery
    ex = torch.minimum(torch.sqrt(qmax * cC / detc) + 0.01, radius_f)
    ey = torch.minimum(torch.sqrt(qmax * cA / detc) + 0.01, radius_f)
    gx, gy = cam.tiles_x, cam.tiles_y
    u, v = proj.u.detach(), proj.v.detach()

    def erect(rx, ry):
        def cl(x, hi):
            return torch.clamp(torch.floor(x), 0, hi).to(torch.int64)
        return (torch.stack([cl((u - rx) / TILE, gx),
                             cl((v - ry) / TILE, gy)], dim=-1),
                torch.stack([cl(torch.floor((u + rx) / TILE) + 1, gx),
                             cl(torch.floor((v + ry) / TILE) + 1, gy)],
                            dim=-1))

    em0, em1 = erect(ex + cull_slack_px, ey + cull_slack_px)
    et0, et1 = erect(ex, ey)
    return (torch.maximum(proj.rect_min, em0),
            torch.minimum(proj.rect_max, em1),
            torch.maximum(proj.rect_min_true, et0),
            torch.minimum(proj.rect_max_true, et1),
            proj.valid & (op_bound >= ALPHA_MIN))


def bin_gaussians(proj: Projected, cam: Camera, cfg: RasterConfig,
                  emit_exp: bool = False, opacity=None, cull_slack_px=0.0,
                  cull_logit_drift: float = 0.0) -> Binning:
    """Depth-ordered per-tile Gaussian lists with a K cap per tile and an M
    cap on the expansion (cfg.max_isect(N)); what the caps drop is counted
    in n_overflow. Margin-only candidates (in the widened rect but not the
    true footprint) rank after every true candidate of their tile.
    `opacity` [N] with the drift budgets `cull_slack_px` (pixels the
    centres may move) and `cull_logit_drift` (growth of the opacity logit)
    while the binning is reused lets cfg.tight_rect and cfg.tile_cull
    act; without it both are skipped."""
    return bin_gaussians_batched([proj], cam, cfg, emit_exp, opacity,
                                 cull_slack_px, cull_logit_drift)[0]


def _expand(proj: Projected, cam: Camera, cfg: RasterConfig, db: int,
            opacity, cull_slack_px, cull_logit_drift):
    """One projection's gaussian-major expansion, truncated to the M
    capacity: (src [E] gaussian of each entry, key [E] = tile << db |
    margin bit | quantized log depth, offs [N] exclusive prefix of the
    per-Gaussian tile counts, total)."""
    dev = proj.u.device
    N = proj.u.shape[0]
    dqb = db - 1
    rmin, rmax = proj.rect_min, proj.rect_max
    rmin_true, rmax_true, valid = (proj.rect_min_true, proj.rect_max_true,
                                   proj.valid)
    if cfg.tight_rect and opacity is not None:
        rmin, rmax, rmin_true, rmax_true, valid = _tight_rects(
            proj, cam, cfg, opacity.detach(), cull_slack_px,
            cull_logit_drift)
    span_x = torch.clamp(rmax[:, 0] - rmin[:, 0], min=0)
    span_y = torch.clamp(rmax[:, 1] - rmin[:, 1], min=0)
    counts = torch.where(valid, span_x * span_y, torch.zeros_like(span_x))
    offs = torch.cumsum(counts, 0) - counts            # exclusive prefix
    total = int(counts.sum())                          # one host sync
    E = min(total, cfg.max_isect(N))                   # entries kept

    depth = proj.depth.detach()
    zn, zf = NEAR_CULL_Z, 1000.0
    tq = torch.log(torch.clamp(depth, zn, zf) / zn) / float(np.log(zf / zn))
    qz = (tq * ((1 << dqb) - 1)).to(torch.int64)

    src = torch.repeat_interleave(torch.arange(N, device=dev), counts,
                                  output_size=total)[:E]
    pos = torch.arange(E, device=dev)
    local = pos - offs[src]
    sx = torch.clamp(span_x[src], min=1)
    tile_x = rmin[src, 0] + local % sx
    tile_y = rmin[src, 1] + local // sx
    tile_id = tile_y * cam.tiles_x + tile_x
    tmin, tmax = rmin_true[src], rmax_true[src]
    in_true = ((tile_x >= tmin[:, 0]) & (tile_y >= tmin[:, 1])
               & (tile_x < tmax[:, 0]) & (tile_y < tmax[:, 1]))
    margin_bit = torch.where(in_true, 0, 1 << dqb)
    return src, (tile_id << db) | margin_bit | qz[src], offs, total


@torch.no_grad()
def bin_gaussians_batched(projs, cam: Camera, cfg: RasterConfig,
                          emit_exp: bool = False, opacity=None,
                          cull_slack_px=0.0, cull_logit_drift: float = 0.0
                          ) -> list:
    """bin_gaussians of S projections of one map (S camera poses) with one
    sort: the batch index sits above the tile id in the int64 key, so the
    stable sort leaves each projection's entries as its own sort would.
    Returns S Binnings equal to the serial ones (slots at or past a tile's
    count, which every consumer masks, may hold other indices)."""
    dev = projs[0].u.device
    N = projs[0].u.shape[0]
    S = len(projs)
    T = cam.num_tiles
    K = cfg.max_per_tile
    M = cfg.max_isect(N)
    db = 32 - max(int(T + 1).bit_length(), 1)
    db = max(min(db, 24), 8)
    dqb = db - 1

    parts = [_expand(p, cam, cfg, db, opacity, cull_slack_px,
                     cull_logit_drift) for p in projs]
    sizes = [p[0].shape[0] for p in parts]
    base = np.concatenate([[0], np.cumsum(sizes)])
    src = torch.cat([p[0] for p in parts])
    key = torch.cat([p[1] + ((b * T) << db) for b, p in enumerate(parts)])
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_gauss = src[perm]

    tids = torch.arange(S * T, device=dev, dtype=torch.int64)
    starts = torch.searchsorted(sorted_key, tids << db)
    ends = torch.searchsorted(sorted_key, (tids + 1) << db)
    ends_true = torch.searchsorted(sorted_key, (tids << db) | (1 << dqb))
    full_count = ends - starts
    tile_count = torch.clamp(full_count, max=K)
    dropped = (full_count - tile_count).reshape(S, T).sum(1)
    true_dropped = torch.clamp(ends_true - starts - K,
                               min=0).reshape(S, T).sum(1)

    # each tile's K slots are the consecutive sorted rows [start, start+K);
    # K pad rows (gauss 0) absorb windows running off the end and only
    # ever sit at slots k >= count
    rows = starts[:, None] + torch.arange(K, device=dev)[None, :]
    k_in = torch.arange(K, device=dev)[None, :] < tile_count[:, None]
    pad = torch.zeros(K, dtype=torch.int64, device=dev)
    tile_gauss = torch.cat([sorted_gauss, pad])[rows].reshape(S, T, K)
    if emit_exp:
        # a slot's position in its own projection's expansion; slots past
        # the count go to the sentinel M, which the backward drops
        slot_pos = torch.cat([perm, pad])[rows].reshape(S, T, K)
        k_in = k_in.reshape(S, T, K)
    tile_count = tile_count.to(torch.int32).reshape(S, T)
    out = []
    for b, (_, _, offs, total) in enumerate(parts):
        slot_exp_pos = exp_offsets = None
        if emit_exp:
            slot_exp_pos = torch.where(k_in[b], slot_pos[b] - int(base[b]),
                                       M)
            exp_offsets = torch.clamp(
                torch.cat([offs, offs.new_tensor([total])]), max=M
            ).to(torch.int32)
        binning = Binning(
            tile_gauss=tile_gauss[b], tile_count=tile_count[b],
            n_isect=torch.tensor(total, device=dev),
            n_overflow=max(total - M, 0) + dropped[b],
            n_true_overflow=true_dropped[b], slot_exp_pos=slot_exp_pos,
            exp_offsets=exp_offsets)
        if cfg.tile_cull and opacity is not None:
            binning = cull_tile_slots(binning, projs[b], opacity.detach(),
                                      cam, cfg, M, slack_px=cull_slack_px,
                                      logit_drift=cull_logit_drift)
        out.append(binning)
    return out


# ---------------------------------------------------------------------------
# compositing


def _pad_k(gdata: torch.Tensor) -> torch.Tensor:
    pad_k = (-gdata.shape[1]) % CHUNK
    if pad_k:
        gdata = torch.cat([gdata, gdata.new_zeros(
            (gdata.shape[0], pad_k, gdata.shape[2]))], dim=1)
    return gdata


class _CompositeTableFused(torch.autograd.Function):
    """The mapping render core: table [N, 6+F] (u, v, A, B, C, op,
    features) -> gather by tile slots -> kernel A. Backward: kernel B
    (bf16 or f32 rows) -> duplicate-free scatter of the live columns into
    gaussian-major expansion order -> kernel C -> d table."""

    @staticmethod
    def forward(ctx, table, idx, counts, slot_exp_pos, exp_offsets, m_cap,
                F, tiles_x, sq_col, live_cols, scatter_bf16, chunk):
        gdata = _pad_k(table[idx])
        out, final_t, saved = composite_forward(gdata, counts, F, tiles_x,
                                                sq_col, chunk)
        ctx.save_for_backward(gdata, counts, slot_exp_pos, exp_offsets,
                              *(saved if saved is not None else ()))
        ctx.args = (table.shape[0], m_cap, F, tiles_x, sq_col, live_cols,
                    scatter_bf16, chunk)
        return out, final_t

    @staticmethod
    def backward(ctx, gout, dfinal):
        gdata, counts, slot_exp_pos, exp_offsets, *saved = ctx.saved_tensors
        n, m_cap, F, tiles_x, sq_col, live_cols, scatter_bf16, chunk = \
            ctx.args
        acc = torch.bfloat16 if scatter_bf16 else torch.float32
        dg = composite_backward(gdata, counts, gout, dfinal, saved or None,
                                F, tiles_x, sq_col, acc, chunk)
        K = slot_exp_pos.shape[1]
        dtab = _expansion_reduce(dg[:, :K], slot_exp_pos, exp_offsets, m_cap,
                                 n, live_cols)
        return (dtab, None, None, None, None, None, None, None, None, None,
                None, None)


def _expansion_reduce(dg, slot_exp_pos, exp_offsets, m_cap: int, n: int,
                      live_cols):
    """Per-slot gradient rows dg [T, K, C] (f32 or bf16) -> d table [n, C]
    f32: a duplicate-free scatter of the live columns into gaussian-major
    expansion order, then kernel C over each Gaussian's contiguous
    segment. Real slots map to distinct expansion positions; padding slots
    all carry the sentinel m_cap, whose row is dropped. Rows no slot
    covers (K cap, a tile subset) stay zero."""
    C = dg.shape[2]
    cols = list(live_cols) if live_cols is not None else list(range(C))
    dsub = dg[..., cols].reshape(-1, len(cols))
    d_exp = torch.zeros((m_cap + 1, len(cols)), dtype=dg.dtype,
                        device=dg.device)
    d_exp[slot_exp_pos.reshape(-1)] = dsub
    planar = segment_reduce_rows(d_exp, exp_offsets)     # [L, n] f32
    dtab = torch.zeros((n, C), dtype=torch.float32, device=dg.device)
    dtab[:, cols] = planar.T
    return dtab


class _GatherRowsSegreduce(torch.autograd.Function):
    """table[idx]; backward = _expansion_reduce of the cotangent rows
    (cast to bf16 first when scatter_bf16)."""

    @staticmethod
    def forward(ctx, table, idx, slot_exp_pos, exp_offsets, m_cap,
                live_cols, scatter_bf16):
        ctx.save_for_backward(slot_exp_pos, exp_offsets)
        ctx.args = (table.shape[0], m_cap, live_cols, scatter_bf16)
        return table[idx]

    @staticmethod
    def backward(ctx, dg):
        slot_exp_pos, exp_offsets = ctx.saved_tensors
        n, m_cap, live_cols, scatter_bf16 = ctx.args
        if scatter_bf16:
            dg = dg.to(torch.bfloat16)
        return (_expansion_reduce(dg, slot_exp_pos, exp_offsets, m_cap, n,
                                  live_cols),
                None, None, None, None, None, None)


def _index_add_rows(dg, idx, n: int, live_cols, scatter_bf16: bool):
    """Per-slot gradient rows dg [T, K, C] -> d table [n, C] in dg's dtype
    by index_add_ of the live columns (accumulated in bf16 when
    scatter_bf16); the dead columns, which feed detached chains, stay
    zero."""
    cols = list(live_cols)
    acc = torch.bfloat16 if scatter_bf16 else dg.dtype
    dsub = dg[..., cols].reshape(-1, len(cols)).to(acc)
    sub = torch.zeros((n, len(cols)), dtype=acc, device=dg.device)
    sub.index_add_(0, idx.reshape(-1), dsub)
    dtab = torch.zeros((n, dg.shape[-1]), dtype=dg.dtype, device=dg.device)
    dtab[:, cols] = sub.to(dg.dtype)
    return dtab


class _GatherRowsPartialGrad(torch.autograd.Function):
    """table[idx]; backward = _index_add_rows of the cotangent rows."""

    @staticmethod
    def forward(ctx, table, idx, live_cols, scatter_bf16):
        ctx.save_for_backward(idx)
        ctx.args = (table.shape[0], live_cols, scatter_bf16)
        return table[idx]

    @staticmethod
    def backward(ctx, dg):
        (idx,) = ctx.saved_tensors
        n, live_cols, scatter_bf16 = ctx.args
        return (_index_add_rows(dg, idx, n, live_cols, scatter_bf16), None,
                None, None)


def _raster_table(proj: Projected, opacity, features):
    """[N, 6+F] rows (u, v, A, B, C, op, features)."""
    return torch.stack([proj.u, proj.v, proj.conic[:, 0], proj.conic[:, 1],
                        proj.conic[:, 2], opacity]
                       + list(features.unbind(-1)), dim=1)


def composite(proj: Projected, opacity, features, binning: Binning,
              cam: Camera, cfg: RasterConfig, live_grad_cols=None,
              sq_col=None):
    """Rasterize all tiles -> ([T, P, F(+1)], [T, P]). With
    cfg.bwd_mode "segreduce" (and "auto") it needs a binning made with
    emit_exp=True: its backward is the expansion-order segment reduce.
    "scatter" gathers the rows and adds their gradients back by index.
    live_grad_cols: table columns whose gradients survive downstream; the
    backward scatters only those."""
    F = features.shape[-1]
    table = _raster_table(proj, opacity, features)            # [N, 6+F]
    live = tuple(live_grad_cols) if live_grad_cols is not None else None
    if cfg.resolve_bwd_mode() == "scatter":
        gdata = (table[binning.tile_gauss] if live is None else
                 _GatherRowsPartialGrad.apply(table, binning.tile_gauss, live,
                                              cfg.grad_scatter_bf16))
        return composite_gdata(gdata, binning.tile_count, cam, cfg, F,
                               sq_col=sq_col)
    if binning.slot_exp_pos is None:
        raise ValueError("composite needs a binning made with "
                         "emit_exp=True")
    return _CompositeTableFused.apply(
        table, binning.tile_gauss, binning.tile_count, binning.slot_exp_pos,
        binning.exp_offsets, cfg.max_isect(table.shape[0]), F, cam.tiles_x,
        sq_col, live, cfg.grad_scatter_bf16, cfg.tile_chunk)


def composite_gdata(gdata, counts, cam: Camera, cfg: RasterConfig, F: int,
                    sq_col=None, bwd_bf16: bool = False):
    """Compositing of already-assembled records gdata [T, K, 6+F]
    (absolute-pixel u, v), differentiable wrt gdata."""
    return composite_tiles(_pad_k(gdata), counts, F, cam.tiles_x, sq_col,
                           bwd_bf16, cfg.tile_chunk)


def _tiles_to_image(tiles, cam: Camera):
    """[T, P, C] tiles -> [C, H, W] image."""
    gx, gy = cam.tiles_x, cam.tiles_y
    c = tiles.shape[-1]
    img = tiles.reshape(gy, gx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    img = img.reshape(gy * TILE, gx * TILE, c)[: cam.height, : cam.width]
    return img.permute(2, 0, 1)


def render(means_cam, quats_cam, log_scales, logit_opacities, features,
           alive, cam: Camera, cfg: RasterConfig = RasterConfig(),
           binning: Binning | None = None, live_grad_cols=None, sq_col=None,
           means2d_offset=None):
    """Full differentiable render. Returns dict(image [F(+1), H, W],
    final_T [H, W], radii [N], n_isect, n_overflow). means2d_offset: see
    project_gaussians; on the whole image its gradient comes back through
    kernel B's du/dv and kernel C's columns 0-1."""
    opacity = torch.sigmoid(logit_opacities[:, 0])
    proj = project_gaussians(means_cam, quats_cam, log_scales, alive, cam,
                             means2d_offset=means2d_offset)
    if binning is None:
        # an inline binning serves one composite, so it is not culled
        binning = bin_gaussians(
            proj, cam, cfg, emit_exp=cfg.resolve_bwd_mode() == "segreduce")
    else:
        # frozen tile lists may reference Gaussians culled at this pose
        opacity = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    tiles_out, tiles_t = composite(proj, opacity, features, binning, cam,
                                   cfg, live_grad_cols, sq_col=sq_col)
    return {"image": _tiles_to_image(tiles_out, cam),
            "final_T": _tiles_to_image(tiles_t[..., None], cam)[0],
            "radii": proj.radius, "n_isect": binning.n_isect,
            "n_overflow": binning.n_overflow}


# table columns of the fused render: u, v, A, B, C, op, r, g, b, z
TRACKING_LIVE_COLS = (0, 1, 2, 3, 4, 9)
MAPPING_LIVE_COLS = tuple(range(10))


def render_rgbd_sil(means_cam, quats_cam, log_scales, logit_opacities,
                    rgb_colors, alive, cam: Camera,
                    cfg: RasterConfig = RasterConfig(),
                    binning: Binning | None = None, live_grad_cols=None,
                    means2d_offset=None):
    """Fused RGB + depth + silhouette + depth^2 render: composites
    [r, g, b, z] (+ z^2 synthesized in the kernel); the silhouette is
    1 - final_T. Returns (im [3,H,W], depth [1,H,W], sil [H,W],
    depth_sq [1,H,W], aux)."""
    feats = torch.cat([rgb_colors, means_cam[:, 2:3]], dim=-1)
    out = render(means_cam, quats_cam, log_scales, logit_opacities, feats,
                 alive, cam, cfg, binning, live_grad_cols, sq_col=3,
                 means2d_offset=means2d_offset)
    img = out["image"]
    return (img[0:3], img[3:4], 1.0 - out["final_T"], img[4:5],
            {"radii": out["radii"], "final_T": out["final_T"],
             "n_isect": out["n_isect"], "n_overflow": out["n_overflow"]})


# ---------------------------------------------------------------------------
# tile-subset renders (the opt-in fast modes): only the tiles in `sel` are
# composited. They are re-indexed into one virtual row of tiles
# (tiles_x = T_sub), so kernels A and B run unchanged; every per-iteration
# cost that scales with the intersection count shrinks with the subset.


def _virtual_row_shift(sel, cam: Camera, width: int, dtype):
    """[Ts, 1, width] shift of (u, v) (columns 0, 1) that moves real tile
    sel[t] onto virtual tile t of a single-row grid, whose pixel origin is
    (t * TILE, 0): an additive constant, transparent to gradients."""
    t_sub = sel.shape[0]
    ox = (sel % cam.tiles_x) * TILE
    oy = (sel // cam.tiles_x) * TILE
    shift = torch.zeros((t_sub, 1, width), dtype=dtype, device=sel.device)
    shift[:, 0, 0] = (torch.arange(t_sub, device=sel.device) * TILE
                      - ox).to(dtype)
    shift[:, 0, 1] = (-oy).to(dtype)
    return shift


class _TileGrid(NamedTuple):
    """Stand-in for Camera inside composite_gdata: the selected tiles laid
    out as one virtual row."""
    num_tiles: int
    tiles_x: int


# Rows (t_sub * max_per_tile) from which "auto" sends the subset render's
# backward through the expansion scatter + kernel C instead of index_add_:
# the reference's crossover (isogs_slam_tpu/ops/rasterize.py), so the
# fast configuration's mapping stripe (T = 975 x K = 512 / 768) takes
# kernel C and its tracking subsets (T = 806 / 209 x K = 256) take
# index_add_, as in the reference. The route is the reference's for the
# sum's sake, not for speed: kernel C sums each row in f32 in a fixed
# order, while index_add_ accumulates the bf16 rows with atomics in bf16,
# and a fast run through it moved its ATE 0.067-0.196 cm between calls of
# one seed. On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py, phase
# "subset route", each aggregation as its backward runs it) index_add_
# took 0.24 / 0.25 / 0.45 ms at 124,416 / 499,200 / 1,651,200 rows (a
# quarter stripe, a stripe, every tile at K = 512) against 0.49-0.53 /
# 0.51-0.57 / 0.62-0.69 ms for the expansion route, whose cost is the
# zero-fill, the row scatter and the re-expansion around a 0.04 ms kernel:
# 0.2-0.3 ms an iteration, which the host-bound run does not show.
SUBSET_SEGREDUCE_MIN_ROWS = 256 * 1024


def subset_uses_segreduce(cfg: RasterConfig, t_sub: int) -> bool:
    """Which backward aggregation the subset render takes (shared by
    render_tiles_subset and the caller's emit_exp decision): an explicit
    bwd_mode decides; "auto" applies the row-count crossover."""
    if cfg.bwd_mode == "segreduce":
        return True
    return (cfg.resolve_bwd_mode() == "segreduce"
            and t_sub * cfg.max_per_tile >= SUBSET_SEGREDUCE_MIN_ROWS)


def image_to_tiles(img, cam: Camera):
    """[C, H, W] -> [num_tiles, TILE*TILE, C] in the compositor's pixel
    order (p = y_local * TILE + x_local); out-of-image pixels are zero."""
    C = img.shape[0]
    gy, gx = cam.tiles_y, cam.tiles_x
    x = torch.nn.functional.pad(
        img, (0, gx * TILE - cam.width, 0, gy * TILE - cam.height))
    x = x.reshape(C, gy, TILE, gx, TILE).permute(1, 3, 2, 4, 0)
    return x.reshape(gy * gx, TILE * TILE, C)


def tiles_to_image(tiles, tiles_x: int):
    """[Ts, TILE*TILE, C] (row-major tile ids, Ts a multiple of tiles_x)
    -> [C, (Ts / tiles_x) * TILE, tiles_x * TILE]: the inverse of
    image_to_tiles on a contiguous band of tile rows."""
    ts, _, c = tiles.shape
    rows = ts // tiles_x
    x = tiles.reshape(rows, tiles_x, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    return x.reshape(c, rows * TILE, tiles_x * TILE)


def tile_pixel_validity(cam: Camera) -> np.ndarray:
    """[num_tiles, TILE*TILE] bool: the pixel lies inside the H x W image
    (tiles on the right and bottom edges are partly padding)."""
    gy, gx = cam.tiles_y, cam.tiles_x
    vy = np.arange(gy * TILE).reshape(gy, TILE) < cam.height
    vx = np.arange(gx * TILE).reshape(gx, TILE) < cam.width
    v = vy[:, None, :, None] & vx[None, :, None, :]
    return v.reshape(gy * gx, TILE * TILE)


def render_tiles_subset(means_cam, quats_cam, log_scales, logit_opacities,
                        rgb_colors, alive, sel, binning: Binning,
                        cam: Camera, cfg: RasterConfig, live_grad_cols=None,
                        means2d_offset=None):
    """Differentiable fused rgb + z (+ z^2) render of only the tiles in
    sel [T_sub] (tile ids). Returns (tiles_out [T_sub, P, 5] with channels
    (r, g, b, z, z^2), final_t [T_sub, P], aux). The backward adds the
    per-slot gradients into the table either by index (index_add_ of the
    live columns) or, when subset_uses_segreduce says so and the binning
    carries expansion positions, through the subset's expansion positions
    and kernel C. means2d_offset: see project_gaussians."""
    opacity = torch.sigmoid(logit_opacities[:, 0])
    proj = project_gaussians(means_cam, quats_cam, log_scales, alive, cam,
                             means2d_offset=means2d_offset)
    # frozen tile lists may reference Gaussians culled at this pose
    opacity = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    table = _raster_table(
        proj, opacity, torch.cat([rgb_colors, means_cam[:, 2:3]], dim=-1))
    idx = binning.tile_gauss[sel]                          # [T_sub, K]
    counts = binning.tile_count[sel]
    t_sub = sel.shape[0]
    live = tuple(live_grad_cols) if live_grad_cols is not None else None
    if live is None:
        gdata = table[idx]
    elif (subset_uses_segreduce(cfg, t_sub)
          and binning.slot_exp_pos is not None):
        gdata = _GatherRowsSegreduce.apply(
            table, idx, binning.slot_exp_pos[sel], binning.exp_offsets,
            cfg.max_isect(table.shape[0]), live, cfg.grad_scatter_bf16)
    else:
        gdata = _GatherRowsPartialGrad.apply(table, idx, live,
                                             cfg.grad_scatter_bf16)
    gdata = gdata + _virtual_row_shift(sel, cam, gdata.shape[-1],
                                       gdata.dtype)
    grid = _TileGrid(num_tiles=t_sub, tiles_x=t_sub)
    # the next backward step casts the rows to bf16 anyway on either
    # route, so kernel B emits them in bf16 directly
    bwd_bf16 = cfg.grad_scatter_bf16 and live is not None
    out, final_t = composite_gdata(gdata, counts, grid, cfg, 4, sq_col=3,
                                   bwd_bf16=bwd_bf16)
    return out, final_t, {"radii": proj.radius}


# ---------------------------------------------------------------------------
# slot-table render (tracking): params are frozen during a tracking frame,
# so per-(tile, slot) raw records are gathered once and each iteration
# re-projects them per slot with the pose as the only gradient leaf.

RAW_COLS = 14   # means3d(3), unnorm_rot(4), log_scales(3), logit_op(1), rgb(3)


def gather_raw_table(params, tile_gauss: torch.Tensor) -> torch.Tensor:
    """[T, K] indices -> [T, K, RAW_COLS] raw world-frame records."""
    raw = torch.cat([params.means3d, params.unnorm_rotations,
                     params.log_scales, params.logit_opacities,
                     params.rgb_colors], dim=-1)
    return raw.detach()[tile_gauss]


def _slot_gdata(raw, cam_quat, cam_trans, cam: Camera, tile_ids=None):
    """Per-slot world->camera transform + EWA projection of a frozen raw
    table [T, K, RAW_COLS] -> composite records [T, K, 10]. Slots whose
    current-pose tile rect does not cover their tile (candidates that only
    the binning margin added) are silenced, keeping the render equal to a
    margin-free per-Gaussian render at every pose inside the margin."""
    T, K = raw.shape[0], raw.shape[1]
    flat = raw.reshape(T * K, RAW_COLS)
    m0, m1, m2 = flat[:, 0], flat[:, 1], flat[:, 2]
    quats_w = flat[:, 3:7]
    log_scales = flat[:, 7:10]
    logit_op = flat[:, 10]
    rgb = flat[:, 11:14]

    qn = normalize(cam_quat)
    r, x, y, z = qn[0], qn[1], qn[2], qn[3]
    tx = ((1 - 2 * (y * y + z * z)) * m0 + 2 * (x * y - r * z) * m1
          + 2 * (x * z + r * y) * m2 + cam_trans[0])
    ty = (2 * (x * y + r * z) * m0 + (1 - 2 * (x * x + z * z)) * m1
          + 2 * (y * z - r * x) * m2 + cam_trans[1])
    tz = (2 * (x * z - r * y) * m0 + 2 * (y * z + r * x) * m1
          + (1 - 2 * (x * x + y * y)) * m2 + cam_trans[2])
    means_cam = torch.stack([tx, ty, tz], dim=-1)
    quats_cam = quat_mult(qn[None, :], normalize(quats_w))

    u, v, cA, cB, cC, det, radius_f = _ewa_core(means_cam, quats_cam,
                                                log_scales, cam)
    valid = (tz > NEAR_CULL_Z) & (det != 0) & (radius_f > 0)
    if tile_ids is None:
        tile_ids = torch.arange(T, device=raw.device)
    tcx = torch.repeat_interleave(tile_ids % cam.tiles_x, K).to(torch.float32)
    tcy = torch.repeat_interleave(tile_ids // cam.tiles_x, K).to(torch.float32)
    us, vs, rs = u.detach(), v.detach(), radius_f.detach()
    covered = ((tcx >= torch.floor((us - rs) / TILE))
               & (tcx < torch.floor((us + rs + TILE - 1) / TILE))
               & (tcy >= torch.floor((vs - rs) / TILE))
               & (tcy < torch.floor((vs + rs + TILE - 1) / TILE)))
    valid = valid & covered
    zero = torch.zeros_like(tz)
    opacity = torch.where(valid, torch.sigmoid(logit_op), zero)

    def safe(a):   # culled slots' conic/uv can be inf/NaN
        return torch.where(valid, a, zero)

    return torch.stack(
        [safe(u), safe(v), safe(cA), safe(cB), safe(cC), opacity,
         rgb[:, 0], rgb[:, 1], rgb[:, 2], safe(tz)], dim=-1
    ).reshape(T, K, 10)


def render_rgbd_sil_slots(raw, counts, cam_quat, cam_trans, cam: Camera,
                          cfg: RasterConfig):
    """Fused RGB+depth+sil+depth^2 render from a frozen per-slot raw
    table; (cam_quat, cam_trans) are the only differentiable inputs.
    Returns (im, depth, silhouette, depth_sq, aux) like render_rgbd_sil."""
    gdata = _slot_gdata(raw, cam_quat, cam_trans, cam)
    tiles_out, tiles_t = composite_gdata(gdata, counts, cam, cfg, 4, sq_col=3)
    img = _tiles_to_image(tiles_out, cam)
    final_t = _tiles_to_image(tiles_t[..., None], cam)[0]
    return (img[0:3], img[3:4], 1.0 - final_t, img[4:5], {"final_T": final_t})


def render_rgbd_sil_slots_subset(raw_sub, counts_sub, sel, cam_quat,
                                 cam_trans, cam: Camera, cfg: RasterConfig):
    """Slot-table render of only the tiles in sel [Ts] (tracking's
    counterpart of render_tiles_subset). raw_sub [Ts, K, RAW_COLS] =
    raw[sel], counts_sub [Ts]. Returns tile-space (out [Ts, P, 5] with
    channels (r, g, b, z, z^2), silhouette [Ts, P]) on the same virtual
    single-row grid."""
    gdata = _slot_gdata(raw_sub, cam_quat, cam_trans, cam, tile_ids=sel)
    t_sub = raw_sub.shape[0]
    shift = _virtual_row_shift(sel, cam, gdata.shape[-1], gdata.dtype)
    grid = _TileGrid(num_tiles=t_sub, tiles_x=t_sub)
    out, final_t = composite_gdata(gdata + shift, counts_sub, grid, cfg, 4,
                                   sq_col=3)
    return out, 1.0 - final_t
