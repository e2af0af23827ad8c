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
    re-projects it per slot each iteration (pose is the only leaf).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import TILE, Camera
from ..utils.transforms import normalize, quat_mult
from .composite import composite_backward, composite_forward, composite_tiles
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
    # not ported yet (opt-in in the reference): raise NotImplementedError
    tile_cull: bool = False
    tight_rect: bool = False
    max_isect_cap: int = 0    # static intersection capacity override

    def max_isect(self, num_gaussians: int) -> int:
        m = (self.max_isect_cap if self.max_isect_cap > 0
             else int(num_gaussians * self.isect_per_gaussian))
        return max(1024, (m + 1023) // 1024 * 1024)

    def check_ported(self):
        for knob in ("tile_cull", "tight_rect"):
            if getattr(self, knob):
                raise NotImplementedError(
                    f"RasterConfig.{knob} is not ported to the PyTorch "
                    f"package yet")


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
                      margin_px: float = 0.0) -> Projected:
    """Per-Gaussian EWA projection. margin_px widens the binning rect only
    (frozen tile lists reused across pose updates stay supersets)."""
    tz = means_cam[:, 2]
    u, v, cA, cB, cC, det, radius_f = _ewa_core(means_cam, quats,
                                                log_scales, cam)
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


def bin_gaussians(proj: Projected, cam: Camera, cfg: RasterConfig,
                  emit_exp: bool = False) -> Binning:
    """Depth-ordered per-tile Gaussian lists with a K cap per tile and an M
    cap on the expansion (cfg.max_isect(N)); what the caps drop is counted
    in n_overflow. Margin-only candidates (in the widened rect but not the
    true footprint) rank after every true candidate of their tile."""
    cfg.check_ported()
    dev = proj.u.device
    N = proj.u.shape[0]
    T = cam.num_tiles
    K = cfg.max_per_tile
    M = cfg.max_isect(N)
    db = 32 - max(int(T + 1).bit_length(), 1)
    db = max(min(db, 24), 8)
    dqb = db - 1

    rmin, rmax = proj.rect_min, proj.rect_max
    span_x = torch.clamp(rmax[:, 0] - rmin[:, 0], min=0)
    span_y = torch.clamp(rmax[:, 1] - rmin[:, 1], min=0)
    counts = torch.where(proj.valid, span_x * span_y,
                         torch.zeros_like(span_x))
    offs = torch.cumsum(counts, 0) - counts            # exclusive prefix
    total = int(counts.sum())                          # one host sync
    E = min(total, M)                                  # entries kept

    depth = proj.depth.detach()
    zn, zf = NEAR_CULL_Z, 1000.0
    tq = torch.log(torch.clamp(depth, zn, zf) / zn) / float(np.log(zf / zn))
    qz = (tq * ((1 << dqb) - 1)).to(torch.int64)

    # gaussian-major expansion, truncated to the M capacity
    src = torch.repeat_interleave(torch.arange(N, device=dev), counts,
                                  output_size=total)[:E]
    pos = torch.arange(E, device=dev)
    local = pos - offs[src]
    sx = torch.clamp(span_x[src], min=1)
    tile_x = rmin[src, 0] + local % sx
    tile_y = rmin[src, 1] + local // sx
    tile_id = tile_y * cam.tiles_x + tile_x
    tmin, tmax = proj.rect_min_true[src], proj.rect_max_true[src]
    in_true = ((tile_x >= tmin[:, 0]) & (tile_y >= tmin[:, 1])
               & (tile_x < tmax[:, 0]) & (tile_y < tmax[:, 1]))
    margin_bit = torch.where(in_true, 0, 1 << dqb)
    key = (tile_id << db) | margin_bit | qz[src]
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_gauss = src[perm]

    tids = torch.arange(T, device=dev, dtype=torch.int64)
    starts = torch.searchsorted(sorted_key, tids << db)
    ends = torch.searchsorted(sorted_key, (tids + 1) << db)
    ends_true = torch.searchsorted(sorted_key, (tids << db) | (1 << dqb))
    full_count = ends - starts
    tile_count = torch.clamp(full_count, max=K)
    n_overflow = (max(total - M, 0)
                  + torch.sum(full_count - tile_count))
    n_true_overflow = torch.sum(torch.clamp(ends_true - starts - K, min=0))

    # each tile's K slots are the consecutive sorted rows [start, start+K);
    # K pad rows (gauss 0, position M) absorb windows running off the end
    # and only ever sit at slots k >= count
    rows = starts[:, None] + torch.arange(K, device=dev)[None, :]
    k_in = torch.arange(K, device=dev)[None, :] < tile_count[:, None]
    pad_g = torch.zeros(K, dtype=torch.int64, device=dev)
    tile_gauss = torch.cat([sorted_gauss, pad_g])[rows]
    slot_exp_pos = exp_offsets = None
    if emit_exp:
        pad_p = torch.full((K,), M, dtype=torch.int64, device=dev)
        slot_exp_pos = torch.where(k_in, torch.cat([perm, pad_p])[rows], M)
        exp_offsets = torch.clamp(
            torch.cat([offs, offs.new_tensor([total])]), max=M
        ).to(torch.int32)
    return Binning(tile_gauss=tile_gauss,
                   tile_count=tile_count.to(torch.int32),
                   n_isect=torch.tensor(total, device=dev),
                   n_overflow=n_overflow, n_true_overflow=n_true_overflow,
                   slot_exp_pos=slot_exp_pos, exp_offsets=exp_offsets)


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
        C = gdata.shape[2]
        cols = list(live_cols) if live_cols is not None else list(range(C))
        dsub = dg[:, :K, cols].reshape(-1, len(cols))
        # real slots map to distinct expansion positions; padding slots
        # all carry the sentinel m_cap, whose row is dropped
        d_exp = torch.zeros((m_cap + 1, len(cols)), dtype=acc,
                            device=dg.device)
        d_exp[slot_exp_pos.reshape(-1)] = dsub
        planar = segment_reduce_rows(d_exp, exp_offsets)     # [L, n] f32
        dtab = torch.zeros((n, C), dtype=torch.float32, device=dg.device)
        dtab[:, cols] = planar.T
        return (dtab, None, None, None, None, None, None, None, None, None,
                None, None)


def composite(proj: Projected, opacity, features, binning: Binning,
              cam: Camera, cfg: RasterConfig, live_grad_cols=None,
              sq_col=None):
    """Rasterize all tiles -> ([T, P, F(+1)], [T, P]). Needs a binning
    made with emit_exp=True (its backward is the expansion-order segment
    reduce). live_grad_cols: table columns whose gradients survive
    downstream; the backward scatters only those."""
    if binning.slot_exp_pos is None:
        raise ValueError("composite needs a binning made with "
                         "emit_exp=True")
    F = features.shape[-1]
    table = torch.stack([proj.u, proj.v, proj.conic[:, 0], proj.conic[:, 1],
                         proj.conic[:, 2], opacity]
                        + list(features.unbind(-1)), dim=1)   # [N, 6+F]
    live = tuple(live_grad_cols) if live_grad_cols is not None else None
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
           binning: Binning | None = None, live_grad_cols=None, sq_col=None):
    """Full differentiable render. Returns dict(image [F(+1), H, W],
    final_T [H, W], radii [N], n_isect, n_overflow)."""
    opacity = torch.sigmoid(logit_opacities[:, 0])
    proj = project_gaussians(means_cam, quats_cam, log_scales, alive, cam)
    if binning is None:
        binning = bin_gaussians(proj, cam, cfg, emit_exp=True)
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
                    binning: Binning | None = None, live_grad_cols=None):
    """Fused RGB + depth + silhouette + depth^2 render: composites
    [r, g, b, z] (+ z^2 synthesized in the kernel); the silhouette is
    1 - final_T. Returns (im [3,H,W], depth [1,H,W], sil [H,W],
    depth_sq [1,H,W], aux)."""
    feats = torch.cat([rgb_colors, means_cam[:, 2:3]], dim=-1)
    out = render(means_cam, quats_cam, log_scales, logit_opacities, feats,
                 alive, cam, cfg, binning, live_grad_cols, sq_col=3)
    img = out["image"]
    return (img[0:3], img[3:4], 1.0 - out["final_T"], img[4:5],
            {"radii": out["radii"], "final_T": out["final_T"],
             "n_isect": out["n_isect"], "n_overflow": out["n_overflow"]})


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
