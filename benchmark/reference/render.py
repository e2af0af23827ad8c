"""Plain 3D Gaussian splatting renderer, frozen in the benchmark.

The published 3DGS rasteriser written out in plain PyTorch (no kernel, no
import of the program): EWA projection with the 1.3 tan(fov) frustum clamp
and the 0.3 px low-pass, a near cull at z <= 0.2, a 3-sigma radius from
the larger eigenvalue, 16 x 16 tiles, front-to-back alpha compositing in
depth order with alpha clamped at 0.99, pairs under alpha 1/255 skipped and
a pixel closed once its transmittance would fall under 1e-4. The outputs
per pixel are colour, depth, depth^2 and silhouette (the composited weight
of a ones feature). Pixel (x, y) is at integer coordinates; u = fx x / z +
cx.

`cap` keeps only the front-most `cap` Gaussians of a tile, as the
configuration's per-tile limits state (raster.max_per_tile for mapping,
raster.max_per_tile_tracking for tracking); a frozen `Bins` reproduces the
configured reuse of tile lists across iterations (mapping's phase-long
lists, tracking's margin-widened lists). Without them every intersection
is composited.

Memory: tiles are composited in chunks of at most CHUNK_PAIRS
(slot, pixel) pairs. `render` runs without a graph; `backward` recomputes
one chunk at a time with a graph to turn the loss's gradient in the image
into a gradient in the per-Gaussian records.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
NEAR = 0.2
LOW_PASS = 0.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
CHUNK_PAIRS = 1 << 25
# records per Gaussian: u v A B C opacity r g b z z^2 1
N_REC = 12


class Cam(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def tiles_x(self):
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self):
        return (self.height + TILE - 1) // TILE


class Bins(NamedTuple):
    gauss: torch.Tensor     # [E] Gaussian of each kept (tile, slot) entry
    tile: torch.Tensor      # [E] its tile, entries grouped by tile in order
    start: torch.Tensor     # [T] first entry of each tile
    count: torch.Tensor     # [T] entries of each tile


def normalize(q, eps=1e-12):
    return q / torch.sqrt(torch.clamp(torch.sum(q * q, -1, keepdim=True),
                                      min=eps * eps))


def quat_to_rot(q):
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def records(means, quats, log_scales, logit_op, rgb, alive, q_cam, t_cam,
            cam: Cam):
    """Per-Gaussian screen records [N, N_REC] and their 3-sigma radius [N]
    and validity [N] at the world-to-camera pose (q_cam, t_cam).
    Differentiable in the map and in the pose."""
    W = quat_to_rot(q_cam)                                      # [3, 3]
    mc = means @ W.T + t_cam
    x, y, z = mc[:, 0], mc[:, 1], mc[:, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-7), z)
    u = cam.fx * x / (z + 1e-7) + cam.cx
    v = cam.fy * y / (z + 1e-7) + cam.cy
    R = W @ quat_to_rot(quats)                                  # [N, 3, 3]
    s2 = torch.exp(2.0 * log_scales)
    cov = (R * s2[:, None, :]) @ R.transpose(1, 2)              # [N, 3, 3]
    limx = 1.3 * cam.width / (2.0 * cam.fx)
    limy = 1.3 * cam.height / (2.0 * cam.fy)
    xc = torch.clamp(x / zs, -limx, limx) * z
    yc = torch.clamp(y / zs, -limy, limy) * z
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * xc / (zs * zs)], -1),
        torch.stack([zero, cam.fy / zs, -cam.fy * yc / (zs * zs)], -1)], -2)
    c2 = J @ cov @ J.transpose(1, 2)                            # [N, 2, 2]
    a = c2[:, 0, 0] + LOW_PASS
    b = c2[:, 0, 1]
    c = c2[:, 1, 1] + LOW_PASS
    det = a * c - b * b
    det_s = torch.where(det != 0, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))).detach()
    valid = alive & (z > NEAR) & (det != 0) & (radius > 0)
    op = torch.sigmoid(logit_op.reshape(-1))
    rec = torch.stack([u, v, c / det_s, -b / det_s, a / det_s, op,
                       rgb[:, 0], rgb[:, 1], rgb[:, 2], z, z * z,
                       torch.ones_like(z)], -1)
    rec = torch.where(valid[:, None], rec, torch.zeros_like(rec))
    return rec, radius, valid


def tile_rect(u, v, r, cam: Cam):
    """Tiles [x0, x1) x [y0, y1) a footprint of radius r covers."""
    def cl(t, hi):
        return torch.clamp(torch.floor(t), 0, hi).to(torch.int64)
    return (cl((u - r) / TILE, cam.tiles_x), cl((v - r) / TILE, cam.tiles_y),
            cl((u + r + TILE - 1) / TILE, cam.tiles_x),
            cl((v + r + TILE - 1) / TILE, cam.tiles_y))


def depth_key(z, cam: Cam):
    """Depth order at the resolution of the configured renderer: log depth
    over [NEAR, 1000] m in 2^(db - 1) - 1 steps, db = 32 less the bits of
    the tile count (clamped to 8..24), so that Gaussians closer in depth
    than one step keep their own order."""
    T = cam.tiles_x * cam.tiles_y
    db = max(min(32 - max(int(T + 1).bit_length(), 1), 24), 8)
    levels = (1 << (db - 1)) - 1
    tq = (torch.log(torch.clamp(z, NEAR, 1000.0) / NEAR)
          / math.log(1000.0 / NEAR))
    return (tq * levels).to(torch.int64)


def bin_tiles(rec, radius, valid, cam: Cam, cap: int | None = None,
              margin_px: float = 0.0) -> Bins:
    """Per-tile Gaussian lists in depth order. With a margin the rects are
    widened by margin_px and the entries only the margin adds rank after
    every true one of their tile; `cap` keeps the first `cap` entries of a
    tile."""
    u, v = rec[:, 0].detach(), rec[:, 1].detach()
    x0, y0, x1, y1 = tile_rect(u, v, radius + margin_px, cam)
    tx0, ty0, tx1, ty1 = tile_rect(u, v, radius, cam)
    w = torch.clamp(x1 - x0, min=0)
    h = torch.clamp(y1 - y0, min=0)
    n = torch.where(valid, w * h, torch.zeros_like(w))
    total = int(n.sum())
    dev = rec.device
    g = torch.repeat_interleave(torch.arange(rec.shape[0], device=dev), n,
                                output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[g]
    tx = x0[g] + local % torch.clamp(w[g], min=1)
    ty = y0[g] + local // torch.clamp(w[g], min=1)
    tile = ty * cam.tiles_x + tx
    true = (tx >= tx0[g]) & (tx < tx1[g]) & (ty >= ty0[g]) & (ty < ty1[g])
    # order: tile, then true before margin-only, then depth; ties keep the
    # Gaussians' own order
    order = torch.argsort(depth_key(rec[:, 9].detach(), cam)[g], stable=True)
    order = order[torch.argsort((~true[order]).to(torch.int64), stable=True)]
    order = order[torch.argsort(tile[order], stable=True)]
    g, tile = g[order], tile[order]
    T = cam.tiles_x * cam.tiles_y
    count = torch.bincount(tile, minlength=T)
    start = torch.cumsum(count, 0) - count
    if cap is not None:
        rank = torch.arange(total, device=dev) - start[tile]
        keep = rank < cap
        g, tile = g[keep], tile[keep]
        count = torch.clamp(count, max=cap)
        start = torch.cumsum(count, 0) - count
    return Bins(g, tile, start, count)


def _chunks(bins: Bins):
    """Tile chunks of at most CHUNK_PAIRS pairs: (tiles, slots) with slots
    [c, K] entry indices (-1 past a tile's count)."""
    cnt = bins.count
    order = torch.argsort(cnt, descending=True)
    cnt_sorted = cnt[order].tolist()
    dev = cnt.device
    i, T = 0, len(cnt_sorted)
    while i < T:
        k = max(cnt_sorted[i], 1)
        c = max(1, min(T - i, CHUNK_PAIRS // (k * TILE * TILE)))
        tiles = order[i:i + c]
        ar = torch.arange(k, device=dev)
        slots = bins.start[tiles][:, None] + ar[None, :]
        slots = torch.where(ar[None, :] < bins.count[tiles][:, None], slots,
                            torch.full_like(slots, -1))
        yield tiles, slots
        i += c


def _composite(g, tiles, cam: Cam):
    """g [c, K, N_REC] records of each tile's slots (zero rows past the
    count) -> per-pixel [c, P, N_REC - 6] (r, g, b, z, z^2, silhouette)."""
    dev, dt = g.device, g.dtype
    px = torch.arange(TILE, device=dev, dtype=dt)
    pxs, pys = px.repeat(TILE), px.repeat_interleave(TILE)
    ox = ((tiles % cam.tiles_x) * TILE).to(dt)
    oy = ((tiles // cam.tiles_x) * TILE).to(dt)
    dx = g[:, :, 0:1] - (ox[:, None] + pxs[None, :])[:, None, :]
    dy = g[:, :, 1:2] - (oy[:, None] + pys[None, :])[:, None, :]
    power = (-0.5 * (g[:, :, 2:3] * dx * dx + g[:, :, 4:5] * dy * dy)
             - g[:, :, 3:4] * dx * dy)
    alpha = torch.clamp(g[:, :, 5:6] * torch.exp(power), max=ALPHA_MAX)
    contrib = (power <= 0) & (alpha >= ALPHA_MIN)
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))
    keep = torch.cumprod(1.0 - a, dim=1)
    t_excl = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], 1)
    include = (contrib & (keep >= T_EPS)).detach()
    w = torch.where(include, a * t_excl, torch.zeros_like(a))
    return torch.einsum("ckp,ckf->cpf", w, g[:, :, 6:])


def _gather(rec, bins: Bins, slots, mask_fn=None):
    idx = torch.where(slots >= 0, bins.gauss[slots.clamp(min=0)],
                      torch.zeros_like(slots))
    g = rec[idx]
    ok = slots >= 0
    if mask_fn is not None:
        ok = ok & mask_fn(idx, slots)
    return torch.where(ok[..., None], g, torch.zeros_like(g))


def _to_image(tiles_out, tiles, cam: Cam, out):
    """Scatter [c, P, F] tile outputs into the padded image out [F, Hp,
    Wp]."""
    tx = tiles % cam.tiles_x
    ty = tiles // cam.tiles_x
    blk = tiles_out.reshape(-1, TILE, TILE, tiles_out.shape[-1])
    view = out.reshape(out.shape[0], cam.tiles_y, TILE, cam.tiles_x, TILE)
    view[:, ty, :, tx, :] = blk.permute(0, 3, 1, 2).to(out.dtype)


def render(rec, bins: Bins, cam: Cam, mask_fn=None):
    """[6, H, W] image: r, g, b, depth, depth^2, silhouette. `mask_fn(gauss
    [c, K], slots [c, K]) -> bool` silences slots (tracking's coverage
    test)."""
    F = N_REC - 6
    out = torch.zeros((F, cam.tiles_y * TILE, cam.tiles_x * TILE),
                      device=rec.device, dtype=rec.dtype)
    with torch.no_grad():
        for tiles, slots in _chunks(bins):
            _to_image(_composite(_gather(rec, bins, slots, mask_fn), tiles,
                                 cam), tiles, cam, out)
    return out[:, :cam.height, :cam.width]


def backward(rec_leaf, bins: Bins, cam: Cam, grad_img, mask_fn=None):
    """d loss / d rec [N, N_REC] from d loss / d image [6, H, W]."""
    gpad = torch.zeros((grad_img.shape[0], cam.tiles_y * TILE,
                        cam.tiles_x * TILE), device=grad_img.device,
                       dtype=grad_img.dtype)
    gpad[:, :cam.height, :cam.width] = grad_img
    gview = gpad.reshape(gpad.shape[0], cam.tiles_y, TILE, cam.tiles_x, TILE)
    total = torch.zeros_like(rec_leaf)
    for tiles, slots in _chunks(bins):
        leaf = rec_leaf.detach().requires_grad_(True)
        with torch.enable_grad():
            o = _composite(_gather(leaf, bins, slots, mask_fn), tiles, cam)
        tx = tiles % cam.tiles_x
        ty = tiles // cam.tiles_x
        go = gview[:, ty, :, tx, :].permute(0, 2, 3, 1).reshape(o.shape)
        (gr,) = torch.autograd.grad(o, leaf, go.to(o.dtype))
        total += gr
    return total


def coverage_mask(rec, radius, bins: Bins, cam: Cam):
    """Tracking's per-iteration silencing of slots whose footprint at the
    current pose no longer covers their tile (entries a margin-widened
    binning added)."""
    u, v = rec[:, 0].detach(), rec[:, 1].detach()
    x0, y0, x1, y1 = tile_rect(u, v, radius, cam)

    def fn(idx, slots):
        t = bins.tile[slots.clamp(min=0)]
        tx, ty = t % cam.tiles_x, t // cam.tiles_x
        return ((tx >= x0[idx]) & (tx < x1[idx]) & (ty >= y0[idx])
                & (ty < y1[idx]))
    return fn
