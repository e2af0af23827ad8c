"""Plain SplaTAM steps that the benchmark's check follows, frozen here.

Each function restates one step of the configured SLAM job in plain
PyTorch on top of `render.py`: the tracking loss and its Adam loop on the
pose, the mapping loss (L1 + SSIM colour, masked depth L1, the IsoGS flat
and iso-surface terms) with its Adam loop on the map, pruning, and the
silhouette densification rule. The configuration's capacities are part of
what it states and are followed as stated: the per-tile limits, the
intersection capacity (raster.isect_per_gaussian of the first frame's
rows, grown by half again when a binning's demand passes three quarters of
it), and the tracking tile lists kept across frames while the predicted
pose moves the map by no more than the margin's budget.

The job's random stream is an input: the reference draws, from the job's
seed, what the configured steps draw, in their order (the first frame's
log-scale perturbation, the iso term's query pool and each iteration's
sample of it).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

ISECT_GRANULE = 1 << 18


class Map(NamedTuple):
    means: torch.Tensor
    quats: torch.Tensor
    log_scales: torch.Tensor
    logit_op: torch.Tensor      # [N, 1]
    rgb: torch.Tensor


def map_from_npz(d, device) -> Map:
    def t(k):
        return torch.as_tensor(np.asarray(d[k], np.float32), device=device)
    return Map(t("means3D"), t("unnorm_rotations"), t("log_scales"),
               t("logit_opacities"), t("rgb_colors"))


def isect_capacity(rows: int) -> int:
    return max(ISECT_GRANULE, -(-rows // ISECT_GRANULE) * ISECT_GRANULE)


def median(x):
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# --------------------------------------------------------------- losses
def _gauss_window(dev, dt, size=11, sigma=1.5):
    xs = torch.arange(size, device=dev, dtype=dt) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return (g[:, None] * g[None, :])[None, None].expand(3, 1, size, size)


def ssim(a, b):
    """Mean SSIM of [3, H, W] images: 11 x 11 Gaussian window (sigma 1.5),
    zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    w = _gauss_window(a.device, a.dtype)

    def f(x):
        return F.conv2d(x[None], w, padding=5, groups=3)[0]
    mu1, mu2 = f(a), f(b)
    s1 = f(a * a) - mu1 * mu1
    s2 = f(b * b) - mu2 * mu2
    s12 = f(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
         / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))
    return m.mean()


def tracking_loss(img, gt_im, gt_d, tc: dict):
    """SplaTAM's tracking loss on a rendered [6, H, W] image: L1 sums over
    valid depth and silhouette > sil_thres, on the silhouette-normalised
    render where the configuration asks for it. Returns (loss, im, depth,
    mask_frac), each weighted."""
    im, d, d2, s = img[0:3], img[3:4], img[4:5], img[5]
    if tc["sil_norm_render"]:
        sc = torch.clamp(s, min=1e-6)[None]
        im, d, d2 = im / sc, d / sc, d2 / sc
    unc = (d2 - d * d).detach()
    nan_ok = ~torch.isnan(d) & ~torch.isnan(unc)
    if tc["ignore_outlier_depth_loss"]:
        err = torch.abs(gt_d - d) * (gt_d > 0)
        mask = (err < 10 * median(err)) & (gt_d > 0)
    else:
        mask = gt_d > 0
    mask = (mask & nan_ok & (s > tc["sil_thres"])[None]).detach()
    ld = torch.sum(torch.where(mask, torch.abs(gt_d - d), torch.zeros_like(d)))
    li = torch.sum(torch.where(mask.expand_as(im), torch.abs(gt_im - im),
                               torch.zeros_like(im)))
    wi, wd = tc["w_im"] * li, tc["w_depth"] * ld
    return wi + wd, wi, wd, mask.float().mean()


def mapping_image_loss(img, gt_im, gt_d, mc: dict):
    """The mapping loss's image terms: 0.8 L1 + 0.2 (1 - SSIM) colour and
    the depth L1 mean over valid depth. Returns (im, depth), weighted."""
    im, d, d2 = img[0:3], img[3:4], img[4:5]
    unc = (d2 - d * d).detach()
    mask = ((gt_d > 0) & ~torch.isnan(d) & ~torch.isnan(unc)).detach()
    cnt = torch.clamp(mask.float().sum(), min=1.0)
    ld = torch.sum(torch.where(mask, torch.abs(gt_d - d),
                               torch.zeros_like(d))) / cnt
    li = 0.8 * torch.abs(gt_im - im).mean() + 0.2 * (1.0 - ssim(im, gt_im))
    return mc["w_im"] * li, mc["w_depth"] * ld


def flat_loss(log_scales, alive):
    s = torch.clamp(torch.exp(log_scales), min=1e-5)
    m = torch.amin(s, dim=1)
    return (torch.sum(torch.where(alive, m, torch.zeros_like(m)))
            / torch.clamp(alive.float().sum(), min=1.0))


_P1, _P2, _P3 = 73856093, 19349663, 83492791


def _cells(points, cell):
    return torch.floor(points / cell).to(torch.int64)


def _hash(cells, table: int):
    return ((cells[..., 0] * _P1) ^ (cells[..., 1] * _P2)
            ^ (cells[..., 2] * _P3)) & (table - 1)


def _pack(cells):
    c = torch.clamp(cells + 512, 0, 1023)
    return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)


def knn_hash(points, alive, log_scales, queries, k: int, cap: int = 24):
    """The configured neighbour search of the iso term (knn_method "hash",
    hash_cap 24): points hashed by their cell of a uniform grid (cell =
    2.5 x the lower median of the alive Gaussians' mean scale) into a
    power-of-two table (the rows' count, clamped to 2^16..2^21, rounded
    up), buckets in row order; a query's candidates are the first `cap`
    rows of each of its 27 neighbouring cells' buckets that lie in that
    cell, and its neighbours the k nearest of them. Indices [Q, k], -1
    where fewer than k were found."""
    dev = points.device
    ms = torch.exp(torch.mean(log_scales, 1))
    v = torch.sort(torch.where(alive, ms, torch.full_like(ms, math.inf))
                   ).values
    n = int(alive.sum())
    cell = torch.clamp(2.5 * v[min(n // 2, len(v) - 1)], 1e-4, 1e3)
    C = points.shape[0]
    table = 1 << (max(min(C, 1 << 21), 1 << 16) - 1).bit_length()
    cells = _cells(points, cell)
    h = torch.where(alive, _hash(cells, table), torch.full_like(cells[:, 0],
                                                                table))
    order = torch.sort(h, stable=True).indices
    counts = torch.bincount(h, minlength=table + 1)[:table]
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    cell_of = torch.cat([_pack(cells)[order],
                         torch.full((cap,), -1, dtype=torch.int64,
                                    device=dev)])
    order_p = torch.cat([order, torch.zeros(cap, dtype=torch.int64,
                                            device=dev)])
    pts = torch.cat([points[order], torch.zeros((cap, 3), device=dev)])
    d = torch.arange(-1, 2, device=dev)
    off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1
                      ).reshape(-1, 3)
    out = []
    for qs in range(0, queries.shape[0], 4096):
        q = queries[qs:qs + 4096]
        nc = _cells(q, cell)[:, None, :] + off[None]
        nh = _hash(nc, table)
        slots = starts[nh][..., None] + torch.arange(cap, device=dev)
        inb = slots < ends[nh][..., None]
        slots = torch.clamp(slots, max=C + cap - 1)
        ok = (inb & (cell_of[slots] == _pack(nc)[..., None])).reshape(
            q.shape[0], -1)
        diff = pts[slots].reshape(q.shape[0], -1, 3) - q[:, None, :]
        d2 = torch.where(ok, torch.sum(diff * diff, -1),
                         torch.full_like(ok, math.inf, dtype=q.dtype))
        top, arg = torch.topk(-d2, k, dim=1)
        idx = torch.gather(order_p[slots].reshape(q.shape[0], -1), 1, arg)
        out.append(torch.where(torch.isfinite(top), idx,
                               torch.full_like(idx, -1)))
    return torch.cat(out)


def iso_loss(m: Map, alive, q_idx, nbr, target=1.0):
    """IsoGS iso-surface term: density D(q) = sum_j op_j exp(-0.5 d^T
    Sigma_j^-1 d) over each query's neighbours, loss mean((D - target)^2)
    over alive queries."""
    ok = (nbr >= 0) & alive[nbr.clamp(min=0)]
    j = nbr.clamp(min=0)
    Rj = R.quat_to_rot(m.quats[j])                             # [Q, k, 3, 3]
    delta = m.means[q_idx][:, None, :] - m.means[j]
    c = torch.einsum("qkji,qkj->qki", Rj, delta)               # R^T delta
    s = torch.clamp(torch.exp(m.log_scales[j]), min=1e-5)
    quad = torch.sum(c * c / (s * s + 1e-8), -1)
    dens = torch.where(ok, torch.sigmoid(m.logit_op[j][..., 0])
                       * torch.exp(-0.5 * quad), torch.zeros_like(quad))
    D = dens.sum(-1)
    qv = alive[q_idx]
    n = torch.clamp(qv.float().sum(), min=1.0)
    err = (D - target) ** 2
    return (torch.sum(torch.where(qv, err, torch.zeros_like(err))) / n,
            torch.sum(torch.where(qv, D, torch.zeros_like(D))) / n)


# ---------------------------------------------------------------- Adam
class Adam:
    """torch.optim.Adam's update on a tuple of leaves, one rate each."""

    def __init__(self, leaves, lrs, eps):
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.lrs, self.eps, self.n = lrs, eps, 0

    def step(self, leaves, grads):
        self.n += 1
        bc1 = 1 - 0.9 ** self.n
        bc2 = 1 - 0.999 ** self.n
        out = []
        for i, (p, g) in enumerate(zip(leaves, grads)):
            self.m[i] = 0.9 * self.m[i] + 0.1 * g
            self.v[i] = 0.999 * self.v[i] + 0.001 * g * g
            out.append(p - self.lrs[i] * (self.m[i] / bc1)
                       / (torch.sqrt(self.v[i] / bc2) + self.eps))
        return out


# ------------------------------------------------------------ tracking
def const_velocity(rots, trans, t):
    """The configured initial pose of frame t (forward_prop): the last
    pose plus the last step, from the poses the program estimated."""
    if t > 1:
        r1 = rots[:, t - 1] / np.linalg.norm(rots[:, t - 1])
        r2 = rots[:, t - 2] / np.linalg.norm(rots[:, t - 2])
        q = r1 + (r1 - r2)
        return q / np.linalg.norm(q), trans[:, t - 1] + (trans[:, t - 1]
                                                        - trans[:, t - 2])
    return rots[:, t - 1], trans[:, t - 1]


def pixel_drift(means, q0, t0, q1, t1, cam: R.Cam, stride=16):
    """Largest screen motion (px, Chebyshev) of every stride-th Gaussian
    between two poses, over those within 48 px of the screen; inf where
    one crosses the near plane."""
    pts = means[::stride]

    def uv(q, t):
        pc = pts @ R.quat_to_rot(q).T + t
        z = torch.where(pc[:, 2] > 0, pc[:, 2], torch.full_like(pc[:, 2],
                                                                1e-6))
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        on = (u > -48) & (u < cam.width + 48) & (v > -48) & (v < cam.height
                                                            + 48)
        return u, v, pc[:, 2] > R.NEAR, on
    u0, v0, m0, on0 = uv(q0, t0)
    u1, v1, m1, on1 = uv(q1, t1)
    if bool(((m0 ^ m1) & (on0 | on1)).any()):
        return math.inf
    ok = m0 & m1 & (on0 | on1)
    d = torch.maximum((u0 - u1).abs(), (v0 - v1).abs())
    return float(torch.where(ok, d, torch.zeros_like(d)).max())


class Tracker:
    """The configured tracking of consecutive frames against one map."""

    def __init__(self, m: Map, cam: R.Cam, tc: dict, isect_cap: int):
        self.m, self.cam, self.tc = m, cam, tc
        self.alive = torch.ones(m.means.shape[0], dtype=torch.bool,
                                device=m.means.device)
        self.bins = None
        self.bin_pose = None
        self.isect_cap = isect_cap

    def _rec(self, q, t):
        m = self.m
        return R.records(m.means, m.quats, m.log_scales, m.logit_op, m.rgb,
                         self.alive, q, t, self.cam)

    def track(self, q0, t0, gt_im, gt_d):
        """Returns dict(log [iters, 4] of (loss, im, depth, mask_frac), quat
        and trans of the best candidate, poses: the pose after each
        step)."""
        tc, cam = self.tc, self.cam
        dev = gt_im.device
        q = torch.as_tensor(q0, dtype=torch.float32, device=dev)
        t = torch.as_tensor(t0, dtype=torch.float32, device=dev)
        if self.bins is not None:
            drift = pixel_drift(self.m.means, *self.bin_pose, q, t, cam)
            if drift > tc["reuse_margin_px"] - tc["bin_margin_px"]:
                self.bins = None
        if self.bins is None:
            with torch.no_grad():
                rec, rad, val = self._rec(q, t)
                self.bins, n_isect = bin_capped(
                    rec, rad, val, cam, tc["max_per_tile"],
                    tc["reuse_margin_px"], self.isect_cap)
            self.bin_pose = (q, t)
            self.n_isect = n_isect
        opt = Adam([q, t], [tc["lr_quat"], tc["lr_trans"]], 1e-8)
        best = (q, t)
        best_metric = math.inf
        rows, poses = [], []
        it, cur_max, doubled = 0, tc["num_iters"], False
        while True:
            qq = q.detach().requires_grad_(True)
            tt = t.detach().requires_grad_(True)
            rec, rad, _ = self._rec(qq, tt)
            mask_fn = R.coverage_mask(rec, rad, self.bins, cam)
            img = R.render(rec.detach(), self.bins, cam, mask_fn)
            img_leaf = img.detach().requires_grad_(True)
            with torch.enable_grad():
                loss, li, ld, mf = tracking_loss(img_leaf, gt_im, gt_d, tc)
                (g_img,) = torch.autograd.grad(loss, img_leaf)
            g_rec = R.backward(rec.detach(), self.bins, cam, g_img, mask_fn)
            gq, gt_ = torch.autograd.grad(rec, (qq, tt), g_rec)
            with torch.no_grad():
                nq, nt = opt.step([qq.detach(), tt.detach()], [gq, gt_])
            row = [float(x.detach()) for x in (loss, li, ld, mf)]
            metric = row[0] / max(row[3], 1e-6)
            if metric < best_metric:
                best_metric, best = metric, (nq, nt)
            rows.append(row)
            poses.append((nq.cpu().numpy().copy(), nt.cpu().numpy().copy()))
            q, t = nq, nt
            it += 1
            if it >= cur_max:
                if (tc["use_depth_loss_thres"] and not doubled
                        and not row[2] < tc["depth_loss_thres"]):
                    cur_max, doubled = 2 * tc["num_iters"], True
                else:
                    break
        if self.n_isect > 0.75 * self.isect_cap:
            self.grow_isect(self.n_isect)
        return {"log": np.asarray(rows), "quat": best[0], "trans": best[1],
                "poses": poses}

    def grow_isect(self, n_isect):
        self.isect_cap = isect_capacity(max(int(n_isect * 1.5),
                                            self.isect_cap + ISECT_GRANULE))
        self.bins = None


def bin_capped(rec, radius, valid, cam, cap, margin_px, isect_cap):
    """bin_tiles under the intersection capacity: the Gaussian-major
    expansion keeps its first isect_cap entries. Returns (bins, demand)."""
    x0, y0, x1, y1 = R.tile_rect(rec[:, 0], rec[:, 1], radius + margin_px,
                                 cam)
    n = torch.where(valid, (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0),
                    torch.zeros_like(x0))
    total = int(n.sum())
    keep_valid = valid
    if total > isect_cap:
        # Gaussians whose entries all lie past the capacity drop out; the
        # one straddling it keeps its first entries
        first = torch.cumsum(n, 0) - n
        keep_valid = valid & (first < isect_cap)
    bins = R.bin_tiles(rec, radius, keep_valid, cam, cap=None,
                       margin_px=margin_px)
    if total > isect_cap:
        bins = _truncate_straddler(bins, rec, radius, valid, cam, margin_px,
                                   isect_cap, n)
    if cap is not None:
        bins = _cap(bins, cap)
    return bins, total


def _truncate_straddler(bins, rec, radius, valid, cam, margin_px, cap, n):
    first = torch.cumsum(n, 0) - n
    s = int(torch.nonzero(valid & (first < cap) & (first + n > cap))[0, 0]) \
        if bool((valid & (first < cap) & (first + n > cap)).any()) else -1
    if s < 0:
        return bins
    keep_n = cap - int(first[s])
    x0, y0, x1, _ = R.tile_rect(rec[s:s + 1, 0], rec[s:s + 1, 1],
                                radius[s:s + 1] + margin_px, cam)
    w = int((x1 - x0).clamp(min=1))
    local = torch.arange(keep_n, device=rec.device)
    kept = ((y0 + local // w) * cam.tiles_x + x0 + local % w)
    drop = (bins.gauss == s) & ~torch.isin(bins.tile, kept)
    g, tile = bins.gauss[~drop], bins.tile[~drop]
    T = cam.tiles_x * cam.tiles_y
    count = torch.bincount(tile, minlength=T)
    return R.Bins(g, tile, torch.cumsum(count, 0) - count, count)


def _cap(bins, cap):
    rank = torch.arange(bins.gauss.shape[0], device=bins.gauss.device) \
        - bins.start[bins.tile]
    keep = rank < cap
    g, tile = bins.gauss[keep], bins.tile[keep]
    count = torch.clamp(bins.count, max=cap)
    return R.Bins(g, tile, torch.cumsum(count, 0) - count, count)


def true_drop_frac(bins_full, cap):
    """Share of a binning's true candidates past the per-tile limit."""
    over = torch.clamp(bins_full.count - cap, min=0).sum()
    return float(over) / max(int(bins_full.count.sum()), 1)


# ------------------------------------------------------------- mapping
def first_frame_map(gt_im, gt_d, cam: R.Cam, noise):
    """The configured first-frame init: every valid-depth pixel becomes an
    isotropic Gaussian at its back-projected point (first camera frame),
    coloured by its pixel, log-scale log(z / mean(fx, fy)) + 0.01 noise,
    identity rotation, opacity 0.5."""
    H, W = gt_d.shape[-2:]
    dev = gt_d.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    z = gt_d[0]
    pts = torch.stack([(xs - cam.cx) / cam.fx * z, (ys - cam.cy) / cam.fy * z,
                       z], -1).reshape(-1, 3)
    cols = gt_im.permute(1, 2, 0).reshape(-1, 3)
    scale = z.reshape(-1) / ((cam.fx + cam.fy) / 2.0)
    ls = 0.5 * torch.log(torch.clamp(scale * scale, min=1e-12))
    ls = ls[:, None].expand(-1, 3) + 0.01 * noise
    ok = z.reshape(-1) > 0
    n = int(ok.sum())
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1
    return Map(pts[ok].contiguous(), quats, ls[ok].contiguous(),
               torch.zeros((n, 1), device=dev), cols[ok].contiguous())


def map_phase(m: Map, kf_im, kf_d, q, t, cam: R.Cam, mc: dict, isect_cap,
              gen: torch.Generator, scene_radius: float, capacity: int):
    """The first frame's mapping phase on its one keyframe: frozen capped
    tile lists and the iso term's query pool with its neighbours, both from
    the phase's start, then num_iters iterations of loss, pruning and Adam.
    `gen` continues the job's random stream after the init's draw: the
    pool's scores over the map's `capacity` rows, then each iteration's
    sample of the pool, as the configured phase draws them. Returns (map,
    alive, log [iters, 3] of (im, depth, flat), true-drop share,
    intersection demand)."""
    dev = kf_im.device
    n = m.means.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    with torch.no_grad():
        rec, rad, val = R.records(*m, alive, q, t, cam)
        full, n_isect = bin_capped(rec, rad, val, cam, None, 0.0, isect_cap)
        drop = true_drop_frac(full, mc["max_per_tile"])
        bins = _cap(full, mc["max_per_tile"])
        del full, rec
        pad = capacity - n
        alive_c = torch.cat([alive, torch.zeros(pad, dtype=torch.bool,
                                                device=dev)])
        scores = torch.rand(capacity, generator=gen, device=dev)
        scores = scores + torch.where(alive_c, 0.0, 2.0)
        pool = torch.topk(-scores, min(mc["iso_pool"], capacity)).indices
        means_c = torch.cat([m.means, torch.zeros((pad, 3), device=dev)])
        ls_c = torch.cat([m.log_scales, torch.zeros((pad, 3), device=dev)])
        nbr = knn_hash(means_c, alive_c, ls_c, means_c[pool], mc["iso_k"])
        del means_c, ls_c
    opt = Adam(list(m), mc["lrs"], 1e-15)
    rows = []
    for it in range(mc["num_iters"]):
        leaves = [p.detach().requires_grad_(True) for p in m]
        lm = Map(*leaves)
        with torch.enable_grad():
            rec, _, _ = R.records(*lm, alive, q, t, cam)
        img = R.render(rec.detach(), bins, cam)
        img_leaf = img.detach().requires_grad_(True)
        with torch.enable_grad():
            li, ld = mapping_image_loss(img_leaf, kf_im, kf_d, mc)
            (g_img,) = torch.autograd.grad(li + ld, img_leaf)
        g_rec = R.backward(rec.detach(), bins, cam, g_img)
        sel = torch.randint(0, pool.shape[0],
                            (min(mc["iso_sample"], pool.shape[0]),),
                            generator=gen, device=dev)
        with torch.enable_grad():
            fl = mc["w_flat"] * flat_loss(lm.log_scales, alive)
            # the pool may hold rows past the map (small maps): zero rows,
            # dead, as the program's capacity-shaped state holds them
            lm_c = Map(*[torch.cat([p, p.new_zeros((pad,) + p.shape[1:])])
                         for p in leaves])
            iso, _ = iso_loss(lm_c, torch.cat([alive, alive_c[n:]]),
                              pool[sel], nbr[sel])
            total = (torch.sum(rec * g_rec) + fl + mc["w_iso"] * iso)
            grads = torch.autograd.grad(total, leaves)
        rows.append([float(li.detach()), float(ld.detach()),
                     float(fl.detach())])
        with torch.no_grad():
            if it % mc["prune_every"] == 0 and it <= mc["prune_stop"]:
                op = torch.sigmoid(lm.logit_op[:, 0])
                big = (torch.exp(lm.log_scales).max(1).values
                       > 0.1 * scene_radius)
                alive = alive & ~((op < mc["prune_opacity"]) | big)
            m = Map(*opt.step(leaves, grads))
    return (Map(*[p.detach() for p in m]), alive, np.asarray(rows), drop,
            n_isect)


def densify_count(m: Map, q, t, gt_d, cam: R.Cam, cap, isect_cap,
                  sil_thres=0.5):
    """Pixels the configured silhouette densification adds at pose (q, t):
    silhouette < sil_thres, or rendered depth behind the frame's by more
    than 50 times the median error, where the frame has depth."""
    dev = gt_d.device
    alive = torch.ones(m.means.shape[0], dtype=torch.bool, device=dev)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    with torch.no_grad():
        rec, rad, val = R.records(*m, alive, q, t, cam)
        bins, _ = bin_capped(rec, rad, val, cam, cap, 0.0, isect_cap)
        img = R.render(rec, bins, cam)
    sil, rd, gd = img[5], img[3], gt_d[0]
    err = torch.abs(gd - rd) * (gd > 0)
    add = ((sil < sil_thres) | ((rd > gd) & (err > 50 * median(err)))) \
        & (gd > 0)
    return int(add.sum())
