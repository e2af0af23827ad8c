"""Per-tile front-to-back alpha compositing: kernels A (forward) and B
(backward), their plain PyTorch versions, and the autograd Function
(counterpart of isogs_slam_tpu/ops/pallas_composite.py).

gdata [T, K, 6+F] holds per-slot records (absolute-pixel u, v, conic A B C,
opacity, F features) in depth order; counts [T] the valid slots per tile.
Tile t's pixel origin is ((t % tiles_x) * 16, (t // tiles_x) * 16) and
pixel p of a tile is (p % 16, p // 16) from it. `sq_col` appends the square
of feature sq_col as an extra output channel (the z^2 channel), whose
cotangent folds back into that feature.

On a CUDA tensor every entry point launches the kernel from
csrc/composite.cu (or raises); the plain versions run only for tensors on
the CPU, and in comparisons against the kernels. `composite_bwd_moments`
is the backward kernel's own algebra in plain PyTorch, for tests.
"""
from __future__ import annotations

import torch

from ..utils import spans
from . import _cuda

TILE = 16
P = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def _out_width(F: int, sq_col) -> int:
    return F + (0 if sq_col is None else 1)


def _check(gdata: torch.Tensor, counts: torch.Tensor, F: int, sq_col):
    if gdata.dim() != 3 or gdata.shape[2] != 6 + F:
        raise ValueError(f"gdata must be [T, K, {6 + F}], got "
                         f"{tuple(gdata.shape)}")
    if gdata.dtype != torch.float32:
        raise TypeError(f"gdata must be float32, got {gdata.dtype}")
    if counts.shape != (gdata.shape[0],) or counts.dtype != torch.int32:
        raise ValueError("counts must be int32 [T]")
    if counts.device != gdata.device:
        raise ValueError("gdata and counts must be on one device")
    if not (1 <= F <= 4):
        raise ValueError(f"the CUDA kernels take 1..4 features, got {F}")
    if sq_col is not None and not (0 <= sq_col < F):
        raise ValueError(f"sq_col {sq_col} out of range for {F} features")


# ---------------------------------------------------------------------------
# plain versions (the reference's fused-XLA _composite_chunk formulation)


def _tile_pixels(dev, dt):
    """x and y of a tile's P pixels from the tile's origin, [P] each."""
    px = torch.arange(TILE, dtype=dt, device=dev)
    return px.repeat(TILE), px.repeat_interleave(TILE)


def _pair_alpha(g, cnt, ox, oy):
    """Per (slot, pixel) pair of a chunk of tiles: power, clamped alpha and
    the contribution mask, [c, K, P] each."""
    K = g.shape[1]
    dev, dt = g.device, g.dtype
    u, v, A, B, Cc, op = (g[..., i] for i in range(6))
    pxs, pys = _tile_pixels(dev, dt)
    pix_x = ox.to(dt)[:, None] + pxs[None, :]   # [c, P]
    pix_y = oy.to(dt)[:, None] + pys[None, :]
    dx = u[:, :, None] - pix_x[:, None, :]      # [c, K, P]
    dy = v[:, :, None] - pix_y[:, None, :]
    power = (-0.5 * (A[:, :, None] * dx * dx + Cc[:, :, None] * dy * dy)
             - B[:, :, None] * dx * dy)
    alpha = torch.clamp(op[:, :, None] * torch.exp(power), max=ALPHA_MAX)
    slot_valid = (torch.arange(K, device=dev)[None, :]
                  < cnt[:, None].to(torch.int64))
    contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & slot_valid[:, :, None]
    return power, alpha, contrib


def _slot_features(g, F: int, sq_col):
    feat = g[..., 6:6 + F]
    if sq_col is not None:
        z = g[..., 6 + sq_col:7 + sq_col]
        feat = torch.cat([feat, z * z], dim=-1)
    return feat


def _transmittance(alpha, contrib):
    """(a, 1 - a, T_excl, include) of the front-to-back recurrence; a is
    alpha on contributing pairs and 0 elsewhere."""
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - a
    # exclusive cumulative transmittance (1 - a >= 0.01, so the division
    # is exact in form)
    t_excl = torch.cumprod(one_minus, dim=1) / one_minus
    include = (contrib & (t_excl * one_minus >= T_EPS)).detach()
    return a, one_minus, t_excl, include


def _composite_chunk(g, cnt, ox, oy, F: int, sq_col):
    """One chunk of tiles. g [c, K, 6+F]; cnt [c]; ox, oy [c] pixel
    origins. Returns ([c, P, F(+1)], [c, P])."""
    _, alpha, contrib = _pair_alpha(g, cnt, ox, oy)
    a, _, t_excl, include = _transmittance(alpha, contrib)
    w = torch.where(include, a * t_excl, torch.zeros_like(a))
    out = torch.einsum("ckp,ckf->cpf", w, _slot_features(g, F, sq_col))
    return out, 1.0 - torch.sum(w, dim=1)


def _chunks(T: int, chunk: int):
    for s in range(0, T, chunk):
        yield s, min(s + chunk, T)


def _origins(T: int, tiles_x: int, device):
    tid = torch.arange(T, device=device)
    return (tid % tiles_x) * TILE, (tid // tiles_x) * TILE


def _used_slots(counts) -> int:
    """Slots a chunk of tiles uses: the slots at or past every tile's
    count contribute nothing and get a zero gradient, so the plain versions
    skip them."""
    return int(counts.max()) if counts.numel() else 0


def composite_fwd_plain(gdata, counts, F: int, tiles_x: int, sq_col=None,
                        chunk: int = 256):
    """Plain version of kernel A: (out [T, P, F(+1)], final_T [T, P])."""
    T = gdata.shape[0]
    ox, oy = _origins(T, tiles_x, gdata.device)
    outs, fts = [], []
    for s, e in _chunks(T, chunk):
        k = _used_slots(counts[s:e])
        o, f = _composite_chunk(gdata[s:e, :k], counts[s:e], ox[s:e],
                                oy[s:e], F, sq_col)
        outs.append(o)
        fts.append(f)
    if not outs:
        return (gdata.new_zeros((0, P, _out_width(F, sq_col))),
                gdata.new_zeros((0, P)))
    return torch.cat(outs), torch.cat(fts)


def composite_bwd_plain(gdata, counts, gout, dfinal, F: int, tiles_x: int,
                        sq_col=None, out_dtype=torch.float32,
                        chunk: int = 256):
    """Plain version of kernel B: d gdata [T, K, 6+F] by autograd through
    the plain forward, one chunk of tiles at a time."""
    T = gdata.shape[0]
    ox, oy = _origins(T, tiles_x, gdata.device)
    parts = []
    for s, e in _chunks(T, chunk):
        k = _used_slots(counts[s:e])
        dg = gdata.new_zeros((e - s,) + gdata.shape[1:])
        if k:
            with torch.enable_grad():
                g = gdata[s:e, :k].detach().requires_grad_(True)
                o, f = _composite_chunk(g, counts[s:e], ox[s:e], oy[s:e], F,
                                        sq_col)
                (dg[:, :k],) = torch.autograd.grad(
                    (o, f), (g,), (gout[s:e], dfinal[s:e]))
        parts.append(dg.to(out_dtype))
    if not parts:
        return torch.zeros(gdata.shape, dtype=out_dtype, device=gdata.device)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# kernel B's algebra in plain PyTorch (tests and the card check only): the
# block cull, the exp-free reject test and the sums over a tile's pixels in
# tile-local coordinates, as csrc/composite.cu forms them

PMIN_MARGIN = 1e-3
CULL_REL = 1e-5
BW, BH = 8, 4            # the block of pixels one warp owns


def prereject_contrib(power, alpha, contrib, op):
    """The contribution mask as the kernels take it: a pair is rejected
    without its exponential where power < log(1/255 / op) - margin, and
    tested on alpha as the plain version does otherwise. op <= 0 gives
    +inf or NaN, and the comparison is then false."""
    pmin = torch.log(ALPHA_MIN / op) - PMIN_MARGIN
    return contrib & (power >= pmin[:, :, None])


def block_cull_pass(g, ox, oy):
    """[c, K, P] bool: may slot k contribute to any pixel of the 8x4 block
    that holds pixel p? The kernels walk a slot only for the blocks that
    pass. Conservative: the largest `power` over the continuous block
    against pmin, with slack for rounding. `power` is concave with its top
    at the slot's centre, so over the block it is largest at the centre if
    that is inside, else on an edge that faces the centre. A conic that is
    not positive definite passes."""
    dt = g.dtype
    u, v, A, B, Cc, op = (g[..., i, None] for i in range(6))   # [c, K, 1]
    hA, hC = -0.5 * A, -0.5 * Cc
    pmin = torch.log(ALPHA_MIN / op) - PMIN_MARGIN
    bx = torch.arange(0, TILE, BW, dtype=dt, device=g.device).repeat(
        TILE // BH)
    by = torch.arange(0, TILE, BH, dtype=dt,
                      device=g.device).repeat_interleave(TILE // BW)
    x0 = ox.to(dt)[:, None, None] + bx          # [c, 1, blocks]
    y0 = oy.to(dt)[:, None, None] + by
    dx0, dx1 = u - (x0 + (BW - 1)), u - x0
    dy0, dy1 = v - (y0 + (BH - 1)), v - y0

    def f(dx, dy):
        return (hA * dx * dx + hC * dy * dy) - B * dx * dy

    def clamp(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    zero = torch.zeros_like(dx0)
    ex, ey = clamp(zero, dx0, dx1), clamp(zero, dy0, dy1)
    m = torch.maximum(f(ex, clamp(0.5 * B / hC * ex, dy0, dy1)),
                      f(clamp(0.5 * B / hA * ey, dx0, dx1), ey))
    mag = -(hA * torch.maximum(dx0 * dx0, dx1 * dx1)
            + hC * torch.maximum(dy0 * dy0, dy1 * dy1))
    definite = (hA < 0) & (hC < 0) & (B * B < 4.0 * hA * hC)
    ok = (m >= pmin - CULL_REL * mag) | ~definite             # [c, K, 8]
    pxs, pys = _tile_pixels(g.device, torch.int64)
    block_of = (pys // BH) * (TILE // BW) + pxs // BW           # [P]
    return ok[:, :, block_of]


def _bwd_moments_chunk(g, cnt, ox, oy, gout, dfinal, F: int, sq_col):
    dt = g.dtype
    u, v, A, B, Cc, op = (g[..., i] for i in range(6))
    power, alpha, contrib = _pair_alpha(g, cnt, ox, oy)
    contrib = (prereject_contrib(power, alpha, contrib, op)
               & block_cull_pass(g, ox, oy))
    a, one_minus, t_excl, include = _transmittance(alpha, contrib)
    w = torch.where(include, a * t_excl, torch.zeros_like(a))
    # the two per-pair scalars: w and dpower
    gw = (torch.einsum("ckf,cpf->ckp", _slot_features(g, F, sq_col), gout)
          - dfinal[:, None, :])
    gww = gw * w
    suffix = torch.flip(torch.cumsum(torch.flip(gww, (1,)), 1), (1,)) - gww
    da = gw * t_excl - suffix / one_minus
    dpower = torch.where(include & (alpha < ALPHA_MAX), da * alpha,
                         torch.zeros_like(da))
    # the 11 sums over a tile's pixels
    pxs, pys = _tile_pixels(g.device, dt)
    xl, yl = pxs - 7.5, pys - 7.5
    phi = torch.stack([torch.ones_like(xl), xl, yl, xl * xl, xl * yl,
                       yl * yl], dim=1)                     # [P, 6]
    m = torch.einsum("ckp,pm->ckm", dpower, phi)
    gsum = torch.einsum("ckp,cpf->ckf", w, gout)
    # the ten columns from the sums and the slot record
    ut = (u - ox.to(dt)[:, None]) - 7.5
    vt = (v - oy.to(dt)[:, None]) - 7.5
    m0, m1, m2, m3, m4, m5 = (m[..., i] for i in range(6))
    sdx = ut * m0 - m1
    sdy = vt * m0 - m2
    sxx = ut * (sdx - m1) + m3
    syy = vt * (sdy - m2) + m5
    sxy = ut * sdy + (m4 - vt * m1)
    dop = torch.where(op > 0, m0 / op, torch.zeros_like(m0))
    dfeat = gsum[..., :F].clone()
    if sq_col is not None:
        dfeat[..., sq_col] += 2.0 * g[..., 6 + sq_col] * gsum[..., F]
    cols = torch.stack([-A * sdx - B * sdy, -Cc * sdy - B * sdx, -0.5 * sxx,
                        -sxy, -0.5 * syy, dop], dim=-1)
    return torch.cat([cols, dfeat], dim=-1)


def composite_bwd_moments(gdata, counts, gout, dfinal, F: int, tiles_x: int,
                          sq_col=None, out_dtype=torch.float32,
                          chunk: int = 256):
    """d gdata [T, K, 6+F] formed the way kernel B forms it (no autograd):
    the same function as composite_bwd_plain."""
    T = gdata.shape[0]
    ox, oy = _origins(T, tiles_x, gdata.device)
    dg = torch.zeros(gdata.shape, dtype=out_dtype, device=gdata.device)
    with torch.no_grad():
        for s, e in _chunks(T, chunk):
            k = _used_slots(counts[s:e])
            if k:
                dg[s:e, :k] = _bwd_moments_chunk(
                    gdata[s:e, :k], counts[s:e], ox[s:e], oy[s:e], gout[s:e],
                    dfinal[s:e], F, sq_col).to(out_dtype)
    return dg


# ---------------------------------------------------------------------------
# kernel wrappers


def composite_fwd_cuda(gdata, counts, F: int, tiles_x: int, sq_col=None):
    """Kernel A. Returns (out [T, P, F(+1)], final_T [T, P], last [T, P]
    int32 index of each pixel's last included slot (-1: none), T_end
    [T, P] transmittance after it) — the last two feed kernel B."""
    _check(gdata, counts, F, sq_col)
    if not gdata.is_cuda:
        raise ValueError("composite_fwd_cuda needs CUDA tensors")
    gdata = gdata.contiguous()
    counts = counts.contiguous()
    T, K, _ = gdata.shape
    dev = gdata.device
    out = torch.empty((T, P, _out_width(F, sq_col)), dtype=torch.float32,
                      device=dev)
    final_t = torch.empty((T, P), dtype=torch.float32, device=dev)
    last = torch.empty((T, P), dtype=torch.int32, device=dev)
    tend = torch.empty((T, P), dtype=torch.float32, device=dev)
    lib = _cuda.library("composite")
    err = lib.composite_fwd(
        _cuda.ptr(gdata), _cuda.ptr(counts), T, K, F,
        -1 if sq_col is None else sq_col, tiles_x, _cuda.ptr(out),
        _cuda.ptr(final_t), _cuda.ptr(last), _cuda.ptr(tend),
        _cuda.stream_ptr())
    _cuda.check(err, "composite_fwd")
    _cuda.count_launch(f"composite_fwd[T={T},K={K}]")
    return out, final_t, last, tend


def composite_bwd_cuda(gdata, counts, gout, dfinal, last, tend, F: int,
                       tiles_x: int, sq_col=None, out_dtype=torch.float32):
    """Kernel B: d gdata [T, K, 6+F] in out_dtype (f32 or bf16) from the
    output cotangents gout [T, P, F(+1)] and d final_T [T, P]."""
    _check(gdata, counts, F, sq_col)
    T, K, C = gdata.shape
    Fo = _out_width(F, sq_col)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("out_dtype must be float32 or bfloat16")
    for name, x, shape, dt in (("gout", gout, (T, P, Fo), torch.float32),
                               ("dfinal", dfinal, (T, P), torch.float32),
                               ("last", last, (T, P), torch.int32),
                               ("tend", tend, (T, P), torch.float32)):
        if x.shape != shape or x.dtype != dt or not x.is_cuda:
            raise ValueError(f"{name} must be CUDA {dt} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    gdata, counts, gout, dfinal = (x.contiguous() for x in
                                   (gdata, counts, gout, dfinal))
    dg = torch.empty((T, K, C), dtype=out_dtype, device=gdata.device)
    lib = _cuda.library("composite")
    err = lib.composite_bwd(
        _cuda.ptr(gdata), _cuda.ptr(counts), T, K, F,
        -1 if sq_col is None else sq_col, tiles_x, _cuda.ptr(gout),
        _cuda.ptr(dfinal), _cuda.ptr(last.contiguous()),
        _cuda.ptr(tend.contiguous()), int(out_dtype == torch.bfloat16),
        _cuda.ptr(dg), _cuda.stream_ptr())
    _cuda.check(err, "composite_bwd")
    _cuda.count_launch(f"composite_bwd[T={T},K={K}]")
    return dg


def composite_forward(gdata, counts, F: int, tiles_x: int, sq_col=None,
                      chunk: int = 256):
    """Forward dispatch: (out, final_T, saved) with `saved` what
    composite_backward needs besides gdata/counts (kernel A's per-pixel
    termination state on CUDA, None for the plain version)."""
    if gdata.is_cuda:
        out, final_t, last, tend = composite_fwd_cuda(gdata, counts, F,
                                                      tiles_x, sq_col)
        return out, final_t, (last, tend)
    _check(gdata, counts, F, sq_col)
    out, final_t = composite_fwd_plain(gdata, counts, F, tiles_x, sq_col,
                                       chunk)
    return out, final_t, None


def composite_backward(gdata, counts, gout, dfinal, saved, F: int,
                       tiles_x: int, sq_col=None, out_dtype=torch.float32,
                       chunk: int = 256):
    if gdata.is_cuda:
        last, tend = saved
        return composite_bwd_cuda(gdata, counts, gout.float(),
                                  dfinal.float(), last, tend, F, tiles_x,
                                  sq_col, out_dtype)
    return composite_bwd_plain(gdata, counts, gout, dfinal, F, tiles_x,
                               sq_col, out_dtype, chunk)


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gdata, counts, F, tiles_x, sq_col, bwd_bf16, chunk):
        out, final_t, saved = composite_forward(gdata, counts, F, tiles_x,
                                                sq_col, chunk)
        ctx.save_for_backward(gdata, counts,
                              *(saved if saved is not None else ()))
        ctx.args = (F, tiles_x, sq_col, bwd_bf16, chunk)
        return out, final_t

    @staticmethod
    def backward(ctx, gout, dfinal):
        gdata, counts, *saved = ctx.saved_tensors
        F, tiles_x, sq_col, bwd_bf16, chunk = ctx.args
        with spans.fine("render.composite_bwd"):
            dg = composite_backward(
                gdata, counts, gout, dfinal, saved or None, F, tiles_x,
                sq_col, torch.bfloat16 if bwd_bf16 else torch.float32, chunk)
        # the cotangent crosses the Function boundary in gdata's dtype
        return dg.to(gdata.dtype), None, None, None, None, None, None


def composite_tiles(gdata, counts, F: int, tiles_x: int, sq_col=None,
                    bwd_bf16: bool = False, chunk: int = 256):
    """Differentiable (wrt gdata) compositing: (out [T, P, F(+1)],
    final_T [T, P]). bwd_bf16 emits kernel B's output in bf16 (the
    boundary cotangent stays f32)."""
    return _CompositeTiles.apply(gdata, counts, F, tiles_x, sq_col,
                                 bwd_bf16, chunk)
