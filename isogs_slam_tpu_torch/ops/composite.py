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
the CPU, and in comparisons against the kernels.
"""
from __future__ import annotations

import torch

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


def _composite_chunk(g, cnt, ox, oy, F: int, sq_col):
    """One chunk of tiles. g [c, K, 6+F]; cnt [c]; ox, oy [c] pixel
    origins. Returns ([c, P, F(+1)], [c, P])."""
    K = g.shape[1]
    dev, dt = g.device, g.dtype
    u, v, A, B, Cc, op = (g[..., i] for i in range(6))
    feat = g[..., 6:6 + F]
    if sq_col is not None:
        z = g[..., 6 + sq_col:7 + sq_col]
        feat = torch.cat([feat, z * z], dim=-1)
    px = torch.arange(TILE, dtype=dt, device=dev)
    pxs = px.repeat(TILE)                       # x within tile, [P]
    pys = px.repeat_interleave(TILE)            # y within tile
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
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - a
    # exclusive cumulative transmittance (1 - a >= 0.01, so the division
    # is exact in form)
    t_excl = torch.cumprod(one_minus, dim=1) / one_minus
    include = (contrib & (t_excl * one_minus >= T_EPS)).detach()
    w = torch.where(include, a * t_excl, torch.zeros_like(a))
    out = torch.einsum("ckp,ckf->cpf", w, feat)
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
    _cuda.count_launch(f"composite_fwd[K={K}]")
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
    _cuda.count_launch(f"composite_bwd[K={K}]")
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
        dg = composite_backward(
            gdata, counts, gout, dfinal, saved or None, F, tiles_x, sq_col,
            torch.bfloat16 if bwd_bf16 else torch.float32, chunk)
        # the cotangent crosses the Function boundary in gdata's dtype
        return dg.to(gdata.dtype), None, None, None, None, None, None


def composite_tiles(gdata, counts, F: int, tiles_x: int, sq_col=None,
                    bwd_bf16: bool = False, chunk: int = 256):
    """Differentiable (wrt gdata) compositing: (out [T, P, F(+1)],
    final_T [T, P]). bwd_bf16 emits kernel B's output in bf16 (the
    boundary cotangent stays f32)."""
    return _CompositeTiles.apply(gdata, counts, F, tiles_x, sq_col,
                                 bwd_bf16, chunk)
