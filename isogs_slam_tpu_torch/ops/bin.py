"""Tile binning's expansion on the card: kernel pair Q (csrc/bin.cu).

Q count writes each row's tile count, Q expand the gaussian-major
expansion's sort keys (tile << db | margin bit | quantized depth) and
int32 source rows, both forming the tile rects in registers from the
projection's (u, v), radius, valid mask and margin. The plain version is
ops/rasterize.py's eager chain (`_expand`), which runs for tensors on the
CPU, for cfg.tight_rect and in comparisons against the kernels; the keys
are equal bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def _uv_stride(proj) -> int:
    """Floats between rows of proj.u and proj.v, which must be columns of
    one float32 table (kernel P's) or contiguous vectors of one stride."""
    u, v = proj.u, proj.v
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("u and v must be float32")
    if u.stride(0) != v.stride(0):
        raise ValueError("u and v must have one row stride")
    return u.stride(0)


def _rows(proj):
    """(radius [N] int32, valid [N] bool), contiguous, held by the caller
    until the launch."""
    if proj.radius.dtype != torch.int32 or proj.valid.dtype != torch.bool:
        raise TypeError("radius must be int32 and valid bool")
    return proj.radius.contiguous(), proj.valid.contiguous()


def bin_count_cuda(proj, cam) -> torch.Tensor:
    """Q count: [N] int32 tile count of each row's binning rect (0 where
    the row is not valid)."""
    n = proj.u.shape[0]
    radius, valid = _rows(proj)
    counts = torch.empty(n, dtype=torch.int32, device=proj.u.device)
    err = _cuda.library("bin").bin_count(
        _cuda.ptr(proj.u), _cuda.ptr(proj.v), _uv_stride(proj),
        _cuda.ptr(radius), _cuda.ptr(valid), n,
        ctypes.c_float(proj.margin_px), cam.tiles_x, cam.tiles_y,
        _cuda.ptr(counts), _cuda.stream_ptr())
    _cuda.check(err, "bin_count")
    _cuda.count_launch("bin_count")
    return counts


def bin_expand_cuda(proj, cam, offs: torch.Tensor, qz: torch.Tensor,
                    db: int, tile_base: int, keys: torch.Tensor,
                    src: torch.Tensor):
    """Q expand: writes the first E = keys.shape[0] entries of the
    expansion, keys [E] int64 (offset by tile_base tiles) and src [E]
    int32. offs [N] int64 exclusive prefix of the counts, qz [N] int32
    quantized depth."""
    n = proj.u.shape[0]
    if offs.dtype != torch.int64 or qz.dtype != torch.int32:
        raise TypeError("offs must be int64 and qz int32")
    if keys.dtype != torch.int64 or src.dtype != torch.int32:
        raise TypeError("keys must be int64 and src int32")
    if not (keys.is_contiguous() and src.is_contiguous()
            and offs.is_contiguous() and qz.is_contiguous()):
        raise ValueError("keys, src, offs and qz must be contiguous")
    radius, valid = _rows(proj)
    err = _cuda.library("bin").bin_expand(
        _cuda.ptr(proj.u), _cuda.ptr(proj.v), _uv_stride(proj),
        _cuda.ptr(radius), _cuda.ptr(valid), _cuda.ptr(offs),
        _cuda.ptr(qz), n, ctypes.c_float(proj.margin_px),
        cam.tiles_x, cam.tiles_y, db, tile_base, keys.shape[0],
        _cuda.ptr(keys), _cuda.ptr(src), _cuda.stream_ptr())
    _cuda.check(err, "bin_expand")
    _cuda.count_launch("bin_expand")
