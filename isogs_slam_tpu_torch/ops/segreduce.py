"""Contiguous-segment row reduction: kernel C and its plain version
(counterpart of isogs_slam_tpu/ops/segreduce.py).

out[c, n] = sum(d_exp[off[n]:off[n+1], c]), accumulated in f32 from f32 or
bf16 rows, returned planar [L, N]. The mapping backward writes each
(tile, slot) gradient row to its gaussian-major expansion position, so a
Gaussian's rows are one contiguous segment.
"""
from __future__ import annotations

import torch

from . import _cuda

LMAX = 16


def segment_reduce_rows_plain(d_exp: torch.Tensor,
                              exp_offsets: torch.Tensor) -> torch.Tensor:
    """index_add_ over repeat_interleave'd segment ids."""
    n = exp_offsets.shape[0] - 1
    offs = exp_offsets.to(torch.int64)
    lengths = offs[1:] - offs[:-1]
    end = int(offs[-1])
    seg = torch.repeat_interleave(
        torch.arange(n, device=d_exp.device), lengths, output_size=end)
    rows = d_exp[int(offs[0]):end].to(torch.float32)
    out = torch.zeros((n, d_exp.shape[1]), dtype=torch.float32,
                      device=d_exp.device)
    out.index_add_(0, seg, rows)
    return out.T.contiguous()


def segment_reduce_rows_cuda(d_exp: torch.Tensor,
                             exp_offsets: torch.Tensor) -> torch.Tensor:
    """Kernel C. d_exp [M, L] f32/bf16 must hold every row below
    exp_offsets[-1]; exp_offsets [N+1] int32 non-decreasing."""
    if d_exp.dim() != 2 or not (1 <= d_exp.shape[1] <= LMAX):
        raise ValueError(f"d_exp must be [M, L<= {LMAX}], got "
                         f"{tuple(d_exp.shape)}")
    if d_exp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"d_exp must be float32 or bfloat16, got "
                        f"{d_exp.dtype}")
    if exp_offsets.dim() != 1 or exp_offsets.dtype != torch.int32:
        raise ValueError("exp_offsets must be int32 [N+1]")
    if not (d_exp.is_cuda and exp_offsets.is_cuda):
        raise ValueError("segment_reduce_rows_cuda needs CUDA tensors")
    d_exp = d_exp.contiguous()
    exp_offsets = exp_offsets.contiguous()
    n = exp_offsets.shape[0] - 1
    L = d_exp.shape[1]
    out = torch.empty((L, n), dtype=torch.float32, device=d_exp.device)
    lib = _cuda.library("segreduce")
    err = lib.segreduce(_cuda.ptr(d_exp), int(d_exp.dtype == torch.bfloat16),
                        _cuda.ptr(exp_offsets), n, L, _cuda.ptr(out),
                        _cuda.stream_ptr())
    _cuda.check(err, "segreduce")
    _cuda.count_launch("segreduce")
    return out


def segment_reduce_rows(d_exp: torch.Tensor,
                        exp_offsets: torch.Tensor) -> torch.Tensor:
    """Planar [L, N] f32 segment sums; kernel C on CUDA tensors."""
    if d_exp.is_cuda:
        return segment_reduce_rows_cuda(d_exp, exp_offsets)
    return segment_reduce_rows_plain(d_exp, exp_offsets)
