"""Gaussian-window SSIM for the mapping loss, MS-SSIM and PSNR for eval
(counterpart of isogs_slam_tpu/ops/ssim.py).

11x11 window, sigma 1.5, SAME zero padding, per channel. The separable
filter runs as two dense band-matrix products in true f32 (the package
disables TF32 on import; a TF32 filter would bias the variance terms).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _band_matrix_np(n: int, window_size: int, sigma: float, pad_lo: int,
                    pad_hi: int) -> np.ndarray:
    """1D gaussian filter as a band matrix [n_out, n] under
    (pad_lo, pad_hi) zero padding."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    n_out = n + pad_lo + pad_hi - window_size + 1
    m = np.zeros((n_out, n), np.float32)
    for i in range(n_out):
        for t in range(window_size):
            j = i - pad_lo + t
            if 0 <= j < n:
                m[i, j] = g[t]
    return m


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, window_size: int, sigma: float, pad: int,
                 device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_band_matrix_np(n, window_size, sigma, pad, pad),
                           device=device)


def _depthwise_filter(img: torch.Tensor, window_size: int = 11,
                      sigma: float = 1.5) -> torch.Tensor:
    """[..., H, W] -> per-channel 2D gaussian filter, SAME zero padding."""
    H, W = img.shape[-2], img.shape[-1]
    pad = window_size // 2
    gv = _band_matrix(H, window_size, sigma, pad, img.device)
    gh = _band_matrix(W, window_size, sigma, pad, img.device)
    return torch.matmul(torch.matmul(gv, img), gh.T)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-position SSIM over [..., H, W] images in [0, 1]."""
    f = _depthwise_filter(torch.stack([img1, img2, img1 * img1, img2 * img2,
                                       img1 * img2]), window_size)
    mu1, mu2 = f[0], f[1]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f[2] - mu1_sq
    s2 = f[3] - mu2_sq
    s12 = f[4] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu12 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    return ssim_map(img1, img2, window_size).mean()


calc_ssim = ssim  # reference-name alias


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _valid_filter(img: torch.Tensor, window_size: int,
                  sigma: float = 1.5) -> torch.Tensor:
    """[..., H, W] -> per-channel 2D gaussian filter without padding."""
    H, W = img.shape[-2], img.shape[-1]
    gv = _band_matrix(H, window_size, sigma, 0, img.device)
    gh = _band_matrix(W, window_size, sigma, 0, img.device)
    return torch.matmul(torch.matmul(gv, img), gh.T)


@torch.no_grad()
def ms_ssim(img1, img2, window_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM over [C, H, W] in [0, 1] (pytorch_msssim semantics:
    valid-padding gaussian filter, 2x2 mean pool between scales, contrast
    sensitivity at the coarse scales, relu-clamped). The scale count is
    reduced (weights renormalized) for images smaller than the five-scale
    pyramid needs.

    Computed in f32 whatever the input dtype, with true-f32 filter products
    (the package turns TF32 off): the variance terms E[x^2] - mu^2 cancel,
    and a reduced-precision filter biases the cs ratios upward, past 1.0."""
    img1 = torch.as_tensor(img1).to(torch.float32)
    img2 = torch.as_tensor(img2).to(torch.float32)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smaller = min(img1.shape[-2], img1.shape[-1])
    n_scales = 1
    while (n_scales < len(_MSSSIM_WEIGHTS)
           and smaller // (2 ** n_scales) >= window_size):
        n_scales += 1

    vals = []
    a, b = img1, img2
    for i in range(n_scales):
        f = _valid_filter(torch.stack([a, b, a * a, b * b, a * b]),
                          window_size)
        mu1, mu2 = f[0], f[1]
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = f[2] - mu1_sq
        s2 = f[3] - mu2_sq
        s12 = f[4] - mu12
        cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
        if i == n_scales - 1:
            vals.append((((2 * mu12 + c1) * (2 * s12 + c2))
                         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean())
        else:
            vals.append(cs_map.mean())
            a = F.avg_pool2d(a[None], 2)[0]
            b = F.avg_pool2d(b[None], 2)[0]
    vals = torch.relu(torch.stack(vals))
    weights = torch.tensor(_MSSSIM_WEIGHTS[:n_scales], dtype=torch.float32,
                           device=vals.device)
    weights = weights / weights.sum()
    return torch.prod(vals ** weights)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR: mean over the per-channel 20 log10(1 / sqrt(mse))."""
    mse = ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()
