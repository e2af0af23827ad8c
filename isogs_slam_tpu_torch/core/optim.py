"""Adam with torch.optim.Adam semantics and per-leaf learning rates
(counterpart of isogs_slam_tpu/core/optim.py, dense mode).

Betas (0.9, 0.999); eps 1e-8 for tracking, 1e-15 for mapping; eps added
after the sqrt of the bias-corrected second moment. The state is a plain
tuple of tensors so the SLAM loop can re-create it per frame and zero rows
of it (the opacity reset) directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    mu: tuple
    nu: tuple
    count: int


def init(params) -> AdamState:
    return AdamState(mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params),
                     count=0)


def _bias_correction(b: float, count: int, device) -> torch.Tensor:
    # 1 - b^c via expm1/log1p in f32, as the reference computes it
    c = torch.tensor(float(count), dtype=torch.float32, device=device)
    return -torch.expm1(c * torch.log1p(
        torch.tensor(b - 1.0, dtype=torch.float32, device=device)))


def step(params, grads, state: AdamState, lrs, eps: float = 1e-8,
         b1: float = 0.9, b2: float = 0.999):
    """One Adam step over the leaves of `params` (a tuple or NamedTuple);
    `lrs` holds one learning rate per leaf. Returns (new params of the
    same type, new state)."""
    count = state.count + 1
    dev = params[0].device
    bc1 = _bias_correction(b1, count, dev)
    bc2 = _bias_correction(b2, count, dev)
    mu, nu, new = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        mu.append(m)
        nu.append(v)
    out = type(params)(*new) if hasattr(params, "_fields") else tuple(new)
    return out, AdamState(mu=tuple(mu), nu=tuple(nu), count=count)
