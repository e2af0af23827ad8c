"""Adam with torch.optim.Adam semantics and per-leaf learning rates
(counterpart of isogs_slam_tpu/core/optim.py), dense and lazy (per row).

Betas (0.9, 0.999); eps 1e-8 for tracking, 1e-15 for mapping; eps added
after the sqrt of the bias-corrected second moment. The state is a plain
tuple of tensors so the SLAM loop can re-create it per frame and zero rows
of it (the opacity reset) directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import spans


class AdamState(NamedTuple):
    mu: tuple
    nu: tuple
    count: int
    # lazy mode only: per-row step counts, one [N, 1] int32 tensor per
    # leaf. None = dense torch semantics (every row steps every call, rows
    # with a zero gradient included).
    rcount: tuple | None = None


def init(params, lazy: bool = False) -> AdamState:
    rc = (tuple(torch.zeros((p.shape[0], 1), dtype=torch.int32,
                            device=p.device) for p in params)
          if lazy else None)
    return AdamState(mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params),
                     count=0, rcount=rc)


def _bias_correction(b: float, count, device) -> torch.Tensor:
    """1 - b^count via expm1/log1p in f32, as the reference computes it;
    count is a host number or a tensor of per-row counts."""
    # host numbers copied to the card: each blocking copy waits for its
    # queue
    with spans.span("sync.adam_bias"):
        c = torch.as_tensor(count, device=device).to(torch.float32)
        b_1 = torch.tensor(b - 1.0, dtype=torch.float32, device=device)
    return -torch.expm1(c * torch.log1p(b_1))


def step(params, grads, state: AdamState, lrs, eps: float = 1e-8,
         b1: float = 0.9, b2: float = 0.999):
    """One Adam step over the leaves of `params` (a tuple or NamedTuple);
    `lrs` holds one learning rate per leaf. Returns (new params of the
    same type, new state).

    Lazy mode (state from init(..., lazy=True); every leaf [N, C]): a row
    updates its moments, its parameter and its own bias-correction count
    only on calls where that leaf's gradient row is non-zero, so a row the
    mapping stripe did not render takes no pure-momentum step."""
    count = state.count + 1
    dev = params[0].device
    if state.rcount is not None:
        return _step_lazy(params, grads, state, lrs, eps, b1, b2)
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


def _step_lazy(params, grads, state: AdamState, lrs, eps, b1, b2):
    dev = params[0].device
    mu, nu, new, rcount = [], [], [], []
    for p, g, m, v, rc, lr in zip(params, grads, state.mu, state.nu,
                                  state.rcount, lrs):
        t = torch.any(g != 0, dim=1, keepdim=True)
        rc = rc + t.to(rc.dtype)
        m = torch.where(t, b1 * m + (1 - b1) * g, m)
        v = torch.where(t, b2 * v + (1 - b2) * g * g, v)
        c = torch.clamp(rc, min=1)
        bc1 = _bias_correction(b1, c, dev)
        bc2 = _bias_correction(b2, c, dev)
        new.append(torch.where(
            t, p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), p))
        mu.append(m)
        nu.append(v)
        rcount.append(rc)
    out = type(params)(*new) if hasattr(params, "_fields") else tuple(new)
    return out, AdamState(mu=tuple(mu), nu=tuple(nu), count=state.count + 1,
                          rcount=tuple(rcount))


def mask_rows(state: AdamState, keep_order: torch.Tensor) -> AdamState:
    """Row-gather the moments (and the lazy per-row counts) by
    keep_order, as compaction reorders the map's rows."""
    def g(leaves):
        return tuple(a[keep_order] if a.ndim >= 1 else a for a in leaves)
    return AdamState(mu=g(state.mu), nu=g(state.nu), count=state.count,
                     rcount=None if state.rcount is None
                     else g(state.rcount))


def zero_rows(state: AdamState, rows: torch.Tensor) -> AdamState:
    """Zero the moments of the rows where the bool mask `rows` [N] is set
    (a parameter replaced wholesale, as the opacity reset does). The lazy
    per-row counts are kept: the first step after the reset is
    bias-corrected as a warm step, as torch keeps its global step."""
    def z(leaves):
        out = []
        for a in leaves:
            if a.ndim >= 1 and a.shape[0] == rows.shape[0]:
                a = torch.where(rows.reshape((-1,) + (1,) * (a.ndim - 1)),
                                torch.zeros_like(a), a)
            out.append(a)
        return tuple(out)
    return AdamState(mu=z(state.mu), nu=z(state.nu), count=state.count,
                     rcount=state.rcount)
