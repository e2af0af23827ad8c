"""Carry a map state between the JAX package and the port.

Both packages use the same field names, so a state converts field by field
through numpy arrays. Nothing here imports JAX: `state_from_arrays` reads
any object with the MapState attributes whose leaves `np.asarray` accepts
(numpy arrays, or the reference's device arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .gaussians import GaussianParams, MapState


def params_from_arrays(params, device="cuda") -> GaussianParams:
    dev = resolve_device(device)
    return GaussianParams(*[
        torch.as_tensor(np.array(getattr(params, f), np.float32),
                        device=dev)
        for f in GaussianParams._fields])


def state_from_arrays(state, device="cuda") -> MapState:
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    return MapState(
        params=params_from_arrays(state.params, dev),
        alive=torch.as_tensor(np.array(state.alive, bool), device=dev),
        hwm=torch.as_tensor(int(np.asarray(state.hwm)), dtype=torch.int64,
                            device=dev),
        timestep=f32(state.timestep), max_2d_radius=f32(state.max_2d_radius),
        means2d_grad_accum=f32(state.means2d_grad_accum),
        denom=f32(state.denom), scene_radius=f32(state.scene_radius))


def state_to_arrays(state: MapState) -> dict:
    """Every field as a numpy array; params flattened under their names."""
    out = {f: getattr(state.params, f).detach().cpu().numpy()
           for f in GaussianParams._fields}
    for f in MapState._fields:
        if f != "params":
            out[f] = getattr(state, f).detach().cpu().numpy()
    return out
