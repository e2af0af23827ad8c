"""Carry a map state, or a whole SLAM object's state, between the JAX
package and the port.

Both packages use the same field names, so a state converts field by field
through numpy arrays. Nothing here imports JAX: `state_from_arrays` reads
any object with the MapState attributes whose leaves `np.asarray` accepts
(numpy arrays, or the reference's device arrays), and `slam_to_arrays`
reads either package's SLAM object. A checkpoint (io/checkpoints.py) is the
other way across: one written by either package loads in the other.
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


def slam_to_arrays(slam) -> dict:
    """A SLAM object's trajectory, keyframe library and map as numpy
    arrays: what `slam_from_arrays` (of this package, or any SLAM class
    with the same attributes) needs to continue from the same state."""
    kf = slam.kf
    n = len(kf)

    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    out = {"cam_rots": np.array(slam.cam_rots), "cam_trans":
           np.array(slam.cam_trans),
           "kf_time_indices": np.asarray(kf.time_indices, np.int64),
           "kf_w2cs": np.asarray(kf.w2cs, np.float64).reshape(n, 4, 4),
           "kf_colors": host(kf.colors)[:n], "kf_depths": host(kf.depths)[:n],
           "kf_quats": host(kf.quats)[:n], "kf_trans": host(kf.trans)[:n],
           "gt_w2c_all": np.asarray(slam.gt_w2c_all, np.float64
                                    ).reshape(-1, 4, 4),
           "keyframe_time_indices": np.asarray(slam.keyframe_time_indices,
                                               np.int64)}
    if slam.state is not None:
        st = slam.state
        for f in GaussianParams._fields:
            out["map_" + f] = host(getattr(st.params, f))
        for f in MapState._fields:
            if f != "params":
                out["map_" + f] = host(getattr(st, f))
    return out


class _Fields:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def slam_from_arrays(slam, arrays: dict):
    """Load `slam_to_arrays` output into a freshly constructed SLAM of this
    package: trajectory, keyframes (colours are the library's uint8,
    written back unchanged) and map, on slam.device."""
    dev = slam.device
    slam.cam_rots = np.array(arrays["cam_rots"], np.float32)
    slam.cam_trans = np.array(arrays["cam_trans"], np.float32)
    slam.gt_w2c_all = [np.asarray(g) for g in arrays["gt_w2c_all"]]
    slam.keyframe_time_indices = [int(t) for t in
                                  arrays["keyframe_time_indices"]]
    kf = slam.kf
    n = len(arrays["kf_time_indices"])
    assert n <= kf.max_keyframes, "keyframe overflow"
    kf.time_indices = [int(t) for t in arrays["kf_time_indices"]]
    kf.w2cs = [np.asarray(w) for w in arrays["kf_w2cs"]]
    kf.colors[:n] = torch.as_tensor(np.array(arrays["kf_colors"]),
                                    device=dev)
    kf.depths[:n] = torch.as_tensor(np.array(arrays["kf_depths"]),
                                    device=dev)
    kf.quats[:n] = torch.as_tensor(np.array(arrays["kf_quats"]), device=dev)
    kf.trans[:n] = torch.as_tensor(np.array(arrays["kf_trans"]), device=dev)
    if "map_alive" in arrays:
        params = _Fields(**{f: arrays["map_" + f]
                            for f in GaussianParams._fields})
        slam.state = state_from_arrays(
            _Fields(params=params, **{f: arrays["map_" + f]
                                      for f in MapState._fields
                                      if f != "params"}), dev)
        slam._map_changed()
        slam._init_isect_cap()
    return slam
