"""A handheld sweep around a desk, at the TUM RGB-D benchmark's fr1/desk
speeds (Sturm et al., IROS 2012: 0.413 m/s and 23.33 deg/s, which at 30 Hz
is step_m = 0.0138 m and step_deg = 0.78 deg a frame).

The camera walks sideways while it turns towards the side it walks from,
so it keeps looking at a point about step_m / step_rad (1 m) in front of
it: a slowly curving walk. Each frame's step and turn are the means
scaled by factors drawn uniformly in `jitter` (0.7-1.3) from the start's
stream, so the path's radius wanders frame by frame. The turn is mostly
yaw, with a pitch part that swings slowly up and down (a weight of
pitch_share against 1 for the yaw, on a period of pitch_period frames).
`rs` chooses where the camera starts on the room's floor plan, its
heading, how far it looks down, the sweep's direction and the pitch's
phase; it then draws the factors, two a frame, in frame order."""
from __future__ import annotations

import math

import numpy as np


def _axis_angle(axis, angle):
    """Rotation matrix about the unit vector `axis` by `angle` radians."""
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def path(motion: dict, n: int, rs: np.random.RandomState) -> np.ndarray:
    step = float(motion["step_m"])
    turn = math.radians(float(motion["step_deg"]))
    lo, hi = (float(v) for v in motion["jitter"])
    share = float(motion["pitch_share"])
    period = float(motion["pitch_period"])
    heading = rs.uniform(0, 2 * math.pi)
    look_down = math.radians(rs.uniform(8.0, 16.0))
    pos = np.array([rs.uniform(-0.8, 0.8), rs.uniform(-0.15, 0.05),
                    rs.uniform(-0.5, 0.5)])
    side = 1.0 if rs.uniform() < 0.5 else -1.0
    phase = rs.uniform(0, 2 * math.pi)
    # camera axes in the room: x right, y down (as the room's y), z forward
    c, s = math.cos(heading), math.sin(heading)
    yaw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    R = yaw @ _axis_angle((1.0, 0.0, 0.0), -look_down)
    out = np.zeros((n, 4, 4))
    for i in range(n):
        if i > 0:
            f_step, f_turn = rs.uniform(lo, hi, size=2)
            pitch = share * math.sin(2 * math.pi * i / period + phase)
            axis = np.array([pitch, side, 0.0])
            R = R @ _axis_angle(axis / np.linalg.norm(axis),
                                turn * f_turn)
            # walk against the turn, so the view swings about a point ahead
            right = R[:, 0] - R[1, 0] * np.array([0.0, 1.0, 0.0])
            pos = pos - side * step * f_step * right / np.linalg.norm(right)
        out[i, :3, :3], out[i, :3, 3] = R, pos
    out[:, 3, 3] = 1.0
    return out
