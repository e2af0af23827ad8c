"""A circle walked at step_m a frame while the heading turns by step_deg,
so the camera looks along its path (radius step_m / step_rad), pitched 6
degrees down, with a slow height bob. `rs` chooses the circle's centre on
the room's floor plan and the starting heading."""
from __future__ import annotations

import math

import numpy as np


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def path(motion: dict, n: int, rs: np.random.RandomState) -> np.ndarray:
    step = float(motion["step_m"])
    turn = math.radians(float(motion["step_deg"]))
    heading = rs.uniform(0, 2 * math.pi)
    out = np.zeros((n, 4, 4))
    radius = step / turn
    centre = np.array([rs.uniform(-0.4, 0.4), 0.0, rs.uniform(-0.3, 0.3)])
    for i in range(n):
        phi = heading + i * turn
        pos = centre + radius * np.array([math.cos(phi), 0.0,
                                          math.sin(phi)])
        pos[1] = -0.05 + 0.03 * math.sin(2 * math.pi * i / 120.0)
        # the tangent of the circle is the viewing direction
        R = _rot_y(-phi) @ _rot_x(math.radians(-6.0))
        out[i, :3, :3], out[i, :3, 3] = R, pos
    out[:, 3, 3] = 1.0
    return out
