"""A Kinect v1 depth image, the sensor of the TUM RGB-D benchmark.

From the ray-cast depth z (metres along the optical axis):
  * axial noise: z + sigma(z) e, e ~ N(0, 1) drawn from `gen`, with
    sigma(z) = a + b (z - z0)^2 (Nguyen, Izadi & Lovell, 3DIMPVT 2012:
    a = 0.0012 m, b = 0.0019 / m, z0 = 0.4 m);
  * holes (depth 0): where z lies outside the sensor's range, and on a
    band one pixel wide on each side of a depth edge, where a pixel's
    4-neighbour lies nearer or farther than edge_jump (5%) of its own z;
  * quantisation to the dataset's PNG step, 1 / png_depth_scale m (TUM
    stores depth as 16-bit PNGs at 5000 a metre).
"""
from __future__ import annotations

import torch


def holes(z: torch.Tensor, sensor: dict) -> torch.Tensor:
    """Where the sensor gives no depth: out of range or at an edge."""
    near, far = (float(v) for v in sensor["range_m"])
    jump = float(sensor["edge_jump"])
    out = (z < near) | (z > far)
    edge = torch.zeros_like(out)
    for dim in (0, 1):
        d = torch.abs(torch.diff(z, dim=dim))
        n = z.shape[dim] - 1
        lo, hi = z.narrow(dim, 0, n), z.narrow(dim, 1, n)
        edge.narrow(dim, 0, n).logical_or_(d > jump * lo)
        edge.narrow(dim, 1, n).logical_or_(d > jump * hi)
    return out | edge


def sigma(z: torch.Tensor, sensor: dict) -> torch.Tensor:
    a, b = (float(v) for v in sensor["sigma_m"])
    return a + b * (z - float(sensor["sigma_z0_m"])) ** 2


def apply(depth: torch.Tensor, sensor: dict,
          gen: torch.Generator) -> torch.Tensor:
    """The sensor's depth [H, W] for the true depth [H, W]."""
    z = depth.to(torch.float64)
    e = torch.randn(z.shape, generator=gen, device=z.device,
                    dtype=torch.float64)
    noisy = z + sigma(z, sensor) * e
    scale = float(sensor["png_depth_scale"])
    noisy = torch.round(noisy * scale) / scale
    return torch.where(holes(z, sensor), torch.zeros_like(noisy), noisy)
