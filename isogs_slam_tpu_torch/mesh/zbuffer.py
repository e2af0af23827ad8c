"""Headless software z-buffer depth rendering of triangle meshes
(counterpart of isogs_slam_tpu/mesh/zbuffer.py), in PyTorch on an explicit
device: perspective projection, per-face bounded pixel footprint,
perspective-correct barycentric depth, scatter-min depth buffer.

Marching-tetrahedra meshes have near-uniform triangle sizes (~1 voxel edge
-> a few pixels), so each face rasterizes a capped `cap` x `cap` pixel
window anchored at its screen bbox; faces larger than the cap are filled
partially and counted. The depth buffer is a minimum, which does not
depend on the order of the writes, so the depth is repeatable.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

NEAR = 0.01


def _raster_chunk(tri_uvz: torch.Tensor, zbuf: torch.Tensor, width: int,
                  height: int, cap: int):
    """tri_uvz [F, 3, 3] per-face (u, v, z) screen vertices; zbuf [H*W+1]
    running min depth (sentinel row last), updated in place. Returns the
    number of faces wider than `cap` pixels (a 0-d tensor)."""
    u = tri_uvz[:, :, 0]
    v = tri_uvz[:, :, 1]
    z = tri_uvz[:, :, 2]
    ok = torch.all(z > NEAR, dim=1)           # no near-plane clipping
    x0 = torch.floor(torch.min(u, dim=1).values).int()
    y0 = torch.floor(torch.min(v, dim=1).values).int()
    x1 = torch.ceil(torch.max(u, dim=1).values).int()
    y1 = torch.ceil(torch.max(v, dim=1).values).int()
    overflow = ok & ((x1 - x0 >= cap) | (y1 - y0 >= cap))
    x0 = torch.clamp(x0, 0, width - 1)
    y0 = torch.clamp(y0, 0, height - 1)

    k = torch.arange(cap * cap, dtype=torch.int32, device=tri_uvz.device)
    px = x0[:, None] + k[None, :] % cap                       # [F, cap^2]
    py = y0[:, None] + k[None, :] // cap
    fx = px.float()
    fy = py.float()

    ax, ay = u[:, 0:1], v[:, 0:1]
    bx, by = u[:, 1:2], v[:, 1:2]
    cx, cy = u[:, 2:3], v[:, 2:3]
    # signed edge functions (areas of sub-triangles)
    w0 = (cx - bx) * (fy - by) - (cy - by) * (fx - bx)
    w1 = (ax - cx) * (fy - cy) - (ay - cy) * (fx - cx)
    w2 = (bx - ax) * (fy - ay) - (by - ay) * (fx - ax)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)      # 2*area
    inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
              | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
    nz = torch.abs(area) > 1e-12
    inv_area = torch.where(nz, 1.0 / torch.where(nz, area, 1.0), 0.0)
    b0 = w0 * inv_area
    b1 = w1 * inv_area
    b2 = w2 * inv_area
    # perspective-correct depth: 1/z interpolates linearly in screen space
    inv_z = (b0 / z[:, 0:1] + b1 / z[:, 1:2] + b2 / z[:, 2:3])
    zp = torch.where(inv_z > 0, 1.0 / torch.clamp(inv_z, min=1e-12),
                     torch.inf)

    valid = (inside & nz & ok[:, None] & (px < width) & (py < height)
             & torch.isfinite(zp) & (zp > NEAR))
    flat = torch.where(valid, py.long() * width + px.long(), width * height)
    zbuf.scatter_reduce_(0, flat.reshape(-1),
                         torch.where(valid, zp, torch.inf).reshape(-1),
                         reduce="amin")
    return torch.sum(overflow.int())


@torch.no_grad()
def render_mesh_depth(vertices: np.ndarray, faces: np.ndarray,
                      w2c: np.ndarray, K: np.ndarray, width: int,
                      height: int, cap: int = 8,
                      chunk: int = 262144, device="cuda") -> np.ndarray:
    """Depth image [H, W] (meters, 0 = no surface) of the mesh seen from
    w2c (world-to-camera 4x4) with intrinsics K [3x3], rasterized on
    `device` ("cuda" unless the caller asks for "cpu").

    Pixel convention matches the Gaussian rasterizer (core/camera.py):
    u = fx*x/z + cx - 0.5, pixel centers at integer coordinates.
    `cap` bounds the per-face pixel footprint; faces wider than cap px
    are partially filled (counted + warned)."""
    dev = resolve_device(device)
    verts = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    R = np.asarray(w2c[:3, :3], np.float32)
    t = np.asarray(w2c[:3, 3], np.float32)
    vc = verts @ R.T + t
    z = vc[:, 2]
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    zsafe = np.where(np.abs(z) > 1e-9, z, 1e-9)
    u = fx * vc[:, 0] / zsafe + cx - 0.5
    v = fy * vc[:, 1] / zsafe + cy - 0.5
    uvz = np.stack([u, v, z], axis=1).astype(np.float32)      # [V, 3]

    # cull faces entirely off-screen or behind the camera (host side,
    # cheap) to shrink the device workload
    tri = uvz[faces]                                          # [F, 3, 3]
    front = (tri[:, :, 2] > NEAR).all(axis=1)
    on = ((tri[:, :, 0].max(axis=1) >= 0)
          & (tri[:, :, 0].min(axis=1) < width)
          & (tri[:, :, 1].max(axis=1) >= 0)
          & (tri[:, :, 1].min(axis=1) < height))
    tri = tri[front & on]
    F = tri.shape[0]

    zbuf = torch.full((width * height + 1,), torch.inf, dtype=torch.float32,
                      device=dev)
    n_over = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, F, chunk):
        part = tri[s: s + chunk]
        if part.shape[0] < chunk:
            pad = np.zeros((chunk - part.shape[0], 3, 3), np.float32)
            pad[:, :, 2] = -1.0                               # z<NEAR: ok=F
            part = np.concatenate([part, pad])
        n_over += _raster_chunk(torch.as_tensor(part, device=dev), zbuf,
                                width, height, cap)
    n_over = int(n_over)
    if n_over:
        print(f"[zbuffer] {n_over} faces exceeded the {cap}px footprint "
              f"cap (partially filled) — consider cap={cap*2}")
    depth = zbuf[:-1].reshape(height, width).cpu().numpy()
    return np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
