"""The benchmark's frames: an analytic room ray-cast in plain PyTorch.

A closed room of 6 x 2.7 x 4 m (x, y, z; y points down, as a camera's y
does) with boxes and spheres on its floor, each surface procedurally
textured (a sum of three seeded sinusoids over a base colour) and shaded
Lambertian under one fixed light, so a surface looks the same from every
view. A frame is cast per pixel through a pinhole camera (u = fx x / z + cx
at integer pixel coordinates, the convention of the loaders' frames), and
returns the colour at 0-255 (uint8 steps) and the depth along the optical
axis in metres. A traffic file names the camera motion (and optionally a
depth sensor model), and a job's path starts at one of a fixed set of
starts; the seed supplies the texture phases and the order in which a
run's jobs take the starts. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import plugins

ROOM_LO = (-3.0, -1.5, -2.0)
ROOM_HI = (3.0, 1.2, 2.0)
# axis-aligned boxes (lo, hi) and spheres (centre, radius) inside the room
BOXES = (
    ((-2.2, 0.45, 0.9), (-0.9, 1.2, 1.9)),      # a desk-height block
    ((1.4, -0.2, -1.9), (2.6, 1.2, -1.2)),      # a cabinet at a wall
    ((0.6, 0.7, 1.2), (1.3, 1.2, 1.8)),         # a low box
    ((-2.9, -0.6, -1.2), (-2.6, 0.6, 0.3)),     # a panel on the left wall
)
SPHERES = (
    ((-1.5, 0.2, 1.35), 0.25),                  # on the desk-height block
    ((0.3, 0.85, -1.2), 0.35),
    ((2.2, -0.55, 0.8), 0.3),
)
LIGHT = (0.35, -0.8, 0.45)
N_SURF = 6 + len(BOXES) + len(SPHERES)   # room faces count as 6 surfaces


def _surface_table(gen: torch.Generator, device) -> dict:
    """Per-surface base colour and three sinusoids (direction, wavelength,
    phase). Wavelengths and colours are fixed; the seed draws the phases
    and the directions, so every seed has the same kind of texture."""
    rs = np.random.RandomState(12345)
    base = rs.uniform(0.25, 0.9, size=(N_SURF, 3))
    wl = np.stack([rs.uniform(0.06, 0.12, N_SURF),
                   rs.uniform(0.15, 0.3, N_SURF),
                   rs.uniform(0.4, 0.8, N_SURF)], axis=1)        # [S, 3]
    dirs = torch.randn((N_SURF, 3, 3), generator=gen, device=device,
                       dtype=torch.float64)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    phase = torch.rand((N_SURF, 3), generator=gen, device=device,
                       dtype=torch.float64) * (2 * math.pi)
    return {"base": torch.as_tensor(base, device=device),
            "freq": torch.as_tensor(2 * math.pi / wl, device=device),
            "dirs": dirs, "phase": phase}


def _room_hit(o, d):
    """Exit of rays o + t d from the room's inside: (t, normal, surface)."""
    lo = torch.tensor(ROOM_LO, dtype=o.dtype, device=o.device)
    hi = torch.tensor(ROOM_HI, dtype=o.dtype, device=o.device)
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_side = torch.where(d > 0, (hi - o) / safe, (lo - o) / safe)   # [R, 3]
    t, axis = torch.min(t_side, dim=-1)
    n = torch.zeros_like(d)
    sgn = -torch.sign(torch.gather(d, 1, axis[:, None]))[:, 0]
    n.scatter_(1, axis[:, None], sgn[:, None])
    pos = torch.gather(d, 1, axis[:, None])[:, 0] > 0
    surf = axis * 2 + pos.to(axis.dtype)
    return t, n, surf


def _box_hit(o, d, lo, hi):
    lo = torch.tensor(lo, dtype=o.dtype, device=o.device)
    hi = torch.tensor(hi, dtype=o.dtype, device=o.device)
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t0 = (lo - o) / safe
    t1 = (hi - o) / safe
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    t_near, axis = torch.max(tmin, dim=-1)
    t_far = torch.min(tmax, dim=-1).values
    hit = (t_near <= t_far) & (t_near > 1e-6)
    n = torch.zeros_like(d)
    sgn = -torch.sign(torch.gather(d, 1, axis[:, None]))[:, 0]
    n.scatter_(1, axis[:, None], sgn[:, None])
    return torch.where(hit, t_near, torch.full_like(t_near, math.inf)), n


def _sphere_hit(o, d, c, r):
    c = torch.tensor(c, dtype=o.dtype, device=o.device)
    oc = o - c
    a = torch.sum(d * d, -1)
    b = torch.sum(oc * d, -1)
    cc = torch.sum(oc * oc, -1) - r * r
    disc = b * b - a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / a
    hit = (disc > 0) & (t > 1e-6)
    t = torch.where(hit, t, torch.full_like(t, math.inf))
    p = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
    return t, (p - c) / r


def cast(c2w: torch.Tensor, cam: dict, tex: dict):
    """One frame seen by a camera at c2w [4, 4] (float64): (colour [H, W,
    3] in 0..1 before quantisation, depth [H, W] in metres)."""
    H, W = int(cam["height"]), int(cam["width"])
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    d_cam = torch.stack([(xs - cam["cx"]) / cam["fx"],
                         (ys - cam["cy"]) / cam["fy"],
                         torch.ones_like(xs)], -1).reshape(-1, 3)
    d = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3].expand_as(d)
    t, n, surf = _room_hit(o, d)
    for i, (lo, hi) in enumerate(BOXES):
        tb, nb = _box_hit(o, d, lo, hi)
        closer = tb < t
        t = torch.where(closer, tb, t)
        n = torch.where(closer[:, None], nb, n)
        surf = torch.where(closer, torch.full_like(surf, 6 + i), surf)
    for i, (c, r) in enumerate(SPHERES):
        ts, ns = _sphere_hit(o, d, c, r)
        closer = ts < t
        t = torch.where(closer, ts, t)
        n = torch.where(closer[:, None], ns, n)
        surf = torch.where(closer, torch.full_like(surf,
                                                   6 + len(BOXES) + i), surf)
    p = o + t[:, None] * d
    dirs = tex["dirs"][surf]                                   # [R, 3, 3]
    arg = (torch.einsum("rkc,rc->rk", dirs, p) * tex["freq"][surf]
           + tex["phase"][surf])
    pattern = torch.mean(0.5 + 0.5 * torch.sin(arg), -1)      # [R] in 0..1
    light = torch.tensor(LIGHT, dtype=p.dtype, device=dev)
    light = light / torch.linalg.norm(light)
    shade = 0.35 + 0.65 * torch.clamp(torch.sum(n * -light, -1), min=0.0)
    col = tex["base"][surf] * (0.45 + 0.55 * pattern)[:, None] * shade[:, None]
    return col.reshape(H, W, 3), t.reshape(H, W)


def make_frames(camera: dict, traffic: dict, seed: int, start: int,
                device):
    """All frames of one job: (colour [n, H, W, 3] float32 at 0-255 in
    uint8 steps, depth [n, H, W] float32, c2w [n, 4, 4] float64 relative to
    the first frame, as the loaders give them). The traffic's motion names
    its path's file, benchmark/motion/<kind>.py, whose `path(motion, n, rs)`
    walks from the fixed start number `start`, so every seed walks the same
    set of paths; a traffic's optional depth model names a file
    benchmark/sensor/<kind>.py, whose `apply(depth, sensor, gen)` turns the
    ray-cast depth into the sensor's. `seed` (any integer) draws the
    textures' phases and directions and the sensor's noise."""
    n = int(traffic["frames_per_job"])
    ss = np.random.SeedSequence([int(seed) % (1 << 63), int(seed) >> 63])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]) % (1 << 62))
    tex = _surface_table(gen, device)
    motion = traffic["motion"]
    c2w = plugins.load("motion", motion["kind"]).path(
        motion, n, np.random.RandomState([int(start), 7]))
    sensor = traffic.get("depth")
    model = plugins.load("sensor", sensor["kind"]) if sensor else None
    cols, depths = [], []
    for i in range(n):
        col, dep = cast(torch.as_tensor(c2w[i], device=device), camera, tex)
        if model is not None:
            dep = model.apply(dep, sensor, gen)
        cols.append(torch.round(col.clamp(0, 1) * 255.0).to(torch.float32))
        depths.append(dep.to(torch.float32))
    rel = np.linalg.inv(c2w[0])[None] @ c2w
    return torch.stack(cols), torch.stack(depths), rel
