"""Analytic ground-truth mesh for the synthetic box room (counterpart of
isogs_slam_tpu/tools/synth_gt_mesh.py; numpy only).

The synthetic validation scene (datasets/synthetic.py::
make_room_gaussians, room=2.0) is five planar walls; their exact
geometry is known analytically, so mesh geometry eval
(scripts/eval_mesh_geometry.py — accuracy/completion/chamfer/F-score)
can run against TRUE surfaces with no dataset on disk. Each wall is
two triangles, subdivided for denser surface sampling.

Walls (matching make_room_gaussians exactly):
  z = +room  : x, y in [-room, room]          (back wall)
  x = -room  : y in [-room, room], z in [0, 2*room]
  x = +room  : same
  y = -room  : x in [-room, room], z in [0, 2*room]
  y = +room  : same

Usage:
  python -m isogs_slam_tpu_torch.tools.synth_gt_mesh --out gt_room.ply
"""
from __future__ import annotations

import argparse

import numpy as np


def make_wall(origin, eu, ev, n=8):
    """Rectangle origin + u*eu + v*ev, u,v in [0,1], subdivided n x n."""
    verts = []
    for i in range(n + 1):
        for j in range(n + 1):
            verts.append(np.asarray(origin)
                         + (i / n) * np.asarray(eu)
                         + (j / n) * np.asarray(ev))
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b = a + 1
            c = a + (n + 1)
            d = c + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def gt_room_mesh(room: float = 2.0, n: int = 8):
    r = room
    walls = [
        ([-r, -r, r], [2 * r, 0, 0], [0, 2 * r, 0]),       # z = +r
        ([-r, -r, 0], [0, 2 * r, 0], [0, 0, 2 * r]),       # x = -r
        ([r, -r, 0], [0, 2 * r, 0], [0, 0, 2 * r]),        # x = +r
        ([-r, -r, 0], [2 * r, 0, 0], [0, 0, 2 * r]),       # y = -r
        ([-r, r, 0], [2 * r, 0, 0], [0, 0, 2 * r]),        # y = +r
    ]
    verts, faces = [], []
    off = 0
    for origin, eu, ev in walls:
        v, f = make_wall(origin, eu, ev, n)
        verts.append(v)
        faces.append(f + off)
        off += v.shape[0]
    return np.concatenate(verts), np.concatenate(faces)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--room", type=float, default=2.0)
    ap.add_argument("--subdiv", type=int, default=8)
    args = ap.parse_args(argv)
    from ..mesh.meshio import write_ply_mesh
    verts, faces = gt_room_mesh(args.room, args.subdiv)
    write_ply_mesh(args.out, verts.astype(np.float32), faces)
    print(f"wrote {args.out}: {verts.shape[0]} verts, "
          f"{faces.shape[0]} faces")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
