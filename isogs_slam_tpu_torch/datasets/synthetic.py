"""Synthetic RGB-D sequence (counterpart of
isogs_slam_tpu/datasets/synthetic.py): a procedurally generated,
checkerboard-textured Gaussian box room rendered by the port's own
`render_rgbd_sil` along a smooth orbit. Colour and depth agree across
views and the poses are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import Camera
from ..ops.rasterize import RasterConfig, render_rgbd_sil
from ..utils.transforms import rotmat_to_quat, transform_to_frame


def make_room_gaussians(rng: np.random.Generator, n_per_wall: int = 900,
                        room: float = 2.0):
    """Checkerboard-textured box-room walls as opaque Gaussians (numpy)."""
    pts, cols = [], []
    side = int(np.sqrt(n_per_wall))
    lin = np.linspace(-room, room, side)
    u, v = np.meshgrid(lin, lin, indexing="xy")
    u, v = u.reshape(-1), v.reshape(-1)
    walls = [
        (np.stack([u, v, np.full_like(u, room)], -1), (0.8, 0.3, 0.3)),
        (np.stack([np.full_like(u, -room), u, v + room], -1), (0.3, 0.8, 0.3)),
        (np.stack([np.full_like(u, room), u, v + room], -1), (0.3, 0.3, 0.8)),
        (np.stack([u, np.full_like(u, -room), v + room], -1), (0.8, 0.8, 0.3)),
        (np.stack([u, np.full_like(u, room), v + room], -1), (0.3, 0.8, 0.8)),
    ]
    for p, base in walls:
        checker = ((np.floor(p[:, 0] * 2) + np.floor(p[:, 1] * 2)
                    + np.floor(p[:, 2] * 2)) % 2)
        c = np.outer(checker, np.array(base)) \
            + np.outer(1 - checker, np.array(base) * 0.45)
        c = np.clip(c + rng.uniform(-0.18, 0.18, c.shape), 0.02, 0.98)
        pts.append(p)
        cols.append(c)
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    pts += rng.normal(0, 0.005, pts.shape).astype(np.float32)
    n = pts.shape[0]
    spacing = 2 * room / side
    log_scales = np.log(np.full((n, 3), spacing * 0.9, np.float32))
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    logit_op = np.full((n, 1), 4.0, np.float32)
    return pts, cols, quats, log_scales, logit_op


def make_trajectory(num_frames: int, radius: float = 0.4,
                    step: float = 0.012):
    """Smooth orbit segment, ~`step` meters per frame (c2w matrices)."""
    poses = []
    for i in range(num_frames):
        t = i * step / (2 * np.pi * radius)
        ang = 0.35 * np.sin(2 * np.pi * t)
        cx = radius * np.sin(2 * np.pi * t)
        cy = 0.15 * np.sin(4 * np.pi * t)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = [cx, cy, 0.3 * np.sin(2 * np.pi * t)]
        poses.append(c2w.astype(np.float32))
    return poses


class SyntheticDataset:
    """`ds[i]` -> (color [H,W,3] f32 0..255, depth [H,W,1] f32 (0 where the
    silhouette is below 0.9), intrinsics [4,4], c2w [4,4]) as numpy."""

    def __init__(self, num_frames: int = 20, height: int = 120,
                 width: int = 160, seed: int = 0, n_per_wall: int = 2500,
                 traj_step: float = 0.012, device="cuda"):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.height, self.width = height, width
        f = 0.75 * width
        self.cam = Camera(width=width, height=height, fx=f, fy=f,
                          cx=width / 2 - 0.5, cy=height / 2 - 0.5)
        (self.pts, self.cols, self.quats, self.log_scales,
         self.logit_op) = make_room_gaussians(rng, n_per_wall)
        self.poses = make_trajectory(num_frames, step=traj_step)
        self.num_imgs = num_frames
        self.png_depth_scale = 6553.5
        self._cache = {}

    def __len__(self):
        return self.num_imgs

    def get_cam_K(self):
        K = np.eye(3, dtype=np.float32)
        K[0, 0], K[1, 1] = self.cam.fx, self.cam.fy
        K[0, 2], K[1, 2] = self.cam.cx, self.cam.cy
        return K

    @torch.no_grad()
    def render(self, quat: torch.Tensor, trans: torch.Tensor):
        n = self.pts.shape[0]
        cfg = RasterConfig(max_per_tile=min(n, 512), tile_chunk=64)
        t = [torch.as_tensor(a, device=self.device) for a in
             (self.pts, self.quats, self.log_scales, self.logit_op,
              self.cols)]
        mc, qc = transform_to_frame(t[0], t[1], quat, trans,
                                    gaussians_grad=False, camera_grad=False)
        alive = torch.ones(n, dtype=torch.bool, device=self.device)
        im, depth, sil, _, _ = render_rgbd_sil(mc, qc, t[2], t[3], t[4],
                                               alive, self.cam, cfg)
        return im, depth, sil

    def __getitem__(self, index: int):
        if index not in self._cache:
            c2w = self.poses[index]
            w2c = np.linalg.inv(c2w)
            quat = rotmat_to_quat(torch.as_tensor(w2c[:3, :3]))
            im, depth, sil = self.render(
                quat.to(self.device, torch.float32),
                torch.as_tensor(w2c[:3, 3], dtype=torch.float32,
                                device=self.device))
            im = np.clip(im.cpu().numpy(), 0, 1)
            depth = depth[0].cpu().numpy()
            sil = sil.cpu().numpy()
            depth = np.where(sil > 0.9, depth, 0.0)
            color = (im.transpose(1, 2, 0) * 255.0).astype(np.float32)
            intr = np.eye(4, dtype=np.float32)
            intr[:3, :3] = self.get_cam_K()
            self._cache[index] = (color, depth[:, :, None].astype(np.float32),
                                  intr, c2w.astype(np.float32))
        return self._cache[index]
