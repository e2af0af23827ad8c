"""Degree-3 real spherical-harmonics colour evaluation (counterpart of
isogs_slam_tpu/ops/sh.py).

A per-Gaussian [N]-elementwise polynomial in the unit view direction
(camera centre -> Gaussian mean), evaluated before rasterization; the
compositing kernels then blend the per-view colours exactly like stored
RGB. Used by the viewers on checkpoints whose `sh_coeffs_flat` carries
higher bands (external 3DGS maps, the C++ renderer's SH path).

Layout: sh_flat [N, 48] interleaves channel fastest: coefficient k's RGB
lives at columns [3k, 3k+3) (the `sh_coeffs_flat` checkpoint key).
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(sh_flat: torch.Tensor, dirs: torch.Tensor,
            deg: int = 3) -> torch.Tensor:
    """SH -> RGB per Gaussian.

    sh_flat [N, 48] (deg-3; higher-band columns may be zero), dirs [N, 3]
    unnormalized view directions, deg in {0,1,2,3}. Returns [N, 3] colours
    shifted by +0.5 and clamped at 0 (the 3DGS / gsplat convention)."""
    sh = sh_flat.reshape(sh_flat.shape[0], 16, 3)
    res = C0 * sh[:, 0]
    if deg >= 1:
        n = torch.linalg.norm(dirs, dim=-1, keepdim=True)
        d = dirs / torch.clamp(n, min=1e-12)
        x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        res = res - C1 * y * sh[:, 1] + C1 * z * sh[:, 2] \
            - C1 * x * sh[:, 3]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = (res + C2[0] * xy * sh[:, 4] + C2[1] * yz * sh[:, 5]
               + C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + C2[3] * xz * sh[:, 7] + C2[4] * (xx - yy) * sh[:, 8])
    if deg >= 3:
        res = (res + C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
               + C3[1] * xy * z * sh[:, 10]
               + C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
               + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
               + C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
               + C3[5] * z * (xx - yy) * sh[:, 14]
               + C3[6] * x * (xx - yy - 3.0 * zz) * sh[:, 15])
    return torch.clamp(res + 0.5, min=0.0)


def sh_colors_for_pose(sh_flat: torch.Tensor, means3d: torch.Tensor,
                       cam_center_world: torch.Tensor,
                       deg: int = 3) -> torch.Tensor:
    """View-dependent per-Gaussian colours for one camera pose: direction =
    Gaussian mean - camera centre, in the WORLD frame. cam_center_world
    [3] = -R_w2c^T t (the camera origin in world)."""
    dirs = means3d - cam_center_world[None, :]
    return eval_sh(sh_flat, dirs, deg)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """[N,3] colours -> [N,48] deg-3 SH with only band 0 set (the inverse
    of eval_sh at any direction when the higher bands are zero; the
    checkpoint writer's formula)."""
    sh = torch.zeros((rgb.shape[0], 48), dtype=rgb.dtype, device=rgb.device)
    sh[:, 0:3] = (rgb - 0.5) / C0
    return sh
