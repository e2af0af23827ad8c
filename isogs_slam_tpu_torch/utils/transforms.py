"""Quaternion / SE(3) helpers (counterpart of
isogs_slam_tpu/utils/transforms.py). Quaternions are (w, x, y, z)."""
from __future__ import annotations

import torch

from . import spans


def normalize(q: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    """L2-normalize along `dim`. The clamp sits inside the sqrt so all-zero
    rows (dead Gaussian slots) keep a finite gradient."""
    n2 = torch.sum(q * q, dim=dim, keepdim=True)
    return q / torch.sqrt(torch.clamp(n2, min=eps * eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternion (normalized internally) -> [..., 3, 3]."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


# the reference's name for the same function
build_rotation = quat_to_rotmat


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, broadcasting over leading dims."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([w, x, y, z], dim=-1)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 4] (w, x, y, z), best-conditioned
    candidate (pytorch3d's matrix_to_quaternion)."""
    f = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = f.unbind(-1)
    x = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                     1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    q_abs = torch.where(x > 0, torch.sqrt(torch.clamp(x, min=0.0)),
                        torch.zeros_like(x))
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01],
                    dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20],
                    dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21],
                    dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2],
                    dim=-1),
    ], dim=-2)
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cand, -2, idx)[..., 0, :]


def pose_to_w2c(cam_quat: torch.Tensor, cam_trans: torch.Tensor
                ) -> torch.Tensor:
    """(quat [4], trans [3]) -> 4x4 world-to-camera matrix."""
    R = quat_to_rotmat(cam_quat)
    top = torch.cat([R, cam_trans.reshape(3, 1)], dim=1)
    # a blocking copy from the host: it waits for the card's queue
    with spans.span("sync.pose_matrix"):
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                              device=top.device)
    return torch.cat([top, bottom], dim=0)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def transform_to_frame(means3d, unnorm_rots, cam_quat, cam_trans,
                       gaussians_grad: bool, camera_grad: bool):
    """World -> camera-frame means and orientation quats. The gradient
    flags detach the pose or the Gaussians (the reference's `.detach()`)."""
    if not camera_grad:
        cam_quat = cam_quat.detach()
        cam_trans = cam_trans.detach()
    if not gaussians_grad:
        means3d = means3d.detach()
        unnorm_rots = unnorm_rots.detach()
    cam_quat_n = normalize(cam_quat)
    w2c = pose_to_w2c(cam_quat_n, cam_trans)
    means_cam = transform_points(w2c, means3d)
    rots_cam = quat_mult(cam_quat_n[None, :], normalize(unnorm_rots))
    return means_cam, rots_cam


def relative_transformation(t1: torch.Tensor, t2: torch.Tensor
                            ) -> torch.Tensor:
    """inv(t1) @ t2 ([..., 4, 4]), the T with t1 @ T == t2: the pose
    normalization of the dataset layer (geometryutils.
    relative_transformation), a general inverse in t1's dtype."""
    return torch.linalg.inv(t1) @ t2
