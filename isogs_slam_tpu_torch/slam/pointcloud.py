"""RGB-D back-projection and silhouette-driven densification (counterpart
of isogs_slam_tpu/slam/pointcloud.py)."""
from __future__ import annotations

import torch

from .. import resolve_device
from ..core.camera import Camera
from ..core.gaussians import (GaussianParams, MapState, append_rows,
                              empty_state, new_gaussian_rows)
from ..ops.rasterize import RasterConfig, render_rgbd_sil
from ..utils import spans
from ..utils.transforms import normalize, pose_to_w2c, transform_to_frame
from .losses import _median


def backproject(im, depth, cam: Camera, c2w=None):
    """im [3,H,W] in [0,1], depth [1,H,W] -> (points [HW,3], colors [HW,3],
    mean3_sq_dist [HW]) with the "projective" scale rule
    (depth / ((fx+fy)/2))^2."""
    H, W = depth.shape[-2:]
    xs = torch.arange(W, dtype=im.dtype, device=im.device)
    ys = torch.arange(H, dtype=im.dtype, device=im.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    z = depth[0]
    x = (xg - cam.cx) / cam.fx * z
    y = (yg - cam.cy) / cam.fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    if c2w is not None:
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    cols = im.permute(1, 2, 0).reshape(-1, 3)
    scale_g = z.reshape(-1) / ((cam.fx + cam.fy) / 2.0)
    return pts, cols, scale_g * scale_g


def _log_scale_noise(pts, gaussian_distribution, perturb, generator):
    """The "isotropic" init's N(0, 1) log-scale draws ("anisotropic" has
    none): `perturb` when given, else drawn with `generator`."""
    if gaussian_distribution != "isotropic":
        return None
    if perturb is not None:
        return torch.as_tensor(perturb, dtype=pts.dtype, device=pts.device)
    return torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                       device=pts.device)


@torch.no_grad()
def add_new_gaussians(state: MapState, gt_im, gt_depth, cam_quat, cam_trans,
                      time_idx, cam: Camera, rcfg: RasterConfig,
                      sil_thres: float = 0.5,
                      gaussian_distribution: str = "isotropic",
                      perturb=None, generator=None) -> MapState:
    """Densify where the current frame is unexplained (splatam.py:799-841):
    non_presence = (silhouette < sil_thres)
                 | (rendered depth > gt depth & error > 50 * median error),
    masked by valid gt depth; those pixels are back-projected with the
    current pose and appended. The "isotropic" log-scale noise is
    `perturb` ([H*W, 3] normals) or drawn with `generator`."""
    params = GaussianParams(*[p.detach() for p in state.params])
    means_cam, quats_cam = transform_to_frame(
        params.means3d, params.unnorm_rotations, cam_quat, cam_trans,
        gaussians_grad=False, camera_grad=False)
    _, depth, silhouette, _, _ = render_rgbd_sil(
        means_cam, quats_cam, params.log_scales, params.logit_opacities,
        params.rgb_colors, state.alive, cam, rcfg)
    non_presence_sil = silhouette < sil_thres
    gtd = gt_depth[0]
    rd = depth[0]
    depth_error = torch.abs(gtd - rd) * (gtd > 0)
    non_presence_depth = (rd > gtd) & (depth_error
                                       > 50.0 * _median(depth_error))
    valid = ((non_presence_sil | non_presence_depth) & (gtd > 0)).reshape(-1)

    w2c = pose_to_w2c(normalize(cam_quat), cam_trans)
    # the inverse reads back its status to raise on a singular matrix
    with spans.span("sync.pose_inverse"):
        c2w = torch.linalg.inv(w2c)
    pts, cols, m3sd = backproject(gt_im, gt_depth, cam, c2w)
    rows = new_gaussian_rows(
        pts, cols, torch.clamp(m3sd, min=1e-12),
        _log_scale_noise(pts, gaussian_distribution, perturb, generator))
    return append_rows(state, rows, valid, time_idx)


@torch.no_grad()
def initialize_first_frame(gt_im, gt_depth, cam: Camera, capacity: int,
                           scene_radius_depth_ratio: float,
                           time_idx: int = 0,
                           gaussian_distribution: str = "isotropic",
                           perturb=None, generator=None,
                           device="cuda") -> MapState:
    """First-frame map init (splatam.py:411-453): every valid-depth pixel
    becomes a Gaussian; scene_radius = max(depth) / ratio. gt_im
    [3,H,W], gt_depth [1,H,W] (tensors or arrays) are moved to `device`;
    the log-scale noise is `perturb` or drawn with `generator`."""
    dev = resolve_device(device)
    gt_im = torch.as_tensor(gt_im, dtype=torch.float32, device=dev)
    gt_depth = torch.as_tensor(gt_depth, dtype=torch.float32, device=dev)
    state = empty_state(capacity, dev)
    pts, cols, m3sd = backproject(gt_im, gt_depth, cam, None)
    valid = gt_depth[0].reshape(-1) > 0
    rows = new_gaussian_rows(
        pts, cols, torch.clamp(m3sd, min=1e-12),
        _log_scale_noise(pts, gaussian_distribution, perturb, generator))
    state = append_rows(state, rows, valid, time_idx)
    return state._replace(
        scene_radius=torch.max(gt_depth) / scene_radius_depth_ratio)
