"""Point-to-plane ICP Gauss-Newton pose polish, an opt-in tracking
refinement (counterpart of isogs_slam_tpu/slam/icp.py).

After the photometric Adam loop the map's depth is rendered at the current
pose (forward only, through the frozen slot table), rendered and measured
depth are back-projected, and damped Gauss-Newton steps are taken on the
point-to-plane residual with the analytic SE(3) Jacobian; a photometric
block (coloured ICP) constrains the directions depth does not observe.
One slot-table render per iteration; the rest is elementwise work and a
6x6 solve in f32 on the map's device.

Geometry. The tracked pose (quat, trans) parameterises w2c. A
left-multiplied camera-frame increment Exp(delta) updates
w2c_new = Exp(delta) @ w2c. Measured points X (gt depth back-projected)
live in the camera frame and do not move with delta; rendered model points
Y are fixed world geometry, so Y(delta) = Exp(delta) Y and

    r(delta) = n . (Exp(delta) Y - X)  ~=  n . (Y + omega x Y + t - X)
    J_omega = Y x n,   J_t = n,        r0 = n . (Y - X)

with n the model surface normal from finite differences of Y.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..ops.rasterize import RasterConfig, render_rgbd_sil_slots
from ..utils.transforms import quat_mult, quat_to_rotmat


class GNConfig(NamedTuple):
    iters: int = 0               # 0 = off
    damping: float = 1e-3        # LM damping relative to the top eigenvalue
    reject_factor: float = 10.0  # drop residuals > factor * median
    sil_thres: float = 0.9       # model-confidence gate on rendered depth
    min_normal_dot: float = 0.1  # reject grazing normals (|n . view|)
    # relative eigenvalue floor of the 6x6 solve: step only in pose
    # directions the residual observes (components below the floor are
    # zeroed, not damped). 0 disables.
    eig_floor: float = 1e-4
    # weight of the photometric block against the point-to-plane block
    # after per-block robust normalisation; 0 = depth only
    phot_weight: float = 0.3
    # trust region per iteration on the pose increment (metres / radians)
    max_step: float = 0.05


def _exp_quat(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle [3] -> unit quaternion (w, x, y, z): the exact exp map
    with the small-angle-safe sinc form."""
    theta2 = torch.sum(omega * omega)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    s = torch.where(theta2 > 1e-12, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    return torch.cat([torch.cos(half)[None], s * omega])


def apply_increment(quat, trans, delta):
    """Left-multiply w2c by Exp(delta), delta = (omega[3], t[3]):
    R' = dR R, t' = dR t + dt."""
    dq = _exp_quat(delta[:3])
    dR = quat_to_rotmat(dq)
    return quat_mult(dq, quat), dR @ trans + delta[3:]


def backproject_grid(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """[H, W] depth -> [H, W, 3] camera-frame points (pinhole, z forward,
    pixel centres at integer coordinates)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - cam.cx) / cam.fx * depth
    y = (v - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normals_from_points(pts: torch.Tensor, valid: torch.Tensor):
    """Central-difference surface normals of an organised point grid.
    pts [H, W, 3], valid [H, W] -> (unit normals [H, W, 3], ok [H, W]).
    Normals face the camera. The differences wrap (roll), so the image's
    border is never ok."""
    du = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dv = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    ok = (valid
          & torch.roll(valid, -1, dims=1) & torch.roll(valid, 1, dims=1)
          & torch.roll(valid, -1, dims=0) & torch.roll(valid, 1, dims=0))
    ok = ok.clone()
    ok[0, :] = False
    ok[-1, :] = False
    ok[:, 0] = False
    ok[:, -1] = False
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    ok = ok & (norm[..., 0] > 1e-12)
    # the viewing ray is +p, so a camera-facing surface has n . p < 0
    flip = torch.sum(n * pts, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n), ok


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Element cnt // 2 of the sorted masked values (the upper median of
    an even count; torch.median would give the lower one), 0 for an empty
    mask. No host synchronisation."""
    v = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))
                   .reshape(-1)).values
    cnt = torch.sum(mask)
    idx = torch.clamp(cnt // 2, 0, x.numel() - 1)
    return torch.where(cnt > 0, v[idx], torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def gn_solve(JtJ: torch.Tensor, Jtr: torch.Tensor,
             gcfg: GNConfig) -> torch.Tensor:
    """Damped 6x6 GN solve, optionally restricted to observable directions.

    With eig_floor > 0 the system is solved in the eigenbasis of the
    block-scaled normal matrix and the components whose eigenvalue is
    below eig_floor * lambda_max are zeroed instead of damped: a near-null
    direction (a flat wall: in-plane translations and the in-plane
    rotation) carries no signal but some noise in Jtr, which a damped
    inverse would amplify by ~1 / damping. The scaling is per block, not
    per axis: only the rotation block (which scales like depth^2) is
    balanced against the translation block, by the block traces, so the
    eigenvalue ratios inside a block — the rank information the cut
    needs — survive."""
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    if gcfg.eig_floor <= 0.0:
        lm = gcfg.damping * torch.diag(torch.diag(JtJ)) + 1e-9 * eye
        return -torch.linalg.solve(JtJ + lm, Jtr)
    d = torch.diag(JtJ)
    rho = torch.sqrt(torch.clamp(d[0] + d[1] + d[2], min=1e-12)
                     / torch.clamp(d[3] + d[4] + d[5], min=1e-12))
    s = torch.cat([(1.0 / rho).expand(3), torch.ones_like(d[:3])])
    A = JtJ * s[:, None] * s[None, :]
    lam, V = torch.linalg.eigh(A)                    # ascending
    keep = lam > gcfg.eig_floor * lam[-1]
    inv = torch.where(keep, 1.0 / (lam + gcfg.damping * lam[-1]),
                      torch.zeros_like(lam))
    b = V.T @ (s * Jtr)
    return -s * (V @ (inv * b))


def _image_grads(im: torch.Tensor):
    """Central-difference pixel gradients of im [C, H, W] ->
    (gu, gv [C, H, W], ok [H, W] interior mask)."""
    gu = torch.zeros_like(im)
    gu[:, :, 1:-1] = 0.5 * (im[:, :, 2:] - im[:, :, :-2])
    gv = torch.zeros_like(im)
    gv[:, 1:-1, :] = 0.5 * (im[:, 2:, :] - im[:, :-2, :])
    ok = torch.zeros(im.shape[1:], dtype=torch.bool, device=im.device)
    ok[1:-1, 1:-1] = True
    return gu, gv, ok


@torch.no_grad()
def gn_depth_polish(raw, counts, quat, trans, gt_depth, cam: Camera,
                    rcfg: RasterConfig, gcfg: GNConfig, gt_im=None):
    """Damped GN refinement of (quat, trans) against the frozen slot-table
    render. gt_depth [1, H, W]. Returns (quat, trans, cost0, cost1): the
    polished pose and the cost before and after; the caller accepts the
    polish only when cost1 < cost0.

    gt_im [3, H, W] (with gcfg.phot_weight > 0) adds the photometric
    block. Both blocks share the row structure J = (Y x n_eff, n_eff):
    for point-to-plane n_eff is the surface normal with residual
    n . (Y - X); for a colour channel, linearising
    I_gt(pi(Exp(delta) Y)) - c_model gives n_eff = grad(I_gt) . J_pi(Y)
    with residual I_gt(u) - c_model(u). Each block is normalised by its
    median absolute residual, so phot_weight is a dimensionless mix."""
    dev = gt_depth.device
    gt_d = gt_depth[0]
    meas_valid = (gt_d > 0) & torch.isfinite(gt_d)
    X = backproject_grid(gt_d, cam)                     # sensor frame: fixed
    zero = torch.zeros((), device=dev)
    inf = torch.full((), float("inf"), device=dev)

    use_phot = gt_im is not None and gcfg.phot_weight > 0.0
    if use_phot:
        gt_p = gt_im[:3]
        gu, gv, g_ok = _image_grads(gt_p)

    def masked_sq_rms(r, ok, cnt):
        return torch.sqrt(torch.sum(torch.where(ok, r * r,
                                                torch.zeros_like(r)))
                          / torch.clamp(cnt, min=1.0))

    def linearize(q, t):
        """One render -> (JtJ [6,6], Jtr [6], p2p RMS, photometric RMS,
        ok count)."""
        im, depth, sil, _, _ = render_rgbd_sil_slots(raw, counts, q, t, cam,
                                                     rcfg)
        # the composited depth is sum(w_i z_i) with sum(w_i) = silhouette;
        # the sensor measures E[z | hit] = depth / sil
        d_model = depth[0] / torch.clamp(sil, min=1e-6)
        model_valid = ((sil > gcfg.sil_thres) & (d_model > cam.near)
                       & torch.isfinite(d_model))
        Y = backproject_grid(d_model, cam)
        n, n_ok = normals_from_points(Y, model_valid)

        r = torch.sum(n * (Y - X), dim=-1)              # [H, W]
        ok = meas_valid & model_valid & n_ok
        # normals nearly orthogonal to the ray carry no depth constraint
        ray = Y / torch.clamp(torch.linalg.norm(Y, dim=-1, keepdim=True),
                              min=1e-12)
        ok = ok & (torch.abs(torch.sum(n * ray, dim=-1))
                   > gcfg.min_normal_dot)
        med = _masked_median(torch.abs(r), ok)
        ok = ok & (torch.abs(r)
                   < gcfg.reject_factor * torch.clamp(med, min=1e-6))

        w = ok.to(torch.float32)
        cnt = torch.sum(w)
        cost = masked_sq_rms(r, ok, cnt)
        J = torch.cat([torch.linalg.cross(Y, n, dim=-1), n], dim=-1)
        Jf = (J * w[..., None]).reshape(-1, 6)
        rf = (r * w).reshape(-1)
        JtJ_d = Jf.T @ Jf
        Jtr_d = Jf.T @ rf
        if not use_phot:
            return JtJ_d, Jtr_d, cost, zero, cnt

        # photometric block: the rendered colour carries the same
        # silhouette scaling as the depth channel
        c_model = im / torch.clamp(sil, min=1e-6)[None]      # [3, H, W]
        r_p = gt_p - c_model
        Z = torch.clamp(Y[..., 2], min=1e-6)
        zeros = torch.zeros_like(Z)
        jpi0 = torch.stack([cam.fx / Z, zeros,
                            -cam.fx * Y[..., 0] / (Z * Z)], dim=-1)
        jpi1 = torch.stack([zeros, cam.fy / Z,
                            -cam.fy * Y[..., 1] / (Z * Z)], dim=-1)
        qv = gu[..., None] * jpi0[None] + gv[..., None] * jpi1[None]
        ok_p = ((model_valid & g_ok & meas_valid)[None]
                & torch.isfinite(r_p))
        med_p = _masked_median(torch.abs(r_p), ok_p)
        ok_p = ok_p & (torch.abs(r_p)
                       < gcfg.reject_factor * torch.clamp(med_p, min=1e-6))
        Jp = torch.cat([torch.linalg.cross(Y[None].expand_as(qv), qv,
                                           dim=-1), qv], dim=-1)
        wp_row = ok_p.to(torch.float32)
        Jpf = (Jp * wp_row[..., None]).reshape(-1, 6)
        rpf = (r_p * wp_row).reshape(-1)
        wd2 = 1.0 / torch.clamp(med, min=1e-4) ** 2
        wp2 = (gcfg.phot_weight / torch.clamp(med_p, min=1e-3)) ** 2
        JtJ = wd2 * JtJ_d + wp2 * (Jpf.T @ Jpf)
        Jtr = wd2 * Jtr_d + wp2 * (Jpf.T @ rpf)
        cost_p = masked_sq_rms(r_p, ok_p, torch.sum(wp_row))
        return JtJ, Jtr, cost, cost_p, cnt

    q1, t1 = quat, trans
    cost_d0, cost_p0 = inf, inf
    for i in range(gcfg.iters):
        JtJ, Jtr, cost_d, cost_p, cnt = linearize(q1, t1)
        if i == 0:
            cost_d0, cost_p0 = cost_d, cost_p
        delta = gn_solve(JtJ, Jtr, gcfg)
        # a catastrophic solve (rank-deficient ok-set) must not fling the
        # pose, and the cap bounds how much map error a frame can absorb
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        dmax = torch.max(torch.abs(delta))
        delta = delta * torch.clamp(
            gcfg.max_step / torch.clamp(dmax, min=1e-12), max=1.0)
        q2, t2 = apply_increment(q1, t1, delta)
        # with no usable constraints keep the pose
        enough = cnt > 64.0
        q1, t1 = torch.where(enough, q2, q1), torch.where(enough, t2, t1)

    _, _, cost_d1, cost_p1, cnt1 = linearize(q1, t1)
    if use_phot:
        # the combined objective the solve minimises, normalised by each
        # block's initial RMS: cost0 = 1, cost1 < 1 iff the weighted
        # relative residual decreased
        pw2 = gcfg.phot_weight ** 2
        rel_d = cost_d1 / torch.clamp(cost_d0, min=1e-12)
        rel_p = cost_p1 / torch.clamp(cost_p0, min=1e-12)
        cost0 = torch.ones((), device=dev)
        cost1 = torch.sqrt((rel_d ** 2 + pw2 * rel_p ** 2) / (1.0 + pw2))
    else:
        cost0, cost1 = cost_d0, cost_d1
    cost1 = torch.where(cnt1 > 64.0, cost1, inf)
    return q1, t1, cost0, cost1
