"""EWA projection of camera-frame Gaussians into the render core's table:
kernels P fwd and P bwd (csrc/project.cu), their autograd Function, and
the backward kernel's algebra in plain PyTorch (the projection of
isogs_slam_tpu/ops/rasterize.py, which XLA fuses there).

A table row is (u, v, A, B, C, op, features, [z]): what
ops/rasterize.py's `_raster_table` stacks and the compositing gathers. On
a CUDA tensor `project_table_cuda` launches the kernels (or raises); the
plain version is ops/rasterize.py's eager chain (`project_gaussians_plain`
and `_raster_table`), which runs for tensors on the CPU and in
comparisons against the kernels. `project_bwd_formula` is the backward
kernel's algebra in plain PyTorch, for tests.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import spans
from . import _cuda

NEAR_CULL_Z = 0.2
LOW_PASS = 0.3
CMAX = 16   # the kernel's widest table row (csrc/project.cu)


def _limits(cam):
    return 1.3 * cam.tanfovx, 1.3 * cam.tanfovy


def _f32(x: torch.Tensor, name: str, width: int | None, n: int):
    if not x.is_cuda or x.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 CUDA tensor, got "
                        f"{x.dtype} on {x.device}")
    if x.dim() != 2 or x.shape[0] != n or (width is not None
                                           and x.shape[1] != width):
        raise ValueError(f"{name} must be [{n}, {width}], got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def _width(logit_op, f_in: int, depth_col: bool) -> int:
    return 5 if logit_op is None else 6 + f_in + int(depth_col)


def _ptr(x):
    return None if x is None else _cuda.ptr(x)


def project_fwd_cuda(means_cam, quats, log_scales, logit_op, feats, alive,
                     cam, margin_px: float = 0.0, offset=None,
                     depth_col: bool = False, mask_op: bool = False):
    """Kernel P fwd: (table [N, 6 + F_in (+1)] f32, radius [N] int32,
    valid [N] bool). logit_op [N, 1] or None (the table is then [N, 5],
    u v A B C: what binning reads), feats [N, F_in] or None, offset [N, 2]
    or None; mask_op zeroes the opacity of rows that are not valid."""
    n = means_cam.shape[0]
    means_cam = _f32(means_cam, "means_cam", 3, n)
    quats = _f32(quats, "quats", 4, n)
    log_scales = _f32(log_scales, "log_scales", 3, n)
    if logit_op is not None:
        logit_op = _f32(logit_op, "logit_opacities", 1, n)
    f_in = 0
    if feats is not None:
        feats = _f32(feats, "features", None, n)
        f_in = feats.shape[1]
    if logit_op is None and (f_in or depth_col):
        raise ValueError("features and the depth column need the opacity "
                         "column")
    if _width(logit_op, f_in, depth_col) > CMAX:
        raise ValueError(f"kernel P writes at most {CMAX} table columns")
    if offset is not None:
        offset = _f32(offset, "means2d_offset", 2, n)
    if alive.shape != (n,) or alive.dtype != torch.bool or not alive.is_cuda:
        raise ValueError("alive must be a bool CUDA tensor [N]")
    alive = alive.contiguous()
    dev = means_cam.device
    table = torch.empty((n, _width(logit_op, f_in, depth_col)),
                        dtype=torch.float32, device=dev)
    radius = torch.empty(n, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    limx, limy = _limits(cam)
    f = ctypes.c_float
    err = _cuda.library("project").project_fwd(
        _ptr(means_cam), _ptr(quats), _ptr(log_scales), _ptr(logit_op),
        _ptr(feats), f_in, _ptr(alive), _ptr(offset), n, int(depth_col),
        int(mask_op), f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(limx),
        f(limy), f(margin_px), cam.tiles_x, cam.tiles_y, _ptr(table),
        _ptr(radius), _ptr(valid), _cuda.stream_ptr())
    _cuda.check(err, "project_fwd")
    _cuda.count_launch("project_fwd")
    return table, radius, valid


def project_bwd_cuda(means_cam, quats, log_scales, logit_op, valid, dtable,
                     cam, f_in: int, depth_col: bool = False,
                     mask_op: bool = False, want_logit: bool = True,
                     want_feats: bool = True, want_offset: bool = False):
    """Kernel P bwd: (d means_cam [N, 3], d quats [N, 4], d log_scales
    [N, 3], d logit [N, 1] or None, d features [N, F_in] or None,
    d offset [N, 2] or None) from the table's cotangent dtable. The
    forward's inputs are read again and its intermediates recomputed."""
    n = means_cam.shape[0]
    dtable = _f32(dtable, "dtable", _width(logit_op, f_in, depth_col), n)
    dev = means_cam.device

    def out(width, want=True):
        return (torch.empty((n, width), dtype=torch.float32, device=dev)
                if want else None)
    dmeans, dquats, dls = out(3), out(4), out(3)
    dlogit = out(1, want_logit and logit_op is not None)
    dfeats = out(f_in, want_feats and f_in > 0)
    doffset = out(2, want_offset)
    limx, limy = _limits(cam)
    f = ctypes.c_float
    err = _cuda.library("project").project_bwd(
        _ptr(means_cam), _ptr(quats), _ptr(log_scales), _ptr(logit_op),
        _ptr(valid), n, f_in, int(depth_col), int(mask_op), f(cam.fx),
        f(cam.fy), f(limx), f(limy), _ptr(dtable), _ptr(dmeans),
        _ptr(dquats), _ptr(dls), _ptr(dlogit), _ptr(dfeats), _ptr(doffset),
        _cuda.stream_ptr())
    _cuda.check(err, "project_bwd")
    _cuda.count_launch("project_bwd")
    return dmeans, dquats, dls, dlogit, dfeats, doffset


class _ProjectTable(torch.autograd.Function):
    """Kernel P fwd; backward kernel P bwd, which keeps only the inputs
    (and the valid mask) from the forward."""

    @staticmethod
    def forward(ctx, means_cam, quats, log_scales, logit_op, feats, offset,
                alive, cam, margin_px, depth_col, mask_op):
        means_cam, quats, log_scales = (x.contiguous() for x in
                                        (means_cam, quats, log_scales))
        if logit_op is not None:
            logit_op = logit_op.contiguous()
        table, radius, valid = project_fwd_cuda(
            means_cam, quats, log_scales, logit_op, feats, alive, cam,
            margin_px, offset, depth_col, mask_op)
        ctx.save_for_backward(means_cam, quats, log_scales, logit_op, valid)
        ctx.mark_non_differentiable(radius, valid)
        ctx.args = (cam, 0 if feats is None else feats.shape[1], depth_col,
                    mask_op)
        return table, radius, valid

    @staticmethod
    def backward(ctx, dtable, _dradius, _dvalid):
        means_cam, quats, log_scales, logit_op, valid = ctx.saved_tensors
        cam, f_in, depth_col, mask_op = ctx.args
        need = ctx.needs_input_grad
        with spans.fine("render.project_bwd"):
            dm, dq, ds, dl, df, do = project_bwd_cuda(
                means_cam, quats, log_scales, logit_op, valid, dtable, cam,
                f_in, depth_col, mask_op, want_logit=need[3],
                want_feats=need[4], want_offset=need[5])
        return (dm if need[0] else None, dq if need[1] else None,
                ds if need[2] else None, dl, df, do, None, None, None, None,
                None)


def project_table_cuda(means_cam, quats, log_scales, logit_op, feats, alive,
                       cam, margin_px: float = 0.0, offset=None,
                       depth_col: bool = False, mask_op: bool = False):
    """Differentiable (wrt every float input) kernel pair: (table, radius,
    valid) as project_fwd_cuda returns them. Without a gradient to take,
    the forward kernel alone."""
    if not (torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in
            (means_cam, quats, log_scales, logit_op, feats, offset))):
        return project_fwd_cuda(means_cam, quats, log_scales, logit_op, feats,
                                alive, cam, margin_px, offset, depth_col,
                                mask_op)
    return _ProjectTable.apply(means_cam, quats, log_scales, logit_op, feats,
                               offset, alive, cam, float(margin_px),
                               bool(depth_col), bool(mask_op))


# ---------------------------------------------------------------------------
# kernel P bwd's algebra in plain PyTorch (tests and the card check only):
# the forward's intermediates recomputed, then the chain rule written out
# in the kernel's order, autograd's conventions at the kinks


def _ewa_parts(means_cam, quats, log_scales, cam):
    """The forward's intermediates, as the kernels form them."""
    tx, ty, tz = means_cam.unbind(-1)
    q = quats.unbind(-1)
    e = {"tx": tx, "ty": ty, "tz": tz, "tz_safe": tz + 1e-7, "q": q}
    # the device's own sum of the four squares, as the plain chain takes it
    # (the kernel's order is the card's: (q0^2 + q2^2) + (q1^2 + q3^2))
    ss = torch.sum(quats * quats, dim=-1)
    e["ss"] = ss
    e["nrm"] = torch.sqrt(torch.clamp(ss, min=1e-24))
    r, x, y, z = e["qn"] = [c / e["nrm"] for c in q]
    e["R"] = [1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
              2 * (x * z + r * y), 2 * (x * y + r * z),
              1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
              2 * (x * z - r * y), 2 * (y * z + r * x),
              1 - 2 * (x * x + y * y)]
    R = e["R"]
    e["s"] = [torch.exp(c) for c in log_scales.unbind(-1)]
    e["var"] = v = [s * s for s in e["s"]]

    def cov(a, b):
        return (R[a] * v[0] * R[b] + R[a + 1] * v[1] * R[b + 1]
                + R[a + 2] * v[2] * R[b + 2])
    for name, a, b in (("s00", 0, 0), ("s01", 0, 3), ("s02", 0, 6),
                       ("s11", 3, 3), ("s12", 3, 6), ("s22", 6, 6)):
        e[name] = cov(a, b)
    limx, limy = _limits(cam)
    e["tz_nz"] = torch.where(tz == 0, torch.full_like(tz, 1e-7), tz)
    e["xr"], e["yr"] = tx / e["tz_nz"], ty / e["tz_nz"]
    e["xc"] = torch.clamp(e["xr"], -limx, limx)
    e["yc"] = torch.clamp(e["yr"], -limy, limy)
    e["txc"], e["tyc"] = e["xc"] * tz, e["yc"] * tz
    e["inv_z"] = 1.0 / e["tz_nz"]
    e["inv_z2"] = e["inv_z"] * e["inv_z"]
    e["j00"] = cam.fx * e["inv_z"]
    e["j02"] = -cam.fx * e["txc"] * e["inv_z2"]
    e["j11"] = cam.fy * e["inv_z"]
    e["j12"] = -cam.fy * e["tyc"] * e["inv_z2"]
    e["r0x"] = e["j00"] * e["s00"] + e["j02"] * e["s02"]
    e["r0z"] = e["j00"] * e["s02"] + e["j02"] * e["s22"]
    e["r1y"] = e["j11"] * e["s11"] + e["j12"] * e["s12"]
    e["r1z"] = e["j11"] * e["s12"] + e["j12"] * e["s22"]
    e["t01"] = e["j00"] * e["s01"] + e["j02"] * e["s12"]
    e["c00"] = e["r0x"] * e["j00"] + e["r0z"] * e["j02"] + LOW_PASS
    e["c01"] = e["t01"] * e["j11"] + e["r0z"] * e["j12"]
    e["c11"] = e["r1y"] * e["j11"] + e["r1z"] * e["j12"] + LOW_PASS
    e["det"] = e["c00"] * e["c11"] - e["c01"] * e["c01"]
    e["D"] = torch.where(e["det"] != 0, e["det"], torch.ones_like(e["det"]))
    return e


def project_bwd_formula(means_cam, quats, log_scales, logit_op, valid,
                        dtable, cam, f_in: int, depth_col: bool = False,
                        mask_op: bool = False):
    """The gradients kernel P bwd writes (d means_cam, d quats,
    d log_scales, d logit [N, 1] or None, d features [N, F_in], d offset
    [N, 2]), formed as the kernel forms them (no autograd)."""
    e = _ewa_parts(means_cam, quats, log_scales, cam)
    g = dtable.unbind(-1)
    du, dv, dA, dB, dC = g[:5]
    tx, ty, tz = e["tx"], e["ty"], e["tz"]
    dlogit = None
    if logit_op is not None:
        op = torch.sigmoid(logit_op[:, 0])
        dl = g[5] * (1 - op) * op
        if mask_op:
            dl = torch.where(valid, dl, torch.zeros_like(dl))
        dlogit = dl[:, None]
    dfeats = dtable[:, 6:6 + f_in]
    doffset = dtable[:, 0:2]

    # conic = (c11, -c01, c00) / D
    D = e["D"]
    D2 = D * D
    c00, c01, c11 = e["c00"], e["c01"], e["c11"]
    dc11, dc01, dc00 = dA / D, -(dB / D), dC / D
    dD = (-dA * c11) / D2 - (dB * -c01) / D2 - (dC * c00) / D2
    ddet = torch.where(e["det"] != 0, dD, torch.zeros_like(dD))
    dc00 = dc00 + ddet * c11
    dc11 = dc11 + ddet * c00
    dc01 = dc01 - (ddet * c01) * 2
    # the 2D covariance c = J S J^T + 0.3: through J S (r0x, r0z, t01,
    # r1y, r1z) to the Jacobian
    j00, j02, j11, j12 = e["j00"], e["j02"], e["j11"], e["j12"]
    s00, s01, s02, s11, s12, s22 = (e[k] for k in ("s00", "s01", "s02",
                                                   "s11", "s12", "s22"))
    dr0x, dj00 = dc00 * j00, dc00 * e["r0x"]
    dr0z, dj02 = dc00 * j02, dc00 * e["r0z"]
    dt01, dj11 = dc01 * j11, dc01 * e["t01"]
    dr0z = dr0z + dc01 * j12
    dj12 = dc01 * e["r0z"]
    dj00 = dj00 + dt01 * s01
    dj02 = dj02 + dt01 * s12
    dr1y, dr1z = dc11 * j11, dc11 * j12
    dj11 = dj11 + dc11 * e["r1y"]
    dj12 = dj12 + dc11 * e["r1z"]
    dj00 = dj00 + dr0x * s00 + dr0z * s02
    dj02 = dj02 + dr0x * s02 + dr0z * s22
    dj11 = dj11 + dr1y * s11 + dr1z * s12
    dj12 = dj12 + dr1y * s12 + dr1z * s22
    # the Jacobian
    inv_z, inv_z2 = e["inv_z"], e["inv_z2"]
    limx, limy = _limits(cam)
    dinv_z2 = dj02 * (e["txc"] * -cam.fx) + dj12 * (e["tyc"] * -cam.fy)
    dtxc = dj02 * inv_z2 * -cam.fx
    dtyc = dj12 * inv_z2 * -cam.fy
    dinv_z = dj00 * cam.fx + dj11 * cam.fy + dinv_z2 * inv_z * 2
    dtz_nz = -dinv_z * inv_z2
    zero = torch.zeros_like(tz)
    dtz = dtxc * e["xc"] + dtyc * e["yc"]
    dxr = torch.where((e["xr"] >= -limx) & (e["xr"] <= limx), dtxc * tz, zero)
    dyr = torch.where((e["yr"] >= -limy) & (e["yr"] <= limy), dtyc * tz, zero)
    nz2 = e["tz_nz"] * e["tz_nz"]
    dtx = dxr / e["tz_nz"]
    dty = dyr / e["tz_nz"]
    dtz_nz = dtz_nz - ((dxr * tx) / nz2 + (dyr * ty) / nz2)
    dtz = dtz + torch.where(tz != 0, dtz_nz, zero)
    # the pixel centre, the depth column
    ts, ts2 = e["tz_safe"], e["tz_safe"] * e["tz_safe"]
    dtx = dtx + du / ts * cam.fx
    dty = dty + dv / ts * cam.fy
    dtz = dtz - ((du * (tx * cam.fx)) / ts2 + (dv * (ty * cam.fy)) / ts2)
    if depth_col:
        dtz = dtz + g[6 + f_in]
    dmeans = torch.stack([dtx, dty, dtz], dim=-1)
    # the 3D covariance S = R diag(var) R^T, through M = J R: d S =
    # J^T dc J (dc symmetric, dc01 / 2 off the diagonal), so d var_k =
    # m_k^T dc m_k and d R = 2 J^T dc M diag(var). Formed from M's columns
    # m_k, these sums do not cancel as the six entries of d S do where a
    # footprint is thin
    R, var, s = e["R"], e["var"], e["s"]
    h = 0.5 * dc01
    dR = [None] * 9
    dls = []
    for k in range(3):
        m0 = j00 * R[k] + j02 * R[6 + k]
        m1 = j11 * R[3 + k] + j12 * R[6 + k]
        p0 = dc00 * m0 + h * m1
        p1 = h * m0 + dc11 * m1
        w = 2 * var[k]
        dR[k] = w * (j00 * p0)
        dR[3 + k] = w * (j11 * p1)
        dR[6 + k] = w * (j02 * p0 + j12 * p1)
        dls.append((m0 * p0 + m1 * p1) * 2 * s[k] * s[k])
    # the rotation from the normalised quaternion
    r, x, y, z = e["qn"]
    dqn = [2 * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6]
                + x * dR[7]),
           2 * (y * dR[1] + z * dR[2] + y * dR[3] - 2 * x * dR[4]
                - r * dR[5] + z * dR[6] + r * dR[7] - 2 * x * dR[8]),
           2 * (-2 * y * dR[0] + x * dR[1] + r * dR[2] + x * dR[3]
                + z * dR[5] - r * dR[6] + z * dR[7] - 2 * y * dR[8]),
           2 * (-2 * z * dR[0] - r * dR[1] + x * dR[2] + r * dR[3]
                - 2 * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7])]
    # qn = q / sqrt(clamp(|q|^2, 1e-24))
    nrm = e["nrm"]
    dnrm = -sum(dqn[k] * e["qn"][k] for k in range(4)) / nrm
    dss = torch.where(e["ss"] >= 1e-24, dnrm / (2 * nrm), zero)
    dquats = torch.stack([dqn[k] / nrm + dss * 2 * e["q"][k]
                          for k in range(4)], dim=-1)
    return (dmeans, dquats, torch.stack(dls, dim=-1), dlogit, dfeats,
            doffset)

