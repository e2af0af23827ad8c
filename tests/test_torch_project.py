"""Kernel P bwd's algebra (ops/project.py `project_bwd_formula`, the
formula csrc/project.cu's backward computes, in plain PyTorch) against
autograd through the plain projection chain (`project_table` on the CPU:
`_ewa_core`, `project_gaussians_plain`, `_raster_table`), at the chain's
ordinary rows and at each of its kinks and guards."""
import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops.project import project_bwd_formula
from isogs_slam_tpu_torch.ops.rasterize import _ewa_core, project_table

CAM = Camera(width=160, height=120, fx=150.0, fy=140.0, cx=79.5, cy=60.25)
N = 512


def _rows(case: str, rng):
    """(means_cam, quats, log_scales, logit_op, rgb, alive) as numpy f32."""
    z = rng.uniform(0.5, 5.0, N)
    tanx, tany = CAM.tanfovx, CAM.tanfovy
    x = rng.uniform(-1.1, 1.1, N) * tanx * z
    y = rng.uniform(-1.1, 1.1, N) * tany * z
    q = rng.normal(size=(N, 4))
    s = rng.uniform(-5.0, -2.0, (N, 3))
    alive = np.ones(N, bool)
    if case == "near_cull":
        z = 0.2 + rng.uniform(-0.01, 0.01, N)
        z[:8] = np.float32(0.2)
        x, y = x / 10, y / 10
    elif case == "tz_zero":
        z[: N // 2] = 0.0
        z[N // 2: 3 * N // 4] = rng.uniform(-1e-3, 1e-3, N // 4)
    elif case == "tanfov_clamp":
        # both sides of both clamps, and rows on the bounds themselves
        side = rng.choice([-1.0, 1.0], (N, 2))
        x = side[:, 0] * rng.uniform(1.0, 3.0, N) * 1.3 * tanx * z
        y = side[:, 1] * rng.uniform(1.0, 3.0, N) * 1.3 * tany * z
        x[:4] = np.float32(1.3 * tanx) * z[:4]
    elif case == "culled_dead":
        alive[::2] = False
        z[1::4] = -z[1::4]                       # behind the camera
        x[3::8] = 1e4                            # far off the image
        s[5::8] = -30.0                          # zero-radius footprints
    elif case == "det_zero":
        # near-degenerate footprints: one long axis, the 0.3 low-pass lost
        # in rounding, so det = c00 c11 - c01^2 rounds to 0 on many rows
        z = rng.uniform(0.25, 1.0, N)
        x, y = rng.uniform(-0.3, 0.3, N), rng.uniform(-0.3, 0.3, N)
        s = np.stack([np.full(N, 4.0), np.full(N, -20.0),
                      np.full(N, -20.0)], 1)
    q[:2] = 0.0                                  # the 1e-24 norm guard
    m = np.stack([x, y, z], 1)
    return (m.astype(np.float32), q.astype(np.float32), s.astype(np.float32),
            rng.normal(size=(N, 1)).astype(np.float32),
            rng.uniform(0, 1, (N, 3)).astype(np.float32), alive)


CASES = ["random", "near_cull", "tz_zero", "tanfov_clamp", "culled_dead",
         "det_zero", "offset"]


@pytest.mark.parametrize("mask_op", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_project_bwd_formula_matches_autograd(case, mask_op):
    rng = np.random.default_rng(CASES.index(case) + 10 * mask_op)
    arrs = _rows(case, rng)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs[:5]]
    alive = torch.tensor(arrs[5])
    offset = None
    if case == "offset":
        offset = torch.tensor(rng.normal(0, 2, (N, 2)).astype(np.float32),
                              requires_grad=True)
    table, proj = project_table(*leaves, alive, CAM, means2d_offset=offset,
                                depth_col=True, mask_opacity=mask_op)
    rows = torch.ones(N, dtype=torch.bool)
    if case == "det_zero":
        # the guarded rows; where det rounds to a tiny non-zero value the
        # chain's own gradient is rounding noise (dD ~ 1 / det^2 cancels
        # against the c's), and only the same operations in the same order
        # would reproduce it
        det = _ewa_core(*(torch.tensor(a) for a in arrs[:3]), CAM)[5]
        rows = det == 0
        assert int(rows.sum()) > N // 20
    if case == "near_cull":
        assert 0 < int(proj.valid.sum()) < N
    dtable = torch.tensor(rng.normal(size=tuple(table.shape)).astype(
        np.float32))
    wrt = leaves + ([offset] if offset is not None else [])
    auto = torch.autograd.grad(table, wrt, dtable)
    mine = project_bwd_formula(*[x.detach() for x in leaves[:4]], proj.valid,
                               dtable, CAM, 3, depth_col=True,
                               mask_op=mask_op)
    names = ["means_cam", "quats", "log_scales", "logit", "rgb", "offset"]
    for name, a, b in zip(names, auto, mine):
        assert torch.isfinite(a).all() == torch.isfinite(b).all(), name
        keep = rows & torch.isfinite(a).all(dim=1)
        a, b = a[keep], b[keep]
        scale = a.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((a - b).abs().amax(dim=0) / scale).max())
        assert err < 1e-4, f"{case}: d {name} off by {err:.2e} of its max"


def test_project_table_columns_are_the_plain_chain():
    """The table's layout: u, v, conic, the (masked) opacity, the features
    and the depth column, row for row as the chain's pieces give them."""
    rng = np.random.default_rng(3)
    m, q, s, lo, rgb, alive = (torch.tensor(a) for a in
                               _rows("culled_dead", rng))
    table, proj = project_table(m, q, s, lo, rgb, alive, CAM,
                                depth_col=True, mask_opacity=True)
    u, v, cA, cB, cC, _, _ = _ewa_core(m, q, s, CAM)
    op = torch.where(proj.valid, torch.sigmoid(lo[:, 0]), 0.0)
    want = torch.stack([u, v, cA, cB, cC, op, *rgb.unbind(-1), m[:, 2]], 1)
    torch.testing.assert_close(table, want, rtol=0, atol=0, equal_nan=True)
    assert table.shape == (N, 10)
