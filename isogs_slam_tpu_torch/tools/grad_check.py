"""Kernel gradient-correctness harness (counterpart of
isogs_slam_tpu/tools/grad_check.py): central finite differences against
torch.autograd for every differentiable kernel of the port: the flat loss,
the iso-surface loss and the rasterizer's forward and backward through
both of the mapping render's backward routes ("segreduce": kernel B, the
expansion scatter and kernel C; "scatter": kernel B and index_add_).

    python -m isogs_slam_tpu_torch.tools.grad_check [--n 512] [--eps 1e-5]
        [--device cpu]

The analytic gradients run on --device: on the card (the default) the
render goes through kernels A, B and C in f32, on the CPU through their
plain PyTorch versions. The central differences are taken in float64 on
the CPU through the plain versions (the kernels take f32 only): the JAX
tool differences its f32 losses at eps 1e-3, where the f32 rounding of a
sum over ~3000 pixels and the compositing's 1/255 alpha cut-off put
several percent of noise on a probe; in float64 at eps 1e-5 (the JAX
package's tests/test_rasterizer.py::_fd_check differences in float64 too)
the card's f32 kernels come within ~0.2% (bf16 gradient rows) and ~0%
(f32 rows) on the CPU's plain versions. The checks and their pass rule
are the JAX tool's: a check passes when max_diff < abs_tol or rel <
rel_tol (the JAX tool's GradStats.passed), the render checks at abs_tol
max(abs_tol, 1e-2); a probe that straddles one of the compositing's
discontinuities is excluded and counted (at most --max-boundary-hits a
check, see _check). The render check names carry the port's backward
route where the JAX tool's carry its compositing backend. Exit code 0 iff
every check passes.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


class GradStats:
    """Pass rule of the JAX tool: max_diff < abs_tol or rel < rel_tol, rel
    = max_diff / max |numerical|, over the probes that do not straddle a
    discontinuity (`excluded`: their count, at most max_boundary_hits)."""

    def __init__(self, name, analytic, numerical, abs_tol, rel_tol,
                 excluded=0, max_boundary_hits=0):
        d = np.abs(analytic - numerical)
        self.name = name
        self.max_diff = float(d.max()) if d.size else 0.0
        self.mean_diff = float(d.mean()) if d.size else 0.0
        scale = float(np.abs(numerical).max()) + 1e-12
        self.rel = self.max_diff / scale
        self.excluded = excluded
        self.passed = ((self.max_diff < abs_tol or self.rel < rel_tol)
                       and excluded <= max_boundary_hits)

    def report(self):
        flag = "PASS" if self.passed else "FAIL"
        print(f"  [{flag}] {self.name}: max_diff={self.max_diff:.3e} "
              f"mean_diff={self.mean_diff:.3e} rel={self.rel:.2%}"
              + (f" ({self.excluded} boundary probe(s) excluded)"
                 if self.excluded else ""))
        return self.passed


def numerical_gradient(f, x, eps, samples=None, rng=None):
    """Central differences, and the two one-sided slopes of each probe;
    for large x only `samples` random entries are probed. Returns
    (central [x.shape], idx, slope_plus [len(idx)], slope_minus)."""
    x = np.asarray(x, np.float64)
    flat = x.reshape(-1)
    if samples is not None and flat.size > samples:
        idx = (rng or np.random.default_rng(0)).choice(
            flat.size, samples, replace=False)
    else:
        idx = np.arange(flat.size)
    f0 = f(x)
    g = np.zeros(flat.size)
    sp, sm = np.zeros(len(idx)), np.zeros(len(idx))
    for j, i in enumerate(idx):
        xp = flat.copy(); xp[i] += eps
        xm = flat.copy(); xm[i] -= eps
        fp, fm = f(xp.reshape(x.shape)), f(xm.reshape(x.shape))
        g[i] = (fp - fm) / (2 * eps)
        sp[j], sm[j] = (fp - f0) / eps, (f0 - fm) / eps
    return g.reshape(x.shape), idx, sp, sm


def _check(name, loss_fn, num_fn, x0, eps, abs_tol, rel_tol, samples, rng,
           dev, max_boundary_hits):
    """The compositing is discontinuous at the alpha (1/255) and
    transmittance (1e-4) cut-offs and at tile-rect edges, and has a kink
    at the 0.99 opacity clamp: a probe whose eps-interval holds one is not
    a gradient error. Such a probe is recognised by its two one-sided
    slopes disagreeing by more than rel_tol of the probes' largest slope;
    when it is also off the analytic gradient by that much it is excluded
    from the statistics, and the check fails when more than
    max_boundary_hits probes are (the convention of the JAX package's
    tests/test_rasterizer.py::_fd_check)."""
    def f64(arr):
        with torch.no_grad():
            return float(num_fn(torch.as_tensor(np.asarray(arr, np.float64))))

    x = torch.as_tensor(np.asarray(x0, np.float32), device=dev
                        ).requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(x), (x,))
    analytic = g.detach().cpu().numpy().astype(np.float64).reshape(-1)
    numerical, idx, sp, sm = numerical_gradient(f64, x0, eps, samples, rng)
    flat_a = analytic[idx]
    flat_n = numerical.reshape(-1)[idx]
    tol = max(rel_tol * (float(np.abs(flat_n).max()) + 1e-12), abs_tol)
    straddle = ((np.abs(sp - sm) > tol)
                & (np.abs(flat_a - flat_n) > tol))
    keep = ~straddle
    return GradStats(name, flat_a[keep], flat_n[keep], abs_tol, rel_tol,
                     int(straddle.sum()), max_boundary_hits)


def _render_plain(means_cam, quats_cam, log_scales, logit_opacities, rgb,
                  alive, cam, cfg):
    """render_rgbd_sil's forward through the plain compositing in the
    inputs' dtype (float64 for the central differences; the kernels and
    their wrappers take float32 only): (im, depth, silhouette)."""
    from ..ops.composite import composite_fwd_plain
    from ..ops.rasterize import (_pad_k, _raster_table, _tiles_to_image,
                                 bin_gaussians, project_gaussians)
    opacity = torch.sigmoid(logit_opacities[:, 0])
    proj = project_gaussians(means_cam, quats_cam, log_scales, alive, cam)
    b = bin_gaussians(proj, cam, cfg)
    table = _raster_table(proj, opacity,
                          torch.cat([rgb, means_cam[:, 2:3]], dim=-1))
    out, final_t = composite_fwd_plain(_pad_k(table[b.tile_gauss]),
                                       b.tile_count, 4, cam.tiles_x, 3,
                                       chunk=cfg.tile_chunk)
    img = _tiles_to_image(out, cam)
    return img[0:3], img[3:4], 1.0 - _tiles_to_image(final_t[..., None],
                                                     cam)[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=512, help="num gaussians")
    p.add_argument("--eps", type=float, default=1e-5,
                   help="central-difference step (float64)")
    p.add_argument("--samples", type=int, default=64,
                   help="finite-diff probes per tensor")
    p.add_argument("--abs-tol", type=float, default=1e-4)
    p.add_argument("--rel-tol", type=float, default=0.10)
    p.add_argument("--max-boundary-hits", type=int, default=2,
                   help="probes per check that may straddle a "
                        "discontinuity of the compositing")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (kernels A, B, C) or cpu (plain versions)")
    args = p.parse_args(argv)
    from .. import resolve_device
    from ..core.camera import Camera
    from ..ops.iso_loss import flat_loss, iso_surface_loss, \
        sample_pool_queries
    from ..ops.rasterize import RasterConfig, render_rgbd_sil

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n = args.n
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    logs = np.log(rng.uniform(0.03, 0.1, (n, 3))).astype(np.float32)
    ops = rng.uniform(-1, 2, (n, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-n // 8:] = False
    # one fixed query sample for every evaluation of the iso loss
    sel = sample_pool_queries(
        torch.as_tensor(alive), 128, torch.Generator().manual_seed(0))
    cam = Camera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)

    def losses(d, dt):
        """The checks' losses on device d in dtype dt: (name, fn, x0)."""
        def t(a):
            return torch.as_tensor(a, device=d).to(
                dt if a.dtype != bool else torch.bool)

        aj, mj, qj, lj, oj, cj = (t(alive), t(means), t(quats), t(logs),
                                  t(ops), t(rgb))
        s_d = sel.to(d)

        def iso(m=mj, ls=lj, o=oj):
            return iso_surface_loss(m, qj, ls, o, aj, None, 128, sel=s_d,
                                    k=8, knn_method="exact")[0]

        out = [("d flat / d log_scales", lambda ls: flat_loss(ls, aj), logs),
               ("d iso / d means", lambda m: iso(m=m), means),
               ("d iso / d logit_opacities", lambda o: iso(o=o), ops),
               ("d iso / d log_scales", lambda ls: iso(ls=ls), logs)]
        for route in ("segreduce", "scatter"):
            # segreduce as the mapping path runs it (kernel B's rows in
            # bf16, kernel C summing in f32); scatter with f32 rows (its
            # bf16 index_add_ accumulates in bf16). K = 256 holds every
            # tile's candidates at the default n: the JAX tool's K = 128
            # drops 108 (two full tiles), and a probe that moves a
            # Gaussian across the cap's cut is a jump on both of its
            # sides, not a gradient error
            cfg = RasterConfig(max_per_tile=256, tile_chunk=12,
                               bwd_mode=route,
                               grad_scatter_bf16=route == "segreduce")

            def render_loss(m, o=oj, cfg=cfg):
                if dt == torch.float64:
                    im, depth, sil = _render_plain(m, qj, lj, o, cj, aj,
                                                   cam, cfg)
                else:
                    im, depth, sil, _, _ = render_rgbd_sil(
                        m, qj, lj, o, cj, aj, cam, cfg)
                return (torch.sum(im * im) + torch.sum(depth)
                        + 0.3 * torch.sum(sil))

            out.append((f"d render / d means_cam [{route}]", render_loss,
                        means))
            out.append((f"d render / d logit_opacities [{route}]",
                        lambda o, f=render_loss: f(mj, o=o), ops))
        return out

    heads = {0: "== Flat loss (compute_flat_loss semantics) ==",
             1: "== Iso-surface loss (exact KNN) ==",
             4: "== Rasterizer (both backward routes) =="}
    results = []
    for i, ((name, fn, x0), (_, num_fn, _)) in enumerate(zip(
            losses(dev, torch.float32),
            losses(torch.device("cpu"), torch.float64))):
        if i in heads:
            print(heads[i])
        abs_tol = (max(args.abs_tol, 1e-2) if name.startswith("d render")
                   else args.abs_tol)
        results.append(_check(name, fn, num_fn, x0, args.eps, abs_tol,
                              args.rel_tol, args.samples, rng, dev,
                              args.max_boundary_hits))

    ok = all([r.report() for r in results])
    print("\nALL PASS" if ok else "\nFAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
