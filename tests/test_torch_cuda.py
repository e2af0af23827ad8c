"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an NVIDIA card and nvcc, and skip without them
(a CUDA kernel has no interpret mode). This file imports no JAX, so on the
card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.ops import _cuda
from isogs_slam_tpu_torch.ops.composite import (composite_bwd_cuda,
                                                composite_bwd_plain,
                                                composite_fwd_cuda,
                                                composite_fwd_plain)
from isogs_slam_tpu_torch.ops.segreduce import (segment_reduce_rows_cuda,
                                                segment_reduce_rows_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; decided here (not at import) so every test worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gdata(T, K, F, tiles_x, seed):
    """Random per-slot records whose footprints land in their tile; up to
    1.2 opacity so tiles saturate and pixels terminate."""
    rng = np.random.default_rng(seed)
    g = np.zeros((T, K, 6 + F), np.float32)
    for t in range(T):
        ox, oy = (t % tiles_x) * 16, (t // tiles_x) * 16
        g[t, :, 0] = rng.uniform(ox - 2, ox + 18, K)
        g[t, :, 1] = rng.uniform(oy - 2, oy + 18, K)
    g[:, :, 2] = rng.uniform(0.05, 0.6, (T, K))
    g[:, :, 3] = rng.uniform(-0.05, 0.05, (T, K))
    g[:, :, 4] = rng.uniform(0.05, 0.6, (T, K))
    g[:, :, 5] = rng.uniform(0.0, 1.2, (T, K))
    g[:, :, 6:] = rng.uniform(0, 2, (T, K, F))
    counts = rng.integers(0, K + 1, T).astype(np.int32)
    counts[0], counts[1] = 0, K
    return torch.as_tensor(g), torch.as_tensor(counts)


@pytest.mark.parametrize("K,sq_col", [(256, 3), (512, 3), (256, None)])
def test_composite_fwd_kernel_matches_plain(dev, K, sq_col):
    g, c = _gdata(24, K, 4, 6, seed=K)
    g, c = g.to(dev), c.to(dev)
    out, ft, last, tend = composite_fwd_cuda(g, c, 4, 6, sq_col)
    out_p, ft_p = composite_fwd_plain(g, c, 4, 6, sq_col, chunk=8)
    torch.cuda.synchronize()
    assert float((out - out_p).abs().max()) < 1e-5 * float(out_p.abs().max())
    assert float((ft - ft_p).abs().max()) < 1e-5
    assert int(last.max()) < K and int(last.min()) >= -1
    assert torch.all(last[0] == -1)          # empty tile


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composite_bwd_kernel_matches_plain(dev, out_dtype):
    g, c = _gdata(24, 256, 4, 6, seed=5)
    g, c = g.to(dev), c.to(dev)
    rng = np.random.default_rng(6)
    gout = torch.as_tensor(rng.normal(size=(24, 256, 5)), dtype=torch.float32,
                           device=dev)
    dfin = torch.as_tensor(rng.normal(size=(24, 256)), dtype=torch.float32,
                           device=dev)
    _, _, last, tend = composite_fwd_cuda(g, c, 4, 6, 3)
    dg = composite_bwd_cuda(g, c, gout, dfin, last, tend, 4, 6, 3, out_dtype)
    dg_p = composite_bwd_plain(g, c, gout, dfin, 4, 6, 3, chunk=8)
    torch.cuda.synchronize()
    assert dg.dtype == out_dtype
    scale = dg_p.abs().amax(dim=(0, 1))                 # per column
    err = ((dg.float() - dg_p).abs().amax(dim=(0, 1)) / scale).max()
    # f32: gradients to 1e-4 of their max (the reference's kernel
    # tolerance); bf16: one bf16 rounding of each row (2^-8 relative)
    assert float(err) < (1e-4 if out_dtype == torch.float32 else 4e-3)
    # rows at or past count carry zeros
    k = torch.arange(256, device=dev)[None, :] >= c[:, None]
    assert float(dg.float()[k].abs().max()) == 0.0


def _bwd_against_plain(dev, g, c, tiles_x, out_dtype, seed):
    """Kernel A then kernel B on (g, c) against the plain versions; returns
    kernel A's `last` for the caller's own checks."""
    T, K, _ = g.shape
    g, c = g.to(dev), c.to(dev)
    rng = np.random.default_rng(seed)
    gout = torch.as_tensor(rng.normal(size=(T, 256, 5)), dtype=torch.float32,
                           device=dev)
    dfin = torch.as_tensor(rng.normal(size=(T, 256)), dtype=torch.float32,
                           device=dev)
    out, ft, last, tend = composite_fwd_cuda(g, c, 4, tiles_x, 3)
    out_p, ft_p = composite_fwd_plain(g, c, 4, tiles_x, 3, chunk=8)
    dg = composite_bwd_cuda(g, c, gout, dfin, last, tend, 4, tiles_x, 3,
                            out_dtype)
    dg_p = composite_bwd_plain(g, c, gout, dfin, 4, tiles_x, 3, chunk=8)
    torch.cuda.synchronize()
    assert float((out - out_p).abs().max()) < 1e-5 * float(out_p.abs().max())
    assert float((ft - ft_p).abs().max()) < 1e-5
    assert dg.dtype == out_dtype and bool(torch.isfinite(dg.float()).all())
    scale = dg_p.abs().amax(dim=(0, 1))
    err = ((dg.float() - dg_p).abs().amax(dim=(0, 1)) / scale).max()
    # f32: 1e-4 of each column's max; bf16: one bf16 rounding of each row
    assert float(err) < (1e-4 if out_dtype == torch.float32 else 4e-3)
    k = torch.arange(K, device=dev)[None, :] >= c[:, None]
    assert float(dg.float()[k].abs().max()) == 0.0
    return last


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composite_bwd_kernel_matches_plain_k512(dev, out_dtype):
    g, c = _gdata(24, 512, 4, 6, seed=15)
    _bwd_against_plain(dev, g, c, 6, out_dtype, seed=16)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composite_kernels_edge_tiles(dev, out_dtype):
    """Tiles that sit on the kernels' batch edges: every pixel terminating
    within the first staged batch, the last included slot exactly at the
    end of a 32-slot batch and at the start of the next, one slot, and
    slots whose opacity is at, below and far below 1/255 or zero."""
    T, K, tx = 8, 128, 4
    g, c = _gdata(T, K, 4, tx, seed=25)

    def wide(t, n, op):
        """n slots covering the whole tile with nearly flat footprints."""
        ox, oy = (t % tx) * 16, (t // tx) * 16
        g[t, :n, 0], g[t, :n, 1] = ox + 8.0, oy + 8.0
        g[t, :n, 2], g[t, :n, 3], g[t, :n, 4] = 1e-4, 0.0, 1e-4
        g[t, :n, 5] = op

    wide(1, 40, 0.9)            # T falls by 10x a slot: all stop by slot 4
    c[1] = K
    wide(2, 32, 0.02)           # all 32 included: last == 31 (batch edge)
    c[2] = 32
    wide(3, 33, 0.02)           # last == 32: a batch of one slot
    c[3] = 33
    wide(4, 1, 0.5)
    c[4] = 1
    lo = np.float32(1.0 / 255.0)
    g[5, ::2, 5] = torch.as_tensor(np.resize(np.array(
        [0.0, lo, np.nextafter(lo, np.float32(0)), 0.5 * lo, 1e-6],
        np.float32), g[5, ::2, 5].shape))
    c[5] = K
    g[6, :, 5] = 1e-3           # count > 0 and nothing contributes
    c[6] = 64
    last = _bwd_against_plain(dev, g, c, tx, out_dtype, seed=26).cpu()
    assert int(last[1].max()) < 8 and int(last[1].min()) >= 0
    assert bool((last[2] == 31).all()) and bool((last[3] == 32).all())
    assert bool((last[4] == 0).all()) and bool((last[6] == -1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segreduce_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    n = 5000
    lens = rng.integers(0, 6, n)
    lens[7] = 0
    lens[100] = 3000                 # one long segment
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    d = torch.as_tensor(rng.normal(size=(int(offs[-1]) + 3, 10)),
                        dtype=dtype, device=dev)
    o = torch.as_tensor(offs, device=dev)
    out = segment_reduce_rows_cuda(d, o)
    ref = segment_reduce_rows_plain(d, o)
    torch.cuda.synchronize()
    assert out.shape == (10, n) and out.dtype == torch.float32
    # f32 sums taken in another order: each differs by at most a few f32
    # roundings of the segment's absolute sum
    abs_sum = segment_reduce_rows_plain(d.float().abs(), o)
    assert torch.all((out - ref).abs() <= 1e-6 * abs_sum + 1e-7)


def test_launch_counters_count_launches(dev):
    g, c = _gdata(4, 128, 4, 2, seed=9)
    _cuda.reset_launches()
    composite_fwd_cuda(g.to(dev), c.to(dev), 4, 2, 3)
    assert _cuda.LAUNCHES == {"composite_fwd[T=4,K=128]": 1}


@pytest.mark.parametrize("K", [768, 1024])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composite_kernels_large_k(dev, K, out_dtype):
    """The slot counts the pipeline escalates to when a 512 cap drops true
    candidates: the kernels stage 32-slot batches, so K only lengthens
    their loops."""
    g, c = _gdata(12, K, 4, 4, seed=K)
    c[2] = K - 1
    last = _bwd_against_plain(dev, g, c, 4, out_dtype, seed=K + 1)
    assert int(last.max()) < K


@pytest.mark.parametrize("K", [256, 1000])
def test_fused_render_partial_tiles(dev, K):
    """A camera whose last tile column is 8 px wide and last tile row 4 px
    high (a 2x pyramid level of 1200x680 has both), at a K that is and is
    not a multiple of the 128-slot padding: the fused render on the card
    against the CPU, cropped to the image."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (RasterConfig,
                                                    render_rgbd_sil)
    rng = np.random.default_rng(3)
    n = 1200
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    arrs = [means, rng.normal(0, 1, (n, 4)),
            np.log(rng.uniform(0.02, 0.1, (n, 3))),
            rng.uniform(-2, 3, (n, 1)), rng.uniform(0, 1, (n, 3))]
    cam = Camera(width=88, height=52, fx=70.0, fy=70.0, cx=43.5, cy=25.5)
    assert (cam.tiles_x, cam.tiles_y) == (6, 4)
    cfg = RasterConfig(max_per_tile=K, grad_scatter_bf16=False)

    def run(device):
        ps = [torch.tensor(a, dtype=torch.float32, device=device,
                           requires_grad=True) for a in arrs]
        im, d, s, dsq, _ = render_rgbd_sil(
            *ps, torch.ones(n, dtype=torch.bool, device=device), cam, cfg)
        loss = (im ** 2).sum() + d.sum() + 0.5 * s.sum() + dsq.sum()
        gs = torch.autograd.grad(loss, ps)
        return [x.detach().cpu() for x in (im, d, s)], [x.cpu() for x in gs]

    (im1, d1, s1), g1 = run("cpu")
    (im2, d2, s2), g2 = run(dev)
    assert im2.shape == (3, 52, 88) and s2.shape == (52, 88)
    assert float((im1 - im2).abs().max()) < 1e-5
    assert float((d1 - d2).abs().max()) < 1e-4
    assert float((s1 - s2).abs().max()) < 1e-5
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) / float(a.abs().max()) < 1e-4


@pytest.mark.parametrize("K", [512, 1000])
def test_table_fold_kernel_c_matches_former_formulation(dev, K):
    """The mapping route's one fold on the card (kernels A, B and C, every
    column live, bf16 rows), at a K that is and is not a multiple of the
    128-slot padding: the table gradient is torch.equal to the former
    formulation restated here (kernel B's rows gathered by a host list of
    the columns, scattered into d_exp, kernel C, written back into a zero
    table)."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops import rasterize as R
    from isogs_slam_tpu_torch.ops.composite import (composite_backward,
                                                    composite_forward)
    rng = np.random.default_rng(4)
    n = 1500
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    arrs = [means, rng.normal(0, 1, (n, 4)),
            np.log(rng.uniform(0.02, 0.1, (n, 3))),
            rng.uniform(-2, 3, (n, 1)), rng.uniform(0, 1, (n, 3))]
    cam = Camera(width=88, height=52, fx=80.0, fy=80.0, cx=43.5, cy=25.5)
    cfg = R.RasterConfig(max_per_tile=K)
    ps = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]
    with torch.no_grad():
        table, proj = R.project_table(
            *ps, torch.ones(n, dtype=torch.bool, device=dev), cam,
            depth_col=True)
        b = R.bin_gaussians(proj, cam, cfg, emit_exp=True)
    table.requires_grad_(True)
    wo = torch.randn((cam.num_tiles, 256, 5), device=dev)
    wt = torch.randn((cam.num_tiles, 256), device=dev)
    out, ft = R.composite_table(table, 4, b, cam, cfg, R.MAPPING_LIVE_COLS,
                                sq_col=3)
    (got,) = torch.autograd.grad((out * wo).sum() + (ft * wt).sum(), table)

    gdata = R._pad_k(table.detach()[b.tile_gauss])
    _, _, saved = composite_forward(gdata, b.tile_count, 4, cam.tiles_x, 3)
    dg = composite_backward(gdata, b.tile_count, wo, wt, saved, 4,
                            cam.tiles_x, 3, torch.bfloat16)
    cols = list(R.MAPPING_LIVE_COLS)
    dsub = dg[:, :K][..., cols].reshape(-1, len(cols))
    d_exp = torch.zeros((cfg.max_isect(n) + 1, len(cols)),
                        dtype=torch.bfloat16, device=dev)
    d_exp[b.slot_exp_pos.reshape(-1)] = dsub
    want = torch.zeros(table.shape, device=dev)
    want[:, cols] = segment_reduce_rows_cuda(d_exp, b.exp_offsets).T
    torch.cuda.synchronize()
    assert float(got.abs().max()) > 0
    assert torch.equal(got, want)


def test_fused_render_cuda_matches_cpu(dev):
    """The whole fused mapping render (kernel A forward; kernels B and C in
    the backward) on the card against the same render on the CPU."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (RasterConfig,
                                                    render_rgbd_sil)
    rng = np.random.default_rng(0)
    n = 1500
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    arrs = [means, rng.normal(0, 1, (n, 4)),
            np.log(rng.uniform(0.02, 0.1, (n, 3))),
            rng.uniform(-2, 3, (n, 1)), rng.uniform(0, 1, (n, 3))]
    alive = np.ones(n, bool)
    alive[-100:] = False
    cam = Camera(width=96, height=80, fx=80.0, fy=80.0, cx=47.5, cy=39.5)
    cfg = RasterConfig(max_per_tile=256, grad_scatter_bf16=False)

    def run(device):
        ps = [torch.tensor(a, dtype=torch.float32, device=device,
                           requires_grad=True) for a in arrs]
        im, d, s, dsq, _ = render_rgbd_sil(
            *ps, torch.as_tensor(alive, device=device), cam, cfg)
        loss = (im ** 2).sum() + d.sum() + 0.5 * s.sum() + dsq.sum()
        gs = torch.autograd.grad(loss, ps)
        return [x.detach().cpu() for x in (im, d, s)], [x.cpu() for x in gs]

    (im1, d1, s1), g1 = run("cpu")
    (im2, d2, s2), g2 = run(dev)
    assert float((im1 - im2).abs().max()) < 1e-5
    assert float((d1 - d2).abs().max()) < 1e-4
    assert float((s1 - s2).abs().max()) < 1e-5
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) / float(a.abs().max()) < 1e-4


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composite_kernels_on_a_virtual_row(dev, out_dtype):
    """tiles_x = T, as the tile-subset renders launch the kernels: 1000
    tiles in one row (pixel x up to 16,000, where an f32 ulp is 2^-10 px)
    with partial counts, against the plain versions."""
    T, K = 1000, 256
    g, c = _gdata(T, K, 4, T, seed=9)
    g, c = g.to(dev), c.to(dev)
    out, ft, last, tend = composite_fwd_cuda(g, c, 4, T, 3)
    out_p, ft_p = composite_fwd_plain(g, c, 4, T, 3, chunk=50)
    tol = 1e-5 * float(out_p.abs().max())
    # a threshold test may flip in a handful of pixels between the two
    # summation orders; none may be far off
    bad = int(((out - out_p).abs() > tol).any(-1).sum()
              + ((ft - ft_p).abs() > 1e-5).sum())
    assert bad <= 2, bad
    gen = torch.Generator(device=dev).manual_seed(0)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    dfin = torch.randn(ft.shape, generator=gen, device=dev)
    dg = composite_bwd_cuda(g, c, gout, dfin, last, tend, 4, T, 3, out_dtype)
    dg_p = composite_bwd_plain(g, c, gout, dfin, 4, T, 3, chunk=50)
    diff = (dg.float() - dg_p.to(out_dtype).float()).abs()
    rel = diff.amax(dim=(0, 1)) / dg_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    assert float(rel.max()) < (1e-4 if out_dtype == torch.float32
                               else 2 ** -7)


@pytest.mark.parametrize("scatter_bf16", [False, True])
def test_subset_render_routes_agree(dev, scatter_bf16):
    """render_tiles_subset on a subset with partial tiles: the scatter
    route and the segment-reduce route (kernel C on the subset's expansion
    positions) give the CPU render's tiles and gradients (1e-5 / 1e-4 of
    max in f32; one bf16 rounding of the max with bf16 rows)."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (MAPPING_LIVE_COLS,
                                                    RasterConfig,
                                                    bin_gaussians,
                                                    project_gaussians,
                                                    render_tiles_subset)
    rng = np.random.default_rng(0)
    n = 1500
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    arrs = [means, rng.normal(0, 1, (n, 4)),
            np.log(rng.uniform(0.02, 0.1, (n, 3))),
            rng.uniform(-2, 3, (n, 1)), rng.uniform(0, 1, (n, 3))]
    cam = Camera(width=88, height=52, fx=80.0, fy=80.0, cx=43.5, cy=25.5)
    sel_np = np.array([0, 5, 6, 11, 12, 17, 18, 23])   # edge tiles included

    def run(device, route):
        cfg = RasterConfig(max_per_tile=256, bwd_mode=route,
                           grad_scatter_bf16=scatter_bf16)
        ps = [torch.tensor(a, dtype=torch.float32, device=device,
                           requires_grad=True) for a in arrs]
        alive = torch.ones(n, dtype=torch.bool, device=device)
        with torch.no_grad():
            proj = project_gaussians(ps[0], ps[1], ps[2], alive, cam)
            b = bin_gaussians(proj, cam, cfg, emit_exp=True)
        sel = torch.as_tensor(sel_np, device=device)
        out, ft, _ = render_tiles_subset(
            ps[0], ps[1], ps[2], ps[3], ps[4], alive, sel, b, cam, cfg,
            live_grad_cols=MAPPING_LIVE_COLS)
        loss = (out ** 2).sum() + ft.sum()
        gs = torch.autograd.grad(loss, ps)
        return out.detach().cpu(), [x.cpu() for x in gs]

    ref_out, ref_g = run("cpu", "segreduce")
    tol = 2 ** -7 if scatter_bf16 else 1e-4
    for route in ("scatter", "segreduce"):
        out, gs = run(dev, route)
        assert float((out - ref_out).abs().max()) < 1e-5 * max(
            1.0, float(ref_out.abs().max()))
        for a, b in zip(ref_g, gs):
            assert float((a - b).abs().max()) / float(a.abs().max()) < tol, \
                route


def _m2d_scene(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    arrs = [means, rng.normal(0, 1, (n, 4)),
            np.log(rng.uniform(0.02, 0.1, (n, 3))),
            rng.uniform(-2, 3, (n, 1)), rng.uniform(0, 1, (n, 3))]
    alive = np.ones(n, bool)
    alive[-100:] = False
    return arrs, alive


@pytest.mark.parametrize("subset", [False, True],
                         ids=["whole_image", "tile_subset"])
def test_means2d_offset_gradient_cuda_matches_cpu(dev, subset):
    """d loss / d(u, v) of a zero means2d_offset: kernel B's du/dv carried
    back per Gaussian through kernel C's columns 0-1 (whole image, inline
    binning as the offline loss renders) or index_add_ (a tile subset), on
    the card against the plain versions on the CPU; 1e-4 of its max."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (
        MAPPING_LIVE_COLS, RasterConfig, bin_gaussians, project_gaussians,
        render_rgbd_sil, render_tiles_subset)
    arrs, alive = _m2d_scene()
    n = alive.shape[0]
    cam = Camera(width=96, height=80, fx=80.0, fy=80.0, cx=47.5, cy=39.5)
    cfg = RasterConfig(max_per_tile=512, grad_scatter_bf16=False)
    sel = [0, 3, 7, 8, 13, 22, 29]

    def run(device):
        ps = [torch.tensor(a, dtype=torch.float32, device=device)
              for a in arrs]
        al = torch.as_tensor(alive, device=device)
        m2d = torch.zeros((n, 2), device=device, requires_grad=True)
        if subset:
            proj = project_gaussians(ps[0], ps[1], ps[2], al, cam)
            b = bin_gaussians(proj, cam, cfg)
            out, ft, _ = render_tiles_subset(
                *ps, al, torch.tensor(sel, device=device), b, cam, cfg,
                live_grad_cols=MAPPING_LIVE_COLS, means2d_offset=m2d)
            loss = (out ** 2).sum() + ft.sum()
        else:
            im, d, s, dsq, _ = render_rgbd_sil(*ps, al, cam, cfg,
                                               means2d_offset=m2d)
            loss = (im ** 2).sum() + d.sum() + 0.5 * s.sum() + dsq.sum()
        (g,) = torch.autograd.grad(loss, m2d)
        return g.cpu()

    g_cpu = run("cpu")
    _cuda.reset_launches()
    g_dev = run(dev)
    torch.cuda.synchronize()
    assert float(g_cpu.abs().max()) > 0
    assert float((g_cpu - g_dev).abs().max()) < 1e-4 * float(
        g_cpu.abs().max())
    launched = dict(_cuda.LAUNCHES)
    assert any(k.startswith("composite_bwd") for k in launched)
    assert ("segreduce" in launched) != subset


def test_knn_blocked_cuda_matches_cpu(dev):
    """The exact streaming KNN on the card: the CPU's neighbour sets (no
    ties among continuous points) and distances to 1e-6, dead rows never
    chosen."""
    from isogs_slam_tpu_torch.ops.iso_loss import knn_blocked
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(-1, 1, (5000, 3)), dtype=torch.float32)
    q = torch.tensor(rng.uniform(-1, 1, (700, 3)), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(size=5000) > 0.1)
    d_c, i_c = knn_blocked(q, pts, valid, 16, 1024)
    d_g, i_g = knn_blocked(q.to(dev), pts.to(dev), valid.to(dev), 16, 1024)
    i_g = i_g.cpu()
    for a, b in zip(i_c.tolist(), i_g.tolist()):
        assert set(a) == set(b)
    assert bool(valid[i_g].all())
    assert float((torch.sort(d_c, 1).values
                  - torch.sort(d_g.cpu(), 1).values).abs().max()) < 1e-6


def test_density_grid_cuda_matches_cpu(dev):
    """The mesh density pass on the card against the port's own CPU grid
    for a toy flake map: the same spec and growth, grids within 1e-4 of
    the max (two f32 summation orders of the absolute-coordinate lift, as
    tests/test_torch_mesh.py holds it; TF32 would show as ~1e-2)."""
    from isogs_slam_tpu_torch.mesh.density import compute_density
    rng = np.random.default_rng(0)
    n = 400
    ls = np.log(rng.uniform(0.02, 0.12, (n, 3)))
    ls[:, 2] = np.log(0.007)
    params = {"means3D": rng.normal(0, 0.4, (n, 3)).astype(np.float32),
              "log_scales": ls.astype(np.float32),
              "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
              "logit_opacities": rng.normal(0.5, 1.0, (n, 1)
                                            ).astype(np.float32)}
    info_c, info_g = {}, {}
    dc, sc = compute_density(params, voxel_size=0.05, padding=0.3,
                             min_scale_limit=0.025, max_per_block=16,
                             device="cpu", info=info_c)
    dg, sg = compute_density(params, voxel_size=0.05, padding=0.3,
                             min_scale_limit=0.025, max_per_block=16,
                             device=dev, info=info_g)
    assert sc == sg and info_c == info_g and info_c["rounds"] > 0
    scale = np.abs(dc).max()
    assert np.abs(dg - dc).max() < 1e-4 * scale


def test_zbuffer_cuda_matches_cpu(dev):
    """render_mesh_depth on the card against the CPU: the same coverage
    and depth within 1e-5 relative (a minimum does not depend on the
    order of the writes)."""
    from isogs_slam_tpu_torch.mesh.marching import marching_tetrahedra
    from isogs_slam_tpu_torch.mesh.zbuffer import render_mesh_depth
    lin = np.linspace(-1.2, 1.2, 48)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_tetrahedra(-np.sqrt(X ** 2 + Y ** 2 + Z ** 2), -0.5,
                               spacing=(lin[1] - lin[0],) * 3,
                               origin=(-1.2,) * 3, use_native=False)
    v = v + np.array([0.0, 0.0, 2.0], v.dtype)
    K = np.array([[60.0, 0, 40], [0, 60.0, 32], [0, 0, 1]])
    dc = render_mesh_depth(v, f, np.eye(4), K, 80, 64, device="cpu",
                           chunk=16384)
    dg = render_mesh_depth(v, f, np.eye(4), K, 80, 64, device=dev)
    np.testing.assert_array_equal(dg > 0, dc > 0)
    np.testing.assert_allclose(dg, dc, rtol=1e-5)


def test_eval_sh_cuda_matches_cpu(dev):
    """The SH colour pre-pass of the viewers on the card against the CPU,
    every degree: within 1e-6 plus two f32 roundings of each colour (the
    card's elementwise kernels contract multiply-adds; measured 1.2e-6 on
    colours up to ~10)."""
    from isogs_slam_tpu_torch.ops.sh import eval_sh, sh_colors_for_pose
    rng = np.random.default_rng(0)
    shf = torch.tensor(rng.normal(size=(4096, 48)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(4096, 3)), dtype=torch.float32)
    center = torch.tensor([0.1, -0.2, 0.3])
    pairs = [(eval_sh(shf, dirs, deg),
              eval_sh(shf.to(dev), dirs.to(dev), deg).cpu())
             for deg in range(4)]
    pairs.append((sh_colors_for_pose(shf, dirs, center),
                  sh_colors_for_pose(shf.to(dev), dirs.to(dev),
                                     center.to(dev)).cpu()))
    for a, b in pairs:
        torch.testing.assert_close(b, a, rtol=2 ** -22, atol=1e-6)


@pytest.mark.parametrize("with_sh", [False, True])
def test_viewer_render_cuda_matches_cpu(dev, tmp_path, with_sh):
    """The viewers' path (load_scene -> make_render_fn -> render_w2c, the
    forward kernel A without a gradient) on the card against the CPU, with
    and without higher SH bands: image and silhouette within 1e-5, depth
    within 1e-4 (as the fused render's test)."""
    from isogs_slam_tpu_torch.io.checkpoints import save_checkpoint
    from isogs_slam_tpu_torch.ops import _cuda
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    from isogs_slam_tpu_torch.viz_scripts.common import (load_scene,
                                                         make_render_fn,
                                                         render_w2c)
    rng = np.random.default_rng(0)
    n, H, W = 2000, 64, 80
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    gauss = {"means3D": means,
             "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
             "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
             "logit_opacities": rng.uniform(-1, 3, (n, 1)).astype(
                 np.float32),
             "log_scales": np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(
                 np.float32)}
    if with_sh:
        gauss["sh_coeffs_flat"] = (0.3 * rng.normal(size=(n, 48))).astype(
            np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                 np.float32)
    rots = (np.array([1.0, 0, 0, 0])[None, :, None]
            + 0.05 * rng.normal(size=(1, 4, 3))).astype(np.float32)
    trans = (0.05 * rng.normal(size=(1, 3, 3))).astype(np.float32)
    save_checkpoint(str(tmp_path), 2, gauss, rots, trans, np.zeros(n), K,
                    np.eye(4), W, H, [np.eye(4)] * 3, [0])
    outs = []
    for device in ("cpu", dev):
        st, cam, est, _, _, shf = load_scene(str(tmp_path), return_sh=True,
                                             device=device)
        assert (shf is not None) == with_sh
        fn = make_render_fn(cam, RasterConfig(max_per_tile=512))
        _cuda.reset_launches()
        outs.append([[x.cpu() for x in render_w2c(fn, st, w2c, sh_flat=shf)]
                     for w2c in est])
    assert any(k.startswith("composite_fwd") for k in _cuda.LAUNCHES)
    assert not any(k.startswith("composite_bwd") for k in _cuda.LAUNCHES)
    for (im1, d1, s1), (im2, d2, s2) in zip(*outs):
        assert float(im1.max()) > 0.01
        assert float((im1 - im2).abs().max()) < 1e-5
        assert float((d1 - d2).abs().max()) < 1e-4
        assert float((s1 - s2).abs().max()) < 1e-5


def _project_rows(n, seed):
    """Camera-frame rows as the mapping render sees them, with every kink
    and guard of the projection on some rows: the near cull, tz = 0 and
    behind the camera, both sides of the tanfov clamps, dead rows, a zero
    quaternion, and degenerate footprints whose det rounds to 0."""
    rng = np.random.default_rng(seed)
    tanx, tany = 0.5 * 1200 / 600.0, 0.5 * 680 / 600.0
    z = rng.uniform(0.3, 8.0, n)
    x = rng.uniform(-1.2, 1.2, n) * tanx * z
    y = rng.uniform(-1.2, 1.2, n) * tany * z
    s = rng.uniform(-5.5, -2.5, (n, 3))
    k = rng.integers(0, 20, n)
    z[k == 0] = 0.2 + rng.uniform(-0.01, 0.01, int((k == 0).sum()))
    z[k == 1] = -z[k == 1]
    z[k == 2] = 0.0
    far = k == 3
    x[far] = rng.choice([-1, 1], int(far.sum())) * rng.uniform(
        1.3, 4.0, int(far.sum())) * 1.3 * tanx * z[far]
    y[k == 4] = -2.0 * 1.3 * tany * z[k == 4]
    deg = k == 5
    z[deg] = rng.uniform(0.25, 1.0, int(deg.sum()))
    s[deg] = [4.0, -20.0, -20.0]
    q = rng.normal(size=(n, 4))
    q[:3] = 0.0
    alive = rng.uniform(size=n) > 0.1
    arrs = [np.stack([x, y, z], 1), q, s, rng.uniform(-3, 4, (n, 1)),
            rng.uniform(0, 1, (n, 3)), rng.normal(0, 1, (n, 2))]
    return [a.astype(np.float32) for a in arrs], alive


@pytest.mark.parametrize("n", [1000, 1_245_184])
@pytest.mark.parametrize("render", [True, False],
                         ids=["render_table", "binning"])
def test_project_kernels_match_plain(dev, n, render):
    """Kernel P fwd against the plain chain on the card, bit for bit (table,
    radius, valid); kernel P bwd against autograd through it, within 1e-4
    of each gradient column's max. `render`: the mapping render's call
    (opacity masked by valid, rgb + the depth column, a means2d offset);
    else the binning's (the five columns u v A B C, a 2 px margin)."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.project import (_ewa_parts,
                                                  project_bwd_cuda,
                                                  project_fwd_cuda)
    from isogs_slam_tpu_torch.ops.rasterize import (project_gaussians_plain,
                                                    project_table_plain)
    cam = Camera(width=1200, height=680, fx=600.0, fy=600.0, cx=599.5,
                 cy=339.5)
    arrs, alive = _project_rows(n, seed=n % 97)
    ps = [torch.tensor(a, device=dev, requires_grad=True) for a in arrs]
    al = torch.as_tensor(alive, device=dev)
    if render:
        table_p, proj = project_table_plain(*ps[:5], al, cam,
                                            means2d_offset=ps[5],
                                            depth_col=True, mask_opacity=True)
        table, radius, valid = project_fwd_cuda(
            *[p.detach() for p in ps[:5]], al, cam, 0.0, ps[5].detach(),
            True, True)
        wrt = ps
    else:
        proj = project_gaussians_plain(*ps[:3], al, cam, margin_px=2.0)
        table_p = torch.stack([proj.u, proj.v, proj.conic[:, 0],
                               proj.conic[:, 1], proj.conic[:, 2]], 1)
        table, radius, valid = project_fwd_cuda(
            *[p.detach() for p in ps[:3]], None, None, al, cam, 2.0)
        assert table.shape == (n, 5)
        wrt = ps[:3]
    torch.cuda.synchronize()
    torch.testing.assert_close(table, table_p.detach(), rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(radius, proj.radius)
    assert torch.equal(valid, proj.valid)
    assert 0.3 * n < int(valid.sum()) < 0.95 * n

    rng = np.random.default_rng(1)
    dtable = torch.tensor(rng.normal(size=tuple(table_p.shape)).astype(
        np.float32), device=dev)
    auto = torch.autograd.grad(table_p, wrt, dtable)
    if render:
        mine = project_bwd_cuda(*[p.detach() for p in ps[:4]], valid, dtable,
                                cam, 3, True, True, want_offset=True)
    else:
        mine = project_bwd_cuda(*[p.detach() for p in ps[:3]], None, valid,
                                dtable, cam, 0)[:3]
    # rows whose det rounds to a tiny non-zero value: there the chain's own
    # gradient is rounding noise of det (d det ~ 1 / det^2 cancelling
    # against the c's), which only the same operations in the same order
    # reproduce; det = 0 exactly (the guard) is held
    e = _ewa_parts(*[p.detach() for p in ps[:3]], cam)
    rows = (e["det"] == 0) | (e["det"].abs()
                              > 1e-4 * (e["c00"] * e["c11"]).abs())
    assert int((~rows).sum()) < 0.1 * n
    assert int((e["det"] == 0).sum()) > 0
    for name, a, b in zip(["means_cam", "quats", "log_scales", "logit",
                           "rgb", "offset"], auto, mine):
        keep = rows & torch.isfinite(a).all(dim=1)
        a, b = a[keep], b[keep]
        scale = a.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((a - b).abs().amax(dim=0) / scale).max())
        assert err < 1e-4, f"d {name} off by {err:.2e} of its column max"


def test_project_kernels_on_the_render_path(dev):
    """render_rgbd_sil on the card projects through kernel P: the forward
    under no_grad, the pair under grad, and the gradient flows."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import (RasterConfig,
                                                    render_rgbd_sil)
    arrs, alive = _m2d_scene()
    cam = Camera(width=96, height=80, fx=80.0, fy=80.0, cx=47.5, cy=39.5)
    cfg = RasterConfig(max_per_tile=512)
    ps = [torch.tensor(a, dtype=torch.float32, device=dev,
                       requires_grad=True) for a in arrs]
    al = torch.as_tensor(alive, device=dev)
    _cuda.reset_launches()
    with torch.no_grad():
        render_rgbd_sil(*ps, al, cam, cfg)
    assert _cuda.LAUNCHES.get("project_fwd") == 1
    assert "project_bwd" not in _cuda.LAUNCHES
    im, d, s, dsq, _ = render_rgbd_sil(*ps, al, cam, cfg)
    gs = torch.autograd.grad(im.sum() + d.sum() + s.sum(), ps)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["project_fwd"] == 2
    assert _cuda.LAUNCHES["project_bwd"] == 1
    assert all(float(g.abs().max()) > 0 for g in gs)


# the cells' image shapes: Replica's 1200x680 (T = 3225) and TUM fr1's
# 640x480 (T = 1200)
BIN_CAMS = {"1200x680": dict(width=1200, height=680, fx=600.0, fy=600.0,
                             cx=599.5, cy=339.5),
            "640x480": dict(width=640, height=480, fx=517.3, fy=516.5,
                            cx=318.6, cy=255.3)}


def _bin_params(dev, cam, n=300_000, seed=0):
    """A map in the camera's view: 2% dead rows, 2% behind the near
    plane, 2% off the image (zero tile counts), and 5 rows near the camera
    whose rects cover the whole grid."""
    from isogs_slam_tpu_torch.core.gaussians import GaussianParams
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.8, 6.0, n)
    means = np.stack([rng.uniform(-1.05, 1.05, n) * z * cam.cx / cam.fx,
                      rng.uniform(-1.05, 1.05, n) * z * cam.cy / cam.fy,
                      z], -1)
    k = n // 50
    means[:k, 2] = rng.uniform(-1.0, 0.19, k)
    means[k:2 * k, 0] = rng.choice([-1, 1], k) * 20 * means[k:2 * k, 2]
    means[2 * k:2 * k + 5] = [[0.0, 0.0, 0.9]] * 5
    scales = np.exp(rng.uniform(np.log(0.002), np.log(0.03), (n, 3)))
    scales[2 * k:2 * k + 5] = 4.0
    alive = np.ones(n, bool)
    alive[-k:] = False

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    params = GaussianParams(
        means3d=t(means), rgb_colors=t(rng.uniform(0, 1, (n, 3))),
        unnorm_rotations=t(rng.normal(size=(n, 4))),
        logit_opacities=t(rng.normal(size=(n, 1))),
        log_scales=t(np.log(scales)))
    return params, torch.as_tensor(alive, device=dev)


def _bin_projs(params, alive, cam, margin, S):
    """Kernel P's projections of the map at S poses (small translations)."""
    from isogs_slam_tpu_torch.ops.rasterize import project_gaussians
    dev = params.means3d.device
    out = []
    for s in range(S):
        shift = torch.tensor([0.013 * s, -0.007 * s, 0.011 * s], device=dev)
        out.append(project_gaussians(params.means3d + shift,
                                     params.unnorm_rotations,
                                     params.log_scales, alive, cam,
                                     margin_px=margin))
    return out


@pytest.mark.parametrize("S,trunc", [(1, False), (3, False), (1, True),
                                     (3, True)],
                         ids=["S1", "S3", "S1_cap", "S3_cap"])
@pytest.mark.parametrize("margin", [0.0, 8.0])
@pytest.mark.parametrize("K", [256, 512, 768])
@pytest.mark.parametrize("shape", list(BIN_CAMS))
def test_bin_kernel_pair_q_bit_equal(dev, shape, K, margin, S, trunc):
    """Kernel pair Q's expansion and Binnings against the eager chain on
    the card, bit for bit: the keys and source rows, tile_count, n_isect,
    n_overflow, n_true_overflow, tile_gauss and slot_exp_pos below each
    count, exp_offsets; int32 indices. The capacity M holds every
    intersection, or (`trunc`) half of them, so E = M cuts the
    expansion."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops import rasterize as R
    cam = Camera(**BIN_CAMS[shape])
    params, alive = _bin_params(dev, cam)
    N = alive.shape[0]
    with torch.no_grad():
        projs = _bin_projs(params, alive, cam, margin, S)
        cfg = R.RasterConfig(max_per_tile=K, max_isect_cap=64 * N)
        total = int(R.bin_gaussians(projs[0], cam, cfg).n_isect)
        assert total < cfg.max_isect(N)
        if trunc:
            cfg = cfg._replace(max_isect_cap=total // 2)
        M = cfg.max_isect(N)
        db = max(min(32 - int(cam.num_tiles + 1).bit_length(), 24), 8)
        got = R._expand_batch(projs, cam, cfg, db, M, None, 0.0, 0.0)
        ref = R._expand_batch(projs, cam, cfg, db, M, None, 0.0, 0.0,
                              plain=True)
        assert got[3] == ref[3]
        if trunc:
            assert got[3][0] == M
        assert got[0].dtype == ref[0].dtype == torch.int32
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        del got, ref
        qb = R.bin_gaussians_batched(projs, cam, cfg, emit_exp=True)
        eb = R.bin_gaussians_batched(projs, cam, cfg, emit_exp=True,
                                     plain=True)
    for q, e in zip(qb, eb):
        assert q.tile_gauss.dtype == q.slot_exp_pos.dtype == torch.int32
        assert torch.equal(q.tile_count, e.tile_count)
        for f in ("n_isect", "n_overflow", "n_true_overflow"):
            assert int(getattr(q, f)) == int(getattr(e, f)), f
        k_in = (torch.arange(K, device=dev)[None, :]
                < q.tile_count[:, None].long())
        assert torch.equal(torch.where(k_in, q.tile_gauss, -1),
                           torch.where(k_in, e.tile_gauss, -1))
        assert torch.equal(torch.where(k_in, q.slot_exp_pos, -1),
                           torch.where(k_in, e.slot_exp_pos, -1))
        assert torch.equal(q.exp_offsets, e.exp_offsets)
    # the shape exercises what it should: culled rows, whole-grid rows,
    # the K cap where the tiles are crowded
    p0 = projs[0]
    assert not bool(p0.valid.all())
    assert int(qb[0].tile_count.max()) == K or K > 256
    assert int((qb[0].tile_count > 0).sum()) == cam.num_tiles


def test_bin_counters_tracking_and_mapping(dev):
    """One tracking binning (bin_at_pose, margin 8) and one mapping phase's
    binning of two keyframe slots (bin_phase_slots) go through kernel pair
    Q: one launch of each kernel a projection, `render.bin.kernel` counted
    for each Binning and `render.bin.eager` never."""
    from isogs_slam_tpu_torch.core.camera import Camera
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    from isogs_slam_tpu_torch.slam.mapping import (MappingConfig,
                                                   PruneConfig,
                                                   bin_phase_slots)
    from isogs_slam_tpu_torch.slam.tracking import bin_at_pose
    from isogs_slam_tpu_torch.utils import spans
    cam = Camera(**BIN_CAMS["640x480"])
    params, alive = _bin_params(dev, cam, n=50_000)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    trans = torch.zeros(3, device=dev)
    tracer = spans.Tracer()
    _cuda.reset_launches()
    with spans.use(tracer):
        b = bin_at_pose(params, alive, quat, trans, 8.0, cam,
                        RasterConfig(max_per_tile=256))
        bins = bin_phase_slots(params, alive, quat[None].repeat(2, 1),
                               torch.stack([trans, trans + 0.01]), [0, 1],
                               cam, RasterConfig(max_per_tile=512),
                               MappingConfig(40, 1e-4, 2.5e-3, 1e-3, 0.05,
                                             1e-3, PruneConfig(
                                                 False, 0, 0, 0, 1, 0.005,
                                                 0.005, False, 1)),
                               emit=True)
    torch.cuda.synchronize()
    assert b.tile_gauss.dtype == torch.int32 and len(bins) == 2
    assert _cuda.LAUNCHES.get("bin_count") == 3
    assert _cuda.LAUNCHES.get("bin_expand") == 3
    assert tracer.counters.get("render.bin.kernel") == 3
    assert "render.bin.eager" not in tracer.counters


# kernel K (csrc/knn.cu): the iso term's hash-grid K-nearest query
from test_torch_knn import (CASES as KNN_CASES,  # noqa: E402
                            assert_knn_matches, card_order, card_topk,
                            contract_knn, planted_grid, position_rows)


@pytest.mark.parametrize("R", [72, 32768], ids=["one_block", "multi_block"])
def test_card_topk_tie_order(dev, R):
    """torch.topk on the card (one block a row, and ATen's multi-block
    selection at the iso pool's 32,768 rows) orders tied values as
    tests/test_torch_knn.py's card_topk says, which kernel K follows."""
    rng = np.random.default_rng(R)
    vals = -rng.integers(0, 40, (R, 648)).astype(np.float32)
    vals[: R // 4, 100:] = -np.inf
    v, i = torch.topk(torch.as_tensor(vals, device=dev), 16, dim=1)
    want_v, want_i = card_topk(vals, 16)
    assert np.array_equal(v.cpu().numpy(), want_v)
    assert np.array_equal(i.cpu().numpy(), want_i)


@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_kernel_k_matches_plain_on_planted_grids(dev, case):
    """Kernel K and the eager chain on the card against the contract, on
    the toy grids that plant its rules: the distances bit for bit (summed
    as the card's reduction sums 3 values) and the rows, tied and missing
    neighbours in the order and with the rows the card's topk gives them
    (card_order)."""
    from isogs_slam_tpu_torch.ops import spatial_hash as SH
    grid, queries, k, cap = planted_grid(case, device=dev)
    _cuda.reset_launches()
    d2, idx = SH.knn_hash_cuda(grid, queries, k, cap)
    d2_p, idx_p = SH.knn_hash_plain(grid, queries, k, cap)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES.get("knn_hash") == 1
    assert d2.dtype == torch.float32 and idx.dtype == torch.int64
    cands = contract_knn(grid, queries, k, cap, sum_order="acb")
    assert_knn_matches(d2, idx, cands, k)
    want_d, want_i = card_order(cands, k, position_rows(grid, queries, cap))
    for got_d, got_i in ((d2, idx), (d2_p, idx_p)):
        got_d, got_i = got_d.cpu().numpy(), got_i.cpu().numpy()
        assert np.array_equal(got_d.view(np.int32), want_d.view(np.int32))
        assert np.array_equal(got_i, want_i)


def _knn_surface(dev, C, seed=0):
    """A map of C rows shaped like the iso pool's: 57% alive on a wavy
    2 x 2 m surface with 3-6 mm scales (a few rows per cell of 2.5 x the
    median scale), the rest dead, and the pool's 32,768 query rows."""
    from isogs_slam_tpu_torch.ops.iso_loss import sample_pool_queries
    g = torch.Generator(device=dev).manual_seed(seed)
    uv = torch.rand((C, 2), generator=g, device=dev) * 2 - 1
    z = 0.1 * torch.sin(3 * uv[:, 0]) * torch.cos(2 * uv[:, 1])
    means = torch.stack([uv[:, 0], uv[:, 1], z], -1)
    log_scales = torch.log(0.003 + 0.003 * torch.rand(
        (C, 3), generator=g, device=dev))
    alive = torch.arange(C, device=dev) < int(0.57 * C)
    q_idx = sample_pool_queries(alive, 32768, g)
    return means, log_scales, alive, q_idx


def _d2_of(points, queries, idx):
    """|p - q|^2 of rows idx [Q, k] summed as the card's reduction sums 3
    values, (dx^2 + dz^2) + dy^2."""
    d = points[idx] - queries[:, None, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 2]) + sq[..., 1]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("C", [524_288, 1_245_184])
def test_knn_kernel_k_at_the_cells_shapes(dev, C, sparse):
    """At each cell's capacity (tum.handheld 524,288, replica.orbit
    1,245,184), the pool's 32,768 queries, k = 16, cap = 24, on the dense
    surface and on one thinned to ~60,000 live rows (a third of the
    queries short of neighbours): K's distances and rows equal the eager
    chain's bit for bit, and the call's memory rises by under 16 MiB (its
    outputs)."""
    from isogs_slam_tpu_torch.ops import spatial_hash as SH
    means, log_scales, alive, q_idx = _knn_surface(dev, C)
    if sparse:
        keep = round(int(alive.sum()) / 60_000)
        alive = alive & (torch.arange(C, device=dev) % keep == 0)
        q_idx = q_idx[alive[q_idx]]
    cell = SH.default_cell_size(log_scales, alive)
    grid = SH.build_hash_grid(means, alive, cell)
    queries = means[q_idx]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d2, idx = SH.knn_hash_cuda(grid, queries, 16, 24)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise < 16 * 2 ** 20, rise
    d2_p, idx_p = SH.knn_hash_plain(grid, queries, 16, 24)
    assert torch.equal(d2.view(torch.int32), d2_p.view(torch.int32))
    assert torch.equal(idx, idx_p)
    fin = torch.isfinite(d2)
    short = float((~fin).any(1).float().mean())
    assert (0.05 < short < 0.95) if sparse else short < 0.05, short
    assert torch.equal(_d2_of(means, queries, idx)[fin], d2[fin])
    assert bool(alive[idx[fin]].all())


def test_knn_kernel_k_pool_gives_the_eager_iso_loss(dev):
    """The iso loss, mean density and gradients from K's pool equal those
    from the eager chain's pool bit for bit at tum.handheld's shape, on a
    surface sparse enough that about a third of the queries miss
    neighbours."""
    from isogs_slam_tpu_torch.ops import spatial_hash as SH
    from isogs_slam_tpu_torch.ops.iso_loss import (IsoKnnPool,
                                                   iso_surface_loss)
    C = 524_288
    means, log_scales, alive, q_idx = _knn_surface(dev, C, seed=1)
    # every 5th row alive: buckets thin out and queries run short
    alive = alive & (torch.arange(C, device=dev) % 5 == 0)
    q_idx = q_idx[alive[q_idx]]
    g = torch.Generator(device=dev).manual_seed(2)
    rots = torch.randn((C, 4), generator=g, device=dev)
    op = torch.randn((C, 1), generator=g, device=dev)
    cell = SH.default_cell_size(log_scales, alive)
    grid = SH.build_hash_grid(means, alive, cell)
    pools = []
    for fn in (SH.knn_hash_cuda, SH.knn_hash_plain):
        d2, nbr = fn(grid, means[q_idx], 16, 24)
        pools.append(IsoKnnPool(q_idx=q_idx, nbr=nbr,
                                nbr_ok=torch.isfinite(d2)))
    assert torch.equal(pools[0].nbr_ok, pools[1].nbr_ok)
    short = (~pools[0].nbr_ok).any(1).float().mean()
    assert 0.05 < float(short) < 0.95, float(short)
    sel = torch.randint(0, q_idx.shape[0], (8192,), generator=g, device=dev)

    def run(pool):
        leaves = [t.clone().requires_grad_(True)
                  for t in (means, rots, log_scales, op)]
        loss, dens = iso_surface_loss(*leaves, alive, pool, sel=sel)
        return [loss.detach(), dens.detach()] + list(
            torch.autograd.grad(loss, leaves))

    a, b = run(pools[0]), run(pools[1])
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_knn_kernel_k_counters_on_the_pool_path(dev):
    """A mapping phase's iso pool (build_phase_iso) on the card goes
    through K: one launch, `iso.knn.kernel` counted and `iso.knn.eager`
    never."""
    from isogs_slam_tpu_torch.core.gaussians import GaussianParams
    from isogs_slam_tpu_torch.slam.losses import LossConfig
    from isogs_slam_tpu_torch.slam.mapping import build_phase_iso
    from isogs_slam_tpu_torch.utils import spans
    means, log_scales, alive, _ = _knn_surface(dev, 65_536)
    n = means.shape[0]
    params = GaussianParams(
        means3d=means, rgb_colors=torch.rand((n, 3), device=dev),
        unnorm_rotations=torch.randn((n, 4), device=dev),
        logit_opacities=torch.zeros((n, 1), device=dev),
        log_scales=log_scales)
    lcfg = LossConfig(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
                      use_l1=True, ignore_outlier_depth_loss=False,
                      w_im=0.5, w_depth=1.0, iso_pool_size=4096)
    tracer = spans.Tracer()
    _cuda.reset_launches()
    with spans.use(tracer):
        grid, pool = build_phase_iso(params, alive, lcfg,
                                     torch.Generator(device=dev))
    torch.cuda.synchronize()
    assert pool.nbr.shape == (4096, 16)
    assert _cuda.LAUNCHES.get("knn_hash") == 1
    assert tracer.counters.get("iso.knn.kernel") == 1
    assert "iso.knn.eager" not in tracer.counters
