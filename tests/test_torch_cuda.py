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
