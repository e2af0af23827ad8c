"""The PyTorch port's rasterizer against the JAX package: projection,
binning, the compositing forward/backward (plain versions of kernels A and
B against the Pallas kernel in interpret mode), the segment reduce (plain
version of kernel C against the Pallas kernel in interpret mode), and the
mapping and tracking renders with their gradients.

Tolerances are the reference's own: images 1e-5, depth 1e-4, gradients
1e-4 of their max (tests/test_pallas_and_hash.py), 5e-4 / 5e-5 for the
fused mapping backward (tests/test_segreduce.py) and ~1% relative l2 for
the bf16 scatter (tests/test_partial_grad_cols.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.ops.pallas_composite import composite_tiles as j_ct
from isogs_slam_tpu.ops.segreduce import LANES, W, segment_reduce_rows
from isogs_slam_tpu.utils.transforms import transform_to_frame as j_ttf
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.ops.composite import (composite_backward,
                                                composite_tiles)
from isogs_slam_tpu_torch.ops.segreduce import segment_reduce_rows_plain
from isogs_slam_tpu_torch.utils import spans
from isogs_slam_tpu_torch.utils.transforms import transform_to_frame

CAM = dict(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)


def _scene(n=400, seed=3):
    """The reference's test scene (tests/test_segreduce.py) with a few
    dead rows and one row behind the camera."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * np.array([0.8, 0.6, 0.3])
             + np.array([0, 0, 2.0])).astype(np.float32)
    means[1] = [0.0, 0.0, -1.0]
    arrs = [means, rng.normal(size=(n, 4)).astype(np.float32),
            np.log(rng.uniform(0.02, 0.12, size=(n, 3))).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32)]
    alive = np.arange(n) < (n - 7)
    return arrs, alive


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


def _proj_both(arrs, alive, margin=0.0):
    jp = jax.jit(lambda *a: JR.project_gaussians(
        *a, JCamera(**CAM), margin_px=margin))(
        *[jnp.asarray(a) for a in arrs[:3]], jnp.asarray(alive))
    tp = R.project_gaussians(*_t(arrs[:3]), torch.tensor(alive),
                             Camera(**CAM), margin_px=margin)
    return jp, tp


def test_project_gaussians_matches_reference():
    arrs, alive = _scene()
    jp, tp = _proj_both(arrs, alive, margin=3.0)
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), v)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    for f in ("u", "v", "depth", "conic"):
        np.testing.assert_allclose(getattr(tp, f).numpy()[v],
                                   np.asarray(getattr(jp, f))[v],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    rects = R.tile_rects(tp, Camera(**CAM))
    for f, got in zip(("rect_min", "rect_max", "rect_min_true",
                       "rect_max_true"), rects):
        np.testing.assert_array_equal(got.numpy()[v],
                                      np.asarray(getattr(jp, f))[v],
                                      err_msg=f)


@pytest.mark.parametrize("K,margin,cap", [(128, 0.0, 0), (128, 6.0, 0),
                                          (8, 0.0, 0), (128, 0.0, 1024)])
def test_bin_gaussians_tile_lists_match_reference(K, margin, cap):
    """Per-tile lists compared as sets (neither sort is declared stable
    across packages), with counts, overflow counters and the expansion
    positions / segment offsets of emit_exp. cap=1024 truncates the
    expansion (isect overflow); K=8 truncates tiles (K-cap overflow)."""
    arrs, alive = _scene(n=900, seed=1)
    jp, tp = _proj_both(arrs, alive, margin)
    cfg = dict(max_per_tile=K, max_isect_cap=cap)
    jb = jax.jit(lambda p: JR.bin_gaussians(
        p, JCamera(**CAM), JR.RasterConfig(**cfg), emit_exp=True))(jp)
    tb = R.bin_gaussians(tp, Camera(**CAM), R.RasterConfig(**cfg),
                         emit_exp=True)
    counts = np.asarray(jb.tile_count)
    np.testing.assert_array_equal(tb.tile_count.numpy(), counts)
    for f in ("n_isect", "n_overflow", "n_true_overflow"):
        assert int(getattr(tb, f)) == int(getattr(jb, f)), f
    if cap:
        assert int(jb.n_overflow) > 0
    np.testing.assert_array_equal(tb.exp_offsets.numpy(),
                                  np.asarray(jb.exp_offsets))
    jg, jpos = np.asarray(jb.tile_gauss), np.asarray(jb.slot_exp_pos)
    tg, tpos = tb.tile_gauss.numpy(), tb.slot_exp_pos.numpy()
    M = R.RasterConfig(**cfg).max_isect(900)
    for t, c in enumerate(counts):
        assert set(zip(tg[t, :c], tpos[t, :c])) == \
            set(zip(jg[t, :c], jpos[t, :c])), t
        assert np.all(tpos[t, c:] == M)


def _gdata(T, K, F, tiles_x, seed):
    """Slot records whose footprints land in their tile (the reference's
    kernel-test inputs): opacities up to 1.2 saturate tiles over several
    128-slot chunks; tile 0 is empty and tile 1 full."""
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
    return g, counts


@pytest.mark.parametrize("sq_col", [3, None])
def test_composite_plain_matches_pallas_interpret(sq_col):
    """Plain kernel A + B (autograd through the _composite_chunk form)
    against composite_tiles' Pallas kernels in interpret mode: outputs and
    every d gdata column."""
    T, K, F, tx = 8, 256, 4, 4
    g, counts = _gdata(T, K, F, tx, seed=3)
    rng = np.random.default_rng(4)
    Fo = F + (sq_col is not None)
    wo = rng.normal(size=(T, 256, Fo)).astype(np.float32)
    wt = rng.normal(size=(T, 256)).astype(np.float32)

    def jloss(gd):
        out, ft = j_ct(gd, jnp.asarray(counts), F, tx, True, sq_col)
        return jnp.sum(out * wo) + jnp.sum(ft * wt), (out, ft)

    (_, (jo, jft)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(g))
    tg = torch.tensor(g, requires_grad=True)
    to, tft = composite_tiles(tg, torch.tensor(counts), F, tx, sq_col,
                              chunk=3)
    (dg,) = torch.autograd.grad((to * torch.tensor(wo)).sum()
                                + (tft * torch.tensor(wt)).sum(), tg)
    assert float(np.abs(to.detach().numpy() - np.asarray(jo)).max()) < 1e-5
    assert float(np.abs(tft.detach().numpy() - np.asarray(jft)).max()) < 1e-5
    jg = np.asarray(jg)
    scale = np.abs(jg).max(axis=(0, 1))
    err = np.abs(dg.numpy() - jg).max(axis=(0, 1)) / scale
    assert err.max() < 1e-4, err
    assert np.all(dg.numpy()[0] == 0)              # the empty tile


def test_composite_bf16_backward_close_to_f32():
    T, K, F, tx = 8, 256, 4, 4
    g, counts = _gdata(T, K, F, tx, seed=7)

    def grad_of(bf16):
        tg = torch.tensor(g, requires_grad=True)
        out, ft = composite_tiles(tg, torch.tensor(counts), F, tx, 3,
                                  bwd_bf16=bf16)
        (d,) = torch.autograd.grad((out * out).sum() + ft.sum(), tg)
        return d

    a, b = grad_of(False), grad_of(True)
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert float((a - b).abs().max() / a.abs().max()) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segreduce_plain_matches_pallas_interpret(dtype):
    """Plain kernel C against segment_reduce_rows (interpret mode), with
    empty segments and one segment longer than two of the reference's
    chunks. The reference takes 128-lane rows with a W-row zero tail;
    the port takes the dense [M, L] rows."""
    rng = np.random.default_rng(0)
    n_out, L = 70, 10
    lens = rng.integers(0, 9, size=n_out)
    lens[13] = 0
    lens[40] = int(2.5 * W)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    m = int(offs[-1])
    d = rng.normal(size=(m, L)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    d_exp = jnp.zeros((m + W, LANES), jdt).at[:m, :L].set(
        jnp.asarray(d).astype(jdt))
    ref = np.asarray(segment_reduce_rows(d_exp, jnp.asarray(offs), n_out, L,
                                         interpret=True))
    td = torch.tensor(d).to(getattr(torch, dtype))
    got = segment_reduce_rows_plain(td, torch.tensor(offs)).numpy()
    assert got.shape == (L, n_out) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def _render_loss(im, depth, sil, dsq):
    return ((im * im).sum() + depth.abs().sum() + (sil ** 3).sum()
            + dsq.sum())


@pytest.mark.parametrize("backend,bwd_mode", [("pallas-interpret",
                                               "segreduce"),
                                              ("xla", "scatter")])
def test_render_rgbd_sil_and_grads_match_reference(backend, bwd_mode):
    """The mapping render through the fused autograd Function (gather ->
    plain A; B -> expansion-order scatter -> plain C) at f32, against the
    reference's fused Pallas path and its XLA path."""
    arrs, alive = _scene(seed=7)
    cam, jcam = Camera(**CAM), JCamera(**CAM)

    def jloss(p):
        cfg = JR.RasterConfig(max_per_tile=128, backend=backend,
                              bwd_mode=bwd_mode, grad_scatter_bf16=False)
        im, d, s, dsq, _ = JR.render_rgbd_sil(*p, jnp.asarray(alive), jcam,
                                              cfg)
        return (jnp.sum(im * im) + jnp.sum(jnp.abs(d)) + jnp.sum(s ** 3)
                + jnp.sum(dsq)), (im, d, s, dsq)

    (jl, jouts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(a) for a in arrs])
    tp = _t(arrs, grad=True)
    outs = R.render_rgbd_sil(*tp, torch.tensor(alive), cam,
                             R.RasterConfig(max_per_tile=128,
                                            grad_scatter_bf16=False))
    tl = _render_loss(*outs[:4])
    tg = torch.autograd.grad(tl, tp)
    for a, b, tol in zip(outs[:4], jouts, (1e-5, 1e-4, 1e-5, 1e-4)):
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) < tol
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b, name in zip(jg, tg, ["means", "quats", "scales", "op", "rgb"]):
        scale = float(np.abs(np.asarray(a)).max()) + 1e-12
        np.testing.assert_allclose(b.numpy() / scale, np.asarray(a) / scale,
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_render_bf16_scatter_grads_close():
    """grad_scatter_bf16 (the mapping default): kernel B's rows and the
    scatter in bf16, kernel C accumulating in f32 — within ~1% relative
    l2 of the reference's f32 gradient."""
    arrs, alive = _scene(seed=2)
    cam, jcam = Camera(**CAM), JCamera(**CAM)

    def jloss(p):
        cfg = JR.RasterConfig(max_per_tile=128, backend="xla",
                              grad_scatter_bf16=False)
        im, d, s, dsq, _ = JR.render_rgbd_sil(*p, jnp.asarray(alive), jcam,
                                              cfg)
        return jnp.sum(im * im) + jnp.sum(jnp.abs(d)) + jnp.sum(dsq)

    jg = jax.jit(jax.grad(jloss))([jnp.asarray(a) for a in arrs])
    tp = _t(arrs, grad=True)
    im, d, s, dsq, _ = R.render_rgbd_sil(
        *tp, torch.tensor(alive), cam,
        R.RasterConfig(max_per_tile=128, grad_scatter_bf16=True),
        live_grad_cols=R.MAPPING_LIVE_COLS)
    tg = torch.autograd.grad((im * im).sum() + d.abs().sum() + dsq.sum(), tp)
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        rel = np.linalg.norm(b.numpy() - a) / (np.linalg.norm(a) + 1e-12)
        assert rel < 1e-2, rel


@pytest.mark.parametrize("live", ["mapping", "tracking"])
def test_table_fold_matches_former_formulation(live):
    """The mapping route's one fold on kernel B's bf16 rows (plain B and
    C): the table gradient is torch.equal to the former formulation,
    restated here (kernel B's rows gathered by a host list of the live
    columns, scattered into d_exp, segment_reduce_rows_plain, written back
    into a zero table), and the column list reaches the card only where
    some columns are dead: no sync.live_cols span for the mapping render's
    every column, one for tracking's."""
    cols = R.MAPPING_LIVE_COLS if live == "mapping" else R.TRACKING_LIVE_COLS
    arrs, alive = _scene(seed=7)
    cam = Camera(**CAM)
    cfg = R.RasterConfig(max_per_tile=128)
    with torch.no_grad():
        table, proj = R.project_table(*_t(arrs), torch.tensor(alive), cam,
                                      depth_col=True)
        b = R.bin_gaussians(proj, cam, cfg, emit_exp=True)
    table.requires_grad_(True)
    rng = np.random.default_rng(2)
    wo = torch.tensor(rng.normal(size=(cam.num_tiles, 256, 5)),
                      dtype=torch.float32)
    wt = torch.tensor(rng.normal(size=(cam.num_tiles, 256)),
                      dtype=torch.float32)
    tr = spans.Tracer()
    with spans.use(tr):
        out, ft = R.composite_table(table, 4, b, cam, cfg, cols, sq_col=3)
        (got,) = torch.autograd.grad((out * wo).sum() + (ft * wt).sum(),
                                     table)
    assert tr.totals().get("sync.live_cols", (0, 0))[1] == (
        0 if live == "mapping" else 1)

    gdata = R._pad_k(table.detach()[b.tile_gauss])
    dg = composite_backward(gdata, b.tile_count, wo, wt, None, 4,
                            cam.tiles_x, 3, torch.bfloat16, cfg.tile_chunk)
    dsub = dg[:, :128][..., list(cols)].reshape(-1, len(cols))
    m_cap = cfg.max_isect(table.shape[0])
    d_exp = torch.zeros((m_cap + 1, len(cols)), dtype=torch.bfloat16)
    d_exp[b.slot_exp_pos.reshape(-1)] = dsub
    want = torch.zeros(table.shape)
    want[:, list(cols)] = segment_reduce_rows_plain(d_exp, b.exp_offsets).T
    assert torch.equal(got, want)


def test_slot_render_and_pose_grads_match_reference():
    """The tracking render from a frozen slot table (margin-widened
    binning, current-pose coverage silencing) and its pose gradient,
    against the reference's slot render on the Pallas kernel."""
    arrs, alive = _scene(n=600, seed=5)
    arrs[2] = arrs[2] - 0.3                  # smaller footprints
    cam, jcam = Camera(**CAM), JCamera(**CAM)
    q0 = np.array([0.99, 0.02, -0.03, 0.01], np.float32)
    t0 = np.array([0.02, -0.01, 0.03], np.float32)
    from isogs_slam_tpu.core.gaussians import GaussianParams as JGP
    from isogs_slam_tpu_torch.core.gaussians import GaussianParams
    order = [0, 4, 1, 3, 2]                  # means, rgb, rots, op, scales
    jparams = JGP(*[jnp.asarray(arrs[i]) for i in order])
    tparams = GaussianParams(*[torch.tensor(arrs[i]) for i in order])
    jcfg = JR.RasterConfig(max_per_tile=128, backend="pallas-interpret")
    tcfg = R.RasterConfig(max_per_tile=128)

    @jax.jit
    def jbin(params):
        mc, qc = j_ttf(params.means3d, params.unnorm_rotations, q0, t0,
                       False, False)
        b = JR.bin_gaussians(JR.project_gaussians(
            mc, qc, params.log_scales, jnp.asarray(alive), jcam,
            margin_px=4.0), jcam, jcfg)
        return b, JR.gather_raw_table(params, b.tile_gauss)

    jb, raw = jbin(jparams)
    mc2, qc2 = transform_to_frame(tparams.means3d, tparams.unnorm_rotations,
                                  torch.tensor(q0), torch.tensor(t0),
                                  False, False)
    tb = R.bin_gaussians(R.project_gaussians(
        mc2, qc2, tparams.log_scales, torch.tensor(alive), cam,
        margin_px=4.0), cam, tcfg)
    # the same frozen table on both sides (the bins agree as sets)
    traw = torch.tensor(np.asarray(raw))
    counts = np.asarray(jb.tile_count)
    np.testing.assert_array_equal(tb.tile_count.numpy(), counts)

    q1 = q0 + np.array([0.003, -0.002, 0.001, 0.002], np.float32)
    t1 = t0 + np.array([0.004, 0.002, -0.003], np.float32)

    def jloss(q, t):
        im, d, s, dsq, _ = JR.render_rgbd_sil_slots(
            raw, jb.tile_count, q, t, jcam, jcfg)
        return (jnp.sum(im * im) + jnp.sum(jnp.abs(d)) + jnp.sum(s ** 3)
                + jnp.sum(dsq)), (im, d, s)

    (jl, jo), (jgq, jgt) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(q1, t1)
    tq = torch.tensor(q1, requires_grad=True)
    tt = torch.tensor(t1, requires_grad=True)
    outs = R.render_rgbd_sil_slots(traw, torch.tensor(counts), tq, tt, cam,
                                   tcfg)
    tl = _render_loss(*outs[:4])
    gq, gt = torch.autograd.grad(tl, (tq, tt))
    for a, b, tol in zip(outs[:3], jo, (1e-5, 1e-4, 1e-5)):
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) < tol
    for a, b in ((gq, jgq), (gt, jgt)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) / np.abs(b).max() < 1e-4
