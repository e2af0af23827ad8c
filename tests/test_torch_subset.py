"""The port's tile-subset (fast-mode) paths against the JAX package: the
tile layout helpers, stripe geometry, render_tiles_subset by both backward
routes, compute_loss_subsampled on injected stripes, the all-tiles stripe
against the exact loss, compute_loss_slots_subset, lazy Adam, and map_frame
with tile_subsample = 2 and an exact tail.

The reference runs on its XLA route (backend="xla"); its segment reduce is
the Pallas kernel in interpret mode. Tolerances are stated at each assert:
images / losses 1e-5, gradients 1e-4 of each parameter's max, multi-
iteration mapping as tests/test_torch_slice.py holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import optim as JO
from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.core.gaussians import GaussianParams as JParams
from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import mapping as JM
from isogs_slam_tpu.slam import pointcloud as JP
from isogs_slam_tpu.utils.transforms import rotmat_to_quat
from isogs_slam_tpu.utils.transforms import transform_to_frame as j_ttf
from isogs_slam_tpu_torch.core import convert, optim
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.core.gaussians import GaussianParams
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.slam import losses as L
from isogs_slam_tpu_torch.slam import mapping as M
from isogs_slam_tpu_torch.slam import pointcloud as P
from isogs_slam_tpu_torch.utils.transforms import transform_to_frame

# 72 x 104: 7 x 5 tiles with partial tiles on both edges
CAM = dict(width=104, height=72, fx=90.0, fy=90.0, cx=52.0, cy=36.0)
K = 512
CAP = 32768
IDENT = (np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32))
FIELDS = GaussianParams._fields
# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


def _scene(n=600, seed=3):
    """World = camera frame. Arrays in GaussianParams order."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * np.array([0.9, 0.6, 0.3])
             + np.array([0, 0, 2.0])).astype(np.float32)
    arrs = dict(
        means3d=means, rgb_colors=rng.uniform(size=(n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(size=(n, 1)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.02, 0.12, size=(n, 3))
                          ).astype(np.float32))
    gt = np.concatenate([rng.uniform(size=(3, CAM["height"], CAM["width"])),
                         rng.uniform(1.0, 3.0, size=(1, CAM["height"],
                                                     CAM["width"]))]
                        ).astype(np.float32)
    gt[3, :5, :9] = 0.0         # some invalid depth
    return arrs, np.arange(n) < n - 7, gt


def _tparams(arrs, grad=False):
    return GaussianParams(*[torch.tensor(arrs[f], requires_grad=grad)
                            for f in FIELDS])


def _jparams(arrs):
    return JParams(*[jnp.asarray(arrs[f]) for f in FIELDS])


def _bins(arrs, alive, emit=True):
    """The same frozen binning in both packages (K and the intersection
    capacity hold every candidate)."""
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    jp = JR.project_gaussians(jnp.asarray(arrs["means3d"]),
                              jnp.asarray(arrs["unnorm_rotations"]),
                              jnp.asarray(arrs["log_scales"]),
                              jnp.asarray(alive), jcam)
    jb = JR.bin_gaussians(jp, jcam, JR.RasterConfig(
        max_per_tile=K, max_isect_cap=CAP, backend="xla"), emit_exp=emit)
    tp = R.project_gaussians(torch.tensor(arrs["means3d"]),
                             torch.tensor(arrs["unnorm_rotations"]),
                             torch.tensor(arrs["log_scales"]),
                             torch.tensor(alive), cam)
    tb = R.bin_gaussians(tp, cam, R.RasterConfig(
        max_per_tile=K, max_isect_cap=CAP), emit_exp=emit)
    assert int(tb.n_overflow) == 0
    return jb, tb


def _close_grads(got, ref, tol=1e-4):
    for f, a, b in zip(FIELDS, got, ref):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale,
                                   atol=tol, err_msg=f)


# ------------------------------------------------------------------ layout
def test_tile_layout_helpers_match_reference():
    """image_to_tiles, tiles_to_image, tile_pixel_validity and
    _virtual_row_shift: exactly the reference's arrays."""
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    img = np.random.default_rng(0).normal(size=(4, CAM["height"],
                                                CAM["width"])
                                          ).astype(np.float32)
    jt = np.asarray(JR.image_to_tiles(jnp.asarray(img), jcam))
    tt = R.image_to_tiles(torch.tensor(img), cam)
    np.testing.assert_array_equal(tt.numpy(), jt)
    band = slice(cam.tiles_x, 4 * cam.tiles_x)
    np.testing.assert_array_equal(
        R.tiles_to_image(tt[band], cam.tiles_x).numpy(),
        np.asarray(JR.tiles_to_image(jnp.asarray(jt[band]), jcam.tiles_x)))
    np.testing.assert_array_equal(R.tile_pixel_validity(cam),
                                  JR.tile_pixel_validity(jcam))
    full = R.tiles_to_image(tt, cam.tiles_x)[:, :cam.height, :cam.width]
    np.testing.assert_array_equal(full.numpy(), img)
    sel = np.array([3, 8, 9, 30], np.int32)
    np.testing.assert_array_equal(
        R._virtual_row_shift(torch.tensor(sel).long(), cam, 10,
                             torch.float32).numpy(),
        np.asarray(JR._virtual_row_shift(jnp.asarray(sel), jcam, 10,
                                         jnp.float32)))


@pytest.mark.parametrize("sub", [1, 2, 4])
@pytest.mark.parametrize("gy", [5, 8, 43])
def test_stripe_geometry_matches_reference(gy, sub):
    """stripe_shape equal; over one cycle the reference visits each stripe
    once, and each of its (sel, core) pairs is the port's select_stripe of
    that stripe index; cores cover every row; windows carry one halo row
    where the image has one."""
    gx = 3
    shape = M.stripe_shape(gy, gx, sub)
    assert shape == JM.stripe_shape(gy, gx, sub)
    rows_core, rows_w, n_stripes, t_sub = shape
    assert t_sub == rows_w * gx
    ours = []
    for si in range(n_stripes):
        sel, core = M.select_stripe(si, gy, gx, rows_core, rows_w)
        assert sel.shape == core.shape == (t_sub,)
        sel, core = sel.numpy(), core.numpy()
        ours.append((sel, core))
        rows = np.unique(sel // gx)
        core_rows = np.unique(sel[core] // gx)
        np.testing.assert_array_equal(
            core_rows, min(si * rows_core, gy - rows_core)
            + np.arange(rows_core))
        # a contiguous window holding the core and, where the image has
        # one, a halo row on each side
        np.testing.assert_array_equal(rows, rows[0] + np.arange(rows_w))
        assert rows[0] <= max(core_rows[0] - 1, 0)
        assert rows[-1] >= min(core_rows[-1] + 1, gy - 1)
    covered = np.unique(np.concatenate([s[c] // gx for s, c in ours]))
    np.testing.assert_array_equal(covered, np.arange(gy))
    base = jax.random.PRNGKey(5)
    seen = set()
    for visit in range(n_stripes):
        sel, core = JM.select_stripe(base, jnp.int32(visit), None, gy, gx,
                                     rows_core, rows_w, n_stripes)
        hit = [i for i, (s, c) in enumerate(ours)
               if np.array_equal(s, np.asarray(sel))
               and np.array_equal(c, np.asarray(core))]
        assert len(hit) == 1, visit
        seen.add(hit[0])
    assert seen == set(range(n_stripes))


def test_draw_stripes_cycles_per_slot():
    """Each slot's own visits walk whole permutations of the stripes."""
    gen = torch.Generator().manual_seed(0)
    slots = [0, 1, 0, 0, 1, 0, 1, 1, 0, 0, 2]
    idx = M.draw_stripes(slots, 3, True, gen, "cpu")
    for s in set(slots):
        mine = [i for i, sl in zip(idx, slots) if sl == s]
        for c in range(0, len(mine) - len(mine) % 3, 3):
            assert sorted(mine[c:c + 3]) == [0, 1, 2]
    iid = M.draw_stripes(slots, 3, False, gen, "cpu")
    assert len(iid) == len(slots) and set(iid) <= {0, 1, 2}


# ------------------------------------------------------------------ render
@pytest.mark.parametrize("route", ["scatter", "segreduce"])
def test_render_tiles_subset_matches_reference(route):
    """Tiles 1e-5, parameter gradients 1e-4 of max, by each backward
    route, on a subset with partial tiles; and the subset's tiles equal
    the same tiles of the port's full render."""
    arrs, alive, _ = _scene()
    jb, tb = _bins(arrs, alive)
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    sel = np.array([0, 6, 7, 13, 20, 27, 33, 34], np.int32)
    rng = np.random.default_rng(1)
    wo = rng.normal(size=(len(sel), 256, 5)).astype(np.float32)
    wt = rng.normal(size=(len(sel), 256)).astype(np.float32)
    base = dict(max_per_tile=K, max_isect_cap=CAP, bwd_mode=route,
                grad_scatter_bf16=False)

    def jloss(p):
        mc, qc = j_ttf(p.means3d, p.unnorm_rotations, *IDENT,
                       gaussians_grad=True, camera_grad=False)
        out, ft, _ = JR.render_tiles_subset(
            mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
            jnp.asarray(alive), jnp.asarray(sel), jb, jcam,
            JR.RasterConfig(backend="xla", **base),
            live_grad_cols=JR.MAPPING_LIVE_COLS)
        return jnp.sum(out * wo) + jnp.sum(ft * wt), (out, ft)

    (_, (jout, jft)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(_jparams(arrs))

    p = _tparams(arrs, grad=True)
    mc, qc = transform_to_frame(p.means3d, p.unnorm_rotations,
                                *[torch.tensor(x) for x in IDENT],
                                gaussians_grad=True, camera_grad=False)
    cfg = R.RasterConfig(**base)
    assert R.subset_uses_segreduce(cfg, len(sel)) == (route == "segreduce")
    # "auto" follows the crossover constant (None: never kernel C)
    auto = R.subset_uses_segreduce(cfg._replace(bwd_mode="auto"), 975)
    assert auto == (R.SUBSET_SEGREDUCE_MIN_ROWS is not None
                    and 975 * K >= R.SUBSET_SEGREDUCE_MIN_ROWS)
    out, ft, _ = R.render_tiles_subset(
        mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
        torch.tensor(alive), torch.tensor(sel).long(), tb, cam, cfg,
        live_grad_cols=R.MAPPING_LIVE_COLS)
    loss = (out * torch.tensor(wo)).sum() + (ft * torch.tensor(wt)).sum()
    tg = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(jft),
                               atol=1e-5)
    _close_grads([g.numpy() for g in tg], jg)

    with torch.no_grad():
        im, depth, sil, dsq, _ = R.render_rgbd_sil(
            mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
            torch.tensor(alive), cam, cfg, binning=tb)
    full = R.image_to_tiles(torch.cat([im, depth, dsq]), cam)[sel]
    valid = torch.tensor(R.tile_pixel_validity(cam))[sel]
    np.testing.assert_allclose(
        (out.detach() * valid[..., None]).numpy(), full.numpy(), atol=1e-5)


# rows t_sub * K: a quarter stripe, every 4th tracking tile, the mapping
# stripe (K = 512 and 768) and every tile of the 1200x680 image
ROUTE_SIZES = {"quarter_stripe": (243, 512), "tracking": (806, 256),
               "stripe": (975, 512), "stripe_k768": (975, 768),
               "whole_image": (3225, 512)}


@pytest.mark.parametrize("mode", ["auto", "segreduce", "scatter"])
@pytest.mark.parametrize("size", list(ROUTE_SIZES))
def test_subset_route_matches_reference(size, mode):
    """subset_uses_segreduce picks the reference's backward route at the
    fast configuration's sizes (124,416 / 206,336 / 499,200 / 748,800 /
    1,651,200 rows): "auto" takes kernel C from 256 Ki rows, as the
    reference does on its kernel backend ("pallas"; on the CPU the
    reference's "auto" means its scatter route)."""
    t_sub, k = ROUTE_SIZES[size]
    ref = JR.subset_uses_segreduce(
        JR.RasterConfig(max_per_tile=k, bwd_mode=mode, backend="pallas"),
        t_sub)
    assert R.subset_uses_segreduce(
        R.RasterConfig(max_per_tile=k, bwd_mode=mode), t_sub) == ref
    if mode == "auto":
        assert ref == (t_sub * k >= 256 * 1024)


MAP_LOSS = dict(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
                use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                w_depth=1.0, w_flat=50.0, w_iso=0.0, calc_iso=False)


def _sub_loss_both(arrs, alive, gt, sub, si, outlier=False):
    """compute_loss_subsampled on stripe si in both packages:
    (port LossOutputs, port grads, reference LossOutputs, reference
    grads)."""
    jb, tb = _bins(arrs, alive)
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    rows_core, rows_w, _, _ = M.stripe_shape(cam.tiles_y, cam.tiles_x, sub)
    sel, core = M.select_stripe(si, cam.tiles_y, cam.tiles_x, rows_core,
                                rows_w)
    gt_tiles = R.image_to_tiles(torch.tensor(gt), cam)[sel]
    valid = torch.tensor(R.tile_pixel_validity(cam))[sel]
    lkw = dict(MAP_LOSS, ignore_outlier_depth_loss=outlier)
    base = dict(max_per_tile=K, max_isect_cap=CAP, grad_scatter_bf16=False)

    def jloss(p):
        out = JL.compute_loss_subsampled(
            p, jnp.asarray(alive), *IDENT, jnp.asarray(gt_tiles.numpy()),
            jnp.asarray(valid.numpy()), jnp.asarray(core.numpy()),
            jnp.asarray(sel.numpy().astype(np.int32)), jb, jcam,
            JR.RasterConfig(backend="xla", **base), JL.LossConfig(**lkw))
        return out.loss, out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jparams(arrs))
    p = _tparams(arrs, grad=True)
    tout = L.compute_loss_subsampled(
        p, torch.tensor(alive), *[torch.tensor(x) for x in IDENT], gt_tiles,
        valid, core, sel, tb, cam, R.RasterConfig(**base),
        L.LossConfig(**lkw))
    tg = [g.numpy() for g in torch.autograd.grad(tout.loss, p)]
    return tout, tg, jout, jg, (jb, tb)


@pytest.mark.parametrize("sub,si,outlier", [(2, 0, False), (2, 1, True),
                                            (4, 1, False)])
def test_compute_loss_subsampled_matches_reference(sub, si, outlier):
    """Every loss term 1e-5 relative, mask_frac exactly, gradients 1e-4 of
    max, on an injected stripe (top, bottom with a partial tile row, and a
    middle one with both halos)."""
    arrs, alive, gt = _scene()
    tout, tg, jout, jg, _ = _sub_loss_both(arrs, alive, gt, sub, si, outlier)
    for f in ("loss", "im", "depth", "flat"):
        np.testing.assert_allclose(float(getattr(tout, f)),
                                   float(getattr(jout, f)), rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(float(tout.mask_frac), float(jout.mask_frac),
                               atol=1e-6)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    _close_grads(tg, jg)


def test_all_tiles_stripe_equals_exact_loss():
    """At sub = 1 the one stripe is the whole image: compute_loss_subsampled
    equals compute_loss on the same binning (losses 1e-5 relative,
    gradients 1e-4 of max), in the port and against the reference's exact
    loss."""
    arrs, alive, gt = _scene()
    tout, tg, _, _, (jb, tb) = _sub_loss_both(arrs, alive, gt, 1, 0)
    cam = Camera(**CAM)
    rcfg = R.RasterConfig(max_per_tile=K, max_isect_cap=CAP,
                          grad_scatter_bf16=False)
    p = _tparams(arrs, grad=True)
    ex = L.compute_loss(p, torch.tensor(alive),
                        *[torch.tensor(x) for x in IDENT],
                        torch.tensor(gt[:3]), torch.tensor(gt[3:]), cam,
                        rcfg, L.LossConfig(**MAP_LOSS), binning=tb)
    eg = [g.numpy() for g in torch.autograd.grad(ex.loss, p)]
    jex = JL.compute_loss(
        _jparams(arrs), jnp.asarray(alive), *IDENT, jnp.asarray(gt[:3]),
        jnp.asarray(gt[3:]), JCamera(**CAM),
        JR.RasterConfig(max_per_tile=K, max_isect_cap=CAP, backend="xla",
                        grad_scatter_bf16=False),
        JL.LossConfig(**MAP_LOSS), binning=jb)
    for f in ("loss", "im", "depth", "flat", "mask_frac"):
        np.testing.assert_allclose(float(getattr(tout, f)),
                                   float(getattr(ex, f)), rtol=1e-5,
                                   err_msg=f)
        np.testing.assert_allclose(float(getattr(tout, f)),
                                   float(getattr(jex, f)), rtol=1e-5,
                                   err_msg=f)
    _close_grads(tg, eg)


TRACK_LOSS = dict(tracking=True, use_sil_for_loss=True, sil_thres=0.5,
                  use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                  w_depth=1.0, w_flat=0.0, w_iso=0.0, calc_iso=False,
                  sil_norm_render=True)


@pytest.mark.parametrize("sub,outlier", [(1, False), (1, True), (3, False)])
def test_compute_loss_slots_subset_matches_reference(sub, outlier):
    """The subset tracking loss and its pose gradient against the
    reference's (1e-5 relative / 1e-4 of max); at sub = 1 it equals
    compute_loss_slots on the whole image."""
    arrs, alive, gt = _scene()
    jb, tb = _bins(arrs, alive, emit=False)
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    T = cam.num_tiles
    Ts = max(T // sub, 1)
    sel = np.arange(Ts, dtype=np.int32) * sub
    lkw = dict(TRACK_LOSS, ignore_outlier_depth_loss=outlier)
    jraw = JR.gather_raw_table(_jparams(arrs), jb.tile_gauss)
    traw = R.gather_raw_table(_tparams(arrs), tb.tile_gauss)
    gt_tiles = R.image_to_tiles(torch.tensor(gt), cam)[sel]
    valid = torch.tensor(R.tile_pixel_validity(cam))[sel]
    scale = T / Ts
    q0 = np.array([1.0, 0.002, -0.001, 0.001], np.float32)
    t0 = np.array([0.004, -0.002, 0.003], np.float32)

    def jloss(pose):
        out = JL.compute_loss_slots_subset(
            jraw[sel], jb.tile_count[sel], jnp.asarray(sel), pose[0],
            pose[1], jnp.asarray(gt_tiles.numpy()),
            jnp.asarray(valid.numpy()), jcam,
            JR.RasterConfig(max_per_tile=K, backend="xla"),
            JL.LossConfig(**lkw), scale=scale)
        return out.loss, out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jnp.asarray(q0), jnp.asarray(t0)))
    pose = (torch.tensor(q0, requires_grad=True),
            torch.tensor(t0, requires_grad=True))
    rcfg = R.RasterConfig(max_per_tile=K)
    tsel = torch.tensor(sel).long()
    tout = L.compute_loss_slots_subset(
        traw[tsel], tb.tile_count[tsel], tsel, pose[0], pose[1], gt_tiles,
        valid, cam, rcfg, L.LossConfig(**lkw), scale=scale)
    tg = torch.autograd.grad(tout.loss, pose)
    for f in ("loss", "im", "depth", "mask_frac"):
        np.testing.assert_allclose(float(getattr(tout, f)),
                                   float(getattr(jout, f)), rtol=1e-5,
                                   err_msg=f)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(),
                                   b / np.abs(b).max(), atol=1e-4)
    if sub == 1:
        full = L.compute_loss_slots(
            traw, tb.tile_count, pose[0], pose[1], torch.tensor(gt[:3]),
            torch.tensor(gt[3:]), cam, rcfg, L.LossConfig(**lkw))
        for f in ("loss", "im", "depth", "mask_frac"):
            np.testing.assert_allclose(float(getattr(tout, f)),
                                       float(getattr(full, f)), rtol=1e-5,
                                       err_msg=f)


# ------------------------------------------------------------------- Adam
def test_lazy_adam_matches_reference():
    """optim.step in lazy mode over four steps with rows that get no
    gradient on some steps: parameters, moments and per-row counts equal
    to the reference's (1e-6), and an untouched row does not move."""
    rng = np.random.default_rng(0)
    p = [rng.normal(size=(9, 3)).astype(np.float32),
         rng.normal(size=(9, 1)).astype(np.float32)]
    jp, tp = tuple(jnp.asarray(a) for a in p), tuple(torch.tensor(a)
                                                     for a in p)
    js, ts = JO.init(jp, lazy=True), optim.init(tp, lazy=True)
    lrs = (0.01, 0.05)
    for step in range(4):
        g = [rng.normal(size=a.shape).astype(np.float32) for a in p]
        for a in g:
            a[step::3] = 0.0      # these rows are not visited
            a[8] = 0.0            # this one never is
        jp, js = JO.step(jp, tuple(jnp.asarray(a) for a in g), js,
                         tuple(jnp.float32(x) for x in lrs), eps=1e-15)
        tp, ts = optim.step(tp, tuple(torch.tensor(a) for a in g), ts, lrs,
                            eps=1e-15)
    for i in range(2):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]),
                                   atol=1e-6)
        np.testing.assert_allclose(ts.mu[i].numpy(), np.asarray(js.mu[i]),
                                   atol=1e-6)
        np.testing.assert_allclose(ts.nu[i].numpy(), np.asarray(js.nu[i]),
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.rcount[i].numpy(),
                                      np.asarray(js.rcount[i]))
        np.testing.assert_array_equal(tp[i].numpy()[8], p[i][8])
    assert ts.count == int(js.count) == 4


# ---------------------------------------------------------------- mapping
H, W = 96, 64          # 6 x 4 tiles: sub = 2 gives 3-row cores, 5-row windows
MCAP = 8192
MK = 4096
LR_MAP = dict(lr_means3d=0.0001, lr_rgb_colors=0.0025,
              lr_unnorm_rotations=0.001, lr_logit_opacities=0.05,
              lr_log_scales=0.001)
PRUNE = (True, 0, 0, 20, 20, 0.005, 0.005, False, 500)
ISO_LOSS = dict(MAP_LOSS, w_iso=2.0, calc_iso=True, iso_sample_size=256,
                iso_k=16, iso_pool_size=512)
N_ITERS, POLISH = 6, 2
RKW_MAP = dict(max_per_tile=MK, grad_scatter_bf16=False)


def _map_inputs():
    ds = SyntheticDataset(num_frames=2, height=H, width=W, n_per_wall=400,
                          traj_step=0.1)
    frames = []
    for i in range(2):
        color, depth, _, pose = ds[i]
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = np.asarray(rotmat_to_quat(jnp.asarray(w2c[:3, :3], jnp.float32)))
        frames.append((np.asarray(color).astype(np.uint8),
                       np.asarray(depth)[..., 0].astype(np.float32),
                       q.astype(np.float32), w2c[:3, 3].astype(np.float32)))
    c = ds.cam
    cam = Camera(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx,
                 cy=c.cy)
    im0 = (frames[0][0].transpose(2, 0, 1) / 255.0).astype(np.float32)
    k0 = jax.random.PRNGKey(0)
    js = jax.jit(lambda im, d: JP.initialize_first_frame(
        im, d, c, MCAP, k0, 3.0))(im0, frames[0][1][None])
    noise0 = np.array(jax.random.normal(k0, (H * W, 3)))
    ts = P.initialize_first_frame(im0, frames[0][1][None], cam, MCAP, 3.0,
                                  perturb=noise0, device="cpu")
    kf = [np.stack([f[i] for f in frames]) for i in range(4)]
    return js, ts, c, cam, kf


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_map_frame_subset_matches_reference(lazy):
    """map_frame with tile_subsample = 2 and exact_polish_iters = 2, with
    and without lazy Adam, on the reference's own stripes, iso pool and iso
    samples (injected). The first iteration's losses agree to 1e-4; later
    ones to 1e-2 and the parameters to one learning rate per iteration:
    Adam at eps 1e-15 turns a sign flip of a near-zero gradient into a
    full step (as tests/test_torch_slice.py holds the exact path)."""
    _map_frame_subset_both(JR.RasterConfig(backend="xla", **RKW_MAP),
                           R.RasterConfig(**RKW_MAP), lazy)


def test_map_frame_stripe_through_segreduce_matches_reference(monkeypatch):
    """The fast configuration's stripe mapping with the gradient route now
    the reference's: the row crossover is set to this toy stripe's rows in
    both packages and the reference's "auto" resolves as on its kernel
    backend, so both send the stripe iterations' backward through the
    expansion scatter + segment reduce (the port: kernel C's plain
    version, counted here), on the reference's own stripes, two frames
    of keyframes; held as test_map_frame_subset_matches_reference."""
    _, _, _, t_sub = M.stripe_shape(H // 16, W // 16, 2)
    rows = t_sub * MK
    monkeypatch.setattr(JR, "SUBSET_SEGREDUCE_MIN_ROWS", rows)
    monkeypatch.setattr(R, "SUBSET_SEGREDUCE_MIN_ROWS", rows)
    monkeypatch.setattr(JR.RasterConfig, "resolve_bwd_mode",
                        lambda self: ("segreduce" if self.bwd_mode == "auto"
                                      else self.bwd_mode))
    cfg = R.RasterConfig(**RKW_MAP)
    assert R.subset_uses_segreduce(cfg, t_sub)
    assert not R.subset_uses_segreduce(cfg, t_sub - 1)
    calls = []
    apply = R._GatherRowsSegreduce.apply
    monkeypatch.setattr(R._GatherRowsSegreduce, "apply",
                        lambda *a: calls.append(a[1].shape[0]) or apply(*a))
    # another tile_chunk (no numeric effect) keeps the reference's jit from
    # reusing a program traced before the patches
    _map_frame_subset_both(
        JR.RasterConfig(backend="xla", tile_chunk=128, **RKW_MAP), cfg,
        False)
    # the stripe iterations' renders took the segment-reduce route
    assert calls.count(t_sub) == N_ITERS - POLISH, calls



def _map_frame_subset_both(jrcfg, rcfg, lazy):
    js, ts, jcam, cam, (kf_c, kf_d, kf_q, kf_t) = _map_inputs()
    iter_slots = np.array([0, 1, 1, 0, 1, 0], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), N_ITERS)
    n_sub = N_ITERS - POLISH
    _, _, n_stripes, _ = M.stripe_shape(cam.tiles_y, cam.tiles_x, 2)
    # the reference's draws, reproduced from its keys
    perm_base = jax.random.fold_in(keys[0], 0x71C)
    stripe_idx, visits = [], {}
    for s in iter_slots[:n_sub]:
        v = visits.get(int(s), 0)
        visits[int(s)] = v + 1
        perm = jax.random.permutation(jax.random.fold_in(
            jax.random.fold_in(perm_base, int(s)), v // n_stripes),
            n_stripes)
        stripe_idx.append(int(perm[v % n_stripes]))
    pool_key = jax.random.fold_in(keys[0], 0x150)
    scores = (jax.random.uniform(pool_key, (MCAP,))
              + jnp.where(js.alive, 0.0, 2.0))
    pool_q = np.array(jax.lax.top_k(-scores, 512)[1])
    iso_keys = [jax.random.split(jax.random.fold_in(k, 7))[1]
                if i < n_sub else k for i, k in enumerate(keys)]
    sels = [np.array(jax.random.randint(k, (256,), 0, 512))
            for k in iso_keys]

    mkw = dict(num_iters=N_ITERS, tile_subsample=2,
               exact_polish_iters=POLISH, lazy_adam=lazy, **LR_MAP)
    js1, jlog, jstats = JM.map_frame(
        js, jnp.asarray(kf_c), jnp.asarray(kf_d), jnp.asarray(kf_q),
        jnp.asarray(kf_t), jnp.asarray(iter_slots), keys, jcam,
        jrcfg, JL.LossConfig(**ISO_LOSS),
        JM.MappingConfig(prune=JM.PruneConfig(*PRUNE), **mkw))
    ts1, tlog, tstats = M.map_frame(
        ts, torch.tensor(kf_c), torch.tensor(kf_d), torch.tensor(kf_q),
        torch.tensor(kf_t), iter_slots, cam, rcfg,
        L.LossConfig(**ISO_LOSS),
        M.MappingConfig(prune=M.PruneConfig(*PRUNE), **mkw),
        pool_q_idx=torch.tensor(pool_q).long(),
        iso_sels=[torch.tensor(s).long() for s in sels],
        stripe_idx=stripe_idx)
    jlog = np.asarray(jlog)
    assert tlog.shape == jlog.shape == (N_ITERS, M.N_LOG)
    np.testing.assert_allclose(tlog.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-2, atol=1e-4)
    assert int(tstats[0]) == int(jstats[0]) == 0
    got = convert.state_to_arrays(ts1)
    ref = convert.state_to_arrays(convert.state_from_arrays(js1, "cpu"))
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    lr = dict(means3d=1e-4, rgb_colors=2.5e-3, unnorm_rotations=1e-3,
              logit_opacities=5e-2, log_scales=1e-3)
    for k, v in lr.items():
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=N_ITERS * v + 1e-5, err_msg=k)
        # the bulk of the parameters agrees far inside that bound
        close = np.abs(got[k] - ref[k]) <= 0.05 * v + 1e-6
        assert close.mean() > 0.95, (k, close.mean())
    # the subset iterations moved the map: not a no-op
    assert np.abs(got["rgb_colors"]
                  - convert.state_to_arrays(ts)["rgb_colors"]).max() > 1e-4


def test_map_frame_vmap_bins_equals_serial():
    """One batched binning of the phase's slots gives the serial phase's
    result: the same tile lists (tests/test_torch_cull.py holds them
    exactly equal), so losses and parameters agree to f32 rounding
    (1e-6)."""
    _, ts, _, cam, (kf_c, kf_d, kf_q, kf_t) = _map_inputs()
    iter_slots = [0, 1, 1, 0]
    out = []
    for vmap_bins in (False, True):
        gen = torch.Generator().manual_seed(3)
        mcfg = M.MappingConfig(num_iters=4, tile_subsample=2,
                               exact_polish_iters=1, vmap_bins=vmap_bins,
                               prune=M.PruneConfig(*PRUNE), **LR_MAP)
        st, log, stats = M.map_frame(
            ts, torch.tensor(kf_c), torch.tensor(kf_d), torch.tensor(kf_q),
            torch.tensor(kf_t), iter_slots, cam,
            R.RasterConfig(max_per_tile=MK, tile_cull=True),
            L.LossConfig(**ISO_LOSS), mcfg, generator=gen)
        out.append((convert.state_to_arrays(st), log.numpy(),
                    stats.numpy()))
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out[0][2], out[1][2])
    for k in out[0][0]:
        np.testing.assert_allclose(out[0][0][k], out[1][0][k], rtol=0,
                                   atol=1e-6, err_msg=k)
