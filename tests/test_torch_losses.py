"""The PyTorch port's loss operators and losses against the JAX package:
SSIM, the flat loss, the spatial-hash KNN, the iso-surface loss on the same
KNN pool and sample, and the tracking / mapping losses with gradients.

Random draws (the pool's query rows, the iso sample) come from the
reference's keys and are handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.core.gaussians import GaussianParams as JGP
from isogs_slam_tpu.ops import iso_loss as JI
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.ops import spatial_hash as JH
from isogs_slam_tpu.ops import ssim as JS
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.core.gaussians import GaussianParams
from isogs_slam_tpu_torch.ops import iso_loss as I
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.ops import spatial_hash as SH
from isogs_slam_tpu_torch.ops import ssim as S
from isogs_slam_tpu_torch.slam import losses as L

H, W = 48, 64
CAM = dict(width=W, height=H, fx=60.0, fy=60.0, cx=32.0, cy=24.0)


def test_ssim_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        S.ssim_map(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(JS.ssim_map(a, b)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(S.calc_ssim(torch.tensor(a),
                                                 torch.tensor(b))),
                               float(JS.calc_ssim(a, b)), rtol=1e-6)


def test_flat_loss_and_grad_match_reference():
    rng = np.random.default_rng(1)
    ls = rng.normal(-4, 2, (200, 3)).astype(np.float32)
    alive = rng.uniform(size=200) < 0.8
    jv, jg = jax.value_and_grad(JI.flat_loss)(ls, alive)
    t = torch.tensor(ls, requires_grad=True)
    v = I.flat_loss(t, torch.tensor(alive))
    (g,) = torch.autograd.grad(v, t)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-12)


def _surface(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.3 * np.sin(uv[:, 0] * 3) * np.cos(uv[:, 1] * 2)
    pts = np.stack([uv[:, 0], uv[:, 1], z], -1).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, n // 10, replace=False)] = False
    return pts, alive


def test_hash_grid_and_knn_match_reference():
    """Same buckets and sorted order (both sorts stable); same neighbour
    sets and distances for every query (missing neighbours are +inf)."""
    pts, alive = _surface()
    ls = np.log(np.full((pts.shape[0], 3), 0.02, np.float32))
    jcell = JH.default_cell_size(jnp.asarray(ls), jnp.asarray(alive))
    tcell = SH.default_cell_size(torch.tensor(ls), torch.tensor(alive))
    np.testing.assert_allclose(float(tcell), float(jcell), rtol=1e-6)
    # one cell size for both grids: a last-bit difference moves points
    # lying on a cell boundary
    tcell = torch.tensor(np.asarray(jcell))
    jg = JH.build_hash_grid(jnp.asarray(pts), jnp.asarray(alive), jcell)
    tg = SH.build_hash_grid(torch.tensor(pts), torch.tensor(alive), tcell)
    assert tg.table_size == jg.table_size
    np.testing.assert_array_equal(tg.starts.numpy(), np.asarray(jg.starts))
    np.testing.assert_array_equal(tg.ends.numpy(), np.asarray(jg.ends))
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    q = pts[::37]
    jd, ji = JH.knn_hash(jg, jnp.asarray(pts), jnp.asarray(q), 16, cap=24)
    td, ti = SH.knn_hash(tg, torch.tensor(q), 16, cap=24)
    jd, ji, td, ti = (np.asarray(x) for x in (jd, ji, td.numpy(),
                                             ti.numpy()))
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-6)
    for r in range(q.shape[0]):
        fin = np.isfinite(jd[r])
        assert set(ti[r][np.isfinite(td[r])]) == set(ji[r][fin]), r
    vals = torch.tensor(np.arange(10.0, dtype=np.float32))
    al = torch.tensor(np.arange(10) % 3 != 0)
    assert float(SH.median_alive(vals, al)) == float(
        JH.median_alive(jnp.asarray(vals.numpy()), jnp.asarray(al.numpy())))


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    pts, alive = _surface(n, seed)
    return (pts, rng.normal(size=(n, 4)).astype(np.float32)
            + np.array([2.0, 0, 0, 0], np.float32),
            np.log(rng.uniform(0.02, 0.08, (n, 3))).astype(np.float32),
            rng.normal(0.5, 1.0, (n, 1)).astype(np.float32), alive)


def test_iso_loss_on_the_same_pool_matches_reference():
    """build_iso_knn_pool with the reference's query rows finds the same
    neighbours; the iso loss on the reference's pool and sample gives the
    same value, density and gradients."""
    means, rots, ls, op, alive = _gaussians(3000, 2)
    key = jax.random.PRNGKey(7)
    jpool = jax.jit(lambda m, s, a: JI.build_iso_knn_pool(
        m, s, a, key, 512, 16, hash_cap=24))(
        jnp.asarray(means), jnp.asarray(ls), jnp.asarray(alive))
    tpool = I.build_iso_knn_pool(torch.tensor(means), torch.tensor(ls),
                                 torch.tensor(alive), 512, 16, hash_cap=24,
                                 q_idx=torch.tensor(np.asarray(jpool.q_idx),
                                                    dtype=torch.int64))
    np.testing.assert_array_equal(tpool.nbr_ok.numpy(),
                                  np.asarray(jpool.nbr_ok))
    for r in range(0, 512, 7):
        ok = np.asarray(jpool.nbr_ok[r])
        assert set(tpool.nbr.numpy()[r][ok]) == \
            set(np.asarray(jpool.nbr[r])[ok])

    skey = jax.random.PRNGKey(11)
    sel = np.asarray(jax.random.randint(skey, (256,), 0, 512))

    def jf(m, q, s, o):
        return JI.iso_surface_loss(m, q, s, o, jnp.asarray(alive), skey,
                                   sample_size=256, k=16, pool=jpool)

    (jl, jd), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                              has_aux=True))(
        *[jnp.asarray(x) for x in (means, rots, ls, op)])
    pool = I.IsoKnnPool(*[torch.tensor(np.asarray(x)) for x in jpool])
    pool = pool._replace(q_idx=pool.q_idx.long(), nbr=pool.nbr.long())
    ts = [torch.tensor(x, requires_grad=True) for x in (means, rots, ls, op)]
    tl, td = I.iso_surface_loss(*ts, torch.tensor(alive), pool,
                                sample_size=256, sel=torch.tensor(sel))
    tg = torch.autograd.grad(tl, ts)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(td.detach()), float(jd), rtol=1e-5)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 1e-4


def _map_scene(seed=0, n=500):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.2, 3.0, n)], axis=1).astype(np.float32)
    arrs = (pts, rng.uniform(0, 1, (n, 3)).astype(np.float32),
            (rng.normal(size=(n, 4)) + [2.0, 0, 0, 0]).astype(np.float32),
            rng.normal(1.0, 0.5, (n, 1)).astype(np.float32),
            # anisotropic: an isotropic Gaussian's rotation gradient is 0
            # up to rounding
            np.log(rng.uniform(0.02, 0.08, (n, 3))).astype(np.float32))
    alive = np.ones(n, bool)
    alive[:3] = False
    gt_im = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt_d = rng.uniform(1.0, 3.0, (1, H, W)).astype(np.float32)
    gt_d[0, :5] = 0.0                        # invalid depth rows
    return arrs, alive, gt_im, gt_d


def test_mapping_loss_and_grads_match_reference():
    arrs, alive, gt_im, gt_d = _map_scene()
    q = np.array([0.99, 0.03, -0.02, 0.01], np.float32)
    t = np.array([0.02, -0.01, 0.05], np.float32)
    kw = dict(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
              use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
              w_depth=1.0, iso_sample_size=128, iso_pool_size=256)
    key = jax.random.PRNGKey(3)
    jparams = JGP(*[jnp.asarray(a) for a in arrs])
    jpool = jax.jit(lambda m, s, a: JI.build_iso_knn_pool(
        m, s, a, key, 256, 16, hash_cap=24))(
        jparams.means3d, jparams.log_scales, jnp.asarray(alive))
    jcfg = JR.RasterConfig(max_per_tile=128, backend="xla",
                           grad_scatter_bf16=False)

    def jf(p):
        out = JL.compute_loss(p, jnp.asarray(alive), q, t, gt_im, gt_d,
                              JCamera(**CAM), jcfg, JL.LossConfig(**kw),
                              key=key, iso_pool=jpool)
        return out.loss, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    sel = torch.tensor(np.asarray(jax.random.randint(key, (128,), 0, 256)))
    pool = I.IsoKnnPool(torch.tensor(np.asarray(jpool.q_idx)).long(),
                        torch.tensor(np.asarray(jpool.nbr)).long(),
                        torch.tensor(np.asarray(jpool.nbr_ok)))
    tp = GaussianParams(*[torch.tensor(a, requires_grad=True) for a in arrs])
    out = L.compute_loss(tp, torch.tensor(alive), torch.tensor(q),
                         torch.tensor(t), torch.tensor(gt_im),
                         torch.tensor(gt_d), Camera(**CAM),
                         R.RasterConfig(max_per_tile=128,
                                        grad_scatter_bf16=False),
                         L.LossConfig(**kw), iso_pool=pool, iso_sel=sel)
    tg = torch.autograd.grad(out.loss, tp)
    for f in ("loss", "im", "depth", "flat", "iso", "mean_density",
              "mask_frac"):
        np.testing.assert_allclose(float(getattr(out, f).detach()),
                                   float(getattr(jout, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(jout.radii))
    for a, b, name in zip(tg, jg, JGP._fields):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_tracking_slot_loss_and_pose_grads_match_reference():
    arrs, alive, gt_im, gt_d = _map_scene(seed=4)
    q = np.array([0.99, 0.03, -0.02, 0.01], np.float32)
    t = np.array([0.02, -0.01, 0.05], np.float32)
    kw = dict(tracking=True, use_sil_for_loss=True, sil_thres=0.5,
              use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
              w_depth=1.0, w_flat=0.0, w_iso=0.0, calc_iso=False,
              sil_norm_render=True)
    jparams = JGP(*[jnp.asarray(a) for a in arrs])
    jcam = JCamera(**CAM)
    jcfg = JR.RasterConfig(max_per_tile=128, backend="xla")
    from isogs_slam_tpu.utils.transforms import transform_to_frame

    @jax.jit
    def jbin(params):
        mc, qc = transform_to_frame(params.means3d, params.unnorm_rotations,
                                    q, t, False, False)
        b = JR.bin_gaussians(JR.project_gaussians(
            mc, qc, params.log_scales, jnp.asarray(alive), jcam,
            margin_px=8.0), jcam, jcfg)
        return b, JR.gather_raw_table(params, b.tile_gauss)

    jb, raw = jbin(jparams)
    q1 = q + np.array([0.002, 0.001, -0.001, 0.0], np.float32)

    def jf(q_, t_):
        out = JL.compute_loss_slots(raw, jb.tile_count, q_, t_, gt_im, gt_d,
                                    jcam, jcfg, JL.LossConfig(**kw))
        return out.loss, out

    (jl, jout), (jgq, jgt) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(q1, t)
    tq = torch.tensor(q1, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    out = L.compute_loss_slots(torch.tensor(np.asarray(raw)),
                               torch.tensor(np.asarray(jb.tile_count)), tq,
                               tt, torch.tensor(gt_im), torch.tensor(gt_d),
                               Camera(**CAM), R.RasterConfig(max_per_tile=128),
                               L.LossConfig(**kw))
    gq, gt = torch.autograd.grad(out.loss, (tq, tt))
    for f in ("loss", "im", "depth", "mask_frac"):
        np.testing.assert_allclose(float(getattr(out, f).detach()),
                                   float(getattr(jout, f)), rtol=1e-5,
                                   err_msg=f)
    for a, b in ((gq, jgq), (gt, jgt)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 1e-4
