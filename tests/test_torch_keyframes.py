"""The port's keyframe library, overlap selection, cross-frame tile-list
cache and pyramid tracker against the JAX package on the same inputs
(numpy, from a seed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.core.gaussians import GaussianParams as JParams
from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from isogs_slam_tpu.ops.rasterize import render_rgbd_sil as jrender
from isogs_slam_tpu.slam import keyframes as JK
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import tracking as JT
from isogs_slam_tpu.utils.transforms import transform_to_frame as jttf
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.core.gaussians import GaussianParams
from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
from isogs_slam_tpu_torch.slam import keyframes as K
from isogs_slam_tpu_torch.slam import losses as L
from isogs_slam_tpu_torch.slam import tracking as T

H, W = 64, 80
FX = 70.0
CAM = dict(width=W, height=H, fx=FX, fy=FX, cx=W / 2, cy=H / 2)


def _scene(n=512, seed=0, scale=0.04, logit=2.0):
    rng = np.random.default_rng(seed)
    a = dict(
        means3d=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.0, 1.0, n),
                          rng.uniform(1.5, 3.5, n)], 1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=np.tile(np.array([1., 0, 0, 0], np.float32), (n, 1)),
        logit_opacities=np.full((n, 1), logit, np.float32),
        log_scales=np.full((n, 3), np.log(scale), np.float32))
    jp = JParams(**{k: jnp.asarray(v) for k, v in a.items()})
    tp = GaussianParams(**{k: torch.tensor(v) for k, v in a.items()})
    return jp, jnp.ones(n, bool), tp, torch.ones(n, dtype=torch.bool)


def _kf_inputs(seed):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(1.0, 3.0, (H, W))
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0
    Kmat = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float64)
    w2cs = []
    for i in range(7):
        m = np.eye(4)
        a = 0.25 * i
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.05 * i, 0.0, 0.02 * i]
        w2cs.append(m)
    return depth, Kmat, w2cs


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 8), (2, 1)])
def test_keyframe_selection_matches_reference(seed, k):
    """Identical index lists for identical RandomState seeds: the draws are
    made in the same order (randint, then permutation)."""
    depth, Kmat, w2cs = _kf_inputs(seed)
    ref = JK.keyframe_selection_overlap(
        depth, w2cs[0], Kmat, w2cs[1:], k, np.random.RandomState(seed), W, H)
    rng = np.random.RandomState(seed)
    got = K.keyframe_selection_overlap(depth, w2cs[0], Kmat, w2cs[1:], k,
                                       rng, W, H)
    assert [int(i) for i in got] == [int(i) for i in ref]
    assert 0 < len(got) <= k
    # the streams stay in step afterwards
    ref_rng = np.random.RandomState(seed)
    JK.keyframe_selection_overlap(depth, w2cs[0], Kmat, w2cs[1:], k, ref_rng,
                                  W, H)
    assert rng.randint(1 << 30) == ref_rng.randint(1 << 30)
    # the module-level generator the reference pipeline uses is the same
    # stream as RandomState(seed)
    np.random.seed(seed)
    glob = JK.keyframe_selection_overlap(depth, w2cs[0], Kmat, w2cs[1:], k,
                                         np.random, W, H)
    assert [int(i) for i in glob] == [int(i) for i in ref]


def test_backproject_sampled_matches_reference():
    depth, Kmat, w2cs = _kf_inputs(3)
    sampled = np.argwhere(depth >= 0)[::37]
    ref = JK.backproject_sampled(depth, Kmat, w2cs[2], sampled)
    got = K.backproject_sampled(depth, Kmat, w2cs[2], sampled)
    np.testing.assert_array_equal(got, ref)


def test_keyframe_library_round_trip():
    """uint8 colours round (half to even) and clip exactly as the
    reference's; slot max_keyframes is the current frame."""
    rng = np.random.default_rng(0)
    im = rng.uniform(-0.05, 1.05, (3, H, W)).astype(np.float32)
    im[:, 0, :4] = np.array([0.5 / 255, 1.5 / 255, 2.5 / 255, 254.5 / 255],
                            np.float32)
    d = rng.uniform(0, 3, (1, H, W)).astype(np.float32)
    q = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    jl = JK.KeyframeLibrary(3, H, W)
    tl = K.KeyframeLibrary(3, H, W, device="cpu")
    for lib, conv in ((jl, jnp.asarray), (tl, torch.tensor)):
        lib.add_keyframe(7, conv(im), conv(d), conv(q), conv(t), np.eye(4))
        lib.set_current(conv(im[:, ::-1].copy()), conv(d), conv(q), conv(t))
    assert len(tl) == len(jl) == 1 and tl.time_indices == [7]
    assert tl.current_slot == jl.current_slot == 3
    assert tl.colors.dtype == torch.uint8
    np.testing.assert_array_equal(tl.colors.numpy(), np.asarray(jl.colors))
    np.testing.assert_array_equal(tl.depths.numpy(), np.asarray(jl.depths))
    np.testing.assert_array_equal(tl.quats.numpy(), np.asarray(jl.quats))
    np.testing.assert_array_equal(tl.trans.numpy(), np.asarray(jl.trans))
    with pytest.raises(RuntimeError):
        K.KeyframeLibrary(3, H, W)          # no card here: must be asked


def _drift_cases():
    th = 0.02
    return {
        "same": ([1., 0, 0, 0], [0., 0, 0], [1., 0, 0, 0], [0., 0, 0]),
        "yaw": ([1., 0, 0, 0], [0., 0, 0],
                [np.cos(th / 2), 0, np.sin(th / 2), 0], [0., 0, 0]),
        "shift": ([1., 0, 0, 0], [0., 0, 0], [1., 0, 0, 0], [0.03, -0.01, 0]),
        # walking into the scene pushes points through the near plane
        "near": ([1., 0, 0, 0], [0., 0, 0], [1., 0, 0, 0], [0., 0, -1.6]),
    }


@pytest.mark.parametrize("case", list(_drift_cases()))
def test_max_pixel_drift_matches_reference(case):
    jp, jalive, tp, talive = _scene()
    q0, t0, q1, t1 = (np.asarray(x, np.float32) for x in _drift_cases()[case])
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    for stride in (1, 16):
        ref = float(JT.max_pixel_drift(jp.means3d, jalive, q0, t0, q1, t1,
                                       jcam, stride=stride))
        got = float(T.max_pixel_drift(
            tp.means3d, talive, torch.tensor(q0), torch.tensor(t0),
            torch.tensor(q1), torch.tensor(t1), cam, stride=stride))
        if case == "near":
            assert np.isinf(ref) and np.isinf(got)
        else:
            assert got == pytest.approx(ref, abs=1e-3)     # pixels, f32
    if case == "same":
        assert got == 0.0


@pytest.mark.parametrize("margin", [0.0, 16.0])
def test_bin_at_pose_matches_reference(margin):
    """Tile lists as sets (tied depth keys may order differently), equal
    counts; K covers every candidate."""
    jp, jalive, tp, talive = _scene()
    q = np.array([0.999, 0.01, 0.03, -0.01], np.float32)
    t = np.array([0.05, -0.02, 0.1], np.float32)
    jb = JT.bin_at_pose(jp, jalive, q, t, jnp.float32(margin), JCamera(**CAM),
                        JRasterConfig(backend="xla"))
    tb = T.bin_at_pose(tp, talive, torch.tensor(q), torch.tensor(t), margin,
                       Camera(**CAM), RasterConfig())
    counts = np.asarray(jb.tile_count)
    np.testing.assert_array_equal(tb.tile_count.numpy(), counts)
    assert int(tb.n_isect) == int(jb.n_isect)
    jg, tg = np.asarray(jb.tile_gauss), tb.tile_gauss.numpy()
    for i, c in enumerate(counts):
        assert set(tg[i, :c]) == set(jg[i, :c]), i


def test_binning_reuse_policy_matches_reference():
    """The same pose sequence gives the same rebins and reuses in both
    classes; invalidate() and a changed config force a rebin."""
    jp, jalive, tp, talive = _scene()
    jc = JT.BinningReuse(JCamera(**CAM), JRasterConfig(backend="xla"),
                         margin_px=16.0, slack_px=8.0)
    tc = T.BinningReuse(Camera(**CAM), RasterConfig(), margin_px=16.0,
                        slack_px=8.0)
    big = [np.cos(0.25), 0.0, np.sin(0.25), 0.0]
    seq = [([1., 0, 0, 0], [0., 0, 0], False),
           ([1., 0, 0, 0], [0.004, 0, 0], False),     # tiny step: reuse
           ([1., 0, 0, 0], [0.008, 0, 0], False),
           (big, [0., 0, 0], False),                   # hundreds of px
           (big, [0., 0, 0], True),                    # invalidated
           (big, [0.001, 0, 0], False)]
    hist = []
    for q, t, inval in seq:
        q, t = np.asarray(q, np.float32), np.asarray(t, np.float32)
        if inval:
            jc.invalidate()
            tc.invalidate()
        jc.get(jp, jalive, jnp.asarray(q), jnp.asarray(t))
        b = tc.get(tp, talive, torch.tensor(q), torch.tensor(t))
        assert (tc.n_rebins, tc.n_reuses) == (jc.n_rebins, jc.n_reuses)
        hist.append(b)
    assert (tc.n_rebins, tc.n_reuses) == (3, 3)
    assert hist[1] is hist[0] and hist[2] is hist[0]
    assert hist[3] is not hist[0] and hist[4] is not hist[3]


def test_pyramid_cam_and_downsample_match_reference():
    cam, jcam = Camera(**CAM), JCamera(**CAM)
    for k in (1, 2):
        a, b = T.pyramid_cam(cam, k), JT.pyramid_cam(jcam, k)
        for f in ("width", "height", "fx", "fy", "cx", "cy", "near", "far"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.tiles_x, a.tiles_y) == (b.tiles_x, b.tiles_y)
    rng = np.random.default_rng(0)
    # an odd size: the last row and column are cropped
    im = rng.uniform(0, 1, (3, 35, 47)).astype(np.float32)
    d = rng.uniform(0, 3, (1, 35, 47)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = 0.0
    for k in (1, 2):
        jim, jd = JT.downsample_frame(jnp.asarray(im), jnp.asarray(d), k)
        tim, td = T.downsample_frame(torch.tensor(im), torch.tensor(d), k)
        assert tim.shape == jim.shape and td.shape == jd.shape
        np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_track_frame_pyramid_matches_reference():
    """Two levels from the same start pose on a toy scene: equal iteration
    counts and logs of equal shape; the final pose within the tolerance the
    slice test uses for tracking (1e-2 * lr per iteration: an L1 residual
    within f32 rounding of 0 takes either sign)."""
    jp, jalive, tp, talive = _scene(n=384, seed=11, scale=0.06, logit=3.0)
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    jr, tr = JRasterConfig(backend="xla"), RasterConfig()
    qg, tg = jnp.asarray([1., 0, 0, 0]), jnp.zeros(3)
    mc, qc = jttf(jp.means3d, jp.unnorm_rotations, qg, tg, False, False)
    gt_im, gt_d, _, _, _ = jax.jit(lambda a, b: jrender(
        a, b, jp.log_scales, jp.logit_opacities, jp.rgb_colors, jalive, jcam,
        jr))(mc, qc)
    gt_im, gt_d = np.asarray(gt_im), np.asarray(gt_d)
    q0 = np.array([1.0, 0.0, 0.004, 0.0], np.float32)
    t0 = np.array([0.03, -0.01, 0.0], np.float32)
    loss = dict(tracking=True, use_sil_for_loss=True, sil_thres=0.5,
                use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                w_depth=1.0, calc_iso=False, sil_norm_render=True)
    lrq, lrt, n_full, n_coarse = 0.001, 0.004, 4, 3
    tc = dict(num_iters=n_full, lr_quat=lrq, lr_trans=lrt, lr_decay=0.92,
              pyramid_levels=2, pyramid_iters=n_coarse, pyramid_lr_scale=1.5)
    jres = JT.track_frame_pyramid(jp, jalive, q0, t0, gt_im, gt_d, jcam, jr,
                                  JL.LossConfig(**loss),
                                  JT.TrackingConfig(**tc))
    tres = T.track_frame_pyramid(tp, talive, torch.tensor(q0),
                                 torch.tensor(t0), torch.tensor(gt_im),
                                 torch.tensor(gt_d), cam, tr,
                                 L.LossConfig(**loss), T.TrackingConfig(**tc))
    iters = n_full + n_coarse
    assert tres.iters_run == int(jres.iters_run) == iters
    jlog = np.asarray(jres.loss_log)
    assert tres.loss_log.shape == jlog.shape == (iters, T.N_LOG)
    # the first row of each level starts from (nearly) the same pose
    np.testing.assert_allclose(tres.loss_log.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tres.loss_log.numpy(), jlog, rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(tres.quat.numpy(), np.asarray(jres.quat),
                               atol=1e-2 * lrq * 1.5 * iters)
    np.testing.assert_allclose(tres.trans.numpy(), np.asarray(jres.trans),
                               atol=1e-2 * lrt * 1.5 * iters)
    # it moved towards the ground truth
    assert np.linalg.norm(tres.trans.numpy()) < np.linalg.norm(t0)
