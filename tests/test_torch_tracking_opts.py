"""The port's opt-in tracking knobs against the JAX package:
adam_pose_loop with Polyak averaging and early stop on a scripted loss, and
track_frame on a toy scene with tile_subsample, rebin_every_iter, Polyak,
early stop and culled tile lists (the fan, the GN polish and the pyramid:
tests/test_torch_tracking_refine.py).

Tolerances on the toy scene are those tests/test_torch_slice.py states for
the plain tracker: the first iteration's losses 1e-4 relative (3e-4 on a
tile subset, see _assert_tracks_close), later ones 1e-3, poses 1e-2 of a
learning rate per iteration (an L1 residual within f32 rounding of 0 may
take either sign); the fan and the polish add their own steps on top,
bounded at each assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import pointcloud as JP
from isogs_slam_tpu.slam import tracking as JT
from isogs_slam_tpu.utils.transforms import rotmat_to_quat
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
from isogs_slam_tpu_torch.slam import losses as L
from isogs_slam_tpu_torch.slam import pointcloud as P
from isogs_slam_tpu_torch.slam import tracking as T

LR_Q, LR_T = 0.0004, 0.002
# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


# ---------------------------------------------------- the loop, scripted
N_SCRIPTED = 40     # long enough for the iterates to overshoot and stall
def _scripted(mod, xp, target_q, target_t, jitter):
    """An L1 bowl around (target_q, target_t) whose mask_frac wobbles with
    the pose, so that the mask-normalised metric differs from the loss."""
    def loss_fn(pose):
        q, t = pose
        loss = (xp.abs(q - target_q).sum() * 3.0
                + xp.abs(t - target_t).sum())
        z = loss * 0.0
        mask = 0.5 + 0.4 * xp.cos(jitter * t.sum())
        return loss, mod.LossOutputs(loss=loss, im=loss * 0.25,
                                     depth=loss * 0.75, flat=z, iso=z,
                                     mean_density=z, radii=None,
                                     n_overflow=None, mask_frac=mask)
    return loss_fn


@pytest.mark.parametrize("kw", [
    dict(polyak_rho=0.8), dict(early_stop_patience=3),
    dict(early_stop_patience=2, use_depth_loss_thres=True,
         depth_loss_thres=1e-9),
    dict(polyak_rho=0.5, lr_decay=0.9, mask_norm_candidate=False),
    dict(use_depth_loss_thres=True, depth_loss_thres=1e-9)],
    ids=["polyak", "early_stop", "early_stop_beats_doubling",
         "polyak_decay", "doubling"])
def test_adam_pose_loop_matches_reference(kw):
    """Same iteration count, best-improvement iteration, log (1e-5), best
    pose and Polyak pose (1e-6) as the reference's while-loop."""
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    tq = q0 + np.array([0.0007, 0.0031, -0.0022, 0.0013], np.float32)
    tt = np.array([0.0093, -0.0071, 0.0052], np.float32)
    cfg = dict(num_iters=N_SCRIPTED, lr_quat=LR_Q, lr_trans=LR_T, **kw)
    jfin = JT.adam_pose_loop(
        _scripted(JL, jnp, jnp.asarray(tq), jnp.asarray(tt), 40.0),
        (jnp.asarray(q0), jnp.asarray(t0)), JT.TrackingConfig(**cfg))
    tfin = T.adam_pose_loop(
        _scripted(L, torch, torch.tensor(tq), torch.tensor(tt), 40.0),
        (torch.tensor(q0), torch.tensor(t0)), T.TrackingConfig(**cfg))
    assert tfin.it == int(jfin.it)
    if "early_stop" in "".join(kw):
        assert tfin.it < N_SCRIPTED
    assert int(tfin.best_it) == int(jfin.best_it)
    np.testing.assert_allclose(tfin.log.numpy()[:tfin.it],
                               np.asarray(jfin.log)[:tfin.it], rtol=1e-5)
    assert np.isnan(tfin.log.numpy()[tfin.it:]).all()
    for a, b in zip(tfin.best_pose, jfin.best_pose):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if kw.get("polyak_rho", 0) > 0:
        for a, b in zip(tfin.polyak_pose(), jfin.polyak_pose()):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# --------------------------------------------------------- the toy scene
H, W, CAP, K = 48, 64, 8192, 4096
ITERS = 3
TRACK_LOSS = dict(tracking=True, use_sil_for_loss=True, sil_thres=0.99,
                  use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                  w_depth=1.0, w_flat=0.0, w_iso=0.0, calc_iso=False,
                  sil_norm_render=True)
_TOY = []


def _toy():
    if _TOY:
        return _TOY[0]
    ds = SyntheticDataset(num_frames=2, height=H, width=W, n_per_wall=400,
                          traj_step=0.15)
    frames = []
    for i in range(2):
        color, depth, _, pose = ds[i]
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = np.asarray(rotmat_to_quat(jnp.asarray(w2c[:3, :3], jnp.float32)))
        frames.append(((color.transpose(2, 0, 1) / 255.0).astype(np.float32),
                       depth.transpose(2, 0, 1).astype(np.float32),
                       q.astype(np.float32), w2c[:3, 3].astype(np.float32)))
    c = ds.cam
    cam = Camera(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx,
                 cy=c.cy)
    k0 = jax.random.PRNGKey(0)
    js = jax.jit(lambda im, d: JP.initialize_first_frame(
        im, d, c, CAP, k0, 3.0))(*frames[0][:2])
    ts = P.initialize_first_frame(
        *frames[0][:2], cam, CAP, 3.0,
        perturb=np.array(jax.random.normal(k0, (H * W, 3))), device="cpu")
    _TOY.append((frames, c, cam, js, ts))
    return _TOY[0]


def _track_both(kw, pyramid=False, raster=None):
    frames, jcam, cam, js, ts = _toy()
    im1, d1, q1, t1 = frames[1]
    qs = q1 + np.array([0.002, -0.001, 0.001, 0.0], np.float32)
    tsv = t1 + np.array([0.004, -0.002, 0.003], np.float32)
    cfg = dict(num_iters=ITERS, lr_quat=LR_Q, lr_trans=LR_T, **kw)
    raster = raster or {}
    jfn = JT.track_frame_pyramid if pyramid else JT.track_frame
    tfn = T.track_frame_pyramid if pyramid else T.track_frame
    jres = jfn(js.params, js.alive, jnp.asarray(qs), jnp.asarray(tsv),
               jnp.asarray(im1), jnp.asarray(d1), jcam,
               JRasterConfig(max_per_tile=K, backend="xla", **raster),
               JL.LossConfig(**TRACK_LOSS), JT.TrackingConfig(**cfg))
    tres = tfn(ts.params, ts.alive, torch.tensor(qs), torch.tensor(tsv),
               torch.tensor(im1), torch.tensor(d1), cam,
               RasterConfig(max_per_tile=K, **raster),
               L.LossConfig(**TRACK_LOSS), T.TrackingConfig(**cfg))
    return tres, jres


def _assert_tracks_close(tres, jres, extra_q=0.0, extra_t=0.0,
                         first_rtol=1e-4):
    """first_rtol: the toy map is one Gaussian per pixel of walls of one
    depth, so depth keys tie and the two packages' sorts order the tied
    slots differently; that moves the colour term (not the depth term) by
    ~1e-4 of the sum over the whole image and by up to 3e-4 of the sum
    over half of its tiles."""
    n = int(jres.iters_run)
    assert tres.iters_run == n
    jlog = np.asarray(jres.loss_log)
    tlog = tres.loss_log.numpy()
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(tlog[0], jlog[0], rtol=first_rtol, atol=1e-6)
    np.testing.assert_allclose(tlog[0, 2], jlog[0, 2], rtol=1e-5)
    np.testing.assert_allclose(tlog[:n], jlog[:n], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tres.quat.numpy(), np.asarray(jres.quat),
                               atol=1e-2 * LR_Q * n + extra_q)
    np.testing.assert_allclose(tres.trans.numpy(), np.asarray(jres.trans),
                               atol=1e-2 * LR_T * n + extra_t)
    assert int(tres.gn_accepted) == int(jres.gn_accepted)


@pytest.mark.parametrize("kw", [
    dict(tile_subsample=2), dict(tile_subsample=5),
    dict(rebin_every_iter=True), dict(polyak_rho=0.8),
    dict(early_stop_patience=1), dict(tile_subsample=2, polyak_rho=0.6)],
    ids=["sub2", "sub5", "rebin", "polyak", "early_stop", "sub2_polyak"])
def test_track_frame_options_match_reference(kw):
    tres, jres = _track_both(kw)
    _assert_tracks_close(
        tres, jres, first_rtol=3e-4 if "tile_subsample" in kw else 1e-4)
    assert int(tres.gn_accepted) == -1


@pytest.mark.parametrize("knob", ["tile_cull", "tight_rect"])
def test_track_frame_with_culled_tile_lists_matches_reference(knob):
    """The tracking binning passes its margin as the cull's pixel slack;
    tracking on the culled lists agrees with the reference's (that the
    lists preserve the render is held in tests/test_torch_cull.py)."""
    tres, jres = _track_both({}, raster={knob: True})
    _assert_tracks_close(tres, jres)


def test_track_frame_rejects_subset_with_rebin():
    frames, _, cam, _, ts = _toy()
    im1, d1, q1, t1 = frames[1]
    with pytest.raises(ValueError, match="rebin_every_iter"):
        T.track_frame(ts.params, ts.alive, torch.tensor(q1),
                      torch.tensor(t1), torch.tensor(im1), torch.tensor(d1),
                      cam, RasterConfig(max_per_tile=K),
                      L.LossConfig(**TRACK_LOSS),
                      T.TrackingConfig(num_iters=1, lr_quat=LR_Q,
                                       lr_trans=LR_T, tile_subsample=2,
                                       rebin_every_iter=True))
