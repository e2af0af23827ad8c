"""The port's per-frame SLAM slice against the JAX package on the same
frames: initialize_first_frame -> track_frame -> add_new_gaussians ->
map_frame, the path bench.py drives, at a toy size (64x48, a few
iterations), with the reference on its XLA path.

Each package runs its own chain from the same first frame; every random
draw (log-scale noise, the iso pool's query rows, each iteration's iso
sample) is made from the reference's keys and handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import mapping as JM
from isogs_slam_tpu.slam import pointcloud as JP
from isogs_slam_tpu.slam import tracking as JT
from isogs_slam_tpu.utils.transforms import rotmat_to_quat
from isogs_slam_tpu_torch.core import convert
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
from isogs_slam_tpu_torch.slam import losses as L
from isogs_slam_tpu_torch.slam import mapping as M
from isogs_slam_tpu_torch.slam import pointcloud as P
from isogs_slam_tpu_torch.slam import tracking as T

H, W = 48, 64
CAP = 8192
K = 4096
TRACK_ITERS, MAP_ITERS = 3, 3
LR_MAP = dict(lr_means3d=0.0001, lr_rgb_colors=0.0025,
              lr_unnorm_rotations=0.001, lr_logit_opacities=0.05,
              lr_log_scales=0.001)
PRUNE = (True, 0, 0, 20, 20, 0.005, 0.005, False, 500)
TRACK_LOSS = dict(tracking=True, use_sil_for_loss=True, sil_thres=0.99,
                  use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                  w_depth=1.0, w_flat=0.0, w_iso=0.0, calc_iso=False,
                  sil_norm_render=True)
MAP_LOSS = dict(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
                use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                w_depth=1.0, w_flat=50.0, w_iso=2.0, iso_sample_size=256,
                iso_k=16, calc_iso=True, iso_pool_size=512)


def _frames(n):
    # a long step per frame so frame 1 shows wall that frame 0 did not
    ds = SyntheticDataset(num_frames=n, height=H, width=W, n_per_wall=400,
                          traj_step=0.15)
    out = []
    for i in range(n):
        color, depth, _, pose = ds[i]
        im = (color.transpose(2, 0, 1) / 255.0).astype(np.float32)
        d = depth.transpose(2, 0, 1).astype(np.float32)
        w2c = np.linalg.inv(np.asarray(pose, np.float64))
        q = np.asarray(rotmat_to_quat(jnp.asarray(w2c[:3, :3], jnp.float32)))
        out.append((im, d, q.astype(np.float32),
                    w2c[:3, 3].astype(np.float32)))
    c = ds.cam
    return out, c, Camera(width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                          cx=c.cx, cy=c.cy)


def _assert_states_close(ts, js, atol, what):
    got = convert.state_to_arrays(ts)
    ref = convert.state_to_arrays(convert.state_from_arrays(js, "cpu"))
    np.testing.assert_array_equal(got["alive"], ref["alive"],
                                  err_msg=f"{what}: alive")
    assert int(got["hwm"]) == int(ref["hwm"]), what
    for k in ("means3d", "rgb_colors", "unnorm_rotations",
              "logit_opacities", "log_scales", "timestep", "max_2d_radius"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=atol.get(k, 1e-6),
                                   err_msg=f"{what}: {k}")


def test_slice_init_track_densify_map_matches_reference():
    frames, jcam, cam = _frames(2)
    # K covers every tile's candidates: one Gaussian per pixel of a
    # fronto-parallel wall gives equal depth keys, and which of them a
    # per-tile cap keeps is up to each package's (unstable) sort
    jr_track = JRasterConfig(max_per_tile=K, backend="xla")
    jr_map = JRasterConfig(max_per_tile=K, backend="xla",
                           grad_scatter_bf16=False)
    r_track = RasterConfig(max_per_tile=K)
    r_map = RasterConfig(max_per_tile=K, grad_scatter_bf16=False)
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)

    # first-frame init: one Gaussian per valid-depth pixel
    im0, d0, q0, t0 = frames[0]
    js = jax.jit(lambda im, d: JP.initialize_first_frame(
        im, d, jcam, CAP, k0, 3.0))(im0, d0)
    noise0 = np.array(jax.random.normal(k0, (H * W, 3)))
    ts = P.initialize_first_frame(im0, d0, cam, CAP, 3.0, perturb=noise0,
                                  device="cpu")
    _assert_states_close(ts, js, {}, "init")

    # tracking frame 1 from a perturbed ground-truth pose
    im1, d1, q1, t1 = frames[1]
    qs = q1 + np.array([0.002, -0.001, 0.001, 0.0], np.float32)
    tsv = t1 + np.array([0.004, -0.002, 0.003], np.float32)
    tcfg = dict(num_iters=TRACK_ITERS, lr_quat=0.0004, lr_trans=0.002)
    jres = JT.track_frame(js.params, js.alive, qs, tsv, im1, d1, jcam,
                          jr_track, JL.LossConfig(**TRACK_LOSS),
                          JT.TrackingConfig(**tcfg))
    tres = T.track_frame(ts.params, ts.alive, torch.tensor(qs),
                         torch.tensor(tsv), torch.tensor(im1),
                         torch.tensor(d1), cam, r_track,
                         L.LossConfig(**TRACK_LOSS),
                         T.TrackingConfig(**tcfg))
    assert tres.iters_run == int(jres.iters_run) == TRACK_ITERS
    # the tracking loss is a masked L1 *sum* over ~10^4 terms: f32 rounding
    # of the sum is ~1e-5 of it at the shared start pose; later rows see
    # iterates that differ at f32 rounding, which the sum amplifies
    jlog = np.asarray(jres.loss_log)
    np.testing.assert_allclose(tres.loss_log.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tres.loss_log.numpy(), jlog, rtol=1e-3,
                               atol=1e-6)
    # The L1 gradient is a sum of per-pixel signs: a residual within f32
    # rounding of 0 may take either sign, moving the pose gradient by
    # ~1e-3 of itself. Adam normalizes the step, so each iteration's step
    # may differ by that fraction of lr; bound: 1e-2 * lr per iteration.
    np.testing.assert_allclose(tres.quat.numpy(), np.asarray(jres.quat),
                               atol=1e-2 * 0.0004 * TRACK_ITERS)
    np.testing.assert_allclose(tres.trans.numpy(), np.asarray(jres.trans),
                               atol=1e-2 * 0.002 * TRACK_ITERS)

    # densify at the tracked pose (each package its own)
    key, k1, k2 = jax.random.split(key, 3)
    js = JP.add_new_gaussians(js, jnp.asarray(im1), jnp.asarray(d1),
                              jres.quat, jres.trans, 1.0, k1, jcam, jr_map,
                              sil_thres=0.5)
    noise1 = np.array(jax.random.normal(k1, (H * W, 3)))
    ts = P.add_new_gaussians(ts, torch.tensor(im1), torch.tensor(d1),
                             tres.quat, tres.trans, 1.0, cam, r_map,
                             sil_thres=0.5, perturb=noise1)
    assert int(ts.num_alive()) > int(np.asarray(frames[0][1] > 0).sum())
    _assert_states_close(ts, js, {"means3d": 1e-5}, "densify")

    # mapping over a two-keyframe window
    S = 2
    kf = [(frames[0][0], frames[0][1], q0, t0),
          (im1, d1, np.asarray(jres.quat), np.asarray(jres.trans))]
    kf_c = np.stack([(k[0].transpose(1, 2, 0) * 255).astype(np.uint8)
                     for k in kf])
    kf_d = np.stack([k[1][0] for k in kf])
    kf_q = np.stack([k[2] for k in kf]).astype(np.float32)
    kf_t = np.stack([k[3] for k in kf]).astype(np.float32)
    iter_slots = np.array([0, 1, 1], np.int32)
    keys = jax.random.split(k2, MAP_ITERS)
    mcfg = dict(num_iters=MAP_ITERS, **LR_MAP)
    pool_key = jax.random.fold_in(keys[0], 0x150)
    scores = (jax.random.uniform(pool_key, (CAP,))
              + jnp.where(js.alive, 0.0, 2.0))
    pool_q = np.array(jax.lax.top_k(-scores, 512)[1])
    sels = [np.array(jax.random.randint(k, (256,), 0, 512)) for k in keys]
    js, jlog, jstats = JM.map_frame(
        js, jnp.asarray(kf_c), jnp.asarray(kf_d), jnp.asarray(kf_q),
        jnp.asarray(kf_t), jnp.asarray(iter_slots), keys, jcam, jr_map,
        JL.LossConfig(**MAP_LOSS),
        JM.MappingConfig(prune=JM.PruneConfig(*PRUNE), **mcfg))
    ts, tlog, tstats = M.map_frame(
        ts, torch.tensor(kf_c), torch.tensor(kf_d), torch.tensor(kf_q),
        torch.tensor(kf_t), iter_slots, cam, r_map,
        L.LossConfig(**MAP_LOSS),
        M.MappingConfig(prune=M.PruneConfig(*PRUNE), **mcfg),
        pool_q_idx=torch.tensor(pool_q).long(),
        iso_sels=[torch.tensor(s).long() for s in sels])
    jlog = np.asarray(jlog)
    assert tlog.shape == jlog.shape == (MAP_ITERS, M.N_LOG)
    assert np.all(np.isfinite(tlog.numpy()))
    # the first iteration starts from states equal up to the densified
    # points' 1e-5 (backprojected at poses equal to the bound above); the
    # colour term holds 1 - SSIM, whose cancellation leaves ~1e-7 absolute
    np.testing.assert_allclose(tlog.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    # intersections: the densified points differ by ~1e-5, which moves a
    # handful of tile-rect edges
    assert int(tstats[0]) == int(jstats[0]) == 0
    assert abs(int(tstats[1]) - int(jstats[1])) <= 1e-3 * int(jstats[1])
    # Later iterates: Adam at eps 1e-15 turns a sign flip of a near-zero
    # gradient into a full +-lr step, so each parameter may differ by up to
    # its lr per iteration (and the losses by what such steps change).
    lr = {"means3d": LR_MAP["lr_means3d"], "rgb_colors":
          LR_MAP["lr_rgb_colors"], "unnorm_rotations":
          LR_MAP["lr_unnorm_rotations"], "logit_opacities":
          LR_MAP["lr_logit_opacities"], "log_scales": LR_MAP["lr_log_scales"]}
    _assert_states_close(
        ts, js, {k: MAP_ITERS * v + 1e-5 for k, v in lr.items()}, "map")
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-2, atol=1e-4)
