"""Checkpoints and state transfer between the port and the JAX package: the
.npz schema both ways, resume with keyframe replay, and a SLAM object's
state carried across as numpy arrays."""
import glob
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu.io import checkpoints as JC
from isogs_slam_tpu.slam.pipeline import SLAM as JSLAM
from isogs_slam_tpu_torch.core import convert
from isogs_slam_tpu_torch.io import checkpoints as C
from isogs_slam_tpu_torch.slam.pipeline import SLAM
from test_torch_pipeline import N_FRAMES, _config, _frames


def _ckpt_args(rng, n=37, t=6):
    params = {k: rng.normal(size=(n, d)).astype(np.float32)
              for k, d in (("means3D", 3), ("rgb_colors", 3),
                           ("unnorm_rotations", 4), ("logit_opacities", 1),
                           ("log_scales", 3))}
    return dict(
        gauss_params=params,
        cam_unnorm_rots=rng.normal(size=(1, 4, t)).astype(np.float32),
        cam_trans=rng.normal(size=(1, 3, t)).astype(np.float32),
        timestep=rng.integers(0, t, n).astype(np.float32),
        intrinsics=np.eye(3), first_frame_w2c=np.eye(4), org_width=80,
        org_height=64,
        gt_w2c_all_frames=[np.eye(4) * (i + 1) for i in range(4)],
        keyframe_time_indices=[0, 2, 3])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_schema_interchange(tmp_path, writer):
    """A file saved by either package's save_checkpoint loads in the other:
    all keys, dtypes, shapes and values equal to what the other package
    writes from the same inputs (sh_coeffs_flat included)."""
    args = _ckpt_args(np.random.default_rng(0))
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    JC.save_checkpoint(dj, 5, **args)
    C.save_checkpoint(dt, 5, **args)
    if writer == "reference":
        got = C.load_checkpoint(os.path.join(dj, "params5.npz"))
        ref = JC.load_checkpoint(os.path.join(dt, "params5.npz"))
    else:
        got = JC.load_checkpoint(os.path.join(dt, "params5.npz"))
        ref = C.load_checkpoint(os.path.join(dj, "params5.npz"))
    assert set(got) == set(ref) >= set(C.GAUSS_KEYS) | {
        "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics", "w2c",
        "org_width", "org_height", "gt_w2c_all_frames",
        "keyframe_time_indices", "sh_coeffs_flat"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(
        np.load(os.path.join(dt, "keyframe_time_indices5.npy")),
        np.load(os.path.join(dj, "keyframe_time_indices5.npy")))
    assert C.GAUSS_KEYS == JC.GAUSS_KEYS


def test_checkpoint_gc_keeps_last_three(tmp_path):
    args = _ckpt_args(np.random.default_rng(1))
    d = str(tmp_path)
    for frame in (0, 2, 4, 6, 10):
        C.save_checkpoint(d, frame, **args)
    assert [f for f, _ in C.list_checkpoints(d)] == [4, 6, 10]
    assert C.list_checkpoints(d) == JC.list_checkpoints(d)
    assert C.latest_checkpoint(d)[0] == JC.latest_checkpoint(d)[0] == 10
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(d, "keyframe_time_indices*.npy"))) == [
        "keyframe_time_indices10.npy", "keyframe_time_indices4.npy",
        "keyframe_time_indices6.npy"]
    assert C.latest_checkpoint(str(tmp_path / "none")) == (None, None)


def test_checkpoint_resume_replays_keyframes(tmp_path):
    """A run that checkpoints every 2nd frame resumes from its latest
    checkpoint with the trajectory restored and the keyframes replayed,
    and completes; the JAX pipeline resumes from the same files."""
    cfg = _config(tmp_path, "resume", save_checkpoints=True,
                  checkpoint_interval=2)
    cfg["mapping"]["num_iters"] = 3
    cfg["tracking"]["num_iters"] = 3
    slam1 = SLAM(cfg, dataset=_frames())
    slam1.run(end_at=4)
    trans_before = slam1.cam_trans.copy()
    n_before = int(slam1.state.num_alive())

    cfg2 = dict(cfg, load_checkpoint=True, checkpoint_time_idx=-1)
    slam2 = SLAM(cfg2, dataset=_frames())
    assert slam2.try_resume() == 4
    assert slam2.try_resume() == 4                  # idempotent
    np.testing.assert_allclose(slam2.cam_trans[:, :4], trans_before[:, :4],
                               atol=1e-6)
    assert slam2.kf.time_indices == slam2.keyframe_time_indices == [0, 2, 3]
    assert len(slam2.gt_w2c_all) == 4
    assert int(slam2.state.num_alive()) == int(slam2.state.hwm) == n_before
    assert slam2.rcfg.max_isect_cap > 0
    np.testing.assert_array_equal(
        slam2.kf.colors[:3].numpy(), slam1.kf.colors[:3].numpy())

    jslam = JSLAM(dict(cfg2), dataset=_frames())
    assert jslam.try_resume() == 4
    assert jslam.kf.time_indices == [0, 2, 3]
    np.testing.assert_array_equal(np.asarray(jslam.state.params.means3d),
                                  slam2.state.params.means3d.numpy())
    np.testing.assert_array_equal(np.asarray(jslam.state.timestep),
                                  slam2.state.timestep.numpy())
    np.testing.assert_array_equal(jslam.cam_rots, slam2.cam_rots)

    slam2.run()
    assert np.isfinite(slam2.cam_trans).all()
    ck = sorted(glob.glob(os.path.join(slam2.output_dir, "params*.npz")))
    data = np.load(ck[-1])
    assert data["sh_coeffs_flat"].shape == (data["rgb_colors"].shape[0], 48)
    np.testing.assert_allclose(
        data["sh_coeffs_flat"][:, :3] * 0.28209479177387814 + 0.5,
        data["rgb_colors"], atol=1e-5)


def _fast(cfg):
    """The fast configuration's levers (nothing of them is stored in a
    checkpoint or in the arrays)."""
    cfg["tracking"]["tile_subsample"] = 2
    cfg["mapping"]["tile_subsample"] = 2
    cfg["mapping"]["exact_polish_iters"] = 2
    return cfg


@pytest.mark.parametrize("source", ["reference", "port", "port_fast"])
def test_slam_state_crosses_as_arrays(tmp_path, source):
    """slam_to_arrays reads either package's SLAM object; slam_from_arrays
    puts trajectory, keyframe library and map into a new SLAM of the port,
    which then continues from that state; also between two SLAM objects
    built with the fast configuration."""
    frames = _frames()
    cls = JSLAM if source == "reference" else SLAM
    tweak = _fast if source == "port_fast" else (lambda c: c)
    src = cls(tweak(_config(tmp_path, "src",
                            gaussian_distribution="anisotropic")),
              dataset=frames)
    color, depth, _, pose = frames[0]
    src.initialize_first_frame(color, depth)
    src.gt_w2c_all.append(np.linalg.inv(np.asarray(pose, np.float64)))
    if source == "reference":
        import jax.numpy as jnp
        im = jnp.asarray(color).transpose(2, 0, 1) / 255.0
        d = jnp.asarray(depth).transpose(2, 0, 1)
    else:
        im, d = src._to_chw_frame(color, depth)
    q, t = src._pose(0)
    src.kf.add_keyframe(0, im, d, q, t, src._est_w2c(0))
    src.keyframe_time_indices.append(0)
    src.cam_trans[:, 1] = [0.01, -0.02, 0.03]

    arrays = convert.slam_to_arrays(src)
    dst = convert.slam_from_arrays(
        SLAM(tweak(_config(tmp_path, "dst",
                           gaussian_distribution="anisotropic")),
             dataset=frames), arrays)
    back = convert.slam_to_arrays(dst)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], np.asarray(arrays[k]),
                                      err_msg=k)
    assert dst.kf.colors.dtype == torch.uint8
    assert dst.rcfg.max_isect_cap == src.rcfg.max_isect_cap > 0
    assert len(dst.kf) == 1 and dst.keyframe_time_indices == [0]
    # it continues: one tracked frame from the transferred state
    im1, d1 = dst._to_chw_frame(frames[1][0], frames[1][1])
    dst.gt_w2c_all.append(np.linalg.inv(np.asarray(frames[1][3], np.float64)))
    res = dst.track(1, im1, d1)
    assert res.iters_run == 6 and np.isfinite(dst.cam_trans[:, 1]).all()
    assert N_FRAMES == dst.num_frames
    if source == "port_fast":
        assert dst.tcfg.tile_subsample == dst.mcfg.tile_subsample == 2
        assert dst.map(1, im1, d1).shape[0] == dst.mcfg.num_iters
