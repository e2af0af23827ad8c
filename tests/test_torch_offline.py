"""The port's offline trainers against the JAX package: the learning-rate
schedule, offline_chunk (the reference's frame draws and split noise
injected), the post-opt trajectory clamp, checkpoints written by one
package and loaded by the other's PostSLAMOpt, eval_nvs on one map, and
each new CLI end to end on the CPU.

The reference runs on its XLA route (backend="xla"). Tolerances are stated
at each assert."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import optim as JO
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.scripts import eval_novel_view as JEV
from isogs_slam_tpu.scripts import gaussian_splatting as JGS
from isogs_slam_tpu.scripts import post_splatam_opt as JPO
from isogs_slam_tpu.slam import densify as JD
from isogs_slam_tpu.slam import offline as JOff
from isogs_slam_tpu_torch.core import convert, optim
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.scripts import eval_novel_view as EV
from isogs_slam_tpu_torch.scripts import gaussian_splatting as GS
from isogs_slam_tpu_torch.scripts import post_splatam_opt as PO
from isogs_slam_tpu_torch.slam import densify as D
from isogs_slam_tpu_torch.slam import offline as Off
from test_torch_densify import _split_noise
from test_torch_subset import MK, _map_inputs

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "isogs_slam_tpu_torch", "configs", "synthetic")


def test_expon_lr_matches_reference():
    """The means3D schedule over a whole run, in f32 as the reference
    computes it: 1e-6 relative."""
    steps = np.arange(1, 401)
    for final, delay in ((3.2e-6, 0.01), (1.6e-5, 1.0)):
        ref = np.asarray(JOff.expon_lr(jnp.asarray(steps, jnp.float32),
                                       1.6e-4, final, delay, 400))
        got = Off.expon_lr(steps, 1.6e-4, final, delay, 400)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6)


N_ITERS = 6
LRS = dict(lr_means3d=1.6e-4, lr_rgb_colors=2.5e-3, lr_unnorm_rotations=1e-3,
           lr_logit_opacities=5e-2, lr_log_scales=1e-3)


def test_offline_chunk_matches_reference():
    """6 iterations over 2 frames with the reference's frame draws, learning
    rates and split noise: densify at iterations 2 and 4, the opacity
    reset at 3. The first iteration's losses 1e-4 relative (the mapping
    loss's tolerance: f32 sums of the image in another order), later ones
    1e-2; rows split / alive / the intersections dropped exactly;
    parameters within two learning rates per iteration (Adam eps 1e-8)
    and 95% of them within 0.05 of one."""
    js, ts, jcam, cam, (kf_c, kf_d, kf_q, kf_t) = _map_inputs()
    cap = ts.capacity
    dkw = dict(start_after=2, remove_big_after=10 ** 6, stop_after=10 ** 6,
               densify_every=2, grad_thresh=2e-5, reset_opacities_every=3)
    okw = dict(num_iters=N_ITERS, chunk_iters=N_ITERS, frames_per_chunk=2,
               **LRS)
    rkw = dict(max_per_tile=MK, max_isect_cap=65536, grad_scatter_bf16=False)
    iter_frames = np.array([0, 1, 1, 0, 1, 0], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), N_ITERS)
    lr = np.asarray(JOff.expon_lr(jnp.arange(1, N_ITERS + 1,
                                             dtype=jnp.float32),
                                  1.6e-4, 3.2e-6, 0.01, N_ITERS))
    jst, _, jlog = JOff.offline_chunk(
        js, JO.init(js.params), jnp.asarray(kf_c), jnp.asarray(kf_d),
        jnp.asarray(kf_q), jnp.asarray(kf_t), jnp.asarray(iter_frames), keys,
        jnp.asarray(lr), jnp.asarray(0, jnp.int32), jcam,
        JR.RasterConfig(backend="xla", **rkw),
        JOff.OfflineConfig(densify=JD.DensifyConfig(**dkw), **okw))
    tst, _, tlog, counts = Off.offline_chunk(
        ts, optim.init(ts.params), torch.tensor(kf_c), torch.tensor(kf_d),
        torch.tensor(kf_q), torch.tensor(kf_t), iter_frames,
        Off.expon_lr(np.arange(1, N_ITERS + 1), 1.6e-4, 3.2e-6, 0.01,
                     N_ITERS), 0, cam, R.RasterConfig(**rkw),
        Off.OfflineConfig(densify=D.DensifyConfig(**dkw), **okw),
        split_noise=[_split_noise(k, 2, cap) for k in keys])
    jlog = np.asarray(jlog)
    assert tlog.shape == (N_ITERS, Off.N_LOG)
    np.testing.assert_allclose(tlog.numpy()[0, :3], jlog[0], rtol=1e-4)
    np.testing.assert_allclose(tlog.numpy()[:, :3], jlog, rtol=1e-2)
    assert not tlog.numpy()[:, 3].any()            # nothing truncated
    n_clone, n_split, dropped = (int(x) for x in counts)
    assert n_split > 0 and dropped == 0
    assert int(tst.hwm) == int(jst.hwm) == (int(ts.hwm) + n_clone
                                           + 2 * n_split)
    got = convert.state_to_arrays(tst)
    ref = convert.state_to_arrays(convert.state_from_arrays(jst, "cpu"))
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for k in ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
              "log_scales"):
        v = LRS["lr_" + k]
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=2 * N_ITERS * v + 1e-5, err_msg=k)
        close = np.abs(got[k] - ref[k]) <= 0.05 * v + 1e-6
        assert close.mean() > 0.95, (k, close.mean())


def _train_config(tmp_path, name, **data):
    """The port's gaussian_splatting.py cut to 32x48, 5 frames and 4
    iterations, with an intersection capacity that holds every
    intersection at this size."""
    cfg = GS.load_experiment_config(os.path.join(CONFIGS,
                                                 "gaussian_splatting.py"))
    cfg.update(workdir=str(tmp_path), run_name=name, primary_device="cpu")
    cfg["raster"] = dict(max_per_tile=1024, isect_per_gaussian=16.0,
                         tile_chunk=8)
    cfg["data"].update(desired_image_height=32, desired_image_width=48,
                       num_frames=5, **data)
    cfg["train"].update(num_iters_mapping=4, chunk_iters=2,
                        frames_per_chunk=2)
    cfg["train"]["densify_dict"].update(start_after=1, densify_every=2,
                                        grad_thresh=1e-4)
    return cfg


def _post_config(tmp_path, ckpt_dir, jax_=False):
    cfg = _train_config(tmp_path, "post" + ("_j" if jax_ else ""),
                        param_ckpt_path=str(ckpt_dir))
    cfg["checkpoint_time_idx"] = -1
    cfg["train"]["use_gaussian_splatting_densification"] = False
    return cfg


def test_postopt_clamps_to_checkpoint_frame(tmp_path):
    """Mirror of tests/test_postopt_clamp.py: a frame-3 checkpoint whose
    pose arrays hold 8 frames, the tail NaN, gives exactly 4 finite poses,
    normalized."""
    n, total = 64, 8
    rng = np.random.default_rng(0)
    rots = np.zeros((1, 4, total), np.float32)
    rots[0, 0, :] = 2.0
    rots[0, :, 4:] = np.nan
    trans = np.zeros((1, 3, total), np.float32)
    trans[0, :, 4:] = np.nan
    run_dir = tmp_path / "slamrun"
    run_dir.mkdir()
    np.savez(run_dir / "params3.npz",
             means3D=rng.normal(size=(n, 3)).astype(np.float32),
             rgb_colors=rng.uniform(size=(n, 3)).astype(np.float32),
             unnorm_rotations=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
             logit_opacities=np.zeros((n, 1), np.float32),
             log_scales=np.full((n, 3), -3.0, np.float32),
             cam_unnorm_rots=rots, cam_trans=trans)
    cfg = _post_config(tmp_path, run_dir)
    cfg["data"]["num_frames"] = total
    opt = PO.PostSLAMOpt(cfg)
    assert opt.num_frames == 4
    assert np.isfinite(opt.cam_rots).all() and np.isfinite(opt.cam_trans).all()
    np.testing.assert_allclose(opt.cam_rots[0], 1.0)
    assert int(opt.state.num_alive()) == n
    assert opt.state.capacity == 8192      # round_capacity(1.25 n, 8192)


def _rows_of(state):
    a = convert.state_to_arrays(state)
    n = int(a["hwm"])
    return {k: a[k][:n] for k in ("means3d", "rgb_colors",
                                  "unnorm_rotations", "logit_opacities",
                                  "log_scales")}


def test_offline_checkpoints_load_across_packages(tmp_path):
    """A checkpoint the JAX offline trainer saved seeds the port's
    PostSLAMOpt, and one the port's saved seeds the JAX PostSLAMOpt: the
    same rows, capacity, scene radius (1e-5: each package renders frame
    0), trajectory and frame count in both packages."""
    jcfg = _train_config(tmp_path, "gs_j")
    jcfg["primary_device"] = "cpu"
    jr = JGS.OfflineGS(jcfg)
    jr.init_sweep()
    jr.save()
    tr = GS.OfflineGS(_train_config(tmp_path, "gs_t"))
    tr.init_sweep()
    tr.save()
    for src in (jr.output_dir, tr.output_dir):
        t = PO.PostSLAMOpt(_post_config(tmp_path, src))
        j = JPO.PostSLAMOpt(_post_config(tmp_path, src, jax_=True))
        assert t.num_frames == j.num_frames == 5
        assert t.state.capacity == j.state.capacity
        np.testing.assert_allclose(float(t.state.scene_radius),
                                   float(j.state.scene_radius), rtol=1e-5)
        np.testing.assert_array_equal(t.cam_rots, j.cam_rots)
        np.testing.assert_array_equal(t.cam_trans, j.cam_trans)
        got, ref = _rows_of(t.state), _rows_of(
            convert.state_from_arrays(j.state, "cpu"))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the trainers' own maps: the port's sweep holds as many rows as the
    # reference's to 2% (device draws differ; the same frames densify)
    assert abs(int(tr.state.hwm) - int(jr.state.hwm)) <= 0.02 * int(
        jr.state.hwm)


class _Frames:
    """A fixed list of (color, depth, intrinsics, pose) frames."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


def test_eval_nvs_matches_reference(tmp_path):
    """eval_nvs of one map on the same frames: PSNR, MS-SSIM and the depth
    errors 1e-5 relative, LPIPS (rand-alexnet) 1e-4 (f32 convolutions in
    another order), the same frame count and per-frame files."""
    from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
    js, ts, jcam, cam, _ = _map_inputs()
    ds = SyntheticDataset(num_frames=4, height=jcam.height, width=jcam.width,
                          n_per_wall=400, traj_step=0.1)
    frames = _Frames([tuple(np.asarray(a) for a in ds[i]) for i in range(4)])
    rkw = dict(max_per_tile=MK, max_isect_cap=65536)
    ref = JEV.eval_nvs(frames, js, jcam, JR.RasterConfig(backend="xla", **rkw),
                       str(tmp_path / "j"))
    got = EV.eval_nvs(frames, ts, cam, R.RasterConfig(**rkw),
                      str(tmp_path / "t"), device="cpu")
    assert list(got) == list(ref) and got["Frames"] == ref["Frames"] == 3
    assert got["LPIPS Variant"] == ref["LPIPS Variant"]
    for k in ("Average NVS PSNR", "Average NVS MS-SSIM",
              "Average NVS Depth RMSE (cm)", "Average NVS Depth L1 (cm)"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["Average NVS LPIPS"],
                               ref["Average NVS LPIPS"], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


def _write_config(cfg, path):
    with open(path, "w") as f:
        f.write(f"config = {cfg!r}\n")
    return str(path)


def test_offline_clis_end_to_end_on_cpu(tmp_path):
    """The three CLIs with --device cpu at 32x48: the offline trainer
    (densifies, saves, evaluates), post-SLAM optimization of its checkpoint
    (same poses: the same ATE) and the novel-view evaluation of the result;
    without --device each refuses to run without CUDA, and a config for
    the TPU is refused."""
    cfg = _train_config(tmp_path, "gs")
    cfg["primary_device"] = "cuda"                  # the configs' default
    gs_cfg = _write_config(cfg, tmp_path / "gs.py")
    for main in (GS.main, PO.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([gs_cfg, "--no-eval"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EV.main([gs_cfg])
    with pytest.raises(ValueError, match="tpu"):   # a JAX package config
        GS.main([_write_config(dict(cfg, primary_device="tpu"),
                               tmp_path / "tpu.py")])

    runner = GS.main([gs_cfg, "--device", "cpu"])
    c = np.sum(runner.stats["densify_counts"], axis=0)
    assert c[0] + c[1] > 0 and int(runner.state.hwm) > 0
    res = runner.eval_results
    assert np.isfinite(list(v for v in res.values()
                            if isinstance(v, float))).all()
    with open(os.path.join(runner.eval_dir, "eval_summary.json")) as f:
        assert json.load(f) == res

    pcfg = _post_config(tmp_path, runner.output_dir)
    pcfg["primary_device"] = "cuda"
    post = PO.main([_write_config(pcfg, tmp_path / "po.py"), "--device",
                    "cpu"])
    assert post.num_frames == 5
    np.testing.assert_allclose(post.eval_results[
        "Final Average ATE RMSE (cm)"], res["Final Average ATE RMSE (cm)"],
        atol=1e-6)
    losses = np.concatenate(post.stats["chunk_loss"])
    assert np.isfinite(losses).all()

    nvs = EV.main([_write_config(pcfg, tmp_path / "po.py"), "--device",
                   "cpu"])
    assert nvs["Frames"] == 4 and np.isfinite(nvs["Average NVS PSNR"])
    out = os.path.join(post.output_dir, "eval_nvs")
    assert os.path.exists(os.path.join(out, "nvs_eval_summary.json"))
