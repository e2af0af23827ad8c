"""The port's CLI alone: scripts.splatam.main on the port's smoke config, on
the CPU (the kernels' plain versions), then evaluation."""
import csv
import json
import os

import numpy as np

from isogs_slam_tpu_torch.scripts import splatam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "isogs_slam_tpu_torch", "configs", "synthetic",
                     "smoke.py")
SMOKE_FAST = os.path.join(ROOT, "isogs_slam_tpu_torch", "configs",
                          "synthetic", "smoke_fast.py")
FULL_RES_FAST = [os.path.join(ROOT, "isogs_slam_tpu_torch", "configs",
                              "synthetic", name + ".py")
                 for name in ("full_res_fast", "full_res_fastlegal")]


def test_cli_end_to_end_on_cpu(tmp_path):
    """The port's CLI on its smoke config (cut to 96x128, 12 mapping
    iterations), then the asserts of the JAX package's end-to-end test:
    ATE < 8 cm, PSNR > 18 dB, depth L1 < 40 cm, poses moved, online-eval
    artifacts, runtime stats, checkpoints."""
    slam = splatam.main([
        SMOKE, "--end-at", "6", "--device", "cpu",
        "--set", f"workdir={tmp_path}",
        "--set", "data.desired_image_height=96",
        "--set", "data.desired_image_width=128",
        "--set", "mapping.num_iters=12", "--set", "map_every=3",
        "--set", "keyframe_every=3", "--set", "tracking.num_iters=10"])
    res = slam.eval_results
    assert np.isfinite(res["Final Average ATE RMSE (cm)"])
    assert res["Final Average ATE RMSE (cm)"] < 8.0, res
    assert res["Average PSNR"] > 18.0, res
    assert res["Average Depth L1 (cm)"] < 40.0, res
    assert 0.0 < res["Average MS-SSIM"] <= 1.0 + 1e-6
    assert res["LPIPS Variant"] == "rand-alexnet"
    assert np.isfinite(res["Average LPIPS"])
    assert np.abs(slam.cam_trans[:, 1:7]).max() > 1e-4

    out = slam.output_dir
    online = os.path.join(out, "eval_online")
    online_psnr = np.loadtxt(os.path.join(online, "online_psnr.txt"))
    online_ate = np.loadtxt(os.path.join(online, "online_ate.txt"))
    assert online_psnr.size >= 2 and np.isfinite(online_psnr).all()
    assert np.isfinite(online_ate).all()
    with open(os.path.join(online, "online_summary.json")) as f:
        summary = json.load(f)
    assert np.isfinite(summary["Online Average PSNR"])
    assert summary["Frames Evaluated"] == online_psnr.size
    with open(os.path.join(out, "runtime_stats.json")) as f:
        stats = json.load(f)
    assert stats["Final Frame"] == 6
    assert stats["Average Tracking/Frame Time (s)"] > 0
    assert stats["Tracking Binning Rebins"] \
        + stats["Tracking Binning Reuses"] == 6
    with open(os.path.join(out, "eval", "eval_summary.json")) as f:
        assert json.load(f) == res
    for name in ("params0.npz", "params6.npz", "metrics_log.csv",
                 "config.py", "overrides.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "metrics_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert {r["stage"] for r in rows} == {"tracking", "mapping"}
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    track_mask = [float(r["mask_frac"]) for r in rows
                  if r["stage"] == "tracking"]
    assert min(track_mask) > 0.1


def test_cli_fast_config_on_cpu(tmp_path):
    """The CLI on the smoke-sized fast configuration (tile-subset tracking,
    stripe mapping with an exact tail), cut to 64x80: it runs, evaluates,
    and does not collapse (ATE < 8 cm, PSNR > 18 dB, tracking mask > 0.1)."""
    slam = splatam.main([
        SMOKE_FAST, "--end-at", "4", "--device", "cpu",
        "--set", f"workdir={tmp_path}",
        "--set", "data.desired_image_height=64",
        "--set", "data.desired_image_width=80",
        "--set", "mapping.num_iters=6", "--set", "map_every=2",
        "--set", "keyframe_every=2", "--set", "tracking.num_iters=5"])
    assert slam.tcfg.tile_subsample == slam.mcfg.tile_subsample == 2
    assert slam.mcfg.exact_polish_iters == 2
    res = slam.eval_results
    assert res["Final Average ATE RMSE (cm)"] < 8.0, res
    assert res["Average PSNR"] > 18.0, res
    with open(os.path.join(slam.output_dir, "metrics_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert min(float(r["mask_frac"]) for r in rows
               if r["stage"] == "tracking") > 0.1


def test_full_width_fast_configs_load():
    """The full-width fast configurations load through the CLI's loader and
    set the levers of the reference's presets on this package's full_res
    config."""
    from isogs_slam_tpu_torch.slam.pipeline import (_check_ported,
                                                    _mapping_cfg,
                                                    _tracking_cfg)
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    for path, polish in zip(FULL_RES_FAST, (0, 4)):
        cfg = inject_defaults(splatam.load_experiment_config(path))
        assert cfg["primary_device"] == "cuda"
        assert cfg["data"]["desired_image_width"] == 1200
        assert _tracking_cfg(cfg).tile_subsample == 4
        m = _mapping_cfg(cfg)
        assert (m.tile_subsample, m.exact_polish_iters) == (4, polish)
        _check_ported(cfg)          # nothing of it raises


def test_fullres_postopt_config_renders_the_slam_run_frames():
    """The port's post_splatam_opt_fullres.py loads the run of its
    full_res.py: the same run directory and scene-generator inputs (dataset,
    seed, trajectory step, image size, frame count), so the post-opt ground
    truth is the SLAM run's frames; the offline configs run on the card."""
    cfg_dir = os.path.join(ROOT, "isogs_slam_tpu_torch", "configs",
                           "synthetic")
    slam = splatam.load_experiment_config(os.path.join(cfg_dir,
                                                       "full_res.py"))
    post = splatam.load_experiment_config(
        os.path.join(cfg_dir, "post_splatam_opt_fullres.py"))
    assert (post["workdir"], post["data"]["param_run_name"]) == (
        slam["workdir"], slam["run_name"])
    assert post["seed"] == slam["seed"]
    for key in ("dataset_name", "synthetic_traj_step",
                "desired_image_height", "desired_image_width",
                "num_frames"):
        assert post["data"][key] == slam["data"][key], key
    for name in ("gaussian_splatting.py", "post_splatam_opt.py",
                 "post_splatam_opt_fullres.py"):
        cfg = splatam.load_experiment_config(os.path.join(cfg_dir, name))
        assert cfg["primary_device"] == "cuda", name
        assert "train" in cfg and "num_iters_mapping" in cfg["train"]


def test_shipped_config_names_the_device_flag():
    """A shipped config (configs/replica/splatam.py, primary_device "tpu")
    reaching the port is refused with an error that tells the user to pass
    --device cuda (or --device cpu); the flag's value is then taken."""
    import pytest
    from isogs_slam_tpu_torch.slam.config import load_experiment_config
    from isogs_slam_tpu_torch.slam.pipeline import primary_device
    config = load_experiment_config(os.path.join(ROOT, "configs", "replica",
                                                 "splatam.py"))
    assert config["primary_device"] == "tpu"
    with pytest.raises(ValueError, match=r"pass --device cuda \(or --device "
                                         r"cpu\)"):
        primary_device(config)
    config["primary_device"] = "cpu"          # what --device cpu sets
    assert primary_device(config).type == "cpu"


def _numbers(text, key):
    import re
    return [float(x) for x in re.findall(rf"{key}=(-?[0-9.]+)", text)]


def test_installation_check_on_cpu(capsys):
    """The port's environment check with --device cpu passes every item,
    and its render's loss is the JAX check's on the same scene
    (isogs_slam_tpu/scripts/test_installation.py:40-56, the forward only)
    within 1e-6 relative (the printed value has 2 decimals of ~8006)."""
    import jax
    import jax.numpy as jnp
    from isogs_slam_tpu.core.camera import Camera as JCamera
    from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
    from isogs_slam_tpu.ops.rasterize import render_rgbd_sil as jrender
    from isogs_slam_tpu_torch.scripts import test_installation as ti
    assert ti.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 6 and "[FAIL]" not in out
    rng = np.random.default_rng(0)
    n = 500
    means = jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32
                        ).at[:, 2].add(2.5)
    rgb = jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32)
    im, d, _, _, _ = jax.jit(lambda m: jrender(
        m, jnp.tile(jnp.array([1., 0, 0, 0]), (n, 1)),
        jnp.full((n, 3), np.log(0.08)), jnp.ones((n, 1)), rgb,
        jnp.ones(n, bool),
        JCamera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5),
        JRasterConfig(max_per_tile=128, tile_chunk=12)))(means)
    (got,) = _numbers(out, "loss")
    np.testing.assert_allclose(got, float(jnp.sum(im) + jnp.sum(d)),
                               rtol=1e-6)


def test_model_browser_text_listing_matches_reference(tmp_path, capsys):
    """model_browser --text lists the same runs, checkpoint counts, latest
    frames and eval numbers as the JAX browser on a toy experiments tree
    (a run with checkpoints and an eval summary, one with a final
    params.npz only, one with neither, which is not listed)."""
    from isogs_slam_tpu.scripts import model_browser as jmb
    from isogs_slam_tpu_torch.scripts import model_browser as mb
    root = tmp_path / "experiments"
    a = root / "Replica" / "room0_0"
    (a / "eval").mkdir(parents=True)
    for f in (0, 5, 10):
        np.savez(a / f"params{f}.npz", means3D=np.zeros((1, 3)))
    (a / "eval" / "eval_summary.json").write_text(json.dumps(
        {"Final Average ATE RMSE (cm)": 0.123, "Average PSNR": 33.5}))
    b = root / "iPhone_Captures" / "online_demo_0"
    b.mkdir(parents=True)
    np.savez(b / "params.npz", means3D=np.zeros((1, 3)))
    (root / "Replica" / "empty_0").mkdir()
    assert mb.scan_runs(str(root)) == jmb.scan_runs(str(root))
    assert len(mb.scan_runs(str(root))) == 2
    out = []
    for mod in (jmb, mb):
        mod.main(["--root", str(root), "--text"])
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and "33.50" in out[1]
    mb.main(["--root", str(tmp_path / "none"), "--text"])
    assert "no runs with checkpoints" in capsys.readouterr().out
