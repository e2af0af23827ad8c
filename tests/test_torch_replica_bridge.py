"""The Replica bridge and the shipped Replica config in the port: the
port's tools/synth_to_replica.py against the JAX one, the port's
ReplicaDataset on either tree, and configs/replica/splatam.py through the
port's CLI against the JAX package's SLAM on the same files."""
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu.datasets import get_dataset as jget_dataset
from isogs_slam_tpu.datasets import load_dataset_config as jload_cfg
from isogs_slam_tpu.scripts.splatam import apply_overrides as japply
from isogs_slam_tpu.slam.config import inject_defaults as jinject
from isogs_slam_tpu.slam.config import load_experiment_config as jload
from isogs_slam_tpu.slam.pipeline import SLAM as JSLAM
from isogs_slam_tpu.tools.synth_to_replica import \
    write_replica_layout as jwrite
from isogs_slam_tpu_torch.datasets import get_dataset, load_dataset_config
from isogs_slam_tpu_torch.io.images import imread
from isogs_slam_tpu_torch.scripts import splatam
from isogs_slam_tpu_torch.tools.synth_to_replica import (
    main as bridge_main, write_replica_layout)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICA_CFG = os.path.join(ROOT, "configs", "replica", "splatam.py")
H, W, N_FRAMES = 48, 64, 4
KW = dict(num_frames=N_FRAMES, height=H, width=W, traj_step=0.012,
          n_per_wall=400)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{package: (root, yaml path)}: the bridge written by each package."""
    base = tmp_path_factory.mktemp("bridge")
    return {
        "jax": (str(base / "jax"), jwrite(str(base / "jax"), "room0", **KW)),
        "torch": (str(base / "torch"),
                  write_replica_layout(str(base / "torch"), "room0",
                                       device="cpu", **KW))}


def _read(path):
    with open(path) as f:
        return f.read()


def test_bridge_trees_match_reference(trees):
    """traj.txt and the camera YAML are byte-equal; the depth PNGs are
    equal but for pixels one uint16 quantum (1 / 6553.5 m) apart, where
    the two renders' float rounding straddles a truncation step (measured:
    2-5 of 3072 pixels a frame), at most 1% of the pixels; the JPEG colour
    decodes within 2 levels (measured: byte-equal files)."""
    (jr, jy), (tr, ty) = trees["jax"], trees["torch"]
    assert os.path.basename(jy) == os.path.basename(ty)
    assert _read(jy) == _read(ty)
    assert _read(os.path.join(jr, "room0", "traj.txt")) == _read(
        os.path.join(tr, "room0", "traj.txt"))
    for i in range(N_FRAMES):
        res = os.path.join("room0", "results")
        dj = imread(os.path.join(jr, res, f"depth{i:06d}.png"))
        dt = imread(os.path.join(tr, res, f"depth{i:06d}.png"))
        assert dj.dtype == dt.dtype == np.uint16
        diff = np.abs(dj.astype(np.int64) - dt.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, i
        cj = imread(os.path.join(jr, res, f"frame{i:06d}.jpg"))
        ct = imread(os.path.join(tr, res, f"frame{i:06d}.jpg"))
        assert cj.shape == ct.shape == (H, W, 3)
        assert np.abs(cj.astype(int) - ct.astype(int)).max() <= 2, i


def test_bridge_cli_names_the_port(tmp_path, capsys):
    """The bridge's CLI writes the layout and prints a run command of the
    port's CLI on the card."""
    out = str(tmp_path / "ds")
    assert bridge_main(["--out", out, "--frames", "2", "--height", "32",
                        "--width", "48", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "isogs_slam_tpu_torch.scripts.splatam" in text
    assert "--device cuda" in text
    assert os.path.isfile(os.path.join(out, "room0", "results",
                                       "depth000001.png"))


@pytest.mark.parametrize("tree", ["jax", "torch"])
def test_replica_dataset_reads_either_tree(trees, tree):
    """The port's ReplicaDataset gives the JAX one's frames exactly
    (colour, depth, intrinsics, pose normalized to frame 0) on either
    package's tree, through the YAML intrinsics chain."""
    root, yaml_path = trees[tree]
    cfg = load_dataset_config(yaml_path)
    assert cfg == jload_cfg(yaml_path)
    ds = get_dataset(cfg, root, "room0", desired_height=H, desired_width=W,
                     relative_pose=True)
    jds = jget_dataset(cfg, root, "room0", desired_height=H,
                       desired_width=W, relative_pose=True)
    assert type(ds).__name__ == "ReplicaDataset" and len(ds) == len(jds)
    for i in range(N_FRAMES):
        for got, want in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))


def test_shipped_replica_config_matches_reference(trees, tmp_path,
                                                  monkeypatch):
    """configs/replica/splatam.py unmodified but for path, size and cost
    overrides: the port through its CLI (`--set`, --device cpu, eval), the
    JAX package through the same overrides and SLAM, on the same bridge
    files (4 frames at 48x64, 4 tracking and 6 mapping iterations, mapping
    every 3rd frame). The tolerances of test_torch_pipeline's
    shipped_defaults case (the shipped config's isotropic init and iso
    loss draw on the device, where the two packages' draws differ):
    keyframe lists equal, every camera translation within 2 cm, both ATEs
    under 8 cm."""
    root, yaml_path = trees["torch"]
    monkeypatch.setenv("SPLATAM_SCENE_INDEX", "0")
    sets = [f"data.basedir={root}", f"data.gradslam_data_cfg={yaml_path}",
            f"data.desired_image_height={H}", f"data.desired_image_width={W}",
            "tracking.num_iters=4", "mapping.num_iters=6",
            "mapping_window_size=5", "map_every=3", "keyframe_every=3",
            "eval_every=3", "checkpoint_interval=100", "isogs.sample_size=256",
            "isogs.k=8", "load_checkpoint=False", "checkpoint_time_idx=0"]
    args = [REPLICA_CFG, "--device", "cpu", "--set",
            f"workdir={tmp_path / 'torch'}"]
    for s in sets:
        args += ["--set", s]
    slam = splatam.main(args)
    assert type(slam.dataset).__name__ == "ReplicaDataset"
    assert slam.lcfg_track.sil_norm_render is True
    assert slam.lcfg_track.sil_thres == 0.99
    assert slam.lcfg_map.w_flat == 50.0 and slam.lcfg_map.w_iso == 2.0

    jcfg = jload(REPLICA_CFG)
    japply(jcfg, [f"workdir={tmp_path / 'jax'}"] + sets)
    jslam = JSLAM(jinject(jcfg))
    jslam.run()

    assert slam.keyframe_time_indices == jslam.keyframe_time_indices
    assert np.isfinite(slam.cam_trans).all()
    assert np.abs(slam.cam_trans[:, 1:]).max() > 1e-4
    dt = np.linalg.norm(slam.cam_trans - np.asarray(jslam.cam_trans), axis=0)
    assert dt.max() < 2e-2, dt
    res = slam.eval_results
    assert res["Final Average ATE RMSE (cm)"] < 8.0, res
    assert np.isfinite(res["Average PSNR"])
    # the reference's ATE over its host-side trajectory
    from isogs_slam_tpu_torch.eval.eval_helpers import est_w2c
    from isogs_slam_tpu_torch.eval.metrics import evaluate_ate
    est = [jslam.first_frame_w2c] + [est_w2c(jslam, i)
                                     for i in range(1, N_FRAMES)]
    assert 100 * evaluate_ate(jslam.gt_w2c_all, est) < 8.0
    for name in ("params0.npz", f"params{N_FRAMES - 1}.npz",
                 "runtime_stats.json"):
        assert os.path.exists(os.path.join(slam.output_dir, name)), name
    assert os.path.exists(os.path.join(slam.eval_dir, "eval_summary.json"))
