"""The shipped dataset families through the port against the JAX package,
part 2 (part 1, with the fixtures' description and the tolerances, is
test_torch_families.py): the iPhone (NeRFCapture) config, ReplicaV2 with
its novel-view config, and Replica's splatam_s (a separate densification
size), splatam_fast8 (tile-subset tracking, a mapping stripe at
tile_subsample 8) and replica_eval (scene and seed from SCENE_NUM / SEED,
no checkpoints)."""
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu.scripts import eval_novel_view as JEV
from isogs_slam_tpu.scripts.splatam import apply_overrides as japply
from isogs_slam_tpu.slam.config import load_experiment_config as jload
from isogs_slam_tpu.viz_scripts import final_recon as jfinal
from isogs_slam_tpu_torch.io.images import imread
from isogs_slam_tpu_torch.scripts import eval_novel_view as EV
from isogs_slam_tpu_torch.viz_scripts import final_recon
from test_torch_families import (H, N_FRAMES, ROOT, W, _cli_args,
                                 check_family, check_nvs, run_family)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["iphone", "replica_v2", "splatam_s",
                                  "splatam_fast8", "replica_eval"])
def test_family_slam_matches_reference(tmp_path, monkeypatch, case):
    """The shipped config through the port's CLI against the JAX
    package's SLAM, with its knobs as shipped: iPhone (mapping every frame,
    window 32, the depth-loss threshold at 50,000 and outlier depth),
    ReplicaV2 (its imap/00 train split), splatam_s (new Gaussians seeded
    from frames at half the mapping size), splatam_fast8 (tracking on every
    4th tile, mapping stripes at tile_subsample 8 with 4 exact polish
    iterations), replica_eval (scene 2 and seed 1 from SCENE_NUM / SEED,
    mapping every frame, checkpoints off). The iPhone run's map then goes
    through configs/iphone/splatam_viz.py (_final_recon_matches_reference).
    ReplicaV2 then runs
    configs/replica_v2/eval_novel_view.py (use_train_split=False) on the
    run's map through the port's CLI and the JAX one (check_nvs of part
    1)."""
    slam, jslam = run_family(case, tmp_path, monkeypatch)
    cfg = slam.config
    if case == "iphone":
        assert cfg["map_every"] == 1 and cfg["mapping_window_size"] == 32
        assert slam.tcfg.use_depth_loss_thres
        assert slam.tcfg.depth_loss_thres == 50000
        assert slam.lcfg_track.ignore_outlier_depth_loss
    elif case == "replica_v2":
        assert cfg["data"]["use_train_split"]
    elif case == "splatam_s":
        assert slam.densify_dataset is not None
        assert (slam.densify_cam.width, slam.densify_cam.height) == (W // 2,
                                                                     H // 2)
    elif case == "splatam_fast8":
        assert slam.mcfg.tile_subsample == 8
        assert slam.mcfg.exact_polish_iters == 4
        assert slam.tcfg.tile_subsample == 4
    else:
        assert cfg["run_name"] == "room2_1" and cfg["seed"] == 1
        assert cfg["map_every"] == 1 and not cfg["save_checkpoints"]
        assert not [f for f in os.listdir(slam.output_dir)
                    if f.startswith("params")]
    check_family(slam, jslam)
    if case == "iphone":
        _final_recon_matches_reference(slam, tmp_path, monkeypatch)
    if case != "replica_v2":
        return

    ckpt = os.path.join(slam.output_dir, f"params{N_FRAMES - 1}.npz")
    nvs_cfg = os.path.join(ROOT, "configs", "replica_v2",
                           "eval_novel_view.py")
    data = [f"data.basedir={tmp_path / 'data'}",
            f"data.gradslam_data_cfg={slam.config['data']['gradslam_data_cfg']}",
            f"data.desired_image_height={H}", f"data.desired_image_width={W}"]
    got = EV.main([nvs_cfg, "--device", "cpu", "--checkpoint", ckpt,
                   *_cli_args(data + [f"workdir={tmp_path / 'nvs'}"])])
    jcfg = jload(nvs_cfg)
    japply(jcfg, data + [f"workdir={tmp_path / 'nvs_jax'}"])
    cfg_file = tmp_path / "nvs_jax.py"
    cfg_file.write_text(f"config = {jcfg!r}\n")
    ref = JEV.main([str(cfg_file), "--checkpoint", ckpt])
    # the held-out split: one view between each two train views
    check_nvs(got, ref, N_FRAMES - 1)


def _final_recon_matches_reference(slam, tmp_path, monkeypatch):
    """configs/iphone/splatam_viz.py as shipped through each package's
    final_recon CLI (replay of every frame at full size) on the iPhone
    run's last checkpoint, given with --checkpoint: the config's
    scene_path and run directory name .../offline_demo, where the SLAM
    config writes .../offline_demo_0 (both packages read the same files).
    Its workdir is relative, so each package runs in a directory of its
    own. The same files; the frames decode within one level of the
    reference's (test_torch_viz.py's tolerance)."""
    ckpt = os.path.join(slam.output_dir, f"params{N_FRAMES - 1}.npz")
    cfg = os.path.join(ROOT, "configs", "iphone", "splatam_viz.py")
    roots = {}
    for name, mod, extra in (("jax", jfinal, []),
                             ("torch", final_recon, ["--device", "cpu"])):
        run = tmp_path / f"viz_{name}"
        run.mkdir()
        monkeypatch.chdir(run)
        mod.main([cfg, "--checkpoint", ckpt, "--every", "1",
                  "--downscale", "1"] + extra)
        roots[name] = str(run / "experiments" / "iPhone_Captures" /
                          "offline_demo" / "viz")
    tree = {name: sorted(os.path.relpath(os.path.join(d, f), root)
                         for d, _, files in os.walk(root) for f in files)
            for name, root in roots.items()}
    assert tree["torch"] == tree["jax"]
    frames = [f for f in tree["jax"] if f.startswith("replay_color/")]
    assert len(frames) == N_FRAMES
    for rel in frames:
        a = imread(os.path.join(roots["jax"], rel)).astype(int)
        b = imread(os.path.join(roots["torch"], rel)).astype(int)
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1, rel
