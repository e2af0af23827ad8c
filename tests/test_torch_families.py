"""The shipped dataset families through the port against the JAX package
(part 1: TUM, ScanNet, ScanNet++ with its post-SLAM optimization and
novel-view evaluation; part 2 is test_torch_families_replica.py).

Each case writes the synthetic room in its family's on-disk layout with
chip_smoke.py's writer (the one the card's phases use; the config's own
camera YAML, TUM's distortion included), 4 frames at 48x64, and runs the
shipped config through the port's CLI (`scripts.splatam.main --device
cpu`) and the JAX package's SLAM on the same files. The only overrides
are data paths, sizes (the iso sample and the capacity granule among
them) and iteration counts:
each config's cadence and distinctive knobs (map_every, window, the
depth-loss threshold, outlier depth, ignore_bad, the densification size,
tile_subsample) stay as shipped. The device draws differ by construction
(jax.random against torch.Generator), so the tolerances are those of
test_torch_replica_bridge.py's shipped-config case: keyframe lists equal,
every camera translation within 2 cm, both ATEs under 8 cm."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from isogs_slam_tpu.scripts import eval_novel_view as JEV  # noqa: E402
from isogs_slam_tpu.scripts import post_splatam_opt as JPO  # noqa: E402
from isogs_slam_tpu.scripts.splatam import \
    apply_overrides as japply  # noqa: E402
from isogs_slam_tpu.slam.config import inject_defaults as jinject  # noqa
from isogs_slam_tpu.slam.config import \
    load_experiment_config as jload  # noqa: E402
from isogs_slam_tpu.slam.pipeline import SLAM as JSLAM  # noqa: E402
from isogs_slam_tpu.slam.pipeline import \
    _dataset_from_config as jdataset  # noqa: E402
from isogs_slam_tpu_torch.eval.eval_helpers import est_w2c  # noqa: E402
from isogs_slam_tpu_torch.eval.metrics import evaluate_ate  # noqa: E402
from isogs_slam_tpu_torch.scripts import eval_novel_view as EV  # noqa
from isogs_slam_tpu_torch.scripts import post_splatam_opt as PO  # noqa
from isogs_slam_tpu_torch.scripts import splatam  # noqa: E402
from isogs_slam_tpu_torch.slam.config import \
    load_experiment_config  # noqa: E402
from isogs_slam_tpu_torch.slam.pipeline import \
    _dataset_from_config  # noqa: E402

torch.set_num_threads(1)

H, W, N_FRAMES = 48, 64, 4
TRAJ_STEP = 0.012
N_PER_WALL = 400
# (config, layout, camera YAML, size overrides, environment): the
# families of chip_smoke.FAMILIES, and configs/replica/replica_eval.py
# with the scene and seed of the *_eval.py configs' environment contract
CASES = {tag: (cfg, layout, yml, [], {})
         for tag, cfg, layout, yml, _ in chip_smoke.FAMILIES}
# splatam_s densifies at half its tracking and mapping size
CASES["splatam_s"] = CASES["splatam_s"][:3] + (
    [f"data.densification_image_height={H // 2}",
     f"data.densification_image_width={W // 2}"], {})
CASES["replica_eval"] = ("configs/replica/replica_eval.py", "replica",
                         "configs/data/replica.yaml", [],
                         {"SCENE_NUM": "2", "SEED": "1"})
ITERS = ["tracking.num_iters=4", "mapping.num_iters=4",
         "isogs.sample_size=256", "isogs.k=8"]
# the map's row granule, a size the configs leave to the runtime default
# (65,536 rows, 20x what 48x64 frames need): set through the port's CLI,
# which takes a key of the defaults; the JAX CLI does not, so the JAX
# config gets it directly
GRANULE = 4096


def _sequence(cfg):
    return os.path.basename(str(cfg["data"]["sequence"]))


def family_overrides(case, data_root, monkeypatch):
    """Write case's tree under data_root; return (config path, "k=v"
    overrides of data paths, sizes and iteration counts)."""
    cfg_rel, layout, yml, extra, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg_path = os.path.join(ROOT, cfg_rel)
    sets = chip_smoke.write_family(
        layout, str(data_root), _sequence(load_experiment_config(cfg_path)),
        N_FRAMES, H, W, None if yml is None else os.path.join(ROOT, yml),
        device="cpu", traj_step=TRAJ_STEP, n_per_wall=N_PER_WALL)
    kv = [sets[i + 1] for i in range(0, len(sets), 2)]
    return cfg_path, kv + [f"data.desired_image_height={H}",
                           f"data.desired_image_width={W}", *extra]


def _cli_args(kv):
    return [a for s in kv for a in ("--set", s)]


def run_family(case, tmp_path, monkeypatch):
    """The port's CLI and the JAX package's SLAM on case's tree:
    (port SLAM, JAX SLAM)."""
    cfg_path, kv = family_overrides(case, tmp_path / "data", monkeypatch)
    kv = kv + ITERS
    slam = splatam.main([cfg_path, "--device", "cpu", *_cli_args(
        [f"workdir={tmp_path / 'torch'}", f"capacity_granule={GRANULE}"]
        + kv)])
    assert slam.granule == GRANULE
    jcfg = jload(cfg_path)
    japply(jcfg, [f"workdir={tmp_path / 'jax'}"] + kv)
    jcfg["capacity_granule"] = GRANULE
    jslam = JSLAM(jinject(jcfg))
    jslam.run()
    return slam, jslam


def check_family(slam, jslam):
    """The tolerances of the module docstring, and finite eval metrics."""
    assert type(slam.dataset).__name__ == type(jslam.dataset).__name__
    assert len(slam.dataset) == len(jslam.dataset)
    assert (slam.cam.width, slam.cam.height) == (W, H)
    assert slam.keyframe_time_indices == jslam.keyframe_time_indices
    assert np.isfinite(slam.cam_trans).all()
    dt = np.linalg.norm(slam.cam_trans - np.asarray(jslam.cam_trans), axis=0)
    assert dt.max() < 2e-2, dt
    res = slam.eval_results
    assert res["Final Average ATE RMSE (cm)"] < 8.0, res
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))
    est = [jslam.first_frame_w2c] + [est_w2c(jslam, i)
                                     for i in range(1, len(jslam.dataset))]
    assert 100 * evaluate_ate(jslam.gt_w2c_all, est) < 8.0


def check_nvs(got, ref, frames):
    """Novel-view metrics of the port's eval_novel_view CLI against the JAX
    one's on one map: the same frame count; PSNR, MS-SSIM and the depth
    errors within 1e-4 relative, LPIPS within 1e-6 absolute (its values
    are ~1e-4 here). The JAX CLI renders under jax.jit, and on the CPU
    that render differs from the JAX package's own eager one at alpha
    threshold pixels: on the ScanNet++ post-opt map below by up to 8.8e-3
    on 131 of 3,072 pixels at one view (measured), while the port's render
    is within 3e-7 of the eager one there. Those pixels move the metrics
    by up to 4.1e-5 (PSNR), 1.4e-5 (MS-SSIM) relative and 3e-8 (LPIPS)
    absolute (measured), past test_torch_offline.py's 1e-5 for a map
    without such pixels."""
    assert got["Frames"] == ref["Frames"] == frames
    assert got["LPIPS Variant"] == ref["LPIPS Variant"]
    for k in ("Average NVS PSNR", "Average NVS MS-SSIM",
              "Average NVS Depth RMSE (cm)", "Average NVS Depth L1 (cm)"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["Average NVS LPIPS"],
                               ref["Average NVS LPIPS"], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def runs():
    """{case: (port SLAM, its directory)} of this file's SLAM cases, kept
    for the offline test below."""
    return {}


@pytest.mark.parametrize("case,split", [
    (c, s) for c in CASES for s in ("train", "nvs")
    if s == "train" or CASES[c][1] in chip_smoke.NVS_LAYOUTS])
def test_family_dataset_matches_reference(tmp_path, monkeypatch, case,
                                          split):
    """Each family's tree through the config, pipeline._dataset_from_config
    of each package at 48x64: the same loader, length and frames (colour,
    depth, intrinsics, pose) exactly; the novel-view split
    (use_train_split=False) of the layouts that have one."""
    cfg_path, kv = family_overrides(case, tmp_path, monkeypatch)
    cfg = load_experiment_config(cfg_path)
    splatam.apply_overrides(cfg, kv + [
        f"data.use_train_split={split == 'train'}"])
    got = _dataset_from_config(cfg, H, W, "cpu")
    ref = jdataset(cfg, H, W)
    assert type(got).__name__ == type(ref).__name__
    # ScanNet++ skips its is_bad train entry; a novel-view split is the
    # first train frame and one held-out view between each two train views
    # of the written sequence (ScanNet++'s includes the is_bad entry's)
    n_test = N_FRAMES - 1 + (case == "scannetpp")
    assert len(got) == len(ref) == (N_FRAMES if split == "train"
                                    else 1 + n_test)
    for i in range(len(ref)):
        for a, b, what in zip(got[i], ref[i], ("color", "depth",
                                               "intrinsics", "pose")):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what} of frame {i}")


@pytest.mark.parametrize("case", ["tum", "scannet", "scannetpp"])
def test_family_slam_matches_reference(tmp_path_factory, monkeypatch, runs,
                                       case):
    """The shipped config of each family through the port's CLI against
    the JAX package's SLAM (module docstring), with its knobs as shipped:
    TUM (200 tracking iterations shipped, mapping every frame, window 20,
    the depth-loss threshold and outlier depth), ScanNet (window 10,
    outlier depth, crop_edge 8 in its YAML), ScanNet++ (ignore_bad: the
    flagged frame skipped, the depth-loss threshold)."""
    tmp = tmp_path_factory.mktemp(case)
    slam, jslam = run_family(case, tmp, monkeypatch)
    cfg = slam.config
    assert cfg["map_every"] == 1
    assert slam.lcfg_track.sil_thres == 0.99
    if case == "tum":
        assert slam.tcfg.use_depth_loss_thres
        assert slam.tcfg.depth_loss_thres == 20000
        assert slam.lcfg_track.ignore_outlier_depth_loss
        assert cfg["mapping_window_size"] == 20
        assert slam.dataset.distortion is not None
    elif case == "scannet":
        assert slam.lcfg_track.ignore_outlier_depth_loss
        assert cfg["mapping_window_size"] == 10
        assert slam.dataset.crop_edge == 8
    else:
        assert cfg["data"]["ignore_bad"] and slam.tcfg.use_depth_loss_thres
        assert len(slam.dataset) == N_FRAMES   # the is_bad entry skipped
    check_family(slam, jslam)
    runs[case] = (slam, tmp)


def test_scannetpp_postopt_and_nvs_match_reference(tmp_path_factory,
                                                   monkeypatch, runs):
    """configs/scannetpp/post_splatam_opt.py on the ScanNet++ run's map, then
    configs/scannetpp/eval_novel_view.py (use_train_split=False) on the
    result, with data paths, sizes and the iteration count overridden (the
    shipped post-opt config names the checkpoint as .../params.npz, a file
    neither package writes; both read the latest params<i>.npz of a
    directory, so the override names the run directory). Both packages'
    PostSLAMOpt seed the same rows, capacity, trajectory and scene radius
    (1e-5) from it; the port's CLI then optimizes (finite losses) and
    evaluates the SLAM run's poses against its own frame list. That list
    keeps the is_bad entry (the post-opt config sets ignore_bad=False where
    the SLAM config sets True), so from the flagged frame on each pose is
    held against the next frame's ground truth: the post-opt ATE is that of
    the SLAM poses against the first 4 of the 5 frames, within 1e-6 cm,
    as in the reference, which reads the same two configs. The novel-view
    metrics of its map are the JAX CLI's (check_nvs)."""
    if "scannetpp" not in runs:   # run alone: make the SLAM run first
        tmp = tmp_path_factory.mktemp("scannetpp")
        runs["scannetpp"] = (run_family("scannetpp", tmp, monkeypatch)[0],
                             tmp)
    slam, tmp = runs["scannetpp"]
    data = [f"data.basedir={tmp / 'data'}", f"data.desired_image_height={H}",
            f"data.desired_image_width={W}"]
    po_cfg = os.path.join(ROOT, "configs", "scannetpp", "post_splatam_opt.py")
    po_kv = data + [f"data.param_ckpt_path={slam.output_dir}",
                    f"workdir={tmp / 'post'}", "train.num_iters_mapping=8"]
    cfg = load_experiment_config(po_cfg)
    splatam.apply_overrides(cfg, po_kv)
    cfg["primary_device"] = "cpu"
    jcfg = jload(po_cfg)
    japply(jcfg, po_kv)
    t, j = PO.PostSLAMOpt(cfg), JPO.PostSLAMOpt(jcfg)
    assert t.num_frames == j.num_frames == N_FRAMES
    assert t.state.capacity == j.state.capacity
    np.testing.assert_allclose(float(t.state.scene_radius),
                               float(j.state.scene_radius), rtol=1e-5)
    np.testing.assert_array_equal(t.cam_rots, j.cam_rots)
    np.testing.assert_array_equal(t.cam_trans, j.cam_trans)
    n = int(t.state.hwm)
    assert n == int(j.state.hwm) == int(slam.state.num_alive())
    np.testing.assert_array_equal(t.state.params.means3d[:n].numpy(),
                                  np.asarray(j.state.params.means3d)[:n])
    del t, j

    post = PO.main([po_cfg, "--device", "cpu", *_cli_args(po_kv)])
    assert post.num_frames == N_FRAMES
    assert len(post.dataset) == N_FRAMES + 1      # the is_bad entry read
    assert np.isfinite(np.concatenate(post.stats["chunk_loss"])).all()
    gts = [np.linalg.inv(np.asarray(post.dataset[i][3], np.float64))
           for i in range(N_FRAMES)]
    est = [slam.first_frame_w2c] + [est_w2c(slam, i)
                                    for i in range(1, N_FRAMES)]
    np.testing.assert_allclose(
        post.eval_results["Final Average ATE RMSE (cm)"],
        100 * evaluate_ate(gts, est), atol=1e-6)
    ckpt = os.path.join(post.output_dir, f"params{N_FRAMES - 1}.npz")
    assert os.path.exists(ckpt)

    nvs_cfg = os.path.join(ROOT, "configs", "scannetpp", "eval_novel_view.py")
    nvs_kv = data + [f"workdir={tmp / 'nvs'}"]
    got = EV.main([nvs_cfg, "--device", "cpu", "--checkpoint", ckpt,
                   *_cli_args(nvs_kv)])
    jcfg = jload(nvs_cfg)
    japply(jcfg, [f"workdir={tmp / 'nvs_jax'}"] + nvs_kv[:-1])
    cfg_file = tmp / "nvs_jax.py"
    cfg_file.write_text(f"config = {jcfg!r}\n")
    ref = JEV.main([str(cfg_file), "--checkpoint", ckpt])
    # the held-out split: the first train frame (skipped) + N_FRAMES test
    # views (one beside each train frame, the is_bad entry's included)
    check_nvs(got, ref, N_FRAMES)
