"""The port's remaining tools (contracts, drift_shapes, grad_check,
msssim_bias_check, profile_map, multichip_scaling) and its 25 ablation
configs, against the JAX package's tools and configs where they have a
counterpart, at toy sizes on the CPU."""
from __future__ import annotations

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from isogs_slam_tpu.tools import contracts as JC
from isogs_slam_tpu.tools import drift_shapes as JD
from isogs_slam_tpu_torch.tools import contracts as TC
from isogs_slam_tpu_torch.tools import drift_shapes as TD

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
ABL_J = os.path.join(ROOT, "isogs_slam_tpu", "configs", "synthetic",
                     "ablations")
ABL_T = os.path.join(ROOT, "isogs_slam_tpu_torch", "configs", "synthetic",
                     "ablations")


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _dirs():
    return sorted(glob.glob(os.path.join(ART, "r4s*"))
                  + glob.glob(os.path.join(ART, "r5s*")))


@pytest.mark.parametrize("argv", [
    ["--control", "silnorm"],
    ["--control", "silnorm", "--tiebreak", "long100sn:long100fs8",
     "--tiebreak-covers", "fastlegal8,msub8sn"]], ids=["plain", "tiebreak"])
def test_contracts_output_equals_reference(argv):
    """(g) contracts on the committed artifacts/r4s* and r5s* (26
    *_progress.txt runs): the JAX tool's stdout byte for byte, with and
    without the long-run tiebreak of artifacts/r5s2/contracts8.txt."""
    dirs = _dirs()
    assert len(glob.glob(os.path.join(ART, "r[45]s*",
                                      "*_progress.txt"))) == 26
    rj, oj = _stdout(JC.main, dirs + argv)
    rt, ot = _stdout(TC.main, dirs + argv)
    assert rj == rt == 0 and ot == oj and "verdict" in ot
    if "--tiebreak" in argv:
        assert "long100fs8 vs long100sn" in ot


@pytest.mark.parametrize("extra", [[], ["--every", "5"],
                                   ["--names", "long100sn_s0,nosuch"]],
                         ids=["default", "every5", "names"])
def test_drift_shapes_output_equals_reference(extra):
    """(g) drift_shapes on the same artifacts: the JAX tool's stdout."""
    rj, oj = _stdout(JD.main, _dirs() + extra)
    rt, ot = _stdout(TD.main, _dirs() + extra)
    assert rj == rt == 0 and ot == oj and ot.startswith(
        "(missing" if "--names" in extra else "ATE-so-far")


def test_grad_check_passes_with_the_reference_checks(capsys):
    """(h) grad_check on the CPU at n = 128: exit 0, the JAX tool's eight
    checks by name (the render checks carry the port's backward route,
    segreduce / scatter, where the JAX tool's carry its backend, xla /
    pallas-interpret)."""
    from isogs_slam_tpu_torch.tools import grad_check
    rc = grad_check.main(["--device", "cpu", "--n", "128", "--samples",
                          "24"])
    out = capsys.readouterr().out
    assert rc == 0, out
    names = [ln.split("] ", 1)[1].split(":")[0] for ln in out.splitlines()
             if ln.strip().startswith("[PASS]")]
    want = ["d flat / d log_scales", "d iso / d means",
            "d iso / d logit_opacities", "d iso / d log_scales"] + [
        f"d render / d {x} [{r}]" for r in ("segreduce", "scatter")
        for x in ("means_cam", "logit_opacities")]
    assert names == want
    assert "ALL PASS" in out


def _toy_run(root, name):
    """A run directory with params1.npz (the synthetic room's Gaussians,
    800 a wall) and its config (48x64 synthetic frames)."""
    from isogs_slam_tpu_torch.datasets.synthetic import make_room_gaussians
    from isogs_slam_tpu_torch.io.checkpoints import save_checkpoint
    pts, cols, quats, log_scales, logit_op = make_room_gaussians(
        np.random.default_rng(0), 800)
    cfg = dict(workdir=str(root), run_name=name, seed=0,
               primary_device="cpu",
               data=dict(dataset_name="synthetic", basedir="",
                         sequence="synthetic_room", desired_image_height=48,
                         desired_image_width=64, start=0, end=-1, stride=1,
                         num_frames=6),
               raster=dict(max_per_tile=1024))
    n = pts.shape[0]
    run = os.path.join(str(root), name)
    save_checkpoint(
        run, 1, {"means3D": pts, "rgb_colors": cols,
                 "unnorm_rotations": quats, "logit_opacities": logit_op,
                 "log_scales": log_scales},
        np.tile([[1.0], [0], [0], [0]], (1, 2)), np.zeros((3, 2)),
        np.zeros(n), np.eye(3), np.eye(4), 64, 48, [], [0])
    path = os.path.join(str(root), f"{name}.py")
    with open(path, "w") as f:
        f.write(f"config = {cfg!r}\n")
    return path, run


def test_msssim_bias_check_fixed_matches_reference(tmp_path, capsys):
    """(i) msssim_bias_check on a toy checkpoint: the fixed MS-SSIM of
    every frame within 1e-4 of the JAX tool's (the same renders, f32
    filters in both); on the CPU TF32 changes nothing, so legacy equals
    fixed; both flags are back as they were."""
    from isogs_slam_tpu.tools import msssim_bias_check as JB
    from isogs_slam_tpu_torch.tools import msssim_bias_check as TB
    cfg, run = _toy_run(tmp_path, "toy")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    out_t = TB.main(["--config", cfg, "--run", run, "--frames", "2",
                     "--device", "cpu"])
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    capsys.readouterr()
    JB.main(["--config", cfg, "--run", run, "--frames", "2"])
    out_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_t["frames"] == out_j["frames"]
    assert abs(out_t["fixed_mean"] - out_j["fixed_mean"]) < 1e-4
    assert 0.0 < out_t["fixed_mean"] <= 1.0
    assert out_t["bias_mean"] == 0.0


def test_msssim_bias_check_restores_flags_on_failure():
    """(i) The TF32 flags come back when the metric raises."""
    from isogs_slam_tpu_torch.tools import msssim_bias_check as TB
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with pytest.raises(Exception):
        TB.legacy_ms_ssim(torch.zeros(3, 4), torch.zeros(2, 4, 4))
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


def test_profile_map_one_tiny_phase(tmp_path, capsys):
    """(j) profile_map for one phase at 48x64 on the CPU: the top-ops
    table (by CPU time without a card) and the Chrome trace."""
    from isogs_slam_tpu_torch.tools import profile_map
    rows = profile_map.main(["--device", "cpu", "--h", "48", "--w", "64",
                             "--iters", "3", "--phases", "1", "--top", "5",
                             "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "1 phases x 3 iters" in out and "op time" in out
    assert 0 < len(rows) <= 5 and all(ms > 0 for _, ms, _ in rows)
    assert (tmp_path / "trace.json").stat().st_size > 1000


def test_multichip_scaling_environment(tmp_path):
    """(k) multichip_scaling at a tiny size with B in {1, 2} (two gloo
    ranks under torch.distributed.run): the JSON says it measures
    overhead, not speedup, on ranks that share one device, and carries
    the overhead columns and no speedup."""
    from isogs_slam_tpu_torch.tools import multichip_scaling
    out = tmp_path / "mc.json"
    rc = multichip_scaling.main([
        "--device", "cpu", "--ranks", "1,2", "--views", "2", "--n-gauss",
        "300", "--height", "32", "--width", "48", "--reps", "1",
        "--timeout", "150", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    env = res["environment"]
    assert env["measured"] == "overhead, not speedup"
    assert env["ranks_share_one_device"] is True
    assert env["backend"] == "gloo" and env["card"] is None
    modes = [(r["mode"], r["B"]) for r in res["rows"]]
    assert modes == [("serial_map_frame", 1), ("serial_track_frame", 1),
                     ("multiview_phase", 1), ("track_tiles", 1),
                     ("multiview_phase", 2), ("track_tiles", 2)]
    mv2 = res["rows"][4]
    assert mv2["backend"] == "gloo" and mv2["overhead_vs_Bx1"] > 0
    assert not any("speedup" in k for r in res["rows"] for k in r)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-3] for p in glob.glob(os.path.join(ABL_J,
                                                             "*.py"))))
def test_ablation_config_equals_reference(name):
    """(l) Each of the 25 ablation configs: the port's dict equals the JAX
    package's but for primary_device ("cuda" against "tpu"), and the
    port's config readers accept it."""
    from isogs_slam_tpu.slam.config import load_experiment_config as lj
    from isogs_slam_tpu_torch.slam import pipeline as P
    from isogs_slam_tpu_torch.slam.config import (inject_defaults,
                                                  load_experiment_config)
    ct = load_experiment_config(os.path.join(ABL_T, f"{name}.py"))
    cj = lj(os.path.join(ABL_J, f"{name}.py"))
    assert ct.pop("primary_device") == "cuda"
    assert cj.pop("primary_device") == "tpu"
    assert ct == cj
    cfg = inject_defaults(ct)
    P._tracking_cfg(cfg)
    P._mapping_cfg(cfg)
    P._loss_cfg_tracking(cfg)
    P._loss_cfg_mapping(cfg)
    assert len(glob.glob(os.path.join(ABL_T, "*.py"))) == 25
