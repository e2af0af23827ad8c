"""The port's shell drivers (isogs_slam_tpu_torch/bash_scripts/,
isogs_slam_tpu_torch/configs/*/*.bash) against the JAX package's, on the
CPU and at toy scale.

Each pair runs in two identical temporary roots with a recorder first on
PATH as `python` and `python3`: it logs each call's argv and the drivers'
env contract and exits 0, passing `-c` and `-` (heredoc) invocations
through to the real interpreter. The port's calls must equal the JAX
driver's with the module prefix mapped and `--device $DEVICE` appended to
the CLIs that read a shipped config's primary_device (cuda unless
DEVICE=cpu). The pure-host eval driver also runs for real in both
packages (byte-equal CSV and compare_expected output), and start_env.bash
runs the installation check on the CPU with the native build stubbed."""
import json
import os
import stat
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["room0", "room1", "room2", "office0", "office1", "office2",
          "office3", "office4"]
# the env contract of the drivers, recorded with each call
CONTRACT = ("END_AT", "GT_MESH_DIR", "SPLATAM_SCENE_INDEX", "SEED",
            "SCENE_NUM", "SCENE")
# the CLIs that read a shipped config's primary_device="tpu" and take
# --device: the port's drivers pass them --device $DEVICE
DEVICE_CLIS = ("scripts.splatam", "scripts.extract_mesh_fast",
               "scripts.eval_mesh_geometry", "scripts.iphone_demo",
               "scripts.eval_novel_view", "viz_scripts.final_recon")

RECORDER = """#!{python}
import json, os, sys
args = sys.argv[1:]
if args[:1] in (["-c"], ["-"]):
    os.execv({python!r}, [{python!r}] + args)
with open(os.environ["RECORDER_LOG"], "a") as f:
    f.write(json.dumps({{"argv": args, "env": {{
        k: os.environ[k] for k in {contract!r} if k in os.environ}}}}) + "\\n")
# a SLAM run of a Replica scene leaves the eval summary a real run writes
summary = os.environ.get("RECORDER_SUMMARY")
if summary and any(a.endswith(".scripts.splatam") for a in args):
    scene = {scenes!r}[int(os.environ.get("SPLATAM_SCENE_INDEX", "0"))]
    out = os.path.join("experiments", "Replica", scene + "_0", "eval")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "eval_summary.json"), "w") as f:
        f.write(summary)
"""


def _root(path):
    """A temporary root laid out as the repository: configs/, both
    packages and bash_scripts/ linked in."""
    path.mkdir()
    for name in ("configs", "bash_scripts", "isogs_slam_tpu",
                 "isogs_slam_tpu_torch"):
        (path / name).symlink_to(os.path.join(ROOT, name))
    return path


def _recorder(bin_dir):
    bin_dir.mkdir()
    text = RECORDER.format(python=sys.executable, contract=CONTRACT,
                           scenes=SCENES)
    for name in ("python", "python3"):
        p = bin_dir / name
        p.write_text(text)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return bin_dir


def _run(root, script, args, env, bin_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k not in CONTRACT + ("DEVICE",)} | env
    env["GIT_CEILING_DIRECTORIES"] = str(root.parent)
    # the drivers' `python` is this interpreter (or the recorder before it)
    env["PATH"] = os.pathsep.join(
        ([str(bin_dir)] if bin_dir is not None else [])
        + [os.path.dirname(sys.executable), env.get("PATH", "")])
    if bin_dir is not None:
        env["RECORDER_LOG"] = str(root / "calls.jsonl")
    out = subprocess.run(["bash", script, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    log = root / "calls.jsonl"
    calls = ([json.loads(ln) for ln in log.read_text().splitlines()]
             if log.exists() else [])
    return out, calls


def _expected(jax_calls, device):
    """The JAX driver's calls as the port must make them."""
    out = []
    for c in jax_calls:
        argv = [a.replace("isogs_slam_tpu.", "isogs_slam_tpu_torch.")
                if a.startswith("isogs_slam_tpu.") else a for a in c["argv"]]
        module = argv[argv.index("-m") + 1]
        if module.endswith(DEVICE_CLIS):
            argv += ["--device", device]
        out.append({"argv": argv, "env": c["env"]})
    return out


def _replica_data(root, scenes=("room0",)):
    for s in scenes:
        d = root / "data" / "Replica" / s / "results"
        d.mkdir(parents=True)
        (d / "frame000000.jpg").write_bytes(b"")
        (d.parent / "traj.txt").write_text("")


def _gt_meshes(root, scenes):
    (root / "gt").mkdir()
    for s in scenes:
        (root / "gt" / f"{s}.ply").write_text("ply\n")


def _summaries(root, values):
    for scene, d in values.items():
        p = root / "experiments" / "Replica" / f"{scene}_0" / "eval"
        p.mkdir(parents=True)
        (p / "eval_summary.json").write_text(json.dumps(d))


SUMMARY = {"Final Average ATE RMSE (cm)": 0.52, "Average PSNR": 33.1,
           "Average Depth L1 (cm)": 0.6, "Average MS-SSIM": 0.97,
           "Average LPIPS": 0.08}

# (case, JAX driver, its arguments, env, setup of the root, calls):
# each driver of the JAX package that names a module, with the inputs that
# take each branch
CASES = [
    ("all_scenes", "bash_scripts/run_replica_all_scenes.sh", [],
     {"END_AT": "5"}, None, 24),
    ("all_scenes_default_end", "bash_scripts/run_replica_all_scenes.sh", [],
     {}, None, 24),
    ("eval_all", "bash_scripts/run_replica_eval_all.sh", [], {},
     lambda r: _summaries(r, {"room0": SUMMARY, "office2": SUMMARY}), 1),
    ("eval_all_empty", "bash_scripts/run_replica_eval_all.sh",
     ["eval.csv"], {}, None, 0),
    ("mesh_eval", "bash_scripts/run_replica_mesh_eval_all.sh", [],
     {"GT_MESH_DIR": "./gt"},
     lambda r: _gt_meshes(r, ("room1", "office0", "office4")), 3),
    ("mesh_eval_default_dir", "bash_scripts/run_replica_mesh_eval_all.sh",
     [], {}, None, 0),
    ("room0_found", "bash_scripts/replica_room0_if_present.sh",
     ["5", "artifacts/realdata"], {"RECORDER_SUMMARY": json.dumps(SUMMARY)},
     _replica_data, 2),
    ("room0_no_summary", "bash_scripts/replica_room0_if_present.sh", [], {},
     _replica_data, 1),
    ("room0_skipped", "bash_scripts/replica_room0_if_present.sh", ["5"], {},
     None, 0),
    ("online_demo", "bash_scripts/online_demo.bash", [],
     {"CAPTURE_DIR": "/tmp/capture_x"}, None, 1),
    ("nerfcapture2dataset", "bash_scripts/nerfcapture2dataset.bash",
     ["configs/iphone/nerfcapture.py"], {}, None, 1),
    ("nerfcapture2dataset_no_config",
     "bash_scripts/nerfcapture2dataset.bash", ["configs/none.py"], {}, None,
     0),
    ("nerfcapture", "bash_scripts/nerfcapture.bash",
     ["configs/iphone/nerfcapture.py"], {}, None, 3),
    ("replica_sweep", "configs/replica/replica.bash", [], {}, None, 24),
    ("scannet_sweep", "configs/scannet/scannet.bash", [], {}, None, 18),
    ("tum_sweep", "configs/tum/tum.bash", [], {}, None, 15),
    ("scannetpp_sweep", "configs/scannetpp/scannetpp.bash", [], {}, None, 2),
    ("scannetpp_nvs", "configs/scannetpp/eval_novel_view.bash", ["1"], {},
     None, 1),
]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_driver_calls_match_jax_driver(tmp_path, case, device):
    """The port driver's recorded calls (argv and env contract), standard
    output and exit code equal the JAX driver's, with the module prefix
    mapped and --device added to the config-reading CLIs; the device is
    the card unless DEVICE=cpu."""
    _, script, args, env, setup, n_calls = case
    if device == "cpu":
        env = dict(env, DEVICE="cpu")
    results = []
    for tag, path in (("jax", script),
                      ("port", os.path.join("isogs_slam_tpu_torch",
                                            script))):
        root = _root(tmp_path / tag)
        if setup is not None:
            setup(root)
        out, calls = _run(root, path, args, env,
                          _recorder(tmp_path / f"bin_{tag}"))
        results.append((out, calls, root))
    (jout, jcalls, jroot), (pout, pcalls, proot) = results
    assert len(jcalls) == n_calls, jout.stderr
    assert pcalls == _expected(jcalls, device), pout.stderr
    assert (pout.returncode, pout.stdout) == (jout.returncode, jout.stdout)
    for sub in ("artifacts", "experiments"):
        jfiles = sorted(str(p.relative_to(jroot))
                        for p in (jroot / sub).rglob("*"))
        assert sorted(str(p.relative_to(proot))
                      for p in (proot / sub).rglob("*")) == jfiles
    if case[0] == "room0_found":
        assert (proot / "artifacts" / "realdata"
                / "room0_eval_summary.json").read_text() == env[
                    "RECORDER_SUMMARY"]
        # the root is no repository: the driver's commit lands nowhere
        assert subprocess.run(
            ["git", "rev-parse", "--git-dir"], cwd=proot,
            env=dict(os.environ, GIT_CEILING_DIRECTORIES=str(tmp_path)),
            capture_output=True).returncode != 0


def test_eval_all_real_run_matches_jax(tmp_path):
    """run_replica_eval_all.sh of both packages with the real interpreter
    on fabricated summaries of three scenes (one inside expected_metrics'
    bands, two outside): byte-equal CSVs, byte-equal output (the CSV, then
    compare_expected's table) and the same exit code."""
    far = dict(SUMMARY, **{"Final Average ATE RMSE (cm)": 4.0,
                           "Average PSNR": 21.5})
    values = {"room0": SUMMARY, "office1": far,
              "office3": {"Average PSNR": 30.0}}
    outs = []
    for tag, script in (("jax", "bash_scripts/run_replica_eval_all.sh"),
                        ("port", "isogs_slam_tpu_torch/bash_scripts/"
                                 "run_replica_eval_all.sh")):
        root = _root(tmp_path / tag)
        _summaries(root, values)
        out, _ = _run(root, script, [], {})
        csv = (root / "experiments" / "Replica" / "eval_all.csv").read_bytes()
        outs.append((out.returncode, out.stdout, csv))
    assert outs[1] == outs[0]
    rc, stdout, csv = outs[0]
    assert len(csv.decode().splitlines()) == 4
    assert "room0" in stdout and rc != 0


def _start_env_root(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    for name in ("configs", "isogs_slam_tpu_torch"):
        (root / name).symlink_to(os.path.join(ROOT, name))
    # the native build stubbed: no compiler is assumed here
    native = root / "native"
    native.mkdir()
    build = native / "build.sh"
    build.write_text("#!/bin/bash\necho native build stubbed\n"
                     "touch \"$(dirname \"$0\")/built\"\n")
    build.chmod(0o755)
    return root


def test_start_env_cpu(tmp_path):
    """DEVICE=cpu: torch's version and card availability printed, no card
    queried and no kernel built, the (stubbed) native build run from the
    root two levels above the script, and the installation check run for
    real on the CPU: exit 0."""
    root = _start_env_root(tmp_path)
    out, _ = _run(root, "isogs_slam_tpu_torch/bash_scripts/start_env.bash",
                  [], {"DEVICE": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"torch {torch.__version__} cuda available False" in out.stdout
    assert (root / "native" / "built").exists()
    assert "device cpu" in out.stdout and "All checks passed." in out.stdout
    assert out.stdout.rstrip().endswith("environment ready")
    assert "CUDA kernels" not in out.stdout


def test_start_env_records_installation_check(tmp_path):
    """Under the recorder, DEVICE=cpu: the one module call is
    test_installation --device cpu."""
    root = _start_env_root(tmp_path)
    out, calls = _run(root,
                      "isogs_slam_tpu_torch/bash_scripts/start_env.bash",
                      [], {"DEVICE": "cpu"}, _recorder(tmp_path / "bin"))
    assert out.returncode == 0, out.stderr
    assert [c["argv"] for c in calls] == [
        ["-m", "isogs_slam_tpu_torch.scripts.test_installation", "--device",
         "cpu"]]


def test_start_env_without_card_fails(tmp_path):
    """Without DEVICE the card is asked for: with none, exit non-zero before
    the native build and the installation check (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card branch cannot run")
    root = _start_env_root(tmp_path)
    out, calls = _run(root,
                      "isogs_slam_tpu_torch/bash_scripts/start_env.bash",
                      [], {}, _recorder(tmp_path / "bin"))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert calls == [] and not (root / "native" / "built").exists()
