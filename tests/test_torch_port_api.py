"""The port's entry surface against the JAX package: every shipped config
loads through the port's loader to the JAX loader's dict, the public
functions the JAX package exports have counterparts of the same names and
semantics (on a seeded input), the multi-device meshes run on the card
unless the caller asks for the CPU, and the port's copy of the iPhone
trainer config loads without the JAX package."""
import glob
import gzip
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import camera as JC
from isogs_slam_tpu.core import optim as JO
from isogs_slam_tpu.ops import ssim as JS
from isogs_slam_tpu.slam import mapping as JM
from isogs_slam_tpu.slam.config import inject_defaults as jinject
from isogs_slam_tpu.slam.config import load_experiment_config as jload
from isogs_slam_tpu.tools import profile_map as JPM
from isogs_slam_tpu.utils import common as JCO
from isogs_slam_tpu.utils import transforms as JT
from isogs_slam_tpu_torch.core import camera as C
from isogs_slam_tpu_torch.core import optim as O
from isogs_slam_tpu_torch.ops import ssim as S
from isogs_slam_tpu_torch.parallel.dist import make_mesh
from isogs_slam_tpu_torch.parallel.gauss_sharded import make_gauss_mesh
from isogs_slam_tpu_torch.parallel.tile_sharded import make_tile_mesh
from isogs_slam_tpu_torch.slam import mapping as M
from isogs_slam_tpu_torch.slam.config import (inject_defaults,
                                              load_experiment_config)
from isogs_slam_tpu_torch.tools import profile_map as PM
from isogs_slam_tpu_torch.utils import common as CO
from isogs_slam_tpu_torch.utils import transforms as T

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py"))
    if not p.endswith("_splatam_base.py"))
# shipped configs the port reads through a copy of its own: the root file
# imports the JAX package's config loader
PORT_COPIES = {"configs/iphone/gaussian_splatting.py":
               "isogs_slam_tpu_torch/configs/iphone/gaussian_splatting.py"}


def test_every_shipped_config_is_listed():
    """The parametrisation below covers the 31 configs under configs/."""
    assert len(SHIPPED) == 31


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_config_loads_as_reference(path):
    """The port's load_experiment_config + inject_defaults gives the JAX
    loader's dict, key for key (a config that imports the JAX loader is
    read through the port's copy)."""
    ref = jinject(jload(os.path.join(ROOT, path)))
    got = inject_defaults(load_experiment_config(
        os.path.join(ROOT, PORT_COPIES.get(path, path))))
    assert got == ref


def test_iphone_trainer_config_copy_imports_no_jax():
    """The port's copy of configs/iphone/gaussian_splatting.py loads through
    the port's loader, and through the SLAM CLI's config path, without
    importing the JAX package or JAX (a fresh interpreter)."""
    code = (
        "import sys\n"
        "from isogs_slam_tpu_torch.scripts import splatam\n"
        "c = splatam.load_experiment_config("
        f"{PORT_COPIES['configs/iphone/gaussian_splatting.py']!r})\n"
        "assert c['data']['dataset_name'] == 'nerfcapture', c['data']\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.split('.')[0] == 'isogs_slam_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("maker", [make_mesh, make_tile_mesh,
                                   make_gauss_mesh])
def test_meshes_need_a_card_unless_cpu_is_asked(maker):
    """The mesh makers run on the card by default, as every entry point of
    the port does: without one they raise (resolve_device) instead of
    carrying on on the CPU; "cpu" is taken when asked for."""
    assert maker(1, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert maker(1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            maker(1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            maker()


def _rng():
    return np.random.default_rng(12)


def _setup_camera():
    k = np.array([[300.0, 0, 63.5], [0, 310.0, 47.5], [0, 0, 1]])
    for kk in (k, torch.tensor(k)):
        got = C.setup_camera(128, 96, kk, w2c=np.eye(4), near=0.02, far=50.0)
        ref = JC.setup_camera(128, 96, k, w2c=np.eye(4), near=0.02,
                              far=50.0)
        for f in ("width", "height", "fx", "fy", "cx", "cy", "near", "far"):
            assert getattr(got, f) == getattr(ref, f), f


def _adam_states(lazy):
    rng = _rng()
    shapes = ((40, 3), (40, 1), (40, 4))
    mu = [rng.normal(size=s).astype(np.float32) for s in shapes]
    nu = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    rc = ([rng.integers(0, 9, (40, 1)).astype(np.int32) for _ in shapes]
          if lazy else None)
    got = O.AdamState(mu=tuple(map(torch.tensor, mu)),
                      nu=tuple(map(torch.tensor, nu)), count=7,
                      rcount=None if rc is None
                      else tuple(map(torch.tensor, rc)))
    ref = JO.AdamState(mu=tuple(map(jnp.asarray, mu)),
                       nu=tuple(map(jnp.asarray, nu)),
                       count=jnp.asarray(7, jnp.int32),
                       rcount=None if rc is None
                       else tuple(map(jnp.asarray, rc)))
    return got, ref


def _same_state(got, ref):
    assert int(got.count) == int(ref.count)
    for a, b in zip(got.mu + got.nu, ref.mu + ref.nu):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got.rcount is None) == (ref.rcount is None)
    for a, b in zip(got.rcount or (), ref.rcount or ()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _mask_rows():
    keep = _rng().permutation(40)[:25]
    for lazy in (False, True):
        got, ref = _adam_states(lazy)
        _same_state(O.mask_rows(got, torch.tensor(keep)),
                    JO.mask_rows(ref, jnp.asarray(keep)))


def _zero_rows():
    rows = _rng().uniform(size=40) < 0.3
    for lazy in (False, True):
        got, ref = _adam_states(lazy)
        _same_state(O.zero_rows(got, torch.tensor(rows)),
                    JO.zero_rows(ref, jnp.asarray(rows)))


def _ssim():
    """1e-5 absolute, the tolerance ms_ssim is held to."""
    rng = _rng()
    a = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = float(S.ssim(torch.tensor(a), torch.tensor(b)))
    ref = float(JS.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) <= 1e-5, (got, ref)
    assert S.calc_ssim is S.ssim


def _estimated_pose():
    rng = _rng()
    rots = rng.normal(size=(4, 6)).astype(np.float32)
    trans = rng.normal(size=(3, 6)).astype(np.float32)
    for t in (0, 3, 5):
        q, tr = M.estimated_pose(torch.tensor(rots), torch.tensor(trans), t)
        jq, jtr = JM.estimated_pose(jnp.asarray(rots), jnp.asarray(trans), t)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))


def _params2cpu():
    rng = _rng()
    p = {"means3D": rng.normal(size=(9, 3)).astype(np.float32),
         "logit_opacities": rng.normal(size=(9, 1)).astype(np.float32)}
    got = CO.params2cpu({k: torch.tensor(v) for k, v in p.items()})
    ref = JCO.params2cpu({k: jnp.asarray(v) for k, v in p.items()})
    assert got.keys() == ref.keys()
    for k in ref:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], ref[k])


def _relative_transformation():
    """Rigid poses, batched: 1e-6 of the reference (its inverse is R^T, the
    port's a general inverse, as the dataset layer's)."""
    from scipy.spatial.transform import Rotation
    rng = _rng()
    t = np.tile(np.eye(4), (2, 5, 1, 1))
    t[..., :3, :3] = Rotation.random(10, random_state=3).as_matrix(
    ).reshape(2, 5, 3, 3)
    t[..., :3, 3] = rng.normal(size=(2, 5, 3))
    t = t.astype(np.float32)
    got = T.relative_transformation(torch.tensor(t[0]), torch.tensor(t[1]))
    ref = JT.relative_transformation(jnp.asarray(t[0]), jnp.asarray(t[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose((torch.tensor(t[0]) @ got).numpy(), t[1],
                               atol=1e-5)


def _parse_trace(tmp_path, capsys):
    """A trace whose device time each package's profiler would record: the
    JAX tool reads the TPU's XLA-op lane of a jax.profiler trace.json.gz,
    the port's the CUDA kernel lanes of a torch.profiler trace.json. The
    same op durations give the same printed table."""
    rng = _rng()
    names = ["fusion.1", "composite_fwd", "segreduce", "copy"]
    ops = [(names[i % 4], float(rng.integers(5, 500)))
           for i in range(23)]
    jax_ev = [{"ph": "M", "name": "process_name", "pid": 7,
               "args": {"name": "/device:TPU:0"}},
              {"ph": "M", "name": "thread_name", "pid": 7, "tid": 2,
               "args": {"name": "XLA Ops"}},
              {"ph": "X", "pid": 1, "tid": 1, "name": "host", "dur": 9e3}]
    jax_ev += [{"ph": "X", "pid": 7, "tid": 2, "name": n, "dur": d}
               for n, d in ops]
    torch_ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::add",
                 "dur": 9e3}]
    torch_ev += [{"ph": "X", "cat": "kernel" if i % 3 else "gpu_memcpy",
                  "name": n, "dur": d} for i, (n, d) in enumerate(ops)]
    jdir, tdir = tmp_path / "j" / "plugins", tmp_path / "t"
    jdir.mkdir(parents=True)
    tdir.mkdir()
    with gzip.open(jdir / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": jax_ev}, f)
    (tdir / "trace.json").write_text(json.dumps({"traceEvents": torch_ev}))
    JPM.parse_trace(str(tmp_path / "j"), top=3)
    ref = capsys.readouterr().out.splitlines()
    by_op = PM.parse_trace(str(tdir), top=3)
    got = capsys.readouterr().out.splitlines()
    assert ref[-3:] == got[-3:] and len(got) == len(ref) == 5
    total = lambda lines: lines[1].split("(total ")[1].split(" ms")[0]
    assert total(got) == total(ref)
    assert by_op == pytest.approx({n: sum(d for m, d in ops if m == n) / 1e3
                                   for n in names}, rel=1e-12)
    assert PM.parse_trace(str(tmp_path / "none")) is None


PUBLIC = {"core/camera.py::setup_camera": _setup_camera,
          "core/optim.py::mask_rows": _mask_rows,
          "core/optim.py::zero_rows": _zero_rows,
          "ops/ssim.py::ssim": _ssim,
          "slam/mapping.py::estimated_pose": _estimated_pose,
          "utils/common.py::params2cpu": _params2cpu,
          "utils/transforms.py::relative_transformation":
              _relative_transformation}


@pytest.mark.parametrize("name", list(PUBLIC))
def test_public_function_matches_reference(name):
    """The port's function of the JAX package's name, on a seeded input:
    equal results (tolerances at each check)."""
    PUBLIC[name]()


def test_parse_trace_matches_reference(tmp_path, capsys):
    """tools/profile_map.py::parse_trace (docstring of _parse_trace)."""
    _parse_trace(tmp_path, capsys)


def test_relative_transformation_is_the_datasets():
    """datasets/base.py normalizes poses with utils/transforms.py's function
    (no copy of its own), in float64."""
    from isogs_slam_tpu_torch.datasets import base
    assert base.relative_transformation is T.relative_transformation


def test_cli_sets_keys_the_config_leaves_to_its_defaults():
    """The SLAM CLI's --set takes a key that only the runtime defaults
    define (raster.*, capacity_granule), on a shipped config that does not
    name it; a default derived from another key (the densification and
    tracking sizes from the image size) follows that key's override; a key
    that neither defines is refused."""
    from isogs_slam_tpu_torch.scripts.splatam import apply_overrides
    cfg = load_experiment_config(os.path.join(ROOT, "configs", "iphone",
                                              "splatam.py"))
    assert "raster" not in cfg and "capacity_granule" not in cfg
    apply_overrides(cfg, ["capacity_granule=4096", "raster.max_per_tile=768",
                          "data.desired_image_height=48",
                          "data.desired_image_width=64"],
                    defaults=inject_defaults)
    cfg = inject_defaults(cfg)
    assert cfg["capacity_granule"] == 4096
    assert cfg["raster"] == dict(max_per_tile=768, isect_per_gaussian=4.0,
                                 tile_chunk=256)
    assert (cfg["data"]["densification_image_height"],
            cfg["data"]["tracking_image_width"]) == (48, 64)
    for bad in ("raster.bogus=1", "bogus.max_per_tile=1", "capacity=1"):
        with pytest.raises(SystemExit, match="no such config"):
            apply_overrides(cfg, [bad], defaults=inject_defaults)
    raw = load_experiment_config(os.path.join(ROOT, "configs", "iphone",
                                              "splatam.py"))
    with pytest.raises(SystemExit, match="no such config"):
        apply_overrides(raw, ["capacity_granule=4096"])


# the shipped offline configs, each on a 4-frame tree of its family's
# layout at 48x64: (config, layout, runner, size overrides). Replica's
# post-opt trains on every 20th of 100 frames, cut to the tree's 4
OFFLINE_CONFIGS = {
    "replica/gaussian_splatting.py": (
        "replica", "OfflineGS", ["data.desired_image_height_init=24",
                                 "data.desired_image_width_init=32"]),
    "scannetpp/gaussian_splatting.py": (
        "scannetpp", "OfflineGS", ["data.desired_image_height_init=48",
                                   "data.desired_image_width_init=64"]),
    "replica/post_splatam_opt.py": (
        "replica", "PostSLAMOpt", ["data.stride=1", "data.num_frames=4"]),
    "iphone/post_splatam_opt.py": ("nerfcapture", "PostSLAMOpt", []),
}


@pytest.mark.parametrize("name", list(OFFLINE_CONFIGS))
def test_offline_config_runner_matches_reference(tmp_path, name):
    """Each shipped offline config (the trainer's and the post-opt ones;
    ScanNet++'s post-opt runs in test_torch_families.py) through each
    package's runner on its family's tree, with data paths, sizes and frame
    counts overridden (and a 6-frame SLAM checkpoint of random rows for
    the post-opt ones): the same loader and frame counts, cameras, raster
    and optimizer settings exactly, ground-truth or checkpoint poses
    within 1e-6 (the port's quaternions from a float32 matrix; exact for
    the checkpoint's), and a post-opt map of the checkpoint's rows."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    from isogs_slam_tpu.scripts import gaussian_splatting as JGS
    from isogs_slam_tpu.scripts import post_splatam_opt as JPO
    from isogs_slam_tpu.scripts.splatam import apply_overrides as japply
    from isogs_slam_tpu_torch.scripts import gaussian_splatting as GS
    from isogs_slam_tpu_torch.scripts import post_splatam_opt as PO
    from isogs_slam_tpu_torch.scripts.splatam import apply_overrides
    layout, runner, sizes = OFFLINE_CONFIGS[name]
    path = os.path.join(ROOT, "configs", name)
    cfg = load_experiment_config(path)
    yml = {"replica": os.path.join(ROOT, "configs", "data", "replica.yaml")
           }.get(layout)
    sets = chip_smoke.write_family(
        layout, str(tmp_path / "data"),
        os.path.basename(str(cfg["data"]["sequence"])), 4, 48, 64, yml,
        device="cpu", traj_step=0.012, n_per_wall=400)
    kv = [sets[i + 1] for i in range(0, len(sets), 2)] + sizes + [
        "data.desired_image_height=48", "data.desired_image_width=64",
        f"workdir={tmp_path / 'out'}"]
    if runner == "PostSLAMOpt":
        rng = np.random.default_rng(3)
        n, frames = 700, 6
        rots = rng.normal(size=(1, 4, frames)).astype(np.float32)
        ckpt = tmp_path / "slam"
        ckpt.mkdir()
        np.savez(ckpt / f"params{frames - 1}.npz",
                 means3D=rng.normal(size=(n, 3)).astype(np.float32),
                 rgb_colors=rng.uniform(size=(n, 3)).astype(np.float32),
                 unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
                 logit_opacities=rng.normal(size=(n, 1)).astype(np.float32),
                 log_scales=np.full((n, 3), -3.0, np.float32),
                 cam_unnorm_rots=rots,
                 cam_trans=rng.normal(size=(1, 3, frames)).astype(np.float32))
        kv.append(f"data.param_ckpt_path={ckpt}")
    apply_overrides(cfg, kv)
    cfg["primary_device"] = "cpu"
    jcfg = jload(path)
    japply(jcfg, kv)
    got = getattr(PO if runner == "PostSLAMOpt" else GS, runner)(cfg)
    ref = getattr(JPO if runner == "PostSLAMOpt" else JGS, runner)(jcfg)
    assert type(got.dataset).__name__ == type(ref.dataset).__name__
    assert len(got.dataset) == len(ref.dataset)
    assert got.num_frames == ref.num_frames == (
        5 if layout == "scannetpp" else 4)   # ignore_bad=False: all 5 read
    for c, jc in ((got.cam, ref.cam), (got.init_cam, ref.init_cam)):
        assert (c.width, c.height, c.fx, c.fy, c.cx, c.cy) == (
            jc.width, jc.height, jc.fx, jc.fy, jc.cx, jc.cy)
    assert (got.rcfg.max_per_tile, got.rcfg.isect_per_gaussian) == (
        ref.rcfg.max_per_tile, ref.rcfg.isect_per_gaussian)
    assert tuple(got.ocfg._replace(densify=None)) == tuple(
        ref.ocfg._replace(densify=None))
    assert tuple(got.ocfg.densify) == tuple(ref.ocfg.densify)
    assert got.sil_thres == ref.sil_thres
    np.testing.assert_allclose(got.cam_rots, ref.cam_rots, atol=1e-6)
    np.testing.assert_allclose(got.cam_trans, ref.cam_trans, atol=1e-6)
    if runner == "PostSLAMOpt":
        assert got.state.capacity == ref.state.capacity
        np.testing.assert_array_equal(
            got.state.params.means3d[:n].numpy(),
            np.asarray(ref.state.params.means3d)[:n])
        np.testing.assert_allclose(float(got.state.scene_radius),
                                   float(ref.state.scene_radius), rtol=1e-5)
