"""The viewers in the port: ops/sh.py and viz_scripts/{common, final_recon,
online_recon}.py against the JAX package's, on the toy checkpoint of
tests/test_viz.py, on the CPU."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.ops import sh as jsh
from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from isogs_slam_tpu.viz_scripts import common as jcommon
from isogs_slam_tpu.viz_scripts import final_recon as jfinal
from isogs_slam_tpu_torch.io.images import imread
from isogs_slam_tpu_torch.ops import sh
from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
from isogs_slam_tpu_torch.viz_scripts import common, final_recon, \
    online_recon
from test_viz import H, W, _toy_checkpoint

torch.set_num_threads(1)


def _sh_inputs(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 48)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, 3).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_reference(deg):
    """eval_sh, sh_colors_for_pose and rgb_to_sh0 within 1e-6 of the JAX
    functions on the same random coefficients and directions (a zero
    direction included)."""
    shf, dirs, means, center, rgb = _sh_inputs()
    dirs[0] = 0.0
    got = sh.eval_sh(torch.as_tensor(shf), torch.as_tensor(dirs), deg)
    want = jsh.eval_sh(jnp.asarray(shf), jnp.asarray(dirs), deg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    got = sh.sh_colors_for_pose(torch.as_tensor(shf),
                                torch.as_tensor(means),
                                torch.as_tensor(center), deg)
    want = jsh.sh_colors_for_pose(jnp.asarray(shf), jnp.asarray(means),
                                  jnp.asarray(center), deg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sh.rgb_to_sh0(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh0(jnp.asarray(rgb))),
                               rtol=0, atol=1e-6)


def _with_sh(ckpt_path, seed=0):
    """Give the checkpoint random higher-band SH coefficients in place."""
    data = dict(np.load(ckpt_path))
    rng = np.random.default_rng(seed)
    shf = data["sh_coeffs_flat"].copy()
    shf[:, 3:] = 0.3 * rng.normal(size=shf[:, 3:].shape)
    data["sh_coeffs_flat"] = shf.astype(np.float32)
    np.savez(ckpt_path, **data)


@pytest.fixture
def run_dir(tmp_path):
    d = str(tmp_path / "Synthetic" / "toy_0")
    _toy_checkpoint(d)
    return d


@pytest.mark.parametrize("with_sh", [False, True])
def test_load_scene_and_render_match_reference(run_dir, with_sh):
    """load_scene gives the JAX one's map rows, camera, poses and SH
    padding; render_w2c at every estimated pose and one off-trajectory
    pose gives the JAX image, depth and silhouette within 1e-5 (the
    rasterizer's image tolerance), with and without higher SH bands."""
    if with_sh:
        _with_sh(os.path.join(run_dir, "params2.npz"))
    st, cam, est, gt, path, shf = common.load_scene(run_dir, return_sh=True,
                                                    device="cpu")
    jst, jcam, jest, jgt, jpath, jshf = jcommon.load_scene(run_dir,
                                                           return_sh=True)
    assert path == jpath and cam == common.Camera(**vars(jcam))
    assert st.capacity == jst.params.means3d.shape[0]
    assert int(st.hwm) == int(jst.hwm)
    for f in st.params._fields:
        np.testing.assert_array_equal(getattr(st.params, f).numpy(),
                                      np.asarray(getattr(jst.params, f)))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gt, jgt)
    assert (shf is None) == (jshf is None) == (not with_sh)
    if with_sh:
        np.testing.assert_array_equal(shf.numpy(), np.asarray(jshf))

    fn = common.make_render_fn(cam, RasterConfig(max_per_tile=256,
                                                 tile_chunk=16))
    jfn = jcommon.make_render_fn(jcam, JRasterConfig(max_per_tile=256,
                                                     tile_chunk=16))
    off = est[1].copy()
    off[:3, 3] += [0.05, -0.03, 0.02]
    for w2c in list(est) + [off]:
        got = common.render_w2c(fn, st, w2c, sh_flat=shf)
        want = jcommon.render_w2c(jfn, jst, w2c, sh_flat=jshf)
        for g, w in zip(got, want):
            assert g.shape == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
        assert float(got[0].max()) > 0.01


def test_frame_converters_byte_equal():
    """colorize_depth (the port's own turbo table against matplotlib's)
    and frame_to_uint8 give the JAX helpers' bytes."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(-0.5, 6.0, (37, 41))
    depth[0, 0] = np.nan
    for args in ((), (1.0, 3.0), (None, 2.0)):
        np.testing.assert_array_equal(common.colorize_depth(depth, *args),
                                      jcommon.colorize_depth(depth, *args))
    np.testing.assert_array_equal(
        common.colorize_depth(torch.zeros(5, 6)),
        jcommon.colorize_depth(np.zeros((5, 6))))
    im = rng.uniform(-0.2, 1.2, (3, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(common.frame_to_uint8(torch.as_tensor(im)),
                                  jcommon.frame_to_uint8(im))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("mode", ["color", "depth"])
def test_final_recon_cli_matches_reference(tmp_path, mode):
    """The final_recon CLI (--every 2, --downscale 1, a 3-frame orbit) of
    each package on its own copy of the toy run writes the same files, and
    its frames decode within one level of the reference's (a pixel on a
    truncation step of the uint8 conversion)."""
    roots = {}
    for name, mod, extra in (("jax", jfinal, []),
                             ("torch", final_recon, ["--device", "cpu"])):
        work = tmp_path / name
        _toy_checkpoint(str(work / "toy_0"))
        cfg = tmp_path / f"{name}.py"
        cfg.write_text(f"config = {{'workdir': {str(work)!r}, "
                       f"'run_name': 'toy_0'}}\n")
        mod.main([str(cfg), "--every", "2", "--downscale", "1",
                  "--orbit-frames", "3", "--mode", mode] + extra)
        roots[name] = str(work / "toy_0" / "viz")
    files = _tree(roots["jax"])
    assert _tree(roots["torch"]) == files
    assert f"replay_{mode}/00000.png" in files and "trajectory.png" in files
    for rel in files:
        if rel.endswith(".png") and rel != "trajectory.png":
            a = imread(os.path.join(roots["jax"], rel)).astype(int)
            b = imread(os.path.join(roots["torch"], rel)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


def test_online_recon_renders_each_new_checkpoint(tmp_path, capsys):
    """online_recon renders the newest checkpoint at its newest pose (the
    reference's frame), skips a checkpoint still being written (a
    truncated file), and stops after --max-wait idle seconds."""
    work = tmp_path / "run"
    run = str(work / "toy_0")
    _toy_checkpoint(run)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"config = {{'workdir': {str(work)!r}, "
                   f"'run_name': 'toy_0'}}\n")
    frames = online_recon.main([str(cfg), "--poll", "0.01", "--max-wait",
                                "0.05", "--downscale", "1", "--device",
                                "cpu"])
    assert len(frames) == 1 and frames[0].shape == (H, W, 3)
    st, cam, est, _, _ = jcommon.load_scene(run)
    jfn = jcommon.make_render_fn(cam, JRasterConfig(max_per_tile=512,
                                                    tile_chunk=256))
    want = jcommon.frame_to_uint8(jcommon.render_w2c(jfn, st, est[2])[0])
    assert np.abs(frames[0].astype(int) - want.astype(int)).max() <= 1
    assert os.path.exists(os.path.join(run, "viz", "online_replay",
                                       "00000.png"))
    with open(os.path.join(run, "params9.npz"), "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    frames = online_recon.main([str(cfg), "--poll", "0.01", "--max-wait",
                                "0.05", "--device", "cpu"])
    assert frames == [] and "skipping" in capsys.readouterr().out
