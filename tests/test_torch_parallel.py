"""The port's multi-device paths (isogs_slam_tpu_torch/parallel/,
mesh/density.py::density_grid_sharded, the pipeline's map_views /
track_tiles wiring) against the JAX package's shard_map programs.

The port's side runs as two gloo ranks on the CPU: this file is also the
ranks' program (`python tests/test_torch_parallel.py <case> <dir>`, with
torch.distributed.run's environment). Inputs and outputs cross through
the test's tmp_path as .npz files; every spawn has a time limit of its own
whose expiry kills the ranks and fails the test. The JAX side runs in this
process on the conftest's virtual CPU devices (make_mesh(2)). The rank
program imports nothing of JAX.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from isogs_slam_tpu_torch.core.camera import Camera  # noqa: E402
from isogs_slam_tpu_torch.core.gaussians import GaussianParams  # noqa: E402
from isogs_slam_tpu_torch.parallel import dist as pdist  # noqa: E402

torch.set_num_threads(1)

# per-spawn time limits (seconds): the ranks are killed and the test fails
# when one is exceeded
SPAWN_TIMEOUT = 120
PIPELINE_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(case: str, tmp, world: int = 2, timeout: float = SPAWN_TIMEOUT):
    """Run `case` on `world` gloo ranks; fail on a non-zero exit or when
    the ranks outlive `timeout` (they are killed first)."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=str(tmp)))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{case}: the ranks did not finish within {timeout} s")
    rcs = [p.returncode for p in procs]
    if any(rcs):
        pytest.fail(f"{case}: rank exit codes {rcs}\n" + "\n".join(
            o[-4000:] for o in outs))
    return outs


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ rank cases
def _rank_map_step(tmp):
    from isogs_slam_tpu_torch.core import optim
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    from isogs_slam_tpu_torch.parallel.sharded import (
        make_mesh, make_sharded_map_step, replicate, shard_view_batch)
    from isogs_slam_tpu_torch.slam.losses import LossConfig
    from isogs_slam_tpu_torch.slam.mapping import MappingConfig, PruneConfig
    z = np.load(os.path.join(tmp, "in.npz"))
    mesh = make_mesh(2, "cpu")
    params = replicate(mesh, GaussianParams(*[_t(z[k]) for k in
                                              GaussianParams._fields]))
    alive = _t(z["alive"])
    cam = Camera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)
    rcfg = RasterConfig(max_per_tile=256, tile_chunk=12,
                        grad_scatter_bf16=False)
    lcfg = LossConfig(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
                      use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                      w_depth=1.0, w_flat=50.0, w_iso=0.0, calc_iso=False)
    mcfg = MappingConfig(
        num_iters=1, lr_means3d=1e-4, lr_rgb_colors=2.5e-3,
        lr_unnorm_rotations=1e-3, lr_logit_opacities=0.05,
        lr_log_scales=1e-3,
        prune=PruneConfig(False, 0, 0, 20, 20, .005, .005, False, 500))
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    batch = shard_view_batch(mesh, _t(z["quats"]), _t(z["trans"]),
                             _t(z["ims"]), _t(z["depths"]), gens)
    step = make_sharded_map_step(mesh, cam, rcfg, lcfg, mcfg)
    new, opt, loss = step(params, alive, optim.init(params), *batch)
    np.savez(os.path.join(tmp, f"out{mesh.rank}.npz"), loss=_np(loss),
             **{f"p_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                  new)},
             # first Adam step: mu = (1 - b1) g
             **{f"g_{k}": _np(m) / 0.1 for k, m in zip(
                 GaussianParams._fields, opt.mu)})


# the multiview phase case: 4 steps of 2 views over a window of 3 keyframe
# slots (every slot rendered, so the reference's window-wide bin_stats and
# the port's distinct-slot ones count the same slots); the opacity prune
# fires at view counts 0 and 2, the big-Gaussian prune at 2, the opacity
# reset at 4 and 6 (a multiple of 3 in [4, 6) and in [6, 8))
MV_STEP_SLOTS = np.array([[0, 1], [2, 0], [1, 2], [0, 2]])
MV_PRUNE = (True, 0, 2, 20, 2, 0.005, 0.005, True, 3)


def _mv_cfgs(mod_r, mod_l, mod_m, **rkw):
    """The multiview case's (raster, loss, mapping) configs from a
    package's modules: the same fields for the JAX package and the port."""
    rcfg = mod_r.RasterConfig(max_per_tile=256, tile_chunk=12,
                              grad_scatter_bf16=False, **rkw)
    lcfg = mod_l.LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0, w_flat=50.0,
        w_iso=0.0, calc_iso=False)
    mcfg = mod_m.MappingConfig(
        num_iters=8, lr_means3d=1e-4, lr_rgb_colors=2.5e-3,
        lr_unnorm_rotations=1e-3, lr_logit_opacities=0.05,
        lr_log_scales=1e-3, prune=mod_m.PruneConfig(*MV_PRUNE))
    return rcfg, lcfg, mcfg


def _rank_mv_phase(tmp):
    from isogs_slam_tpu_torch.core.gaussians import MapState
    from isogs_slam_tpu_torch.ops import rasterize
    from isogs_slam_tpu_torch.parallel.sharded import (
        make_mesh, make_multiview_map_phase)
    from isogs_slam_tpu_torch.slam import losses, mapping
    z = np.load(os.path.join(tmp, "in.npz"))
    mesh = make_mesh(2, "cpu")
    cam = Camera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)
    phase = make_multiview_map_phase(
        mesh, cam, *_mv_cfgs(rasterize, losses, mapping))
    st = MapState(
        params=GaussianParams(*[_t(z[k]) for k in GaussianParams._fields]),
        **{k: _t(z[k]) for k in MapState._fields if k != "params"})
    st = st._replace(hwm=st.hwm.to(torch.int64))
    new, log, stats = phase(st, _t(z["colors"]), _t(z["depths"]),
                            _t(z["quats"]), _t(z["trans"]), MV_STEP_SLOTS,
                            seed=0)
    np.savez(os.path.join(tmp, f"out{mesh.rank}.npz"),
             **{f"p_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                  new.params)},
             alive=_np(new.alive), max_r=_np(new.max_2d_radius),
             log=_np(log), stats=_np(stats),
             **{f"mu_{k}": _np(m) for k, m in zip(GaussianParams._fields,
                                                  phase.last_opt.mu)})


def _rank_render(tmp):
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    from isogs_slam_tpu_torch.parallel.tile_sharded import (
        make_tile_mesh, render_tiles_sharded)
    z = np.load(os.path.join(tmp, "in.npz"))
    mesh = make_tile_mesh(2, "cpu")
    cam = Camera(width=128, height=96, fx=96., fy=96., cx=63.5, cy=47.5)
    cfg = RasterConfig(max_per_tile=512, tile_chunk=12,
                       grad_scatter_bf16=False)
    args = [_t(z[k]).requires_grad_(True)
            for k in ("means", "quats", "logs", "ops")]
    m = args[0]
    f = torch.cat([_t(z["rgb"]), m[:, 2:3]], dim=-1)
    img, ft = render_tiles_sharded(mesh, args[0], args[1], args[2], args[3],
                                   f, _t(z["alive"]), cam, cfg)
    grads = torch.autograd.grad(torch.sum(img ** 2), args)
    np.savez(os.path.join(tmp, f"out{mesh.rank}.npz"), img=_np(img),
             ft=_np(ft), **{f"g{i}": _np(g) for i, g in enumerate(grads)})


def _track_cfgs():
    from isogs_slam_tpu_torch.ops.rasterize import RasterConfig
    from isogs_slam_tpu_torch.slam.losses import LossConfig
    from isogs_slam_tpu_torch.slam.tracking import TrackingConfig
    rcfg = RasterConfig(grad_scatter_bf16=False, isect_per_gaussian=12.0)
    lcfg = LossConfig(tracking=True, use_sil_for_loss=True, sil_thres=0.5,
                      use_l1=True, ignore_outlier_depth_loss=False,
                      w_im=0.5, w_depth=1.0, calc_iso=False)
    tcfg = TrackingConfig(num_iters=8, lr_quat=0.002, lr_trans=0.01,
                          lr_decay=0.95)
    return rcfg, lcfg, tcfg


TRACK_H, TRACK_W = 48, 64


def _track_cam():
    K = np.array([[60.0, 0, TRACK_W / 2], [0, 60.0, TRACK_H / 2],
                  [0, 0, 1]])
    return Camera.from_intrinsics(K, TRACK_W, TRACK_H)


def _rank_track(tmp):
    from isogs_slam_tpu_torch.parallel.track_sharded import (
        make_tile_mesh, make_tracking_frame_sharded)
    z = np.load(os.path.join(tmp, "in.npz"))
    rcfg, lcfg, tcfg = _track_cfgs()
    mesh = make_tile_mesh(2, "cpu")
    fn = make_tracking_frame_sharded(mesh, _track_cam(), rcfg, lcfg, tcfg)
    params = GaussianParams(*[_t(z[k]) for k in GaussianParams._fields])
    res = fn(params, _t(z["alive"]), _t(z["q0"]), _t(z["t0"]),
             _t(z["gt_im"]), _t(z["gt_d"]))
    np.savez(os.path.join(tmp, f"out{mesh.rank}.npz"), quat=_np(res.quat),
             trans=_np(res.trans), log=_np(res.loss_log),
             iters=res.iters_run)


def _rank_gauss(tmp):
    from isogs_slam_tpu_torch.parallel.gauss_sharded import (
        iso_density_gauss_sharded, make_gauss_mesh)
    z = np.load(os.path.join(tmp, "in.npz"))
    mesh = make_gauss_mesh(2, "cpu")
    m = _t(z["means"]).requires_grad_(True)
    o = _t(z["ops"]).requires_grad_(True)
    d = iso_density_gauss_sharded(mesh, _t(z["queries"]), m, _t(z["quats"]),
                                  _t(z["logs"]), o, _t(z["alive"]), 16)
    gm, go = torch.autograd.grad(torch.sum(d ** 2), (m, o))
    np.savez(os.path.join(tmp, f"out{mesh.rank}.npz"), d=_np(d),
             gm=_np(gm), go=_np(go))


def _rank_density(tmp):
    from isogs_slam_tpu_torch.mesh.density import compute_density
    z = np.load(os.path.join(tmp, "in.npz"))
    info = {}
    dens, spec = compute_density(dict(z), voxel_size=0.08, padding=0.3,
                                 shard_devices=2, device="cpu", info=info)
    np.savez(os.path.join(tmp, f"out{pdist.world_rank()}.npz"), dens=dens,
             shards=info["shard_devices"])


def _pipeline_config(workdir, name, **par):
    from isogs_slam_tpu_torch.slam.config import inject_defaults
    cfg = inject_defaults(dict(
        workdir=str(workdir), run_name=name, seed=0, primary_device="cpu",
        map_every=3, keyframe_every=3, mapping_window_size=5, eval_every=2,
        scene_radius_depth_ratio=3, mean_sq_dist_method="projective",
        gaussian_distribution="isotropic", load_checkpoint=False,
        checkpoint_time_idx=0, save_checkpoints=True,
        checkpoint_interval=5, use_wandb=False, compact_every=50,
        capacity_granule=8192, report_global_progress_every=2,
        eval_online_save_qual=False,
        raster=dict(max_per_tile=1024, isect_per_gaussian=6.0,
                    tile_chunk=20),
        isogs=dict(sample_size=512, k=8, target_saturation=1.0,
                   knn_pool_size=2048),
        data=dict(dataset_name="synthetic", basedir="", sequence="t",
                  desired_image_height=64, desired_image_width=80, start=0,
                  end=-1, stride=1, num_frames=5, prefetch_depth=0),
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=6,
            use_sil_for_loss=True, sil_thres=0.90, use_l1=True,
            ignore_outlier_depth_loss=False, reuse_binning=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.002, cam_trans=0.01)),
        mapping=dict(
            num_iters=8, add_new_gaussians=True, sil_thres=0.5,
            use_l1=True, use_sil_for_loss=False,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0, flat=50.0, iso=2.0),
            lrs=dict(means3D=0.0001, rgb_colors=0.0025,
                     unnorm_rotations=0.001, logit_opacities=0.05,
                     log_scales=0.001),
            prune_gaussians=True,
            pruning_dict=dict(start_after=0, remove_big_after=0,
                              stop_after=20, prune_every=20,
                              removal_opacity_threshold=0.005,
                              final_removal_opacity_threshold=0.005,
                              reset_opacities=False,
                              reset_opacities_every=500),
            use_gaussian_splatting_densification=False)))
    cfg["parallel"].update(par)
    return cfg


def _rank_pipeline(tmp):
    from isogs_slam_tpu_torch.eval.eval_helpers import eval_sequence
    from isogs_slam_tpu_torch.slam.pipeline import SLAM
    r = pdist.world_rank()
    # the tile-sharded tracker after the serial mapping of frame 0: the
    # first tracked frame against the serial run
    a = SLAM(_pipeline_config(os.path.join(tmp, "a"), "a", track_tiles=2))
    a.run(end_at=1)
    np.save(os.path.join(tmp, f"a_trans{r}.npy"), a.cam_trans)
    # both knobs; each rank its own workdir (rank 0 alone may write)
    b = SLAM(_pipeline_config(os.path.join(tmp, f"b{r}"), "b",
                              map_views=2, track_tiles=2))
    b.run()
    res = {}
    if b.is_main:
        res = eval_sequence(b.dataset, b, b.eval_dir, sil_thres=0.5,
                            mapping_iters=8, add_new_gaussians=True,
                            eval_every=2, make_plots=False)
    st = b.state
    np.savez(os.path.join(tmp, f"b{r}.npz"),
             **{f"p_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                  st.params)},
             alive=_np(st.alive), max_r=_np(st.max_2d_radius),
             rots=b.cam_rots, trans=b.cam_trans, kq=_np(b.kf.quats),
             **{f"mu{i}": _np(m) for i, m in enumerate(
                 b._mv_phase.last_opt.mu)},
             replica=b.stats["replica_max_abs_diff"],
             psnr=res.get("Average PSNR", np.nan),
             l1=res.get("Average Depth L1 (cm)", np.nan),
             ate=res.get("Final Average ATE RMSE (cm)", np.nan),
             n_phases=len(b.stats["mapping_frame_time"]))


RANK_CASES = {"map_step": _rank_map_step, "mv_phase": _rank_mv_phase,
              "render": _rank_render,
              "track": _rank_track, "gauss": _rank_gauss,
              "density": _rank_density, "pipeline": _rank_pipeline}


# ------------------------------------------------------------------ tests
def _load(tmp, world=2, prefix="out"):
    return [np.load(os.path.join(tmp, f"{prefix}{r}.npz"))
            for r in range(world)]


def test_sharded_map_step_matches_reference(tmp_path):
    """(a) make_sharded_map_step on two ranks against the JAX package's on
    make_mesh(2) and its single-device batched_map_loss: loss within 1e-5
    relative, gradients within 1e-4 of their max (the reference's own
    contract, tests/test_parallel_and_resume.py:52-82), updated parameters
    within 1e-6; both ranks hold the same parameters bit for bit. The iso
    term's draws differ by construction, so it is off (w_iso 0)."""
    import jax
    import jax.numpy as jnp
    from isogs_slam_tpu.core import optim as jopt
    from isogs_slam_tpu.core.camera import Camera as JCamera
    from isogs_slam_tpu.core.gaussians import (append_rows, empty_state,
                                               new_gaussian_rows)
    from isogs_slam_tpu.ops.rasterize import RasterConfig as JR
    from isogs_slam_tpu.parallel.sharded import (
        batched_map_loss, make_mesh, make_sharded_map_step, replicate,
        shard_view_batch)
    from isogs_slam_tpu.slam.losses import LossConfig as JL
    from isogs_slam_tpu.slam.mapping import (MappingConfig as JM,
                                             PruneConfig as JP)
    rng = np.random.default_rng(0)
    n, B = 1200, 2
    st = empty_state(2048)
    pts = (rng.uniform(-1, 1, (n, 3)).astype(np.float32)
           + np.array([0, 0, 2.5], np.float32))
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = append_rows(st, new_gaussian_rows(jnp.asarray(pts),
                                           jnp.asarray(cols),
                                           jnp.full((n,), 4e-4)),
                     jnp.ones(n, bool), 0)
    cam = JCamera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)
    rcfg = JR(max_per_tile=256, tile_chunk=12, backend="xla",
              grad_scatter_bf16=False)
    lcfg = JL(tracking=False, use_sil_for_loss=False, sil_thres=0.5,
              use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
              w_depth=1.0, w_flat=50.0, w_iso=0.0, calc_iso=False)
    mcfg = JM(num_iters=1, lr_means3d=1e-4, lr_rgb_colors=2.5e-3,
              lr_unnorm_rotations=1e-3, lr_logit_opacities=0.05,
              lr_log_scales=1e-3,
              prune=JP(False, 0, 0, 20, 20, .005, .005, False, 500))
    batch = (jnp.tile(jnp.array([1., 0, 0, 0]), (B, 1)),
             jnp.asarray(rng.normal(0, 0.01, (B, 3)).astype(np.float32)),
             jnp.asarray(rng.uniform(0, 1, (B, 3, 48, 64)).astype(
                 np.float32)),
             jnp.asarray(rng.uniform(1, 4, (B, 1, 48, 64)).astype(
                 np.float32)),
             jax.random.split(jax.random.PRNGKey(0), B))
    loss_ref, g_ref = jax.value_and_grad(batched_map_loss)(
        st.params, st.alive, *batch, cam, rcfg, lcfg)
    mesh = make_mesh(2)
    params, alive = replicate(mesh, (st.params, st.alive))
    step = make_sharded_map_step(mesh, cam, rcfg, lcfg, mcfg)
    new_j, _, loss_j = step(params, alive, replicate(mesh,
                                                     jopt.init(params)),
                            *shard_view_batch(mesh, *batch))
    names = GaussianParams._fields
    np.savez(tmp_path / "in.npz", alive=np.asarray(st.alive),
             quats=np.asarray(batch[0]), trans=np.asarray(batch[1]),
             ims=np.asarray(batch[2]), depths=np.asarray(batch[3]),
             **{k: np.asarray(v) for k, v in zip(names, st.params)})
    _spawn("map_step", tmp_path)
    o0, o1 = _load(tmp_path)
    for k in names:
        np.testing.assert_array_equal(o0[f"p_{k}"], o1[f"p_{k}"])
    assert abs(float(o0["loss"]) - float(loss_ref)) / float(loss_ref) < 1e-5
    assert abs(float(loss_j) - float(loss_ref)) / float(loss_ref) < 1e-5
    for k, g in zip(names, g_ref):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert float(np.abs(o0[f"g_{k}"] - g).max()) < 1e-4 * scale + 1e-8
        np.testing.assert_allclose(o0[f"p_{k}"], np.asarray(
            getattr(new_j, k)), rtol=0, atol=1e-6)


def test_multiview_map_phase_matches_reference(tmp_path):
    """(a) The pipeline's view-parallel mapping phase (MultiviewMapPhase,
    what map_views > 1 runs) on two ranks against the JAX package's
    make_multiview_map_phase on make_mesh(2), from the same map, keyframe
    window and step schedule: 4 Adam steps of 2 views, in which the
    opacity prune, the big-Gaussian prune and the opacity reset (with its
    moment zeroing) each fire on the cumulative view count. The loss log
    within 1e-5 relative (test (a)'s loss tolerance), the parameters within
    1e-6 (test (a)'s one-step tolerance) but for at most 0.1% of the
    elements, which stay within 1e-3 of the learning rate (below), alive,
    max_2D_radius and bin_stats exactly; both ranks hold the same state
    and Adam moments bit for bit. The iso
    term's draws differ by construction, so it is off (the flat term, which
    both evaluate once per step, is on)."""
    import jax
    import jax.numpy as jnp
    from isogs_slam_tpu.core.camera import Camera as JCamera
    from isogs_slam_tpu.core.gaussians import (append_rows, empty_state,
                                               new_gaussian_rows)
    from isogs_slam_tpu.ops import rasterize as jr
    from isogs_slam_tpu.parallel.sharded import (make_mesh,
                                                 make_multiview_map_phase)
    from isogs_slam_tpu.slam import losses as jl
    from isogs_slam_tpu.slam import mapping as jm
    rng = np.random.default_rng(3)
    n, S, B = 1200, 3, 2
    pts = (rng.uniform(-1, 1, (n, 3)).astype(np.float32)
           + np.array([0, 0, 2.5], np.float32))
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = append_rows(empty_state(2048),
                     new_gaussian_rows(jnp.asarray(pts), jnp.asarray(cols),
                                       jnp.full((n,), 4e-4)),
                     jnp.ones(n, bool), 0)
    # anisotropic, rotated Gaussians (an isotropic one's rotation gradient
    # is rounding noise, which Adam's first steps scale up to +-lr); rows
    # the opacity prune removes at once, rows the big-Gaussian prune removes
    # from view count 2 on (0.1 * scene_radius = 0.2)
    op = rng.normal(0.5, 1.0, (2048, 1)).astype(np.float32)
    op[:100] = -7.0
    ls = np.log(rng.uniform(0.01, 0.04, (2048, 3))).astype(np.float32)
    ls[100:140, 0] = np.log(0.3)
    rot = rng.normal(0, 1, (2048, 4)).astype(np.float32)
    st = st._replace(params=st.params._replace(
        logit_opacities=jnp.asarray(op), log_scales=jnp.asarray(ls),
        unnorm_rotations=jnp.asarray(rot)), scene_radius=jnp.float32(2.0))
    quats = np.tile(np.array([1., 0, 0, 0], np.float32), (S, 1))
    quats[:, 1:] = rng.normal(0, 0.01, (S, 3))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    trans = rng.normal(0, 0.02, (S, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (S, 48, 64, 3), dtype=np.uint8)
    depths = rng.uniform(1, 4, (S, 48, 64)).astype(np.float32)
    cam = JCamera(width=64, height=48, fx=48., fy=48., cx=31.5, cy=23.5)
    phase = make_multiview_map_phase(make_mesh(2), cam,
                                     *_mv_cfgs(jr, jl, jm, backend="xla"))
    keys = jax.random.split(jax.random.PRNGKey(0), 4 * B).reshape(4, B, -1)
    names = GaussianParams._fields
    host = {k: np.asarray(v) for k, v in zip(names, st.params)}
    host.update({k: np.asarray(getattr(st, k)) for k in st._fields
                 if k != "params"})
    new_j, log_j, stats_j = phase(
        st, jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(quats),
        jnp.asarray(trans), jnp.asarray(MV_STEP_SLOTS, jnp.int32), keys)
    np.savez(tmp_path / "in.npz", colors=colors, depths=depths, quats=quats,
             trans=trans, **host)
    _spawn("mv_phase", tmp_path)
    o0, o1 = _load(tmp_path)
    for k in o0.files:
        np.testing.assert_array_equal(o0[k], o1[k], err_msg=k)
    alive_j = np.asarray(new_j.alive)
    # the schedule fired: both prunes removed rows, the reset moved every
    # live opacity to log(0.01 / 0.99) at the last step
    assert not alive_j[:140].any() and alive_j[140:n].all()
    live_op = np.asarray(new_j.params.logit_opacities)[alive_j]
    assert np.abs(live_op - np.log(0.01 / 0.99)).max() < 0.2
    np.testing.assert_array_equal(o0["alive"], alive_j)
    np.testing.assert_array_equal(o0["stats"], np.asarray(stats_j))
    np.testing.assert_array_equal(o0["max_r"],
                                  np.asarray(new_j.max_2d_radius))
    log_j = np.asarray(log_j)
    np.testing.assert_allclose(o0["log"], log_j, rtol=1e-5, atol=1e-7)
    # Adam divides by the root of the second moment, so an element whose
    # gradient sits near rounding level moves up to lr a step on the
    # rounding of either package: all but 0.1% of the elements within 1e-6,
    # those within 1e-3 of the group's learning rate
    lrs = (1e-4, 2.5e-3, 1e-3, 0.05, 1e-3)
    for k, lr in zip(names, lrs):
        d = np.abs(o0[f"p_{k}"] - np.asarray(getattr(new_j.params, k)))
        assert float((d > 1e-6).mean()) <= 1e-3, k
        assert float(d.max()) <= max(1e-6, 1e-3 * lr), (k, float(d.max()))


def test_render_tiles_sharded_matches_reference(tmp_path):
    """(b) render_tiles_sharded on two ranks against the JAX function on
    make_tile_mesh(2): image within 1e-5 of its max (the depth channel
    reaches 4), final_T within 1e-5, gradients
    of sum(image^2) within 1e-4 of their max; the ranks agree bit for
    bit. K = 512 holds every tile's candidates; the features are (r, g, b,
    z), the kernels' four (the JAX test also composites 1 and z^2)."""
    import jax
    import jax.numpy as jnp
    from isogs_slam_tpu.core.camera import Camera as JCamera
    from isogs_slam_tpu.ops.rasterize import RasterConfig as JR
    from isogs_slam_tpu.parallel.tile_sharded import (make_tile_mesh,
                                                      render_tiles_sharded)
    rng = np.random.default_rng(0)
    n = 2000
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    logs = np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(np.float32)
    ops = rng.uniform(-2, 3, (n, 1)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-100:] = False
    cam = JCamera(width=128, height=96, fx=96., fy=96., cx=63.5, cy=47.5)
    cfg = JR(max_per_tile=512, tile_chunk=12, backend="xla",
             grad_scatter_bf16=False)
    mesh = make_tile_mesh(2)

    def loss(m, q, s, o):
        f = jnp.concatenate([jnp.asarray(rgb), m[:, 2:3]], -1)
        img, ft = render_tiles_sharded(mesh, m, q, s, o, f,
                                       jnp.asarray(alive), cam, cfg)
        return jnp.sum(img ** 2), (img, ft)

    (_, (img_j, ft_j)), g_j = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in (means, quats, logs, ops)])
    np.savez(tmp_path / "in.npz", means=means, quats=quats, logs=logs,
             ops=ops, rgb=rgb, alive=alive)
    _spawn("render", tmp_path)
    o0, o1 = _load(tmp_path)
    for k in o0.files:
        np.testing.assert_array_equal(o0[k], o1[k])
    img_j = np.asarray(img_j)
    assert float(np.abs(o0["img"] - img_j).max()) < 1e-5 * float(
        np.abs(img_j).max())
    assert float(np.abs(o0["ft"] - np.asarray(ft_j)).max()) < 1e-5
    for i, g in enumerate(g_j):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert float(np.abs(o0[f"g{i}"] - g).max()) < 1e-4 * scale + 1e-7


def _track_scene(seed=0, n=400):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.2, 3.0, n)], axis=1).astype(np.float32)
    params = dict(
        means3d=pts,
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=(rng.normal(size=(n, 4))
                          + np.array([2.0, 0, 0, 0])).astype(np.float32),
        logit_opacities=rng.normal(2.0, 0.5, (n, 1)).astype(np.float32),
        log_scales=np.full((n, 3), np.log(0.06), np.float32))
    alive = np.ones(n, bool)
    alive[-20:] = False
    return params, alive


def test_tile_sharded_tracking_matches_reference(tmp_path):
    """(c) make_tracking_frame_sharded on two ranks against the JAX
    package's on make_tile_mesh(2): the same iterations, quat and trans
    within 5e-4, the loss log within 1e-3 relative (the reference's own
    contract, tests/test_track_sharded.py:78-85); both ranks return the
    same pose bit for bit."""
    import jax.numpy as jnp
    from isogs_slam_tpu.core.camera import Camera as JCamera
    from isogs_slam_tpu.core.gaussians import GaussianParams as JP
    from isogs_slam_tpu.ops.rasterize import RasterConfig as JR
    from isogs_slam_tpu.ops.rasterize import render_rgbd_sil
    from isogs_slam_tpu.parallel.track_sharded import (
        make_tile_mesh, make_tracking_frame_sharded)
    from isogs_slam_tpu.slam.losses import LossConfig as JL
    from isogs_slam_tpu.slam.tracking import TrackingConfig as JT
    from isogs_slam_tpu.utils.transforms import transform_to_frame
    params, alive = _track_scene()
    K = np.array([[60.0, 0, TRACK_W / 2], [0, 60.0, TRACK_H / 2],
                  [0, 0, 1]])
    cam = JCamera.from_intrinsics(K, TRACK_W, TRACK_H)
    rcfg = JR(backend="xla", grad_scatter_bf16=False,
              isect_per_gaussian=12.0)
    lcfg = JL(tracking=True, use_sil_for_loss=True, sil_thres=0.5,
              use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
              w_depth=1.0, calc_iso=False)
    tcfg = JT(num_iters=8, lr_quat=0.002, lr_trans=0.01, lr_decay=0.95)
    jp = JP(**{k: jnp.asarray(v) for k, v in params.items()})
    ja = jnp.asarray(alive)
    mc, qc = transform_to_frame(jp.means3d, jp.unnorm_rotations,
                                jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3),
                                False, False)
    gt_im, gt_d, _, _, _ = render_rgbd_sil(
        mc, qc, jp.log_scales, jp.logit_opacities, jp.rgb_colors, ja, cam,
        rcfg)
    q0 = np.array([1.0, 0.004, -0.003, 0.002], np.float32)
    t0 = np.array([0.02, -0.015, 0.01], np.float32)
    fn = make_tracking_frame_sharded(make_tile_mesh(2), cam, rcfg, lcfg,
                                     tcfg)
    res_j = fn(jp, ja, jnp.asarray(q0), jnp.asarray(t0), gt_im, gt_d)
    np.savez(tmp_path / "in.npz", alive=alive, q0=q0, t0=t0,
             gt_im=np.asarray(gt_im), gt_d=np.asarray(gt_d), **params)
    _spawn("track", tmp_path)
    o0, o1 = _load(tmp_path)
    for k in ("quat", "trans", "log"):
        np.testing.assert_array_equal(o0[k], o1[k])
    assert int(o0["iters"]) == int(res_j.iters_run)
    np.testing.assert_allclose(o0["quat"], np.asarray(res_j.quat),
                               atol=5e-4)
    np.testing.assert_allclose(o0["trans"], np.asarray(res_j.trans),
                               atol=5e-4)
    lj = np.asarray(res_j.loss_log)
    m = np.isfinite(lj[:, 0])
    np.testing.assert_allclose(o0["log"][m, 0], lj[m, 0], rtol=1e-3)
    err0 = float(np.linalg.norm(t0))
    assert float(np.linalg.norm(o0["trans"])) < 0.5 * err0


@pytest.mark.parametrize("mode", ["gn_iters", "fan_rounds",
                                  "ignore_outlier_depth_loss",
                                  "tile_subsample"])
def test_tile_sharded_tracking_rejects_unsupported_modes(mode):
    """(c) The reference's NotImplementedError modes, with its text."""
    from isogs_slam_tpu_torch.parallel.track_sharded import (
        make_tile_mesh, make_tracking_frame_sharded)
    rcfg, lcfg, tcfg = _track_cfgs()
    mesh = make_tile_mesh(1, "cpu")
    if mode == "ignore_outlier_depth_loss":
        lcfg = lcfg._replace(ignore_outlier_depth_loss=True)
        match = "global median"
    else:
        tcfg = tcfg._replace(**{mode: 2})
        match = ("one fast mode at a time" if mode == "tile_subsample"
                 else "Adam loop only")
    with pytest.raises(NotImplementedError, match=match):
        make_tracking_frame_sharded(mesh, _track_cam(), rcfg, lcfg, tcfg)


def test_gauss_sharded_iso_density_matches_reference(tmp_path):
    """(d) iso_density_gauss_sharded on two ranks against the JAX function
    on make_gauss_mesh(2): density within 1e-5, gradients of sum(d^2) in
    means and opacities within 1e-4 of their max; the ranks agree."""
    import jax
    import jax.numpy as jnp
    from isogs_slam_tpu.parallel.gauss_sharded import (
        iso_density_gauss_sharded, make_gauss_mesh)
    rng = np.random.default_rng(0)
    n, Q = 3000, 128
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    logs = np.log(rng.uniform(0.02, 0.08, (n, 3))).astype(np.float32)
    ops = rng.uniform(-1, 2, (n, 1)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-200:] = False
    queries = means[rng.choice(np.where(alive)[0], Q, replace=False)]
    mesh = make_gauss_mesh(2)

    def dens(m, o):
        return iso_density_gauss_sharded(
            mesh, jnp.asarray(queries), m, jnp.asarray(quats),
            jnp.asarray(logs), o, jnp.asarray(alive), 16)

    d_j = dens(jnp.asarray(means), jnp.asarray(ops))
    g_j = jax.grad(lambda m, o: jnp.sum(dens(m, o) ** 2), argnums=(0, 1))(
        jnp.asarray(means), jnp.asarray(ops))
    np.savez(tmp_path / "in.npz", means=means, quats=quats, logs=logs,
             ops=ops, alive=alive, queries=queries)
    _spawn("gauss", tmp_path)
    o0, o1 = _load(tmp_path)
    for k in o0.files:
        np.testing.assert_array_equal(o0[k], o1[k])
    assert float(np.abs(o0["d"] - np.asarray(d_j)).max()) < 1e-5
    for k, g in zip(("gm", "go"), g_j):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert float(np.abs(o0[k] - g).max()) < 1e-4 * scale + 1e-7


def test_density_grid_sharded_matches_serial_and_reference(tmp_path):
    """(e) compute_density(shard_devices=2) on two ranks: the serial
    port's grid bit for bit (the blocks are independent; each rank's chunks
    sum the same candidates in the same order), and the JAX package's
    serial grid within 1e-4 of its max (F64_TOL_TOY of
    tests/test_torch_mesh.py: the two packages' f32 lifts of the quadratic
    form round apart by 1.3e-5 of the max here)."""
    from isogs_slam_tpu.mesh.density import compute_density as jdens
    from isogs_slam_tpu_torch.mesh.density import compute_density
    rng = np.random.default_rng(11)
    n = 400
    params = {
        "means3D": rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.05, 0.2, (n, 3))
                             ).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(0.5, 1.0, (n, 1)).astype(np.float32),
    }
    d_serial, spec = compute_density(params, voxel_size=0.08, padding=0.3,
                                     device="cpu")
    assert spec.num_blocks > 8
    np.savez(tmp_path / "in.npz", **params)
    _spawn("density", tmp_path)
    o0, o1 = _load(tmp_path)
    assert int(o0["shards"]) == 2
    np.testing.assert_array_equal(o0["dens"], o1["dens"])
    np.testing.assert_array_equal(o0["dens"], d_serial)
    d_j, _ = jdens(params, voxel_size=0.08, padding=0.3)
    d_j = np.asarray(d_j)
    assert float(np.abs(o0["dens"] - d_j).max()) <= 1e-4 * float(
        np.abs(d_j).max())


def test_pipeline_two_ranks(tmp_path):
    """(f) The pipeline on two gloo ranks, 64x80 synthetic frames:
    track_tiles = 2 alone tracks the first frame (after frame 0's serial
    mapping) within 1e-4 of the serial run (the reference's contract,
    tests/test_parallel_and_resume.py:176-180); map_views = 2 with
    track_tiles = 2 evaluates within the JAX test's bands (PSNR > 15 dB,
    depth L1 < 40 cm), leaves both ranks' map, Adam moments, poses and
    keyframe poses equal bit for bit (and says so: max difference 0.0),
    and rank 0 alone writes files."""
    from isogs_slam_tpu_torch.slam.pipeline import SLAM
    _spawn("pipeline", tmp_path, timeout=PIPELINE_TIMEOUT)
    s = SLAM(_pipeline_config(tmp_path / "serial", "a"))
    s.run(end_at=1)
    a0 = np.load(tmp_path / "a_trans0.npy")
    a1 = np.load(tmp_path / "a_trans1.npy")
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_allclose(a0[:, 1], s.cam_trans[:, 1], atol=1e-4)
    b0, b1 = _load(tmp_path, prefix="b")
    for k in b0.files:
        if k not in ("psnr", "l1", "ate"):
            np.testing.assert_array_equal(b0[k], b1[k], err_msg=k)
    assert float(b0["replica"]) == 0.0
    assert int(b0["n_phases"]) == 2
    assert float(b0["psnr"]) > 15.0 and float(b0["l1"]) < 40.0
    assert np.isfinite(float(b0["ate"]))
    out0 = tmp_path / "b0" / "b"
    assert (out0 / "metrics_log.csv").exists()
    assert (out0 / "runtime_stats.json").exists()
    assert (out0 / "params4.npz").exists()
    assert (out0 / "eval" / "eval_summary.json").exists()
    written = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "b1")
               for f in fs]
    assert written == [], written


def test_parallel_knobs_clamp_at_world_size_one(tmp_path, capsys):
    """(f) Without a process group both knobs clamp to the one rank with the
    reference's line and the sharded programs run: the B = 1 view phase
    and the one-rank tile tracker."""
    from isogs_slam_tpu_torch.parallel.sharded import MultiviewMapPhase
    from isogs_slam_tpu_torch.slam.pipeline import SLAM
    slam = SLAM(_pipeline_config(tmp_path, "w1", map_views=2,
                                 track_tiles=2))
    out = capsys.readouterr().out
    assert "[parallel] map_views 2 > 1 devices; clamping" in out
    assert "[parallel] track_tiles 2 > 1 devices; clamping" in out
    assert isinstance(slam._mv_phase, MultiviewMapPhase)
    assert slam._mv_phase.B == 1 and slam._tt_mesh.size == 1
    assert slam._track_bins is None
    slam.run(end_at=2)
    assert len(slam._tt_cache) == 1
    assert slam._mv_phase.last_opt is not None
    assert np.isfinite(slam.cam_trans[:, :3]).all()


if __name__ == "__main__":
    # one rank of a spawned case: python tests/test_torch_parallel.py
    # <case> <dir>, under torch.distributed.run's environment
    case, tmp = sys.argv[1], sys.argv[2]
    pdist.init_distributed("cpu")
    try:
        RANK_CASES[case](tmp)
    finally:
        pdist.shutdown()
