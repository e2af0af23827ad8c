"""The port's SLAM pipeline: map-state surgery, the adaptive caps, the
refusal of knobs that are not ported, and the whole pipeline against the
JAX package on the same injected frames."""
import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import gaussians as JG
from isogs_slam_tpu.datasets.synthetic import SyntheticDataset as JSynthetic
from isogs_slam_tpu.slam.pipeline import SLAM as JSLAM
from isogs_slam_tpu_torch.core import convert
from isogs_slam_tpu_torch.core import gaussians as G
from isogs_slam_tpu_torch.slam import pipeline as P
from isogs_slam_tpu_torch.slam.config import inject_defaults

H, W, N_FRAMES = 64, 80, 5


def _config(tmp_path, name="run", **top):
    cfg = dict(
        workdir=str(tmp_path), run_name=name, seed=0, primary_device="cpu",
        map_every=3, keyframe_every=3, mapping_window_size=5, eval_every=2,
        scene_radius_depth_ratio=3, mean_sq_dist_method="projective",
        gaussian_distribution="isotropic", load_checkpoint=False,
        checkpoint_time_idx=0, save_checkpoints=False, checkpoint_interval=5,
        use_wandb=False, compact_every=50, capacity_granule=8192,
        report_global_progress_every=100, eval_online_save_qual=False,
        # K covers every tile's candidates: at tied depth keys the set a
        # smaller cap keeps is up to each package's sort
        raster=dict(max_per_tile=1024, isect_per_gaussian=6.0,
                    tile_chunk=20),
        isogs=dict(sample_size=512, k=8, target_saturation=1.0,
                   knn_pool_size=2048),
        data=dict(dataset_name="synthetic", basedir="", sequence="t",
                  desired_image_height=H, desired_image_width=W, start=0,
                  end=-1, stride=1, num_frames=N_FRAMES, prefetch_depth=0),
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=6,
            use_sil_for_loss=True, sil_thres=0.90, use_l1=True,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.002, cam_trans=0.01)),
        mapping=dict(
            num_iters=6, add_new_gaussians=True, sil_thres=0.5, use_l1=True,
            use_sil_for_loss=False, ignore_outlier_depth_loss=False,
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
            use_gaussian_splatting_densification=False))
    cfg.update(top)
    return cfg


_FRAMES = []


def _frames():
    """The sequence both pipelines are given through `dataset=`: rendered
    once by the JAX package's SyntheticDataset."""
    if not _FRAMES:
        ds = JSynthetic(num_frames=N_FRAMES, height=H, width=W, seed=0,
                        n_per_wall=2500)
        _FRAMES.extend(tuple(np.asarray(a) for a in ds[i])
                       for i in range(N_FRAMES))
    return _FRAMES


# ------------------------------------------------------------ map state
def _random_state(rng, cap, used):
    def arr(*s):
        return rng.normal(size=s).astype(np.float32)

    class St:
        class params:
            means3d, rgb_colors = arr(cap, 3), arr(cap, 3)
            unnorm_rotations, logit_opacities = arr(cap, 4), arr(cap, 1)
            log_scales = arr(cap, 3)
        alive = (rng.uniform(size=cap) < 0.6) & (np.arange(cap) < used)
        hwm = np.int32(used)
        timestep, max_2d_radius = arr(cap), arr(cap)
        means2d_grad_accum, denom = arr(cap), arr(cap)
        scene_radius = np.float32(1.7)
    return St


def _jstate(st):
    return JG.MapState(
        params=JG.GaussianParams(*[jnp.asarray(getattr(st.params, f))
                                   for f in JG.GaussianParams._fields]),
        **{f: jnp.asarray(getattr(st, f)) for f in JG.MapState._fields
           if f != "params"})


@pytest.mark.parametrize("op", ["compact", "grow", "compact_then_grow"])
def test_compact_grow_match_reference(op):
    """Every field exactly equal to the JAX functions' on a random alive
    mask (dead rows included: the permutation is the same stable sort)."""
    st = _random_state(np.random.default_rng(0), 257, 200)
    ts, js = convert.state_from_arrays(st, "cpu"), _jstate(st)
    if "compact" in op:
        ts, js = G.compact(ts), JG.compact(js)
    if "grow" in op:
        ts, js = G.grow_capacity(ts, 400), JG.grow_capacity(js, 400)
        assert ts.capacity == 400
    got = convert.state_to_arrays(ts)
    ref = convert.state_to_arrays(convert.state_from_arrays(js, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if "compact" in op:
        n = int(st.alive.sum())
        assert int(ts.hwm) == n and bool(ts.alive[:n].all())
        assert not bool(ts.alive[n:].any())


# ---------------------------------------------------- construction, caps
def test_adaptive_tile_cap_escalation(tmp_path):
    """_check_tile_cap warns at > 0.5% true-candidate drops and escalates
    the cap 512 -> 768 -> 1024 by default; pinned off it only warns. The
    JAX class is given the same calls."""
    frames = _frames()
    for mod, conv in ((P, torch.tensor), (None, jnp.asarray)):
        def make(name, **raster):
            cfg = _config(tmp_path, name)
            cfg["raster"].update(max_per_tile=512, **raster)
            return (mod.SLAM if mod else JSLAM)(cfg, dataset=frames)

        slam = make("a", adaptive_max_per_tile=True)
        slam._check_tile_cap(conv([0, 1000]))
        assert slam.rcfg.max_per_tile == 512
        slam._check_tile_cap(conv([100, 1000]))
        assert slam.rcfg.max_per_tile == 768
        slam._check_tile_cap(conv([100, 1000]))
        slam._check_tile_cap(conv([100, 1000]))
        assert slam.rcfg.max_per_tile == 1024
        assert slam.rcfg_track.max_per_tile == 256
        assert slam.stats["tile_cap_dropped_frac"] == [0.0, 0.1, 0.1, 0.1]
        slam2 = make("b")            # the shipped default escalates
        slam2._check_tile_cap(conv([100, 1000]))
        assert slam2.rcfg.max_per_tile == 768
        slam3 = make("c", adaptive_max_per_tile=False)
        slam3._check_tile_cap(conv([100, 1000]))
        assert slam3.rcfg.max_per_tile == 512 and slam3._warned_tile_cap
        if mod:
            assert slam.events["max_per_tile"] == [(0, 512, 768),
                                                   (0, 768, 1024)]
    assert P.ADAPTIVE_MAX_PER_TILE_DEFAULT is True


def test_adaptive_isect_cap_growth(tmp_path):
    """The intersection capacity is seeded at first-frame init, grows at
    0.75 occupancy, stays in step with the tile-list cache's config and
    drops the cached tile lists; the JAX class gives the same caps."""
    frames = _frames()
    color, depth = frames[0][0], frames[0][1]
    caps = []
    for cls, conv in ((P.SLAM, torch.tensor), (JSLAM, jnp.asarray)):
        slam = cls(_config(tmp_path, "i"), dataset=frames)
        assert slam.rcfg.max_isect_cap == 0
        slam.initialize_first_frame(color, depth)
        cap0 = slam.rcfg.max_isect_cap
        assert cap0 > 0 and slam.rcfg_track.max_isect_cap == cap0
        assert slam.rcfg.max_isect(10 ** 9) == cap0
        q, t = slam._pose(0)
        b0 = slam._track_bins.get(slam.state.params, slam.state.alive, q, t)
        slam._check_tile_cap(conv([0, 1000, int(cap0 * 0.5)]))
        assert slam.rcfg.max_isect_cap == cap0
        assert slam._track_bins.get(slam.state.params, slam.state.alive, q,
                                    t) is b0
        slam._check_tile_cap(conv([0, 1000, int(cap0 * 0.9)]))
        cap1 = slam.rcfg.max_isect_cap
        assert cap1 > cap0 and slam.rcfg_track.max_isect_cap == cap1
        assert slam._track_bins.rcfg.max_isect_cap == cap1
        # a changed cap leaves no stale tile lists alive
        assert slam._track_bins.get(slam.state.params, slam.state.alive, q,
                                    t) is not b0
        caps.append((cap0, cap1))
        cfg2 = _config(tmp_path, "j")
        cfg2["raster"]["adaptive_isect_cap"] = False
        slam2 = cls(cfg2, dataset=frames)
        slam2.initialize_first_frame(color, depth)
        assert slam2.rcfg.max_isect_cap == 0
    assert caps[0] == caps[1]


def test_ensure_capacity_compacts_then_grows(tmp_path):
    slam = P.SLAM(_config(tmp_path, "cap"), dataset=_frames())
    slam.initialize_first_frame(*_frames()[0][:2])
    cap, used = slam.state.capacity, int(slam.state.hwm)
    assert cap == G.round_capacity(int(H * W * 1.5), 8192)
    q, t = slam._pose(0)
    tl = slam._track_bins.get(slam.state.params, slam.state.alive, q, t)
    slam._ensure_capacity(cap - used)             # fits: nothing happens
    assert slam.state.capacity == cap and not slam.events["compactions"]
    # prune half; asking for more than is free compacts instead of growing
    dead = torch.arange(cap) % 2 == 0
    slam.state = G.prune(slam.state, dead & slam.state.alive)
    n_alive = int(slam.state.num_alive())
    slam._ensure_capacity(cap - used + 10)
    assert slam.state.capacity == cap and int(slam.state.hwm) == n_alive
    assert slam.events["compactions"] == [0]
    assert slam._track_bins.get(slam.state.params, slam.state.alive, q,
                                t) is not tl      # rows moved: rebinned
    slam._ensure_capacity(cap)                    # cannot fit: grow
    new_cap = G.round_capacity(max(n_alive + cap, 2 * cap), 8192)
    assert slam.state.capacity == new_cap
    assert slam.events["capacity"] == [(0, cap, new_cap)]
    assert int(slam.state.num_alive()) == n_alive


# the mapper's densification, the kept iso pool and the fresh iso KNN run
# (tests/test_torch_knobs.py); the multi-device knobs run too, clamped to
# the world size (tests/test_torch_parallel.py runs them on two ranks)
NOT_PORTED = {"parallel.map_views": 2, "parallel.track_tiles": 2}

@pytest.mark.parametrize("knob", list(NOT_PORTED))
def test_unported_knob_raises_at_construction(tmp_path, knob, capsys):
    """The multi-device knobs were refused here until the port had
    parallel/; now a config that sets one constructs without a process
    group as the reference does on one device: the knob clamps to the
    world size with the reference's line, and the sharded program is
    built (the B = 1 view phase, the one-rank tile mesh)."""
    cfg = inject_defaults(_config(tmp_path, "k"))
    section, key = knob.split(".")
    cfg[section][key] = NOT_PORTED[knob]
    slam = P.SLAM(cfg, dataset=_frames())
    assert (f"[parallel] {key} 2 > 1 devices; clamping"
            in capsys.readouterr().out)
    if key == "map_views":
        assert slam._map_views == 1 and slam._mv_phase is not None
    else:
        assert slam._track_tiles == 1 and slam._tt_mesh.size == 1


def test_device_must_be_cuda_or_cpu(tmp_path):
    with pytest.raises(ValueError, match="tpu"):
        P.SLAM(_config(tmp_path, "d", primary_device="tpu"),
               dataset=_frames())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.SLAM(_config(tmp_path, "e", primary_device="cuda"),
               dataset=_frames())
    cfg = _config(tmp_path, "f")
    del cfg["primary_device"]                 # the default is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.SLAM(cfg, dataset=_frames())


def test_profile_trace_dir_writes_a_trace(tmp_path):
    """config["profile_trace_dir"] wraps the run in torch.profiler and
    leaves a chrome trace; it does not silently do nothing."""
    trace_dir = tmp_path / "trace"
    cfg = _config(tmp_path, "prof", profile_trace_dir=str(trace_dir))
    cfg["mapping"]["num_iters"] = 2
    cfg["tracking"]["num_iters"] = 2
    slam = P.SLAM(cfg, dataset=_frames())
    stats = slam.run(end_at=1)
    assert len(stats["tracking_frame_time"]) == 2
    assert (trace_dir / "trace.json").stat().st_size > 10_000


# ------------------------------------------- the slice, against JAX
class _RecordingRNG:
    """A RandomState that logs every draw (name, arguments, result)."""

    def __init__(self, seed):
        self._rs = np.random.RandomState(seed)
        self.log = []

    def randint(self, *a, **kw):
        out = self._rs.randint(*a, **kw)
        self.log.append(("randint", a, sorted(kw.items()),
                         np.asarray(out).tolist()))
        return out

    def permutation(self, x):
        out = self._rs.permutation(x)
        self.log.append(("permutation", np.asarray(x).tolist(),
                         np.asarray(out).tolist()))
        return out


def _run_recorded(slam):
    """Run a SLAM object of either package with its host draws logged and
    the number of alive Gaussians noted after each densify and map."""
    slam.rng = _RecordingRNG(0)
    alive = []
    for name in ("densify", "map"):
        def wrapped(*a, _f=getattr(slam, name), _n=name):
            out = _f(*a)
            alive.append((_n, int(slam.state.num_alive())))
            return out
        setattr(slam, name, wrapped)
    slam.run()
    return alive


def _tracking_rows(slam, frame):
    with open(os.path.join(slam.output_dir, "metrics_log.csv")) as f:
        rows = [r for r in csv.DictReader(f)
                if r["stage"] == "tracking" and int(r["frame"]) == frame]
    return np.array([[float(r[k]) for k in ("loss", "image_loss",
                                            "depth_loss", "mask_frac")]
                     for r in rows])


def _ate_cm(slam):
    from isogs_slam_tpu_torch.eval.metrics import evaluate_ate
    from isogs_slam_tpu_torch.eval.eval_helpers import est_w2c
    est = [slam.first_frame_w2c] + [est_w2c(slam, i)
                                    for i in range(1, N_FRAMES)]
    return 100 * evaluate_ate(slam.gt_w2c_all, est)


@pytest.mark.parametrize("case", ["draws_off", "shipped_defaults"])
def test_pipeline_matches_reference_on_injected_frames(tmp_path, case):
    """Both SLAM classes on the same frames with the same seed: 5 frames at
    64x80, mapping every 3rd, 6 tracking and 6 mapping iterations.

    draws_off (no device draws: anisotropic init, iso weight 0, f32
    gradient rows; a keyframe every 2nd frame, so the second mapping phase
    selects among keyframes): the host draws (keyframe selection, iteration
    slots) and the keyframe lists are equal, the alive counts after every
    densify and mapping phase are equal, the first tracked frame's loss
    columns agree within 1e-2 relative at the shared start pose (measured
    2.8e-3: a masked L1 sum whose silhouette > 0.9 mask differs in 4 of
    5120 pixels after frame 0's six mapping iterations, where Adam at eps
    1e-15 turns a sign flip of a near-zero gradient into a full step of
    lr_logit_opacities = 0.05), and every frame's camera translation
    within 2 mm (measured 0.6 mm).

    shipped_defaults (isotropic init, iso on, bf16 gradient rows: the
    device draws differ by construction; a keyframe every 3rd frame, so
    the last-keyframe rule adds one of its own): keyframe lists equal, both
    runs' ATE under 8 cm, translations within 2 cm: two Adam steps of
    lr_trans = 0.01 (6 iterations a frame leave the pose bouncing at the
    step size; measured 1.5 cm at frame 3, 0.7 cm at frame 4, with the
    two runs' ATE 0.916 and 0.911 cm)."""
    frames = _frames()
    top = {}
    if case == "draws_off":
        top.update(gaussian_distribution="anisotropic", keyframe_every=2)
    cfgs = [_config(tmp_path, f"{case}_{p}", **top) for p in ("j", "t")]
    if case == "draws_off":
        for c in cfgs:
            c["mapping"]["loss_weights"]["iso"] = 0.0
    jslam = JSLAM(cfgs[0], dataset=frames)
    tslam = P.SLAM(cfgs[1], dataset=frames)
    if case == "draws_off":
        jslam.rcfg = jslam.rcfg._replace(grad_scatter_bf16=False)
        tslam.rcfg = tslam.rcfg._replace(grad_scatter_bf16=False)
    jalive = _run_recorded(jslam)
    talive = _run_recorded(tslam)

    # T = 5. keyframe_every = 3: frames 0 and 2, and the last-keyframe rule
    # (time_idx == num_frames - 2) adds frame 3; keyframe_every = 2: 0, 1, 3
    every = cfgs[0]["keyframe_every"]
    assert tslam.keyframe_time_indices == jslam.keyframe_time_indices \
        == {3: [0, 2, 3], 2: [0, 1, 3]}[every]
    assert tslam.kf.time_indices == jslam.kf.time_indices
    assert tslam.kf.max_keyframes == jslam.kf.max_keyframes \
        == N_FRAMES // every + 3
    assert [n for n, _ in talive] == [n for n, _ in jalive] \
        == ["map", "densify", "map"]
    assert np.isfinite(tslam.cam_trans).all()
    assert np.abs(tslam.cam_trans[:, 1:]).max() > 1e-4     # poses moved
    dt = np.linalg.norm(tslam.cam_trans - jslam.cam_trans, axis=0)
    ate_j, ate_t = _ate_cm(jslam), _ate_cm(tslam)
    print(f"[{case}] translation differences (m) {dt}, ATE cm "
          f"{ate_j:.3f} (reference) {ate_t:.3f} (port), alive {jalive} "
          f"{talive}")
    if case == "draws_off":
        assert tslam.rng.log == jslam.rng.log
        # frame 0: slots; frame 2: 1600 pixels, permutation, slots
        assert [e[0] for e in tslam.rng.log] == ["randint", "randint",
                                                 "permutation", "randint"]
        assert tslam.last_selected == [0, 1, 2]
        assert talive == jalive
        jrows, trows = _tracking_rows(jslam, 1), _tracking_rows(tslam, 1)
        assert jrows.shape == trows.shape == (6, 4)
        np.testing.assert_allclose(trows[0], jrows[0], rtol=1e-2)
        assert dt.max() < 2e-3
    else:
        assert dt.max() < 2e-2
    assert ate_j < 8.0 and ate_t < 8.0
