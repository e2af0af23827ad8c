"""The port's headline benchmark (isogs_slam_tpu_torch/bench.py) against
the root bench.py on the CPU at a toy size: the one-line JSON contract,
the same line's structure as bench.py prints, the same configurations
from the same env knobs, and the same work in the frame step (the warm-up
mapping frame against the JAX chain of the same configurations, with the
reference's draws handed to the port)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.datasets.synthetic import SyntheticDataset
from isogs_slam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import mapping as JM
from isogs_slam_tpu.slam import pointcloud as JP
from isogs_slam_tpu.slam import tracking as JT
from isogs_slam_tpu_torch import bench
from isogs_slam_tpu_torch.core import convert
from isogs_slam_tpu_torch.core.camera import Camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"BENCH_H": "48", "BENCH_W": "64", "BENCH_FRAMES": "5",
       "BENCH_PASSES": "2", "BENCH_TRACK_ITERS": "2",
       "BENCH_MAP_ITERS": "4"}
BENCH_TIMEOUT = 600   # seconds for each toy bench run
# every knob bench.py reads into a configuration, off its default
ALL_KNOBS = {"BENCH_TRACK_ITERS": "7", "BENCH_MAP_ITERS": "9",
             "BENCH_TILE_SUBSAMPLE": "4", "BENCH_MAP_POLISH": "4",
             "BENCH_TRACK_TILE_SUBSAMPLE": "4", "BENCH_TILE_CULL": "1",
             "BENCH_TIGHT_RECT": "1", "BENCH_ISECT_PER_GAUSSIAN": "1.5",
             "BENCH_MAX_PER_TILE": "1024", "BENCH_TRACK_MAX_PER_TILE": "512",
             "BENCH_SIL_NORM": "0", "BENCH_TRACK_PATIENCE": "3",
             "BENCH_VMAP_BINS": "1"}


def _bench_line(proc):
    """Wait for a bench process; return its one JSON line (parsed) after
    checking it is the only stdout line that starts with '{'."""
    out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def bench_runs():
    """The three toy runs, started together (each takes ~30-60 s on the
    CPU): the port's bench without and with the fast block, and root
    bench.py on JAX's CPU backend with it. Yields a function name -> parsed
    line; processes still running at the end are killed."""
    port = [sys.executable, "-m", "isogs_slam_tpu_torch.bench", "--device",
            "cpu"]
    runs = {
        "exact": (port, dict(TOY, BENCH_ALSO_FAST="0")),
        "fast": (port, dict(TOY, BENCH_ALSO_FAST="1")),
        "jax": ([sys.executable, os.path.join(REPO, "bench.py")],
                dict(TOY, JAX_PLATFORMS="cpu", ISOGS_NO_COMP_CACHE="1",
                     PYTHONPATH="")),
    }
    procs = {name: subprocess.Popen(
        cmd, env=dict(os.environ, OMP_NUM_THREADS="2", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for name, (cmd, env) in runs.items()}
    lines = {}

    def line(name):
        if name not in lines:
            lines[name] = _bench_line(procs[name])
        return lines[name]

    try:
        yield line
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "also_fast"])
def test_bench_prints_one_json_line(bench_runs, fast):
    """(a) what tests/test_bench_contract.py holds of bench.py: one JSON
    line, its keys, the value equal to one pass's FPS, the pass and frame
    counts, probes above 0; with the fast block, its keys too."""
    r = bench_runs("fast" if fast else "exact")
    for key in ("metric", "value", "unit", "vs_baseline", "detail"):
        assert key in r, key
    assert r["metric"] == "replica-config tracking+mapping FPS (64x48, 1 chip)"
    assert r["unit"] == "fps" and r["value"] > 0
    assert r["vs_baseline"] == round(r["value"] / 0.133, 2)
    d = r["detail"]
    assert len(d["passes"]) == 2
    assert {"fps", "track_s_per_frame", "map_s_per_frame"} \
        <= set(d["passes"][0])
    assert r["value"] in [p["fps"] for p in d["passes"]]
    assert len(d["frame_times_s"]) == 2
    assert all(len(ft) == 5 for ft in d["frame_times_s"])
    assert d["latency_probe_ms"]["pre"] > 0
    assert d["latency_probe_ms"]["post"] > 0
    assert d["n_gaussians"] > 0 and d["device"] == "cpu"
    assert (d["track_iters"], d["map_iters"], d["map_every"]) == (2, 4, 5)
    fast_keys = {"fast_mode_fps", "fast_mode_passes",
                 "fast_mode_probe_post_ms", "fast_mode"}
    if fast:
        assert fast_keys <= set(d)
        assert d["fast_mode_fps"] in [p["fps"] for p in
                                      d["fast_mode_passes"]]
        assert len(d["fast_mode_passes"]) == 2
        assert d["fast_mode_probe_post_ms"] > 0
        assert d["fast_mode"] == ("map sub4 cycle + 4 exact tail iters + "
                                  "track sub4")
    else:
        assert not fast_keys & set(d)


def _structure(x):
    """The key structure of a JSON value: dicts by key, lists by element,
    leaves as their kind (numbers of either type alike)."""
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_structure(v) for v in x]
    return "number" if isinstance(x, (int, float)) else type(x).__name__


def test_bench_line_matches_root_bench(bench_runs):
    """(b) root bench.py (JAX on the CPU) and the port's bench at the same
    toy env print lines of the same structure at every level (bench.py's
    TPU-lock flag aside), the same frames, resolution, iteration counts
    and map_every, and maps within 2% in size (the device draws differ by
    construction: jax.random against torch.Generator)."""
    ref = dict(bench_runs("jax"))
    ref["detail"] = dict(ref["detail"])
    ref["detail"].pop("tpu_lock_acquired", None)
    got = bench_runs("fast")
    assert _structure(got) == _structure(ref)
    assert got["metric"] == ref["metric"]
    for k in ("frames", "resolution", "track_iters", "map_iters",
              "map_every", "fast_mode"):
        assert got["detail"][k] == ref["detail"][k], k
    n_got, n_ref = got["detail"]["n_gaussians"], ref["detail"]["n_gaussians"]
    assert abs(n_got - n_ref) <= 0.02 * n_ref, (n_got, n_ref)


def _jax_configs(env):
    """bench.py:99-160's configurations, built here with its literals."""
    rcfg = JRasterConfig(
        tile_cull=bool(int(env.get("BENCH_TILE_CULL", 0))),
        tight_rect=bool(int(env.get("BENCH_TIGHT_RECT", 0))),
        isect_per_gaussian=float(env.get("BENCH_ISECT_PER_GAUSSIAN", 2.5)),
        max_per_tile=int(env.get("BENCH_MAX_PER_TILE", 512)))
    rcfg_track = rcfg._replace(
        max_per_tile=int(env.get("BENCH_TRACK_MAX_PER_TILE", 256)))
    lcfg_track = JL.LossConfig(
        tracking=True, use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=0.0, w_iso=0.0, calc_iso=False,
        sil_norm_render=bool(int(env.get("BENCH_SIL_NORM", 1))))
    lcfg_map = JL.LossConfig(
        tracking=False, use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0,
        w_flat=50.0, w_iso=2.0, iso_sample_size=8192, iso_k=16,
        calc_iso=True, knn_block=8192)
    tcfg = JT.TrackingConfig(
        num_iters=int(env.get("BENCH_TRACK_ITERS", 10)), lr_quat=0.0004,
        lr_trans=0.002,
        tile_subsample=int(env.get("BENCH_TRACK_TILE_SUBSAMPLE", 1)),
        early_stop_patience=int(env.get("BENCH_TRACK_PATIENCE", 0)))
    mcfg = JM.MappingConfig(
        num_iters=int(env.get("BENCH_MAP_ITERS", 40)), lr_means3d=0.0001,
        lr_rgb_colors=0.0025, lr_unnorm_rotations=0.001,
        lr_logit_opacities=0.05, lr_log_scales=0.001,
        prune=JM.PruneConfig(True, 0, 0, 20, 20, 0.005, 0.005, False, 500),
        tile_subsample=int(env.get("BENCH_TILE_SUBSAMPLE", 1)),
        exact_polish_iters=int(env.get("BENCH_MAP_POLISH", 0)),
        vmap_bins=bool(int(env.get("BENCH_VMAP_BINS", 0))))
    return rcfg, rcfg_track, lcfg_track, lcfg_map, tcfg, mcfg


@pytest.mark.parametrize("env", [{}, ALL_KNOBS], ids=["defaults", "knobs"])
def test_bench_configs_match_root_bench(env):
    """(c) every field of the port's six configurations equals the JAX
    package's built from bench.py's literals (the JAX RasterConfig's
    compositing `backend` has no counterpart in the port)."""
    got = bench.bench_configs(env)
    ref = _jax_configs(env)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        rd = r._asdict()
        rd.pop("backend", None)
        assert g._asdict() == rd, (type(g).__name__, g, r)


def test_bench_default_device_is_the_card():
    """No card: the bench and the entry point fail, they do not fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from isogs_slam_tpu_torch import graft_entry
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()


class _SameFrames:
    """The JAX package's synthetic frames with the port's camera: both
    chains see the same numpy frames."""

    def __init__(self, ds):
        self.ds = ds
        c = ds.cam
        self.cam = Camera(width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                          cx=c.cx, cy=c.cy)

    def __getitem__(self, i):
        return self.ds[i]


def test_run_frame_matches_reference_chain():
    """(d) the port bench's own init and run_frame through the warm-up
    mapping frame (frame map_every - 1: track from the ground-truth pose,
    densify, keyframe slot 1, a mapping phase
    over slots 0-1) against the JAX chain of the same configurations on
    the same frames, bench.py's draws (PRNGKey(0) and its splits) handed
    to the port. K covers every tile's candidates (BENCH_MAX_PER_TILE /
    BENCH_TRACK_MAX_PER_TILE): which of a fronto-parallel wall's tied
    depth keys a smaller cap keeps is up to each package's sort. The
    tolerances are tests/test_torch_slice.py's."""
    env = dict(TOY, BENCH_TRACK_ITERS="3", BENCH_MAP_ITERS="3",
               BENCH_MAX_PER_TILE="4096", BENCH_TRACK_MAX_PER_TILE="4096")
    H, W, n_frames, me = 48, 64, 5, 5
    cfgs = bench.bench_configs(env)
    jr, jr_track, jl_track, jl_map, jt, jm = _jax_configs(env)
    jr = jr._replace(backend="xla")
    jr_track = jr_track._replace(backend="xla")
    jds = SyntheticDataset(num_frames=max(n_frames + 2, me + 2), height=H,
                           width=W, n_per_wall=max(400, (H * W) // 40))
    jcam = jds.cam
    wl = bench.Workload(H, W, n_frames, me, cfgs, "cpu",
                        dataset=_SameFrames(jds))
    cap = wl.capacity

    # first-frame init: bench.py's first split of PRNGKey(0)
    key = jax.random.PRNGKey(0)
    key, sub = jax.random.split(key)
    im0, d0, q0, t0 = (x.numpy() for x in wl.frame(0))
    js = JP.initialize_first_frame(jnp.asarray(im0), jnp.asarray(d0), jcam,
                                   cap, sub, 3.0)
    ts = wl.init_state(perturb=np.array(jax.random.normal(sub, (H * W, 3))))

    # frame me - 1: tracking (bench.py's tile-list cache when reuse_binning)
    i = me - 1
    im, d, q_gt, t_gt = (x.numpy() for x in wl.frame(i))
    jbins = (JT.BinningReuse(jcam, jr_track,
                             margin_px=jt.cross_frame_margin_px,
                             slack_px=jt.bin_margin_px)
             if jt.reuse_binning else None)
    jres = JT.track_frame(js.params, js.alive, q_gt, t_gt, im, d, jcam,
                          jr_track, jl_track, jt,
                          binning=None if jbins is None else jbins.get(
                              js.params, js.alive, jnp.asarray(q_gt),
                              jnp.asarray(t_gt)))
    # densify, keyframe slot 1, mapping over slots 0-1
    key, k1, k2 = jax.random.split(key, 3)
    js = JP.add_new_gaussians(js, jnp.asarray(im), jnp.asarray(d), jres.quat,
                              jres.trans, float(i), k1, jcam, jr,
                              sil_thres=0.5)
    kf_c = np.zeros((bench.S, H, W, 3), np.uint8)
    kf_d = np.zeros((bench.S, H, W), np.float32)
    kf_q = np.zeros((bench.S, 4), np.float32)
    kf_t = np.zeros((bench.S, 3), np.float32)
    for slot, (a, b, q, t) in ((0, (im0, d0, q0, t0)),
                               (1, (im, d, np.asarray(jres.quat),
                                    np.asarray(jres.trans)))):
        kf_c[slot] = (a.transpose(1, 2, 0) * 255).astype(np.uint8)
        kf_d[slot], kf_q[slot], kf_t[slot] = b[0], q, t
    iter_slots = np.random.default_rng(0).integers(0, 2, size=jm.num_iters)
    keys = jax.random.split(k2, jm.num_iters)
    # the reference's iso draws (before map_frame, which donates the
    # state): the phase's KNN pool rows, then each iteration's sample of
    # pool rows
    P = min(jl_map.iso_pool_size, cap)
    scores = (jax.random.uniform(jax.random.fold_in(keys[0], 0x150), (cap,))
              + jnp.where(js.alive, 0.0, 2.0))
    pool_q = np.array(jax.lax.top_k(-scores, P)[1])
    sels = [torch.tensor(np.array(jax.random.randint(
        k, (min(jl_map.iso_sample_size, P),), 0, P))).long() for k in keys]
    js, jlog, jstats = JM.map_frame(
        js, jnp.asarray(kf_c), jnp.asarray(kf_d), jnp.asarray(kf_q),
        jnp.asarray(kf_t), jnp.asarray(iter_slots, jnp.int32), keys, jcam,
        jr, jl_map, jm)

    out = bench.run_frame(
        wl, i, ts, cfgs, perturb=np.array(jax.random.normal(k1, (H * W, 3))),
        pool_q_idx=torch.tensor(pool_q).long(), iso_sels=sels)
    tres, tlog = out.track, out.map_log

    # tracking: tests/test_torch_slice.py's bounds
    n_it = jt.num_iters
    assert tres.iters_run == int(jres.iters_run) == n_it
    jtl = np.asarray(jres.loss_log)
    np.testing.assert_allclose(tres.loss_log.numpy()[0], jtl[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tres.loss_log.numpy(), jtl, rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(tres.quat.numpy(), np.asarray(jres.quat),
                               atol=1e-2 * jt.lr_quat * n_it)
    np.testing.assert_allclose(tres.trans.numpy(), np.asarray(jres.trans),
                               atol=1e-2 * jt.lr_trans * n_it)
    # the keyframe slot the port filled holds the same frame and pose
    np.testing.assert_array_equal(wl.kf_colors[1].numpy(), kf_c[1])
    np.testing.assert_allclose(wl.kf_quats[1].numpy(), kf_q[1],
                               atol=1e-2 * jt.lr_quat * n_it)

    # mapping: the loss log and the map, tests/test_torch_slice.py's bounds
    jlog = np.asarray(jlog)
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(tlog.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-2, atol=1e-4)
    got = convert.state_to_arrays(out.state)
    ref = convert.state_to_arrays(convert.state_from_arrays(js, "cpu"))
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    assert int(got["hwm"]) == int(ref["hwm"])
    n_map = jm.num_iters
    atol = {"means3d": jm.lr_means3d, "rgb_colors": jm.lr_rgb_colors,
            "unnorm_rotations": jm.lr_unnorm_rotations,
            "logit_opacities": jm.lr_logit_opacities,
            "log_scales": jm.lr_log_scales}
    for k in ("means3d", "rgb_colors", "unnorm_rotations",
              "logit_opacities", "log_scales", "timestep", "max_2d_radius"):
        np.testing.assert_allclose(
            got[k], ref[k], rtol=0,
            atol=n_map * atol[k] + 1e-5 if k in atol else 1e-6, err_msg=k)
    # the phase's binning: no true candidate dropped; the peak
    # intersections of a slot within 1e-3 (the densified points differ by
    # ~1e-5, which moves a handful of tile-rect edges). The totals differ by
    # design: the port bins the slots the phase renders (here slot 1 alone),
    # the reference every slot of its window (ROADMAP.md section 3)
    tstats = out.map_stats
    assert int(tstats[0]) == int(jstats[0]) == 0
    assert set(iter_slots.tolist()) == {1}
    assert abs(int(tstats[2]) - int(jstats[2])) <= 1e-3 * int(jstats[2])
    assert wl.peak_isect >= int(tstats[2]) > 0
