"""The port's Inria densification against the JAX package: the gradient
statistics, densify_step on and off its schedule (clone, split with the
reference's own split noise, prune, the opacity reset with zeroed Adam
moments, rows dropped at capacity), the d loss / d(u, v) signal of
means2d_offset through the whole-image render (kernel C's route) and a
tile subset (index_add_), and map_frame(use_densification=True).

The reference runs on its XLA route (backend="xla"); its segment reduce is
the Pallas kernel in interpret mode. Tolerances are stated at each
assert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core import gaussians as JG
from isogs_slam_tpu.core import optim as JO
from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu.slam import densify as JD
from isogs_slam_tpu.slam import losses as JL
from isogs_slam_tpu.slam import mapping as JM
from isogs_slam_tpu.utils.transforms import transform_to_frame as j_ttf
from isogs_slam_tpu_torch.core import convert, optim
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.core.gaussians import GaussianParams
from isogs_slam_tpu_torch.ops import rasterize as R
from isogs_slam_tpu_torch.slam import densify as D
from isogs_slam_tpu_torch.slam import losses as L
from isogs_slam_tpu_torch.slam import mapping as M
from isogs_slam_tpu_torch.utils.transforms import transform_to_frame
from test_torch_subset import (CAM, IDENT, ISO_LOSS, K, LR_MAP, MK, PRUNE,
                               _bins, _jparams, _map_inputs, _scene,
                               _tparams)

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)
FIELDS = GaussianParams._fields


def _split_noise(key, n_split, capacity):
    """The reference's split noise of one densify_step call with `key`."""
    return torch.tensor(np.stack([
        np.asarray(jax.random.normal(k, (capacity, 3), jnp.float32))
        for k in jax.random.split(key, n_split)]))


def _states(cap=256, n=150, seed=0):
    """The same map in both packages: n used rows of `cap`, some dead, a
    third hot, scales below and above 0.01 x scene radius, some too big or
    too transparent to survive the pruning, random Adam moments."""
    rng = np.random.default_rng(seed)

    def rows(*shape):
        a = np.zeros((cap,) + shape, np.float32)
        a[:n] = rng.normal(size=(n,) + shape)
        return a

    log_s = np.zeros((cap, 3), np.float32)
    log_s[:n] = np.log(rng.choice([0.005, 0.05, 0.5], size=(n, 1))
                       * rng.uniform(0.8, 1.2, (n, 3)))
    logit = rows(1)
    logit[:n:17] = -7.0                       # sigmoid < 0.005: pruned
    alive = np.zeros(cap, bool)
    alive[:n] = rng.uniform(size=n) > 0.1
    accum = np.zeros(cap, np.float32)
    accum[:n] = rng.uniform(0, 3, n)
    denom = np.zeros(cap, np.float32)
    denom[:n] = rng.integers(1, 4, n)
    js = JG.MapState(
        params=JG.GaussianParams(
            means3d=jnp.asarray(rows(3)), rgb_colors=jnp.asarray(rows(3)),
            unnorm_rotations=jnp.asarray(rows(4)),
            logit_opacities=jnp.asarray(logit),
            log_scales=jnp.asarray(log_s)),
        alive=jnp.asarray(alive), hwm=jnp.asarray(n, jnp.int32),
        timestep=jnp.asarray(rng.integers(0, 9, cap).astype(np.float32)),
        max_2d_radius=jnp.asarray(rng.uniform(0, 5, cap).astype(np.float32)),
        means2d_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        scene_radius=jnp.asarray(2.0, jnp.float32))
    mom = [[rng.normal(size=np.shape(p)).astype(np.float32) ** 2
            for p in js.params] for _ in range(2)]
    jo = JO.AdamState(mu=JG.GaussianParams(*map(jnp.asarray, mom[0])),
                      nu=JG.GaussianParams(*map(jnp.asarray, mom[1])),
                      count=jnp.asarray(3, jnp.int32))
    to = optim.AdamState(mu=tuple(map(torch.tensor, mom[0])),
                         nu=tuple(map(torch.tensor, mom[1])), count=3)
    return js, convert.state_from_arrays(js, "cpu"), jo, to


def _assert_states_equal(ts, js, atol=1e-6):
    got = convert.state_to_arrays(ts)
    ref = convert.state_to_arrays(convert.state_from_arrays(js, "cpu"))
    for k in ref:
        if got[k].dtype == bool or k == "hwm":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                       atol=atol, err_msg=k)


def test_accumulate_mean2d_gradient_matches_reference():
    """Accumulators, counters and max radii equal to f32 rounding (1e-6)."""
    js, ts, _, _ = _states()
    rng = np.random.default_rng(5)
    radii = rng.integers(0, 4, 256).astype(np.int32)
    g = rng.normal(size=(256, 2)).astype(np.float32)
    j1 = jax.jit(JD.accumulate_mean2d_gradient)(js, jnp.asarray(radii),
                                                 jnp.asarray(g))
    t1 = D.accumulate_mean2d_gradient(ts, torch.tensor(radii),
                                      torch.tensor(g))
    _assert_states_equal(t1, j1)


DCFG = dict(start_after=0, remove_big_after=10, stop_after=100,
            densify_every=20, num_to_split_into=2, reset_opacities_every=30)


@pytest.mark.parametrize("it,thresh", [(20, 2.0), (20, 0.05), (30, 2.0),
                                       (35, 2.0)],
                         ids=["densify", "densify_full", "reset_only",
                              "nothing"])
def test_densify_step_matches_reference(it, thresh):
    """densify_step at an iteration that clones, splits (the reference's
    noise injected) and prunes; the same with so many hot rows that the
    appends overflow the capacity; one that only resets the opacities (and
    zeroes their moments); one that does nothing. State and moments equal
    to 1e-6, the counts the port reports equal to what the reference's
    state shows."""
    js, ts, jo, to = _states()
    jcfg = JD.DensifyConfig(grad_thresh=thresh, **DCFG)
    key = jax.random.PRNGKey(it)
    j1, jo1 = jax.jit(JD.densify_step, static_argnums=(4,))(
        js, jo, key, jnp.asarray(it, jnp.int32), jcfg)
    t1, to1, counts = D.densify_step(
        ts, to, it, D.DensifyConfig(grad_thresh=thresh, **DCFG),
        split_noise=_split_noise(key, 2, 256))
    _assert_states_equal(t1, j1)
    for a, b in zip(to1.mu + to1.nu, tuple(jo1.mu) + tuple(jo1.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    n_clone, n_split, dropped = (int(x) for x in counts)
    grew = int(j1.hwm) - int(js.hwm)
    if it == 20:
        assert n_clone > 0 and n_split > 0
        assert grew == min(n_clone + 2 * n_split, 256 - int(js.hwm))
        assert dropped == n_clone + 2 * n_split - grew
        assert (dropped > 0) == (thresh < 1.0)
        assert not np.asarray(j1.alive)[150:][
            np.asarray(j1.params.logit_opacities)[150:, 0] < -5].any()
    else:
        assert grew == 0 and (n_clone, n_split, dropped) == (0, 0, 0)
    reset = it == 30
    j = FIELDS.index("logit_opacities")
    assert (float(to1.mu[j].abs().max()) == 0.0) == reset
    if reset:
        np.testing.assert_allclose(t1.params.logit_opacities.numpy(),
                                   np.log(0.01 / 0.99), rtol=1e-6)


# ------------------------------------------------------ d loss / d(u, v)
def _m2d_grads(subset):
    """d loss / d means2d_offset in both packages (f32 rows): the whole
    image with an inline binning (the offline loss's route: kernel B's
    du/dv through kernel C's columns 0-1), or a tile subset (index_add_)."""
    arrs, alive, _ = _scene()
    jcam, cam = JCamera(**CAM), Camera(**CAM)
    n = alive.shape[0]
    base = dict(max_per_tile=K, max_isect_cap=32768,
                grad_scatter_bf16=False)
    sel = np.array([0, 6, 7, 13, 20, 27, 33, 34], np.int32)
    jb, tb = _bins(arrs, alive) if subset else (None, None)
    rng = np.random.default_rng(1)
    shape = (len(sel), 256, 5) if subset else (5, CAM["height"],
                                               CAM["width"])
    w = rng.normal(size=shape).astype(np.float32)

    def jloss(m2d):
        p = _jparams(arrs)
        mc, qc = j_ttf(p.means3d, p.unnorm_rotations, *IDENT,
                       gaussians_grad=True, camera_grad=False)
        cfg = JR.RasterConfig(backend="xla", **base)
        if subset:
            out, _, _ = JR.render_tiles_subset(
                mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
                jnp.asarray(alive), jnp.asarray(sel), jb, jcam, cfg, m2d,
                live_grad_cols=JR.MAPPING_LIVE_COLS)
        else:
            im, d, sil, dsq, _ = JR.render_rgbd_sil(
                mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
                jnp.asarray(alive), jcam, cfg, m2d)
            out = jnp.concatenate([im, d, sil[None], dsq])[:5]
        return jnp.sum(out * w)

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros((n, 2), jnp.float32)))
    p = _tparams(arrs)
    m2d = torch.zeros((n, 2), requires_grad=True)
    mc, qc = transform_to_frame(p.means3d, p.unnorm_rotations,
                                *[torch.tensor(x) for x in IDENT],
                                gaussians_grad=True, camera_grad=False)
    cfg = R.RasterConfig(**base)
    if subset:
        out, _, _ = R.render_tiles_subset(
            mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
            torch.tensor(alive), torch.tensor(sel).long(), tb, cam, cfg,
            live_grad_cols=R.MAPPING_LIVE_COLS, means2d_offset=m2d)
    else:
        im, d, sil, dsq, _ = R.render_rgbd_sil(
            mc, qc, p.log_scales, p.logit_opacities, p.rgb_colors,
            torch.tensor(alive), cam, cfg, means2d_offset=m2d)
        out = torch.cat([im, d, sil[None], dsq])[:5]
    (tg,) = torch.autograd.grad((out * torch.tensor(w)).sum(), m2d)
    return tg.numpy(), jg


@pytest.mark.parametrize("subset", [False, True],
                         ids=["whole_image", "tile_subset"])
def test_means2d_offset_gradient_matches_reference(subset):
    """d loss / d(u, v): 1e-4 of its max, with a non-zero signal on the
    rendered rows and none on the dead ones."""
    tg, jg = _m2d_grads(subset)
    scale = np.abs(jg).max()
    assert scale > 0
    np.testing.assert_allclose(tg / scale, jg / scale, atol=1e-4)
    assert not tg[-7:].any()


# ---------------------------------------------------------------- mapping
N_ITERS = 6


def test_map_frame_densification_matches_reference():
    """map_frame with use_densification over 2 keyframes (densify at
    iterations 2 and 4) on the reference's own iso pool, iso samples and
    split noise (injected). The first iteration's losses agree to 1e-4,
    later ones to 1e-2; rows cloned / split / alive exactly; parameters
    within two learning rates per iteration and 95% of them within 0.05 of
    one (Adam at eps 1e-15, as tests/test_torch_subset.py holds the
    mapper)."""
    js, ts, jcam, cam, (kf_c, kf_d, kf_q, kf_t) = _map_inputs()
    iter_slots = np.array([0, 1, 1, 0, 1, 0], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), N_ITERS)
    cap = ts.capacity
    pool_key = jax.random.fold_in(keys[0], 0x150)
    scores = (jax.random.uniform(pool_key, (cap,))
              + jnp.where(js.alive, 0.0, 2.0))
    pool_q = np.array(jax.lax.top_k(-scores, 512)[1])
    sels = [np.array(jax.random.randint(k, (256,), 0, 512)) for k in keys]
    noise = [_split_noise(jax.random.split(k)[0], 2, cap) for k in keys]
    dkw = dict(start_after=2, remove_big_after=10 ** 6, stop_after=10 ** 6,
               densify_every=2, grad_thresh=2e-5, reset_opacities=False)
    mkw = dict(num_iters=N_ITERS, use_densification=True, **LR_MAP)
    rkw = dict(max_per_tile=MK, grad_scatter_bf16=False)
    js1, jlog, jstats = JM.map_frame(
        js, jnp.asarray(kf_c), jnp.asarray(kf_d), jnp.asarray(kf_q),
        jnp.asarray(kf_t), jnp.asarray(iter_slots), keys, jcam,
        JR.RasterConfig(backend="xla", **rkw), JL.LossConfig(**ISO_LOSS),
        JM.MappingConfig(prune=JM.PruneConfig(*PRUNE),
                         densify=JD.DensifyConfig(**dkw), **mkw))
    ts1, tlog, tstats = M.map_frame(
        ts, torch.tensor(kf_c), torch.tensor(kf_d), torch.tensor(kf_q),
        torch.tensor(kf_t), iter_slots, cam, R.RasterConfig(**rkw),
        L.LossConfig(**ISO_LOSS),
        M.MappingConfig(prune=M.PruneConfig(*PRUNE),
                        densify=D.DensifyConfig(**dkw), **mkw),
        pool_q_idx=torch.tensor(pool_q).long(),
        iso_sels=[torch.tensor(s).long() for s in sels], split_noise=noise)
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy()[0], jlog[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-2, atol=1e-4)
    assert tstats.shape == (6,)
    # the intersection totals may differ by a few rect-boundary rows (f32
    # rounding of u +- r at a tile edge); no true candidate is dropped
    assert int(tstats[0]) == int(jstats[0]) == 0
    np.testing.assert_allclose(tstats.numpy()[1:3], np.asarray(jstats)[1:],
                               rtol=1e-3)
    n_clone, n_split, dropped = (int(x) for x in tstats[3:])
    # this map's rows are all wider than 0.01 x the scene radius: splits
    assert n_split > 0 and dropped == 0
    assert int(ts1.hwm) == int(js1.hwm) == (int(ts.hwm) + n_clone
                                           + 2 * n_split)
    got = convert.state_to_arrays(ts1)
    ref = convert.state_to_arrays(convert.state_from_arrays(js1, "cpu"))
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["timestep"], ref["timestep"])
    lr = dict(means3d=1e-4, rgb_colors=2.5e-3, unnorm_rotations=1e-3,
              logit_opacities=5e-2, log_scales=1e-3)
    for k, v in lr.items():
        # a near-zero gradient of opposite sign in the two packages steps
        # a row by +lr in one and -lr in the other (eps 1e-15): two
        # learning rates per iteration at most
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=2 * N_ITERS * v + 1e-5, err_msg=k)
        # the bulk of the parameters agrees far inside that bound
        close = np.abs(got[k] - ref[k]) <= 0.05 * v + 1e-6
        assert close.mean() > 0.95, (k, close.mean())
