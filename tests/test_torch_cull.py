"""The port's output-preserving binning knobs against the JAX package:
`tile_cull` (cull_tile_slots: the exact minimum of the conic form over the
tile box) and `tight_rect` (contribution-ellipse tile rects).

Tolerances: tile lists equal as sets with equal counts (neither package's
sort is declared stable across packages; K covers every candidate); images
1e-5; gradients 1e-4 of each parameter's max (the reference's own, in
tests/test_tile_cull.py and tests/test_tight_rect.py they are 1e-5 / 1e-6
within one package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.core.camera import Camera as JCamera
from isogs_slam_tpu.ops import rasterize as JR
from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops import rasterize as R

CAM = dict(width=96, height=64, fx=70.0, fy=70.0, cx=48.0, cy=32.0)
K = 512
CAP = 16384     # intersection capacity that holds every (gaussian, tile)
# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


def _scene(n=500, seed=11, aniso=True):
    """The reference's cull-test scene (camera frame): aniso=True makes
    flake-like splats, whose conics waste most of their radius square."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * np.array([0.9, 0.6, 0.4])
             + np.array([0, 0, 2.2])).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    s = rng.uniform(0.05, 0.35, size=(n, 3))
    if aniso:
        s[:, 0] *= 0.05
    logit_op = rng.normal(size=(n, 1)).astype(np.float32)
    logit_op[:20] -= 6.0        # some under 1/255: tight_rect drops them
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    alive = np.arange(n) < (n - 5)
    return [means, quats, np.log(s).astype(np.float32), logit_op, rgb], alive


def _jbin(arrs, alive, cfg, emit_exp, **kw):
    cam = JCamera(**CAM)

    def f(m, q, s, lo):
        proj = JR.project_gaussians(m, q, s, jnp.asarray(alive), cam,
                                    margin_px=kw.get("cull_slack_px", 0.0))
        return JR.bin_gaussians(proj, cam, cfg, emit_exp=emit_exp,
                                opacity=jax.nn.sigmoid(lo[:, 0]), **kw)
    return jax.jit(f)(*[jnp.asarray(a) for a in arrs[:4]])


def _tbin(arrs, alive, cfg, emit_exp, **kw):
    cam = Camera(**CAM)
    m, q, s, lo = [torch.tensor(a) for a in arrs[:4]]
    proj = R.project_gaussians(m, q, s, torch.tensor(alive), cam,
                               margin_px=kw.get("cull_slack_px", 0.0))
    return R.bin_gaussians(proj, cam, cfg, emit_exp=emit_exp,
                           opacity=torch.sigmoid(lo[:, 0]), **kw)


@pytest.mark.parametrize("budget", [
    {}, dict(cull_slack_px=4.0, cull_logit_drift=0.8)],
    ids=["no_drift", "drift"])
@pytest.mark.parametrize("knob", ["tile_cull", "tight_rect", "both"])
def test_cull_and_tight_rect_binning_match_reference(knob, budget):
    """Same counts, same (gaussian, expansion position) sets per tile, the
    sentinel beyond every count, the same intersection total; and the knob
    really removed slots."""
    arrs, alive = _scene()
    on = dict(tile_cull=knob in ("tile_cull", "both"),
              tight_rect=knob in ("tight_rect", "both"),
              cull_q_slack=1.5 if budget else 1.0)
    jb = _jbin(arrs, alive, JR.RasterConfig(max_per_tile=K, max_isect_cap=CAP,
                                            backend="xla", **on), True, **budget)
    tb = _tbin(arrs, alive, R.RasterConfig(max_per_tile=K, max_isect_cap=CAP,
                                           **on), True,
               **budget)
    plain = _tbin(arrs, alive, R.RasterConfig(max_per_tile=K,
                                              max_isect_cap=CAP), True,
                  **budget)
    assert int(plain.n_overflow) == 0
    counts = np.asarray(jb.tile_count)
    np.testing.assert_array_equal(tb.tile_count.numpy(), counts)
    assert int(tb.n_isect) == int(jb.n_isect)
    assert int(tb.tile_count.sum()) < int(plain.tile_count.sum())
    if on["tight_rect"]:
        assert int(tb.n_isect) < int(plain.n_isect)
    np.testing.assert_array_equal(tb.exp_offsets.numpy(),
                                  np.asarray(jb.exp_offsets))
    jg, jpos = np.asarray(jb.tile_gauss), np.asarray(jb.slot_exp_pos)
    tg, tpos = tb.tile_gauss.numpy(), tb.slot_exp_pos.numpy()
    M = CAP
    for t, c in enumerate(counts):
        assert set(zip(tg[t, :c], tpos[t, :c])) == \
            set(zip(jg[t, :c], jpos[t, :c])), t
        assert np.all(tpos[t, c:] == M)
    # the compaction keeps the depth order: the kept slots' expansion
    # positions appear in the plain binning's order
    pp = plain.slot_exp_pos.numpy()
    if knob == "tile_cull":
        for t, c in enumerate(counts):
            kept = [p for p in pp[t] if p in set(tpos[t, :c])]
            assert kept == list(tpos[t, :c]), t


def test_min_q_box_matches_reference_and_brute_force():
    """_min_q_box equal to the JAX function (1e-5 relative) and a lower
    bound of q on a dense sampling of the box that it nearly attains."""
    rng = np.random.default_rng(0)
    n = 300
    u, v = rng.uniform(-20, 60, n), rng.uniform(-20, 60, n)
    a, c = rng.uniform(0.01, 0.5, n), rng.uniform(0.01, 0.5, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    box = (16.0, 31.0, 16.0, 31.0)
    args = [x.astype(np.float32) for x in (u, v, a, b, c)]
    ref = np.asarray(JR._min_q_box(*[jnp.asarray(x) for x in args], *box))
    got = R._min_q_box(*[torch.tensor(x) for x in args],
                       *[torch.tensor(x) for x in box]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    gx, gy = np.meshgrid(np.linspace(16, 31, 61), np.linspace(16, 31, 61))
    dx, dy = gx[None] - u[:, None, None], gy[None] - v[:, None, None]
    q = (a[:, None, None] * dx * dx + 2 * b[:, None, None] * dx * dy
         + c[:, None, None] * dy * dy).reshape(n, -1).min(1)
    assert np.all(got <= q * (1 + 1e-4) + 1e-4)
    assert np.all(got >= q - 0.05 * np.maximum(q, 1.0))


def _tloss(arrs, alive, cfg, binning):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    im, depth, sil, dsq, _ = R.render_rgbd_sil(
        *leaves, torch.tensor(alive), Camera(**CAM), cfg, binning=binning)
    loss = ((im * im).sum() + depth.abs().sum() + (sil ** 3).sum()
            + dsq.sum())
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), [g.numpy() for g in grads],
            torch.cat([im, depth, sil[None], dsq]).detach().numpy())


@pytest.mark.parametrize("bwd_mode", ["scatter", "segreduce"])
@pytest.mark.parametrize("knob", ["tile_cull", "tight_rect"])
def test_cull_and_tight_rect_preserve_image_and_grads(knob, bwd_mode):
    """Rendering against the culled / tight binning gives the plain
    binning's image (1e-5) and parameter gradients (1e-4 of max), by both
    backward routes; and the JAX package's loss and gradients with the
    same knob agree with the port's."""
    arrs, alive = _scene()
    emit = bwd_mode == "segreduce"
    base = dict(max_per_tile=K, max_isect_cap=CAP, bwd_mode=bwd_mode,
                grad_scatter_bf16=False)
    on = {knob: True, "cull_q_slack": 1.0}
    cfg0, cfg1 = R.RasterConfig(**base), R.RasterConfig(**base, **on)
    l0, g0, img0 = _tloss(arrs, alive, cfg0, _tbin(arrs, alive, cfg0, emit))
    l1, g1, img1 = _tloss(arrs, alive, cfg1, _tbin(arrs, alive, cfg1, emit))
    np.testing.assert_allclose(img1, img0, atol=1e-5)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    names = ["means", "quats", "scales", "op", "rgb"]
    for a, b, name in zip(g0, g1, names):
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4,
                                   err_msg=name)
    assert np.abs(g1[0]).sum() > 0

    jcfg = JR.RasterConfig(backend="xla", **base, **on)
    jcam = JCamera(**CAM)

    def jloss(params):
        frozen = jax.tree.map(jax.lax.stop_gradient, params)
        proj = JR.project_gaussians(*frozen[:3], jnp.asarray(alive), jcam)
        binning = JR.bin_gaussians(
            proj, jcam, jcfg, emit_exp=emit,
            opacity=jax.nn.sigmoid(frozen[3][:, 0]))
        im, depth, sil, dsq, _ = JR.render_rgbd_sil(
            *params, jnp.asarray(alive), jcam, jcfg, binning=binning)
        return (jnp.sum(im * im) + jnp.sum(jnp.abs(depth))
                + jnp.sum(sil ** 3) + jnp.sum(dsq))

    lj, gj = jax.jit(jax.value_and_grad(jloss))(
        tuple(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(l1, float(lj), rtol=1e-5)
    for a, b, name in zip(gj, g1, names):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4,
                                   err_msg=name)


def test_batched_binning_equals_serial():
    """bin_gaussians_batched of three poses' projections, with both knobs
    on, equals three serial binnings: counts, counters, offsets, and the
    slots below each count (the slots past it are masked by every
    consumer)."""
    arrs, alive = _scene(n=400, seed=5)
    cam = Camera(**CAM)
    m, q, s, lo = [torch.tensor(a) for a in arrs[:4]]
    op = torch.sigmoid(lo[:, 0])
    cfg = R.RasterConfig(max_per_tile=64, tile_cull=True, tight_rect=True,
                         max_isect_cap=2048)
    projs = [R.project_gaussians(m + torch.tensor(d), q, s,
                                 torch.tensor(alive), cam)
             for d in ([0, 0, 0.0], [0.2, 0, 0.1], [-0.3, 0.1, 0.4])]
    kw = dict(emit_exp=True, opacity=op, cull_logit_drift=0.5)
    serial = [R.bin_gaussians(p, cam, cfg, **kw) for p in projs]
    batched = R.bin_gaussians_batched(projs, cam, cfg, **kw)
    assert sum(int(b.n_overflow) for b in serial) > 0   # both caps bite
    for a, b in zip(serial, batched):
        np.testing.assert_array_equal(a.tile_count.numpy(),
                                      b.tile_count.numpy())
        for f in ("n_isect", "n_overflow", "n_true_overflow"):
            assert int(getattr(a, f)) == int(getattr(b, f)), f
        np.testing.assert_array_equal(a.exp_offsets.numpy(),
                                      b.exp_offsets.numpy())
        np.testing.assert_array_equal(a.slot_exp_pos.numpy(),
                                      b.slot_exp_pos.numpy())
        live = (torch.arange(64)[None, :] < a.tile_count[:, None]).numpy()
        np.testing.assert_array_equal(a.tile_gauss.numpy()[live],
                                      b.tile_gauss.numpy()[live])
