"""The algebra of the port's compositing backward (kernel B) on the CPU.

The CUDA kernel does not reduce ten gradient columns per (slot, pixel)
pair: it keeps two per-pair scalars (dpower, w), forms 11 sums over a
tile's pixels in tile-local coordinates and composes the columns per slot,
and it rejects most pairs without an exponential (power < log(1/255 / op)
- margin). `composite_bwd_moments` is that algebra in plain PyTorch; here
it is held against autograd through the plain forward
(`composite_bwd_plain`) and against the JAX package's Pallas kernel in
interpret mode, on the same numpy-seeded inputs, to the reference's
gradient tolerance (1e-4 of each column's max).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.ops.pallas_composite import composite_tiles as j_ct
from isogs_slam_tpu_torch.ops import composite as comp

F = 4


def _records(T, K, tiles_x, seed, kind="local", tiles=None):
    """Slot records for the tiles in `tiles` (default: all); the other
    tiles are empty. kind "local": footprints of a few pixels that land in
    their tile, opacities up to 1.2 so pixels terminate. kind "large":
    radius far above a tile (conic ~1e-4..1e-2) with centres up to
    hundreds of pixels away."""
    rng = np.random.default_rng(seed)
    g = np.zeros((T, K, 6 + F), np.float32)
    counts = np.zeros(T, np.int32)
    for t in (range(T) if tiles is None else tiles):
        ox, oy = (t % tiles_x) * 16, (t // tiles_x) * 16
        if kind == "local":
            g[t, :, 0] = rng.uniform(ox - 2, ox + 18, K)
            g[t, :, 1] = rng.uniform(oy - 2, oy + 18, K)
            g[t, :, 2] = rng.uniform(0.05, 0.6, K)
            g[t, :, 3] = rng.uniform(-0.05, 0.05, K)
            g[t, :, 4] = rng.uniform(0.05, 0.6, K)
            g[t, :, 5] = rng.uniform(0.0, 1.2, K)
        else:
            g[t, :, 0] = ox + rng.uniform(-300, 300, K)
            g[t, :, 1] = oy + rng.uniform(-300, 300, K)
            a = 10 ** rng.uniform(-4, -2, K)
            c = 10 ** rng.uniform(-4, -2, K)
            g[t, :, 2], g[t, :, 4] = a, c
            g[t, :, 3] = rng.uniform(-0.95, 0.95, K) * np.sqrt(a * c)
            g[t, :, 5] = rng.uniform(0.0, 0.6, K)
        g[t, :, 6:] = rng.uniform(0, 2, (K, F))
        counts[t] = rng.integers(K // 2, K + 1)
    return g, counts


def _cotangents(T, sq_col, seed):
    rng = np.random.default_rng(seed)
    Fo = F + (sq_col is not None)
    return (rng.normal(size=(T, 256, Fo)).astype(np.float32),
            rng.normal(size=(T, 256)).astype(np.float32))


def _col_err(got, ref):
    scale = np.abs(ref).max(axis=(0, 1))
    return np.abs(got - ref).max(axis=(0, 1)) / np.maximum(scale, 1e-30)


CASES = {
    # name: (T, K, tiles_x, kind, tiles)
    "local": (8, 256, 4, "local", None),
    # tile 74 of a 75-tile row: pixel origin x = 1184, centres u ~ 1190
    "far_from_origin": (76, 128, 75, "local", [0, 73, 74, 75]),
    "large_gaussians": (6, 128, 3, "large", None),
    "large_far": (76, 128, 75, "large", [74, 75]),
}


@pytest.mark.parametrize("sq_col", [3, None])
@pytest.mark.parametrize("case", list(CASES))
def test_moments_backward_matches_plain(case, sq_col):
    T, K, tx, kind, tiles = CASES[case]
    g, counts = _records(T, K, tx, seed=11, kind=kind, tiles=tiles)
    wo, wt = _cotangents(T, sq_col, seed=12)
    args = (torch.tensor(g), torch.tensor(counts), torch.tensor(wo),
            torch.tensor(wt), F, tx, sq_col)
    ref = comp.composite_bwd_plain(*args, chunk=4).numpy()
    got = comp.composite_bwd_moments(*args, chunk=4).numpy()
    assert np.abs(ref).max() > 0
    err = _col_err(got, ref)
    assert err.max() < 1e-4, err
    # rows at or past a tile's count carry zeros
    past = np.arange(K)[None, :] >= counts[:, None]
    assert np.all(got[past] == 0)


@pytest.mark.parametrize("case", ["local", "far_from_origin",
                                  "large_gaussians"])
def test_moments_backward_matches_pallas_interpret(case):
    T, K, tx, kind, tiles = CASES[case]
    g, counts = _records(T, K, tx, seed=21, kind=kind, tiles=tiles)
    wo, wt = _cotangents(T, 3, seed=22)

    def jloss(gd):
        out, ft = j_ct(gd, jnp.asarray(counts), F, tx, True, 3)
        return jnp.sum(out * wo) + jnp.sum(ft * wt)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(g)))
    got = comp.composite_bwd_moments(
        torch.tensor(g), torch.tensor(counts), torch.tensor(wo),
        torch.tensor(wt), F, tx, 3, chunk=4).numpy()
    err = _col_err(got, ref)
    assert err.max() < 1e-4, err


def test_moments_backward_bf16_output():
    T, K, tx, kind, tiles = CASES["local"]
    g, counts = _records(T, K, tx, seed=31, kind=kind, tiles=tiles)
    wo, wt = _cotangents(T, 3, seed=32)
    args = (torch.tensor(g), torch.tensor(counts), torch.tensor(wo),
            torch.tensor(wt), F, tx, 3)
    ref = comp.composite_bwd_plain(*args, out_dtype=torch.bfloat16)
    got = comp.composite_bwd_moments(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the column max
    err = _col_err(got.float().numpy(), ref.float().numpy())
    assert err.max() < 2 ** -7, err


@pytest.mark.parametrize("case", list(CASES))
def test_prereject_keeps_the_contributing_set(case):
    """Neither the exp-free reject test nor the block cull ever changes
    which pairs contribute:
    exact set equality with the plain version's mask, with opacities
    at, just around and below 1/255 and at 0 mixed in."""
    T, K, tx, kind, tiles = CASES[case]
    g, counts = _records(T, K, tx, seed=41, kind=kind, tiles=tiles)
    lo = np.float32(1.0 / 255.0)
    edge = [0.0, lo, np.nextafter(lo, np.float32(0)),
            np.nextafter(lo, np.float32(1)), 0.5 * lo, 1e-6, 1.0]
    g[:, ::5, 5] = np.resize(np.array(edge, np.float32), g[:, ::5, 5].shape)
    gt, ct = torch.tensor(g), torch.tensor(counts)
    ox, oy = comp._origins(T, tx, gt.device)
    power, alpha, contrib = comp._pair_alpha(gt, ct, ox, oy)
    kept = comp.prereject_contrib(power, alpha, contrib, gt[..., 5])
    assert int(contrib.sum()) > 0
    assert torch.equal(kept, contrib)
    # nor does the cull of whole 8x4 pixel blocks, which does cut work
    passed = comp.block_cull_pass(gt, ox, oy)
    assert torch.equal(kept & passed, contrib)
    if kind == "local":
        assert float(passed[ct > 0].float().mean()) < 0.8
    # and the test does reject most non-contributing pairs without alpha
    pmin = torch.log(comp.ALPHA_MIN / gt[..., 5]) - comp.PMIN_MARGIN
    early = ~(power >= pmin[:, :, None]) | (power > 0)
    valid = (torch.arange(K)[None, :] < ct[:, None])[:, :, None]
    rejected = ~contrib & valid
    assert int((early & rejected).sum()) >= 0.99 * int(rejected.sum())
