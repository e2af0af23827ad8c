"""The port's tile binning against an independent binning written as a
Python loop: each Gaussian's tiles listed one by one, each tile's list
sorted by (margin bit, quantized depth, row) and cut at K slots and at the
intersection capacity. On the CPU this holds the eager chain that is the
plain version of kernel pair Q (csrc/bin.cu); tests/test_torch_cuda.py
holds Q to that chain bit for bit on the card.
"""
import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.core.camera import Camera
from isogs_slam_tpu_torch.ops import rasterize as R

CAM = dict(width=72, height=40, fx=60.0, fy=60.0, cx=36.0, cy=20.0)


def _proj(seed, margin):
    """A small scene's projection: dead rows, a row behind the camera,
    rows off the image and one row near the camera that covers the whole
    grid."""
    rng = np.random.default_rng(seed)
    n = 500
    means = (rng.normal(size=(n, 3)) * np.array([1.0, 0.6, 0.4])
             + np.array([0, 0, 2.2])).astype(np.float32)
    means[1] = [0.0, 0.0, -1.0]
    means[2:6, 0] = [30.0, -30.0, 40.0, -40.0]
    means[6] = [0.0, 0.0, 0.5]
    scales = rng.uniform(0.02, 0.15, size=(n, 3))
    scales[6] = 3.0
    alive = torch.as_tensor(np.arange(n) < n - 9)
    return R.project_gaussians(
        torch.as_tensor(means), torch.as_tensor(
            rng.normal(size=(n, 4)).astype(np.float32)),
        torch.as_tensor(np.log(scales).astype(np.float32)), alive,
        Camera(**CAM), margin_px=margin)


def _loop_binning(proj, cam, K, M):
    """(counts [T], lists {tile: [(row, expansion position)]}, total,
    K-cap drops, margin-free K-cap drops), one Gaussian at a time."""
    T = cam.num_tiles
    db = max(min(32 - int(T + 1).bit_length(), 24), 8)
    u = proj.u.detach().numpy().astype(np.float32)
    v = proj.v.detach().numpy().astype(np.float32)
    rad = proj.radius.numpy().astype(np.float32)
    valid = proj.valid.numpy()
    depth = proj.depth.detach()
    zn, zf = 0.2, 1000.0
    qz = ((torch.log(torch.clamp(depth, zn, zf) / zn)
           / float(np.log(zf / zn))) * ((1 << (db - 1)) - 1)).long().numpy()
    f16, one = np.float32(16), np.float32(1)

    def rect(i, r):
        lo = [int(np.clip(np.floor((c - r) / f16), 0, g))
              for c, g in ((u[i], cam.tiles_x), (v[i], cam.tiles_y))]
        hi = [int(np.clip(np.floor((c + r + f16 - one) / f16), 0, g))
              for c, g in ((u[i], cam.tiles_x), (v[i], cam.tiles_y))]
        return lo, hi

    cands = {t: [] for t in range(T)}
    pos = 0
    for i in range(u.shape[0]):
        if not valid[i]:
            continue
        (x0, y0), (x1, y1) = rect(i, rad[i] + np.float32(proj.margin_px))
        (a0, b0), (a1, b1) = rect(i, rad[i])
        for ty in range(y0, y1):
            for tx in range(x0, x1):
                if pos < M:
                    outside = not (a0 <= tx < a1 and b0 <= ty < b1)
                    cands[ty * cam.tiles_x + tx].append(
                        (int(outside), int(qz[i]), i, pos))
                pos += 1
    counts = np.zeros(T, np.int64)
    lists, dropped, true_dropped = {}, 0, 0
    for t, c in cands.items():
        c.sort()
        counts[t] = min(len(c), K)
        lists[t] = [(i, p) for _, _, i, p in c[:K]]
        dropped += max(len(c) - K, 0)
        true_dropped += max(sum(1 for m, *_ in c if not m) - K, 0)
    return counts, lists, pos, dropped, true_dropped


@pytest.mark.parametrize("K,margin,cap,S", [
    (128, 0.0, 0, 1), (128, 6.0, 0, 1), (8, 0.0, 0, 1), (128, 6.0, 1024, 1),
    (8, 6.0, 0, 3)])
def test_binning_matches_loop_binning(K, margin, cap, S):
    """tile_count, the tile lists and expansion positions below the count
    (the sentinel M above it), the overflow counters, the int32 dtypes,
    and a Projected that carries no tile rects; S > 1 through
    bin_gaussians_batched, one sort for S projections."""
    cam = Camera(**CAM)
    cfg = R.RasterConfig(max_per_tile=K, max_isect_cap=cap)
    projs = [_proj(seed, margin) for seed in range(S)]
    assert not any("rect" in f for f in R.Projected._fields)
    bins = R.bin_gaussians_batched(projs, cam, cfg, emit_exp=True)
    M = cfg.max_isect(projs[0].u.shape[0])
    for proj, b in zip(projs, bins):
        counts, lists, total, dropped, true_dropped = _loop_binning(
            proj, cam, K, M)
        assert b.tile_gauss.dtype == torch.int32
        assert b.slot_exp_pos.dtype == torch.int32
        assert b.exp_offsets.dtype == torch.int32
        np.testing.assert_array_equal(b.tile_count.numpy(), counts)
        assert int(b.n_isect) == total
        assert int(b.n_overflow) == max(total - M, 0) + dropped
        assert int(b.n_true_overflow) == true_dropped
        if cap:
            assert total > M
        if K == 8:
            assert dropped > 0
        tg, tp = b.tile_gauss.numpy(), b.slot_exp_pos.numpy()
        for t, c in enumerate(counts):
            assert list(zip(tg[t, :c], tp[t, :c])) == lists[t], t
            assert np.all(tp[t, c:] == M)
    # the whole-grid row lands in every tile
    assert int(projs[0].radius[6]) > 16 * max(cam.tiles_x, cam.tiles_y)
    assert all(6 in bins[0].tile_gauss[t, :c].tolist()
               for t, c in enumerate(bins[0].tile_count.tolist()) if c < K)
