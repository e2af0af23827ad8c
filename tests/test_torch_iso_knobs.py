"""The iso-KNN knobs of the port against the JAX package: the exact
streaming KNN (knn_blocked), the exact pool, the fresh-KNN iso loss
(iso_pool_size = 0) by hash and by exact KNN, and the pipeline's pool kept
across phases (mapping.iso_pool_refresh_phases).

Points are continuous random draws, so no two distances tie and the k
nearest sets are unique (torch.topk and lax.top_k order ties
differently). Tolerances are stated at each assert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isogs_slam_tpu.ops import iso_loss as JI
from isogs_slam_tpu_torch.core import gaussians as G
from isogs_slam_tpu_torch.ops import iso_loss as I
from isogs_slam_tpu_torch.slam import pipeline as P
from isogs_slam_tpu_torch.slam.config import inject_defaults
from test_torch_pipeline import _config, _frames

# toy sizes: PyTorch's intra-op thread pool buys nothing here and only
# contends with the other test workers
torch.set_num_threads(1)


def _points(n, seed, dead=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    if dead:
        alive[rng.choice(n, dead, replace=False)] = False
    return pts, alive


@pytest.mark.parametrize("block", [64, 1000])
def test_knn_blocked_matches_reference_and_brute_force(block):
    """The same k nearest sets as the JAX function and as a float64 brute
    force (continuous points: no ties), dead rows never chosen, distances
    1e-5 of the reference's."""
    pts, alive = _points(700, 0, dead=50)
    q = np.random.default_rng(1).uniform(-1, 1, (90, 3)).astype(np.float32)
    k = 8
    d_t, i_t = I.knn_blocked(torch.tensor(q), torch.tensor(pts),
                             torch.tensor(alive), k, block)
    d_j, i_j = jax.jit(JI.knn_blocked, static_argnums=(3, 4))(
        jnp.asarray(q), jnp.asarray(pts), jnp.asarray(alive), k, block)
    d64 = ((q[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    d64[:, ~alive] = np.inf
    brute = np.argsort(d64, axis=1)[:, :k]
    i_t = i_t.numpy()
    for r in range(q.shape[0]):
        assert set(i_t[r]) == set(np.asarray(i_j)[r]) == set(brute[r])
    assert alive[i_t].all()
    np.testing.assert_allclose(np.sort(d_t.numpy(), 1),
                               np.sort(np.asarray(d_j), 1), rtol=1e-5,
                               atol=1e-6)


def test_exact_pool_matches_reference():
    """build_iso_knn_pool(knn_method="exact") on the reference's own query
    rows: the same neighbour set per query (as sets), every one finite."""
    pts, alive = _points(600, 2, dead=40)
    ls = np.full((600, 3), -3.0, np.float32)
    key = jax.random.PRNGKey(3)
    jp = JI.build_iso_knn_pool(jnp.asarray(pts), jnp.asarray(ls),
                               jnp.asarray(alive), key, pool_size=128, k=8,
                               knn_method="exact", knn_block=256)
    tp = I.build_iso_knn_pool(torch.tensor(pts), torch.tensor(ls),
                              torch.tensor(alive), 128, 8,
                              q_idx=torch.tensor(np.asarray(jp.q_idx)).long(),
                              knn_method="exact", knn_block=256)
    assert alive[np.asarray(jp.q_idx)].all()
    np.testing.assert_array_equal(tp.nbr_ok.numpy(), np.asarray(jp.nbr_ok))
    for a, b in zip(tp.nbr.numpy(), np.asarray(jp.nbr)):
        assert set(a) == set(b)


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        means=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        rots=rng.normal(size=(n, 4)).astype(np.float32),
        scales=np.log(rng.uniform(0.02, 0.08, (n, 3))).astype(np.float32),
        ops=rng.normal(size=(n, 1)).astype(np.float32))


@pytest.mark.parametrize("method", ["hash", "exact"])
def test_fresh_knn_iso_loss_matches_reference(method):
    """iso_surface_loss without a pool (iso_pool_size = 0): with
    sample_size >= C every alive row is a query whatever the draws, so the
    two packages evaluate the same density sum; loss and mean density 1e-5
    relative, gradients 1e-4 of each parameter's max."""
    n = 400
    g = _gaussians(n, 4)
    alive = np.arange(n) < n - 25
    kw = dict(sample_size=512, k=8, knn_method=method, hash_cap=24,
              knn_block=128)

    def jf(m, q, s, o):
        return JI.iso_surface_loss(m, q, s, o, jnp.asarray(alive),
                                   jax.random.PRNGKey(0), **kw)

    args = [jnp.asarray(g[k]) for k in ("means", "rots", "scales", "ops")]
    (jl, jd), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    leaves = [torch.tensor(g[k], requires_grad=True)
              for k in ("means", "rots", "scales", "ops")]
    tl, td = I.iso_surface_loss(*leaves, torch.tensor(alive), None,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    tg = torch.autograd.grad(tl, leaves)
    assert float(jl) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(td.detach()), float(jd), rtol=1e-5)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(),
                                   b / np.abs(b).max(), atol=1e-4)


def _slam(tmp_path, refresh):
    cfg = inject_defaults(_config(tmp_path, f"pool{refresh}"))
    cfg["mapping"]["iso_pool_refresh_phases"] = refresh
    slam = P.SLAM(cfg, dataset=_frames())
    slam.initialize_first_frame(*_frames()[0][:2])
    return slam


def test_phase_iso_pool_refresh_and_invalidation(tmp_path):
    """refresh = 1 (the default): map_frame builds its own pool (None
    here). refresh = 2: one pool serves two phases, the third builds anew;
    a compaction or a capacity growth drops the kept pool (rows moved)."""
    assert _slam(tmp_path, 1)._phase_iso_pool() is None
    slam = _slam(tmp_path, 2)
    p1 = slam._phase_iso_pool()
    assert isinstance(p1, I.IsoKnnPool)
    assert p1.q_idx.shape[0] == slam.lcfg_map.iso_pool_size
    assert bool(slam.state.alive[p1.q_idx].all())
    assert slam._phase_iso_pool() is p1
    p3 = slam._phase_iso_pool()
    assert p3 is not p1 and slam._iso_pool_age == 1
    # prune half, then ask for more room than is free: a compaction
    slam.state = G.prune(slam.state, (torch.arange(slam.state.capacity) % 2
                                      == 0) & slam.state.alive)
    cap = slam.state.capacity
    slam._ensure_capacity(cap - int(slam.state.hwm) + 10)
    assert slam.events["compactions"] and slam._iso_pool is None
    p4 = slam._phase_iso_pool()
    assert p4 is not p3
    slam._ensure_capacity(2 * cap)                # cannot fit: growth
    assert slam.state.capacity > cap and slam._iso_pool is None
    assert slam._phase_iso_pool() is not p4
