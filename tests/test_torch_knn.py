"""The hash grid's K-nearest query (ops/spatial_hash.py) against a
Python-loop statement of its contract, on toy grids that plant each of
its rules: hash collisions, buckets longer than `cap`, cells that alias
outside [-512, 511], duplicate points (tied distances), queries with
fewer than k neighbours and dead rows. The same contract holds kernel K
on the card (tests/test_torch_cuda.py), with the order and rows the
card's topk gives tied and missing neighbours (card_topk, card_order).
Also: the iso loss and its gradients do not depend on the row a missing
neighbour names."""
import numpy as np
import pytest
import torch

from isogs_slam_tpu_torch.ops import spatial_hash as SH
from isogs_slam_tpu_torch.ops.iso_loss import IsoKnnPool, iso_surface_loss
from isogs_slam_tpu_torch.utils import spans

_P = (73856093, 19349663, 83492791)


def _cell(p, cs):
    return [int(np.floor(np.float32(v) / cs)) for v in p]


def _pack(c):
    c = [min(max(int(v) + 512, 0), 1023) for v in c]
    return c[0] | (c[1] << 10) | (c[2] << 20)


def _neighbour_buckets(grid, q):
    """(neighbour index, cell, bucket start, bucket end) of the 27
    neighbour cells of query q, dx slowest."""
    cs = np.float32(float(grid.cell_size))
    starts = grid.starts.cpu().numpy()
    ends = grid.ends.cpu().numpy()
    qc = _cell(q, cs)
    o = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nc = [qc[0] + dx, qc[1] + dy, qc[2] + dz]
                h = ((nc[0] * _P[0]) ^ (nc[1] * _P[1])
                     ^ (nc[2] * _P[2])) & (grid.table_size - 1)
                yield o, nc, int(starts[h]), int(ends[h])
                o += 1


def contract_knn(grid, queries, k, cap, sum_order="abc"):
    """The query's contract, one candidate at a time. For each query: its
    cell floor(q / cell) in f32; the 27 neighbour cells, dx slowest; each
    one's bucket h = (cx P1 ^ cy P2 ^ cz P3) & (table_size - 1) and its
    first `cap` positions of the hash-sorted rows; a position counts if it
    lies below the bucket's end and its row's cell, packed with
    clamp(c + 512, 0, 1023) an axis, is the neighbour cell's (so rows of
    other cells sharing the bucket use positions up, and far cells alias).
    d2 = |p - q|^2 in f32, summed (dx^2 + dy^2) + dz^2 ("abc", PyTorch's
    order on the CPU) or (dx^2 + dz^2) + dy^2 ("acb", on the card). Returns
    per query every counting candidate as (d2, candidate position = cell
    index x cap + slot, original row), ascending by (d2, position); the
    answer is the k smallest d2, +inf past the counting candidates."""
    pts = grid.points.cpu().numpy().astype(np.float32)
    order = grid.order.cpu().numpy()
    cs = np.float32(float(grid.cell_size))
    out = []
    for q in queries.cpu().numpy().astype(np.float32):
        cands = []
        for o, nc, s, e in _neighbour_buckets(grid, q):
            for j in range(cap):
                pos = s + j
                if pos < e and _pack(_cell(pts[pos], cs)) == _pack(nc):
                    d = pts[pos] - q
                    sq = d * d
                    d2 = ((sq[0] + sq[1]) + sq[2] if sum_order == "abc"
                          else (sq[0] + sq[2]) + sq[1])
                    cands.append((np.float32(d2), o * cap + j,
                                  int(order[pos])))
        cands.sort(key=lambda c: (c[0], c[1]))
        out.append(cands)
    return out


def position_rows(grid, queries, cap):
    """[Q, 27 cap] the row the eager chain names at each candidate
    position, counting or not: the sorted row at the neighbour cell's
    bucket start + slot, 0 past the last row."""
    order = grid.order.cpu().numpy()
    C = order.shape[0]
    rows = np.zeros((queries.shape[0], 27 * cap), np.int64)
    for r, q in enumerate(queries.cpu().numpy().astype(np.float32)):
        for o, _, s, _ in _neighbour_buckets(grid, q):
            for j in range(cap):
                rows[r, o * cap + j] = order[s + j] if s + j < C else 0
    return rows


def assert_knn_matches(d2, idx, cands, k):
    """(d2, idx) [Q, k] against the contract's candidate lists: the
    distances bit for bit, +inf past the counting candidates; where the
    distances are distinct the rows in order; on a tie the rows as a set
    (a tie cut by the k-th place: a subset of the tied rows, as many as
    the contract keeps)."""
    d2, idx = d2.cpu(), idx.cpu()
    for r, cs in enumerate(cands):
        want = np.full(k, np.inf, np.float32)
        n = min(k, len(cs))
        want[:n] = [c[0] for c in cs[:n]]
        got = d2[r].numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), r
        rows = idx[r].tolist()
        for v in set(want[:n].tolist()):
            kept = [c[2] for c in cs[:n] if c[0] == v]
            tied = {c[2] for c in cs if c[0] == v}
            mine = [i for i, x in zip(rows, got) if x == v]
            assert len(mine) == len(kept) and set(mine) <= tied, (r, v)
            if len(kept) == len([c for c in cs if c[0] == v]):
                assert sorted(mine) == sorted(kept), (r, v)


def card_topk(values, k):
    """torch.topk(values, k) (largest, sorted) on the card, for k <= 32,
    in numpy: per row the entries above the k-th value in index order,
    then those equal to it in index order until there are k, then ATen's
    32-wide bitonic sort (SortUtils.cuh bitonicSort, GTOp, the rest
    invalid), which does not keep the order of equal values. Returns
    (values [R, k], indices [R, k])."""
    R, L = values.shape
    kth = -np.sort(-values, axis=1)[:, k - 1:k]
    group = np.where(values > kth, 0, np.where(values == kth, 1, 2))
    order = np.argsort(group, axis=1, kind="stable")[:, :k]
    keys = np.zeros((R, 32), values.dtype)
    idx = np.zeros((R, 32), np.int64)
    valid = np.zeros((R, 32), bool)
    keys[:, :k] = np.take_along_axis(values, order, 1)
    idx[:, :k] = order
    valid[:, :k] = True
    rows = np.arange(R)[:, None]

    def stage(stride, dirs):
        a = np.array([p for p in range(32) if not p & stride])
        b = a + stride
        swap = (keys[:, a] > keys[:, b]) & valid[:, a] | ~valid[:, b]
        do = swap == dirs[a][None, :]
        for arr in (keys, idx, valid):
            va, vb = arr[:, a].copy(), arr[:, b].copy()
            arr[rows, a] = np.where(do, vb, va)
            arr[rows, b] = np.where(do, va, vb)

    lanes = np.arange(32)
    size = 2
    while size < 32:
        stride = size // 2
        while stride:
            stage(stride, (lanes & size) != 0)
            stride //= 2
        size *= 2
    stride = 16
    while stride:
        stage(stride, np.zeros(32, bool))
        stride //= 2
    return keys[:, :k], idx[:, :k]


def card_order(cands, k, rows):
    """The eager chain's answer on the card from the contract's candidate
    lists and the rows at every candidate position (position_rows):
    torch.topk of -d2 over each query's positions (-inf where none
    counts). Returns (d2 [Q, k], rows [Q, k])."""
    neg = np.full(rows.shape, -np.inf, np.float32)
    for r, cs in enumerate(cands):
        for d2, pos, _ in cs:
            neg[r, pos] = -d2
    vals, pos = card_topk(neg, k)
    return -vals, np.take_along_axis(rows, pos, 1)


def planted_grid(case, device="cpu", seed=0):
    """(grid, queries, k, cap) of a toy grid that plants one rule of the
    contract; the cell size is a float32 tensor on `device`, as
    default_cell_size gives it."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1, 1, (500, 2))
    surface = np.stack([uv[:, 0], uv[:, 1],
                        0.2 * np.sin(3 * uv[:, 0])], -1)
    cell, table, k, cap = 0.15, 1 << 12, 16, 24
    alive = None
    if case == "collisions":
        # 64 buckets for ~300 occupied cells: most buckets hold rows of
        # several cells, and cap 6 lets the others use the positions up
        pts, table, cap = surface, 1 << 6, 6
    elif case == "long_buckets":
        # 60 rows in one cell and 30 in another: buckets past cap 8
        blob = rng.uniform(0.01, 0.14, (60, 3))
        blob2 = rng.uniform(0.16, 0.29, (30, 3))
        pts, table, cap = np.concatenate([surface, blob, blob2]), 1 << 10, 8
    elif case == "alias":
        # a copy of the surface 80 m out on every axis: its cells (above
        # 511 on each) all pack to one code, and with 64 buckets rows of
        # other cells share a neighbour's bucket and count for it
        far = surface + 80.0
        pts, table, k = np.concatenate([surface, far]), 1 << 6, 8
    elif case == "duplicates":
        # every row three times: tied distances, ties across the k-th place
        pts, cap = np.repeat(surface[:200], 3, axis=0), 32
    elif case == "sparse":
        # rows 2 m apart: no query has k neighbours, far queries none
        pts = rng.uniform(-1, 1, (60, 3)) + 2.0 * rng.integers(-3, 4, (60, 3))
        cell = 0.4
    elif case == "dead":
        pts = surface
        alive = rng.uniform(size=500) > 0.3
    else:
        raise ValueError(case)
    pts = torch.tensor(pts, dtype=torch.float32, device=device)
    alive = (torch.ones(pts.shape[0], dtype=torch.bool, device=device)
             if alive is None else torch.tensor(alive, device=device))
    cs = torch.tensor(cell, dtype=torch.float32, device=device)
    grid = SH.build_hash_grid(pts, alive, cs, table)
    n = pts.shape[0]
    sel = torch.tensor(rng.choice(n, min(n, 40), replace=False),
                       device=device)
    extra = torch.tensor(rng.uniform(-4, 4, (12, 3)), dtype=torch.float32,
                         device=device)
    queries = torch.cat([pts[sel],
                         pts[sel[:20]] + 0.01 * torch.ones(3, device=device),
                         extra])
    return grid, queries, k, cap


CASES = ["collisions", "long_buckets", "alias", "duplicates", "sparse",
         "dead"]


@pytest.mark.parametrize("case", CASES)
def test_knn_hash_plain_matches_contract(case):
    grid, queries, k, cap = planted_grid(case)
    d2, idx = SH.knn_hash_plain(grid, queries, k, cap)
    cands = contract_knn(grid, queries, k, cap)
    assert_knn_matches(d2, idx, cands, k)
    # the case plants what it says
    alive_rows = set(grid.order[:int(grid.ends[-1])].tolist())
    counts = [len(c) for c in cands]
    assert all(c[2] in alive_rows for cs in cands for c in cs)
    if case == "sparse":
        assert max(counts) < k and min(counts) == 0
    if case == "duplicates":
        assert any(len({c[0] for c in cs[:k]}) < min(k, len(cs))
                   for cs in cands)
    if case in ("collisions", "long_buckets"):
        lengths = (grid.ends - grid.starts).max()
        assert int(lengths) > cap


def test_alias_rule_counts_far_cells():
    """In the alias case some candidate's own cell differs from the
    neighbour cell it counted for (both clamp to the same packed code)."""
    grid, queries, k, cap = planted_grid("alias")
    cs = float(grid.cell_size)
    cands = contract_knn(grid, queries, 10 ** 6, cap)
    pts = grid.points.numpy()
    row_pos = {int(r): p for p, r in enumerate(grid.order.tolist())}
    aliased = 0
    for q, cl in zip(queries.numpy(), cands):
        qc = np.floor(np.float32(q) / np.float32(cs))
        for _, key, row in cl:
            o = key // cap
            nc = qc + np.array([o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1])
            pc = np.floor(pts[row_pos[row]] / np.float32(cs))
            aliased += int(not np.array_equal(nc, pc))
    assert aliased > 0


def test_knn_hash_dispatch_counts_the_eager_path():
    """On the CPU knn_hash is the plain chain, counted `iso.knn.eager`."""
    grid, queries, k, cap = planted_grid("collisions")
    tracer = spans.Tracer()
    with spans.use(tracer):
        d2, idx = SH.knn_hash(grid, queries, k, cap)
        SH.knn_hash(grid, queries[:5], k, cap)
    d2_p, idx_p = SH.knn_hash_plain(grid, queries, k, cap)
    assert torch.equal(d2, d2_p) and torch.equal(idx, idx_p)
    assert tracer.counters == {"iso.knn.eager": 2}


@pytest.mark.parametrize("k", [1, 5, 16, 32])
def test_card_topk_emulation_sorts_and_selects(k):
    """The emulation of the card's topk picks the k largest (ties at the
    k-th place by index) and returns them in descending order."""
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 12, (300, 90)).astype(np.float32)
    vals[:40, 20:] = -np.inf
    got_v, got_i = card_topk(vals, k)
    want = -np.sort(-vals, axis=1)[:, :k]
    assert np.array_equal(got_v, want)
    assert np.array_equal(np.take_along_axis(vals, got_i, 1), got_v)
    for r in range(vals.shape[0]):
        kth = want[r, -1]
        above = set(np.nonzero(vals[r] > kth)[0].tolist())
        ties = np.nonzero(vals[r] == kth)[0][:k - len(above)]
        assert set(got_i[r].tolist()) == above | set(ties.tolist())


@pytest.mark.parametrize("k", [33, 64])
def test_knn_hash_cuda_rejects_k_over_32(k):
    """Kernel K keeps a warp's 32 neighbours at most; more is refused
    before any launch, naming the exact KNN."""
    grid, queries, _, cap = planted_grid("dead")
    with pytest.raises(ValueError, match='knn_method="exact"'):
        SH.knn_hash_cuda(grid, queries, k, cap)


def _iso_inputs(n=400, seed=3):
    rng = np.random.default_rng(seed)
    means = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    rots = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    ls = torch.tensor(rng.uniform(-3.5, -2.0, (n, 3)), dtype=torch.float32)
    op = torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32)
    alive = torch.tensor(rng.uniform(size=n) > 0.15)
    return means, rots, ls, op, alive


@pytest.mark.parametrize("fill", ["zero", "random", "dead_rows"])
def test_iso_loss_ignores_missing_neighbour_index(fill):
    """A pool whose missing neighbours (nbr_ok False) carry any other row
    gives the same iso loss, mean density and gradients, bit for bit. On
    one intra-op thread: on more, the CPU's backward of the neighbour
    gather adds rows with atomics, in an order that varies run to run."""
    means, rots, ls, op, alive = _iso_inputs()
    n = means.shape[0]
    cell = SH.default_cell_size(ls, alive)
    grid = SH.build_hash_grid(means, alive, cell)
    q_idx = torch.arange(0, n, 3)
    d2, nbr = SH.knn_hash_plain(grid, means[q_idx], 16, 24)
    ok = torch.isfinite(d2)
    assert 0 < int((~ok).sum()) < ok.numel()
    g = torch.Generator().manual_seed(5)
    if fill == "zero":
        other = torch.zeros_like(nbr)
    elif fill == "random":
        other = torch.randint(0, n, nbr.shape, generator=g)
    else:
        dead = torch.nonzero(~alive)[:, 0]
        other = dead[torch.randint(0, dead.shape[0], nbr.shape, generator=g)]
    sel = torch.randint(0, q_idx.shape[0], (300,), generator=g)

    def run(nbr_used):
        leaves = [t.clone().requires_grad_(True) for t in (means, rots, ls,
                                                            op)]
        pool = IsoKnnPool(q_idx=q_idx, nbr=nbr_used, nbr_ok=ok)
        loss, dens = iso_surface_loss(*leaves, alive, pool, sample_size=300,
                                      sel=sel)
        grads = torch.autograd.grad(loss, leaves)
        return [loss.detach(), dens.detach()] + list(grads)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = run(nbr)
        b = run(torch.where(ok, nbr, other))
    finally:
        torch.set_num_threads(threads)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
