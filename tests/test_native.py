"""Native C++ toolkit vs Python fallbacks (skipped when no compiler)."""

import numpy as np
import pytest

from gcn_maxcut.native import (
    is_available,
    random_regular_edges_native,
    sort_by_receiver_native,
    bfs_partition_native,
    brute_force_maxcut_native,
    greedy_maxcut_native,
)
from oracle import brute_force_maxcut as oracle_bf, oracle_cut_value

pytestmark = pytest.mark.skipif(not is_available(), reason="native lib unavailable")


def _dense(edges, n):
    adj = np.zeros((n, n), np.float32)
    for u, v in edges:
        adj[u, v] = adj[v, u] = 1
    return adj


def test_native_regular_graph_valid():
    e = random_regular_edges_native(200, 6, seed=1)
    assert e.shape == (600, 2)
    deg = np.bincount(e.ravel(), minlength=200)
    assert np.all(deg == 6)
    assert np.all(e[:, 0] < e[:, 1])
    assert len({tuple(x) for x in e.tolist()}) == 600


def test_native_regular_deterministic():
    e1 = random_regular_edges_native(100, 4, seed=7)
    e2 = random_regular_edges_native(100, 4, seed=7)
    np.testing.assert_array_equal(e1, e2)
    e3 = random_regular_edges_native(100, 4, seed=8)
    assert not np.array_equal(e1, e3)


def test_native_sort_by_receiver():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 300).astype(np.int64)
    dst = rng.integers(0, 50, 300).astype(np.int64)
    w = rng.random(300).astype(np.float32)
    s, d, ww = sort_by_receiver_native(src, dst, 50, w)
    assert np.all(np.diff(d) >= 0)
    # same multiset of (s, d, w) triples
    got = sorted(zip(s.tolist(), d.tolist(), np.round(ww, 5).tolist()))
    exp = sorted(zip(src.tolist(), dst.tolist(), np.round(w, 5).tolist()))
    assert got == exp


def test_native_bfs_partition():
    e = random_regular_edges_native(128, 4, seed=2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    owner = bfs_partition_native(src, dst, 128, 4)
    counts = np.bincount(owner, minlength=4)
    assert counts.sum() == 128
    assert counts.max() <= 32 + 4


def test_native_brute_force_matches_oracle():
    e = random_regular_edges_native(9, 4, seed=3)
    adj = _dense(e, 9)
    ev, _ = oracle_bf(adj, 3, fixed={0: 0, 1: 1, 2: 2})
    asn, val = brute_force_maxcut_native(e, 9, 3, 3)
    assert val == pytest.approx(ev)
    assert oracle_cut_value(adj, asn) == pytest.approx(ev)
    assert list(asn[:3]) == [0, 1, 2]


def test_native_greedy_improves_and_consistent():
    e = random_regular_edges_native(60, 6, seed=4)
    adj = _dense(e, 60)
    rng = np.random.default_rng(1)
    init = rng.integers(0, 3, 60)
    init[:3] = [0, 1, 2]
    c0 = oracle_cut_value(adj, init)
    asn, val = greedy_maxcut_native(e, 60, init)
    assert val >= c0
    assert val == pytest.approx(oracle_cut_value(adj, asn))
    assert list(asn[:3]) == [0, 1, 2]


def test_python_generate_dispatches_to_native_for_large_n():
    from gcn_maxcut.data.generate import random_regular_edges

    e = random_regular_edges(20_000, 4, seed=5)
    deg = np.bincount(e.ravel(), minlength=20_000)
    assert np.all(deg == 4)


def test_native_shard_assembly_matches_numpy_path():
    """gt_shard_counts/fill must reproduce the NumPy lexsort assembly
    bit-for-bit (incl. ELL tables, padding, degrees, node masks)."""
    import numpy as np
    from gcn_maxcut.native.bindings import is_available
    from gcn_maxcut.parallel import shard_graph

    if not is_available():
        import pytest

        pytest.skip("native toolkit unavailable")
    rng = np.random.default_rng(3)
    n, deg, D = 96, 6, 8
    from gcn_maxcut.data.generate import random_regular_edges

    e = random_regular_edges(n, deg, seed=5)
    s = np.concatenate([e[:, 0], e[:, 1]])
    r = np.concatenate([e[:, 1], e[:, 0]])
    w = rng.random(s.shape[0]).astype(np.float32)
    w_sym = w.copy()  # make weights symmetric so the flag matches too
    # build symmetric weights: weight of (u,v) == (v,u)
    key = {}
    for i in range(s.shape[0]):
        a, b = min(s[i], r[i]), max(s[i], r[i])
        w_sym[i] = key.setdefault((a, b), w[i])

    nat, g2l_nat = shard_graph(s, r, n, D, weights=w_sym, use_native=True)
    ref, g2l_ref = shard_graph(s, r, n, D, weights=w_sym, use_native=False)
    np.testing.assert_array_equal(g2l_nat, g2l_ref)
    assert nat.symmetric == ref.symmetric == True  # noqa: E712
    for name in ("senders", "receivers", "weights", "edge_mask",
                 "degrees", "node_mask", "ell_senders", "ell_weights",
                 "ell_mask"):
        a, b = getattr(nat, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name
            )


def test_native_symmetry_check_hash():
    import numpy as np
    from gcn_maxcut.native.bindings import is_available, symmetry_check_native

    if not is_available():
        import pytest

        pytest.skip("native toolkit unavailable")
    s = np.array([0, 1, 1, 2], dtype=np.int64)
    r = np.array([1, 0, 2, 1], dtype=np.int64)
    w = np.array([1.0, 1.0, 2.0, 2.0], dtype=np.float32)
    assert symmetry_check_native(s, r, w) is True
    w2 = np.array([1.0, 1.5, 2.0, 2.0], dtype=np.float32)
    assert symmetry_check_native(s, r, w2) is False
    # directed edge with no reverse
    assert symmetry_check_native(s[:3], r[:3], w[:3]) is False


def test_greedy_sweep_native_beats_random_and_is_consistent():
    from gcn_maxcut.native.bindings import (
        greedy_sweep_native, is_available,
    )
    if not is_available():
        import pytest
        pytest.skip("native toolkit not built")
    import numpy as np
    from gcn_maxcut.data.generate import random_regular_edges

    n, d, k = 4096, 6, 3
    edges = random_regular_edges(n, d, seed=2)
    rng = np.random.default_rng(0)
    init = rng.integers(0, k, n)
    init[:k] = np.arange(k)
    asn, cut, sweeps = greedy_sweep_native(edges, n, init, k=k)
    # returned cut matches a recount, terminals unmoved, beats the
    # random floor decisively
    recount = float((asn[edges[:, 0]] != asn[edges[:, 1]]).sum())
    assert recount == cut
    np.testing.assert_array_equal(asn[:k], np.arange(k))
    assert cut / edges.shape[0] > (k - 1) / k + 0.05
    assert 0 < sweeps <= 100
