"""Core graph container: round-trips, padding invariants, batching."""

import numpy as np
import jax.numpy as jnp

from gcn_maxcut.core import (
    Graph,
    graph_from_edges,
    graph_from_dense,
    dense_adjacency,
    pad_graph_batch,
    round_up,
)


def _random_adj(n, p, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T


def test_round_up():
    assert round_up(1, 8) == 8
    assert round_up(8, 8) == 8
    assert round_up(9, 8) == 16
    assert round_up(0, 128) == 128


def test_dense_sparse_roundtrip():
    adj = _random_adj(17, 0.3, 0)
    g = graph_from_dense(adj)
    back = np.asarray(dense_adjacency(g))
    assert back.shape == (g.n_pad, g.n_pad)
    np.testing.assert_allclose(back[:17, :17], adj, atol=0)
    assert np.all(back[17:, :] == 0)
    assert np.all(back[:, 17:] == 0)


def test_edges_roundtrip_weighted():
    edges = [(0, 1), (1, 2), (2, 3), (0, 3)]
    w = [1.0, 2.0, 3.0, 4.0]
    g = graph_from_edges(edges, 4, weights=w)
    adj = np.asarray(dense_adjacency(g))[:4, :4]
    expect = np.zeros((4, 4), np.float32)
    for (u, v), ww in zip(edges, w):
        expect[u, v] = expect[v, u] = ww
    np.testing.assert_allclose(adj, expect)
    assert int(g.n_edges) == 8  # directed


def test_degrees_and_masks():
    edges = [(0, 1), (1, 2)]
    g = graph_from_edges(edges, 5, n_pad=8)
    deg = np.asarray(g.degrees)
    np.testing.assert_allclose(deg[:5], [1, 2, 1, 0, 0])
    np.testing.assert_allclose(np.asarray(g.node_mask), [1] * 5 + [0] * 3)
    assert float(jnp.sum(g.edge_mask)) == 4.0


def test_receivers_sorted_and_row_ptr():
    adj = _random_adj(23, 0.4, 1)
    g = graph_from_dense(adj)
    recv = np.asarray(g.receivers)
    assert np.all(np.diff(recv) >= 0)
    rp = np.asarray(g.row_ptr)
    assert rp[0] == 0 and rp[-1] == g.e_pad
    # row_ptr segments match receiver runs
    for node in range(g.n_pad):
        seg = recv[rp[node] : rp[node + 1]]
        assert np.all(seg == node)


def test_batching_stacks():
    # shared ell_width: mixed-degree graphs must stack (ragged ELL caught
    # live by the CLI pipeline with d in [4,6])
    gs = [
        graph_from_dense(_random_adj(10, 0.3, s), n_pad=16, e_pad=256, ell_width=10)
        for s in range(3)
    ]
    batch = pad_graph_batch(gs)
    assert batch.senders.shape == (3, 256)
    assert batch.node_mask.shape == (3, 16)
    assert batch.n_nodes.shape == (3,)
    assert batch.ell_senders.shape == (3, 16, 10)


def test_batching_rejects_mixed_padding():
    g1 = graph_from_dense(_random_adj(10, 0.3, 0), n_pad=16, e_pad=128)
    g2 = graph_from_dense(_random_adj(10, 0.3, 1), n_pad=32, e_pad=128)
    try:
        pad_graph_batch([g1, g2])
        assert False, "should raise"
    except ValueError:
        pass


def test_rcm_reorder_bands_a_lattice():
    import numpy as np
    from gcn_maxcut.data.generate import GraphSpec
    from gcn_maxcut.data.reorder import rcm_reorder, graph_bandwidth

    # 8x8 grid graph, scrambled labels: RCM must recover a small bandwidth
    side = 8
    rng = np.random.default_rng(0)
    scramble = rng.permutation(side * side)
    edges = []
    for r in range(side):
        for c in range(side):
            v = r * side + c
            if c + 1 < side:
                edges.append((scramble[v], scramble[v + 1]))
            if r + 1 < side:
                edges.append((scramble[v], scramble[v + side]))
    edges = np.array([(min(a, b), max(a, b)) for a, b in edges], dtype=np.int64)
    spec = GraphSpec(n_nodes=side * side, edges=edges, terminals=[0, 1, 2])

    before = graph_bandwidth(spec.edges)
    new, bw = rcm_reorder(spec)
    assert bw < before
    assert bw <= 2 * side  # grid RCM bandwidth ~ side
    # structure preserved: same degree multiset
    deg0 = np.bincount(spec.edges.ravel(), minlength=64)
    deg1 = np.bincount(new.edges.ravel(), minlength=64)
    assert sorted(deg0) == sorted(deg1)


def test_rcm_cannot_band_expander():
    from gcn_maxcut.data import generate_graph
    from gcn_maxcut.data.reorder import is_bandable

    spec = generate_graph(n=200, d=6, graph_type="reg", seed=0)
    ok, bw = is_bandable(spec, max_bandwidth=32)
    assert not ok  # random regular graphs are expanders
    assert bw > 32
