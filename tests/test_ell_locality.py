"""General-graph SpMM on the ELL gather path: banded, long-range and
RCM-reordered graphs against a dense numpy operator.

Reference kernel being replaced: DGL SpMM
(``python/Training/TrainingNeural.py:80,83`` in the reference tree).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.core.graph import graph_from_edges
from gcn_maxcut.ops.segment import spmm, spmm_ell


def _banded_edges(n=2048, per_node=3, w=50, long_edges=(), seed=0):
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for _ in range(per_node):
            j = int((i + rng.integers(-w, w + 1)) % n)
            if j != i:
                edges.append((i, j))
    edges += list(long_edges)
    return np.asarray(edges, np.int64)


def _dense(g, weighted):
    """Dense operator A[r, s] (+= w) from the graph's real directed edges."""
    m = np.asarray(g.edge_mask) > 0
    s, r = np.asarray(g.senders)[m], np.asarray(g.receivers)[m]
    vals = np.asarray(g.weights)[m] if weighted else np.ones(s.shape[0])
    a = np.zeros((g.n_pad, g.n_pad), np.float64)
    np.add.at(a, (r, s), vals)
    return a


def test_banded_and_expander_graphs_take_the_gather_path():
    g = graph_from_edges(_banded_edges(), 2048)
    assert g.ell_senders is not None
    rng = np.random.default_rng(1)
    n = 2048
    edges = np.stack(
        [np.repeat(np.arange(n), 3), rng.integers(0, n, 3 * n)], axis=1
    )
    edges = edges[edges[:, 0] != edges[:, 1]]
    ge = graph_from_edges(edges, n)
    assert ge.ell_senders is not None
    x = jnp.asarray(rng.normal(size=(n, 8)), jnp.float32)
    for gr in (g, ge):
        np.testing.assert_array_equal(
            np.asarray(spmm(gr, x)), np.asarray(spmm_ell(gr, x, "mask"))
        )


def test_long_edges_are_exact():
    long = [(0, 1000), (5, 1500), (1024, 30)]
    g = graph_from_edges(_banded_edges(long_edges=long), 2048)
    x = np.random.default_rng(2).normal(size=(g.n_pad, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm(g, jnp.asarray(x))), _dense(g, False) @ x,
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_parity_vs_dense(weighted):
    edges = _banded_edges(long_edges=[(0, 900), (7, 1400)], seed=2)
    rng = np.random.default_rng(3)
    wts = (rng.random(len(edges)) + 0.5).astype(np.float32) if weighted else None
    g = graph_from_edges(edges, 2048, weights=wts)
    x = rng.normal(size=(g.n_pad, 128)).astype(np.float32)
    y = spmm(g, jnp.asarray(x), edge_weights=g.weights if weighted else None)
    np.testing.assert_allclose(
        np.asarray(y), _dense(g, weighted) @ x, rtol=1e-5, atol=1e-4
    )


def test_grad_parity_symmetric():
    g = graph_from_edges(_banded_edges(seed=4, long_edges=[(3, 1200)]), 2048)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(g.n_pad, 32)).astype(np.float32)
    dx = jax.grad(lambda x_: jnp.sum(spmm(g, x_) ** 2))(jnp.asarray(x))
    a = _dense(g, False)
    np.testing.assert_allclose(
        np.asarray(dx), 2 * a.T @ (a @ x), rtol=1e-4, atol=1e-3
    )


def test_narrow_features_exact():
    g = graph_from_edges(_banded_edges(seed=6, long_edges=[(2, 1100)]), 2048)
    x = np.random.default_rng(7).normal(size=(g.n_pad, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm(g, jnp.asarray(x))), _dense(g, False) @ x,
        rtol=1e-5, atol=1e-5,
    )


def test_shared_ell_width_pads_exactly():
    edges = _banded_edges(n=512, seed=8)
    g = graph_from_edges(edges, 512)
    wide = graph_from_edges(edges, 512, ell_width=g.ell_senders.shape[1] + 5)
    assert wide.ell_senders.shape[1] == g.ell_senders.shape[1] + 5
    x = jnp.asarray(np.random.default_rng(8).normal(size=(512, 8)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(spmm(wide, x)), np.asarray(spmm(g, x)), rtol=1e-6, atol=1e-6
    )


def test_bf16_feature_rows_match_dense():
    g = graph_from_edges(_banded_edges(seed=9), 2048)
    x = np.random.default_rng(9).normal(size=(g.n_pad, 64)).astype(np.float32)
    y = spmm(g, jnp.asarray(x), feature_dtype="bfloat16")
    assert y.dtype == jnp.float32
    ref = _dense(g, False) @ x
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(y) / scale, ref / scale, atol=1e-2)


def test_no_ell_tables_falls_back_to_segment_sum():
    g = graph_from_edges(_banded_edges(seed=10), 2048, ell_width=0)
    assert g.ell_senders is None
    x = np.random.default_rng(10).normal(size=(g.n_pad, 8)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm(g, jnp.asarray(x))), _dense(g, False) @ x,
        rtol=1e-5, atol=1e-5,
    )


def test_reorder_rcm_recovers_band_from_shuffled_ids():
    # a banded graph whose node ids were randomly shuffled spans the whole
    # id space; reorder="rcm" relabels it back into a narrow band
    n = 2048
    ue = _banded_edges(n=n)
    rng = np.random.default_rng(3)
    shuffled = rng.permutation(n)[ue]

    def bandwidth(g):
        m = np.asarray(g.edge_mask) > 0
        d = np.abs(np.asarray(g.senders)[m] - np.asarray(g.receivers)[m])
        return int(np.minimum(d, n - d).max())

    g_off = graph_from_edges(shuffled, n, reorder="off")
    g_rcm = graph_from_edges(shuffled, n, reorder="rcm")
    assert g_rcm.reorder_perm is not None
    assert bandwidth(g_rcm) < bandwidth(g_off) // 4

    # exactness: spmm on the relabeled graph == spmm on the shuffled graph,
    # rows mapped through the stored permutation
    x = np.random.default_rng(4).normal(size=(n, 32)).astype(np.float32)
    perm = np.asarray(g_rcm.reorder_perm)       # old id -> new id
    inv = np.argsort(perm)                      # new id -> old id
    y_rcm = np.asarray(spmm(g_rcm, jnp.asarray(x[inv])))
    y_ref = np.asarray(spmm(g_off, jnp.asarray(x)))
    np.testing.assert_allclose(y_rcm[perm], y_ref, rtol=2e-5, atol=2e-5)


def test_reorder_rcm_expander_is_exact():
    rng = np.random.default_rng(5)
    n = 1024
    edges = np.stack(
        [np.repeat(np.arange(n), 3), rng.integers(0, n, 3 * n)], axis=1
    )
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = graph_from_edges(edges, n)
    g2 = graph_from_edges(edges, n, reorder="rcm")
    perm = np.asarray(g2.reorder_perm)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y2 = np.asarray(spmm(g2, jnp.asarray(x[np.argsort(perm)])))
    np.testing.assert_allclose(
        y2[perm], np.asarray(spmm(g, jnp.asarray(x))), rtol=2e-5, atol=2e-5
    )


def test_reorder_rcm_explicit():
    g = graph_from_edges(_banded_edges(), 2048)
    em = np.asarray(g.edge_mask) > 0
    ue = np.stack(
        [np.asarray(g.senders)[em], np.asarray(g.receivers)[em]], axis=1
    )
    ue = ue[ue[:, 0] < ue[:, 1]]
    g2 = graph_from_edges(ue, 2048, reorder="rcm")
    assert g2.reorder_perm is not None
    assert int(np.asarray(g2.n_edges)) == int(np.asarray(g.n_edges))
    for bad in ("bogus", "auto"):
        with pytest.raises(ValueError):
            graph_from_edges(ue, 2048, reorder=bad)
