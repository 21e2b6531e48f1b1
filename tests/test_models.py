"""GCN layer/model parity vs the dense DGL-semantics oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from gcn_maxcut.core import graph_from_dense, dense_adjacency
from gcn_maxcut.models import (
    gcn_conv_init,
    gcn_conv_apply,
    gcn_softmax_init,
    gcn_softmax_apply,
    gcn_dev_init,
    gcn_dev_apply,
    embedding_init,
    count_params,
)
from oracle import oracle_gcn_conv


def _graph(n=18, p=0.4, seed=0):
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    a = a + a.T
    return graph_from_dense(a), a


def test_conv_matches_dense_oracle_both_orders():
    g, a = _graph()
    n = a.shape[0]
    rng = np.random.default_rng(1)
    for in_f, out_f in [(12, 5), (5, 12)]:  # project-first and aggregate-first
        params = gcn_conv_init(jax.random.PRNGKey(0), in_f, out_f)
        x = rng.normal(size=(g.n_pad, in_f)).astype(np.float32)
        y = np.asarray(gcn_conv_apply(params, g, jnp.asarray(x)))
        expect = oracle_gcn_conv(
            a, x[:n], np.asarray(params["w"]), np.asarray(params["b"])
        )
        np.testing.assert_allclose(y[:n], expect, rtol=1e-4, atol=1e-5)


def test_conv_zero_degree_clamp():
    # isolated node: degree clamped to 1, output = bias only
    a = np.zeros((4, 4), np.float32)
    a[0, 1] = a[1, 0] = 1.0
    g = graph_from_dense(a)
    params = gcn_conv_init(jax.random.PRNGKey(1), 3, 2)
    x = jnp.ones((g.n_pad, 3), jnp.float32)
    y = np.asarray(gcn_conv_apply(params, g, x))
    np.testing.assert_allclose(y[2], np.asarray(params["b"]), atol=1e-6)


def test_gcn_softmax_shapes_and_simplex():
    g, a = _graph(n=25, seed=2)
    params = gcn_softmax_init(jax.random.PRNGKey(2), 32, 16, 3)
    x = jnp.asarray(
        np.random.default_rng(3).normal(size=(g.n_pad, 32)), jnp.float32
    )
    probs = np.asarray(gcn_softmax_apply(params, g, x))
    assert probs.shape == (g.n_pad, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    assert np.all(probs >= 0)


def test_flagship_param_count_matches_reference():
    # Reference: 1000→500→3 GCNSoftmax = 502,003 params
    # (neural_network_testing.ipynb cell 6 output; SURVEY.md §2.3).
    params = gcn_softmax_init(jax.random.PRNGKey(0), 1000, 500, 3)
    assert count_params(params) == 502_003


def test_dropout_train_vs_eval():
    g, a = _graph(n=10, seed=4)
    params = gcn_softmax_init(jax.random.PRNGKey(3), 8, 4, 3)
    x = jnp.ones((g.n_pad, 8), jnp.float32)
    eval_out = gcn_softmax_apply(params, g, x, dropout=0.5, train=False)
    train_out = gcn_softmax_apply(
        params, g, x, dropout=0.5, train=True, dropout_rng=jax.random.PRNGKey(4)
    )
    assert not np.allclose(np.asarray(eval_out), np.asarray(train_out))
    # eval path deterministic
    eval_out2 = gcn_softmax_apply(params, g, x, dropout=0.5, train=False)
    np.testing.assert_allclose(np.asarray(eval_out), np.asarray(eval_out2))


def test_gcn_dev_sigmoid_range():
    g, _ = _graph(n=12, seed=5)
    params = gcn_dev_init(jax.random.PRNGKey(5), 6, 4, 1)
    x = jnp.asarray(np.random.default_rng(6).normal(size=(g.n_pad, 6)), jnp.float32)
    out = np.asarray(gcn_dev_apply(params, g, x))
    assert out.shape == (g.n_pad, 1)
    assert np.all((out > 0) & (out < 1))


def test_adjacency_as_features_forward():
    # The reference's load-bearing quirk: node features ARE the padded
    # adjacency rows (SURVEY.md §2.3). End-to-end forward must accept them.
    g, a = _graph(n=20, seed=7)
    feats = dense_adjacency(g, width=64)
    params = gcn_softmax_init(jax.random.PRNGKey(6), 64, 32, 3)
    probs = gcn_softmax_apply(params, g, feats)
    assert probs.shape == (g.n_pad, 3)


def test_embedding_init_shape():
    emb = embedding_init(jax.random.PRNGKey(7), 10, 4)
    assert emb.shape == (10, 4)


def test_conv_hand_verified_golden_fixture():
    """Worked-by-hand GraphConv(norm='both') fixture — closes the no-real-DGL
    validation gap as far as this environment allows (DGL is not installable
    here; the other parity tests compare against a *re-implementation*).

    Reference forward being matched: ``dgl.nn.pytorch.GraphConv`` as used in
    ``GCNSoftmax`` (/root/reference/python/Training/TrainingNeural.py:69-85):
    h'_i = (1/sqrt(d_i)) * sum_{j in N(i)} (1/sqrt(d_j)) * x_j  (W = I, b = 0;
    ``dgl.from_networkx`` adds no self-loops; undirected edges become
    symmetric pairs so in-degree == out-degree == d).

    Graph: 5 nodes, undirected edges (0,1), (0,2), (1,2), (2,3), (3,4).
    Degrees d = [2, 2, 3, 2, 1].

    Features x = [[1,0], [0,1], [1,1], [2,0], [0,2]].

    Step 1 — source normalization x_j / sqrt(d_j):
        x0/sqrt2 = (1/sqrt2, 0)         = (0.7071068, 0)
        x1/sqrt2 = (0, 1/sqrt2)         = (0, 0.7071068)
        x2/sqrt3 = (1/sqrt3, 1/sqrt3)   = (0.5773503, 0.5773503)
        x3/sqrt2 = (2/sqrt2, 0)         = (1.4142136, 0)
        x4/1     = (0, 2)

    Step 2 — neighbor sum:
        n0: N={1,2}:   (0 + 1/sqrt3,        1/sqrt2 + 1/sqrt3)
        n1: N={0,2}:   (1/sqrt2 + 1/sqrt3,  0 + 1/sqrt3)
        n2: N={0,1,3}: (1/sqrt2 + 2/sqrt2,  1/sqrt2)
        n3: N={2,4}:   (1/sqrt3,            1/sqrt3 + 2)
        n4: N={3}:     (2/sqrt2,            0)

    Step 3 — destination normalization / sqrt(d_i):
        n0: (1/sqrt6,        1/2 + 1/sqrt6)  = (0.4082483, 0.9082483)
        n1: (1/2 + 1/sqrt6,  1/sqrt6)        = (0.9082483, 0.4082483)
        n2: (3/sqrt6,        1/sqrt6)        = (1.2247449, 0.4082483)
        n3: (1/sqrt6,        1/sqrt6 + sqrt2)= (0.4082483, 1.8224619)
        n4: (sqrt2,          0)              = (1.4142136, 0.0)
    """
    a = np.zeros((5, 5), np.float32)
    for u, v in [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4)]:
        a[u, v] = a[v, u] = 1.0
    g = graph_from_dense(a)
    x = np.zeros((g.n_pad, 2), np.float32)
    x[:5] = [[1, 0], [0, 1], [1, 1], [2, 0], [0, 2]]
    golden = np.array(
        [
            [0.4082483, 0.9082483],
            [0.9082483, 0.4082483],
            [1.2247449, 0.4082483],
            [0.4082483, 1.8224619],
            [1.4142136, 0.0],
        ],
        np.float32,
    )

    # W = I, b = 0: the layer reduces to the normalized aggregation above.
    params = {"w": jnp.eye(2, dtype=jnp.float32), "b": jnp.zeros((2,), jnp.float32)}
    y = np.asarray(gcn_conv_apply(params, g, jnp.asarray(x)))
    np.testing.assert_allclose(y[:5], golden, rtol=1e-6, atol=1e-6)

    # Same fixture through the dense aggregation path.
    y_dense = np.asarray(
        gcn_conv_apply(params, g, jnp.asarray(x), a_dense=dense_adjacency(g, values="mask"))
    )
    np.testing.assert_allclose(y_dense[:5], golden, rtol=1e-5, atol=1e-6)

    # Non-trivial W/b (project-first branch, in_feats > out_feats):
    # output must be (golden @ W) + b by linearity of aggregation.
    w = jnp.asarray([[2.0], [-1.0]])
    b = jnp.asarray([0.25])
    y2 = np.asarray(gcn_conv_apply({"w": w, "b": b}, g, jnp.asarray(x)))
    np.testing.assert_allclose(
        y2[:5], golden @ np.asarray(w) + 0.25, rtol=1e-5, atol=1e-6
    )
