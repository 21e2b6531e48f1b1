"""Dense aggregation path: parity with the sparse gather path.

The dense path replaces the per-edge gather SpMM with an
``n_pad x n_pad`` adjacency matmul (and, in adjacency-feature mode,
contracts ``W1`` over only its first ``n_pad`` rows, since the reference's
padded feature columns beyond ``n_pad`` are identically zero —
``graphExtender.py:28-48``).  These tests pin the algebraic identities on
CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.core.graph import dense_adjacency, pad_graph_batch
from gcn_maxcut.models import (
    gcn_conv_init,
    gcn_conv_apply,
    gcn_softmax_init,
    gcn_softmax_apply,
)
from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.train.loop import (
    _graph_loss,
    _resolve_dense_aggregation,
    make_epoch_fn,
    setup_train_state,
)


def _graph(n=18, p=0.4, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    if weights:
        a = a * np.triu(rng.uniform(0.5, 2.0, (n, n)).astype(np.float32), 1)
    a = a + a.T
    return graph_from_dense(a), a


def test_conv_dense_matches_sparse_both_orders():
    g, _ = _graph()
    a_mask = dense_adjacency(g, values="mask")
    rng = np.random.default_rng(1)
    for in_f, out_f in [(12, 5), (5, 12)]:
        params = gcn_conv_init(jax.random.PRNGKey(0), in_f, out_f)
        x = jnp.asarray(rng.normal(size=(g.n_pad, in_f)).astype(np.float32))
        y_sparse = np.asarray(gcn_conv_apply(params, g, x))
        y_dense = np.asarray(gcn_conv_apply(params, g, x, a_dense=a_mask))
        np.testing.assert_allclose(y_dense, y_sparse, rtol=1e-5, atol=1e-5)


def test_dense_mask_ignores_edge_weights_like_dgl():
    # GraphConv aggregation is unweighted even on weighted graphs; the
    # dense operator must use values="mask", not the weights.
    g, _ = _graph(weights=True)
    a_mask = dense_adjacency(g, values="mask")
    params = gcn_conv_init(jax.random.PRNGKey(0), 7, 4)
    x = jnp.asarray(
        np.random.default_rng(2).normal(size=(g.n_pad, 7)).astype(np.float32)
    )
    y_sparse = np.asarray(gcn_conv_apply(params, g, x))
    y_dense = np.asarray(gcn_conv_apply(params, g, x, a_dense=a_mask))
    np.testing.assert_allclose(y_dense, y_sparse, rtol=1e-5, atol=1e-5)


def test_model_forward_dense_matches_sparse():
    g, _ = _graph(n=25, seed=3)
    params = gcn_softmax_init(jax.random.PRNGKey(1), 32, 16, 3)
    x = jnp.asarray(
        np.random.default_rng(4).normal(size=(g.n_pad, 32)).astype(np.float32)
    )
    p_sparse = np.asarray(gcn_softmax_apply(params, g, x))
    p_dense = np.asarray(
        gcn_softmax_apply(params, g, x, a_dense=dense_adjacency(g, values="mask"))
    )
    np.testing.assert_allclose(p_dense, p_sparse, rtol=1e-5, atol=1e-6)


def test_trimmed_w1_identity():
    # x_full @ W1 == a_feat @ W1[:n_pad] when feature columns >= n_pad are 0
    g, _ = _graph(n=20, seed=5, weights=True)
    cfg = TrainingConfig(n_nodes=64)  # dim_embedding = 64 > n_pad
    loss_full = _graph_loss(
        setup_train_state(cfg).params, g, cfg, jax.random.PRNGKey(0)
    )
    width = min(g.n_pad, cfg.dim_embedding)
    a_mask = dense_adjacency(g, values="mask")
    a_feat = dense_adjacency(g, width=width)
    loss_trim = _graph_loss(
        setup_train_state(cfg).params, g, cfg, jax.random.PRNGKey(0),
        a_mask, a_feat,
    )
    np.testing.assert_allclose(
        float(loss_trim), float(loss_full), rtol=1e-5, atol=1e-5
    )


def test_trimmed_w1_gradients_match():
    g, _ = _graph(n=20, seed=6)
    cfg = TrainingConfig(n_nodes=64)
    params = setup_train_state(cfg).params
    key = jax.random.PRNGKey(0)
    grads_full = jax.grad(_graph_loss)(params, g, cfg, key)
    width = min(g.n_pad, cfg.dim_embedding)
    grads_trim = jax.grad(_graph_loss)(
        params, g, cfg, key,
        dense_adjacency(g, values="mask"),
        dense_adjacency(g, width=width),
    )
    for name in ("conv1", "conv2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                np.asarray(grads_trim[name][leaf]),
                np.asarray(grads_full[name][leaf]),
                rtol=1e-4, atol=1e-5,
            )
    # rows of W1 beyond the trim width get exactly zero gradient
    assert np.all(np.asarray(grads_trim["conv1"]["w"])[width:] == 0.0)


def test_resolve_auto_thresholds():
    # round-5 signature: the resolver takes the aggregation policy string
    assert _resolve_dense_aggregation("auto", n_pad=504, n_graphs=20)
    assert not _resolve_dense_aggregation("auto", n_pad=4096, n_graphs=1)
    assert not _resolve_dense_aggregation("auto", n_pad=2048, n_graphs=1000)
    assert _resolve_dense_aggregation("dense", n_pad=100_000)
    assert not _resolve_dense_aggregation("sparse", n_pad=8)


def test_epoch_fn_dense_vs_sparse_first_epoch():
    # One epoch from identical init must give near-identical cumulative
    # loss on both aggregation backends (trajectories diverge later only
    # through STE argmax tie flips).
    def make(seed):
        rng = np.random.default_rng(seed)
        a = np.triu((rng.random((30, 30)) < 0.4).astype(np.float32), 1)
        from gcn_maxcut.core import graph_from_dense as gfd
        return gfd(a + a.T, e_pad=512, ell_width=30)

    batch = pad_graph_batch([make(s) for s in range(4)])
    losses = {}
    for agg in ("sparse", "dense"):
        cfg = TrainingConfig(n_nodes=32, aggregation=agg)
        state = setup_train_state(cfg)
        fn = make_epoch_fn(cfg, state.optimizer)
        _, _, l = fn(
            state.params, state.opt_state, batch, jax.random.PRNGKey(7),
            num_epochs=1,
        )
        losses[agg] = float(l[-1])
    np.testing.assert_allclose(losses["dense"], losses["sparse"], rtol=1e-4)
