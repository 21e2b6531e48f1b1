"""SpMM/SDDMM vs dense oracles; straight-through gradient algebra."""

import numpy as np
import jax
import jax.numpy as jnp

from gcn_maxcut.core import graph_from_dense, dense_adjacency
from gcn_maxcut.ops import (
    spmm_xla,
    sddmm,
    segment_sum_edges,
    pin_terminals,
    ste_argmax_onehot,
    ste_threshold,
)


def _graph_and_dense(n=19, p=0.35, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    return graph_from_dense(a), a


def test_spmm_matches_dense():
    g, a = _graph_and_dense()
    x = np.random.default_rng(1).normal(size=(g.n_pad, 7)).astype(np.float32)
    y = np.asarray(spmm_xla(g, jnp.asarray(x)))
    expect = a @ x[: a.shape[0]]
    np.testing.assert_allclose(y[: a.shape[0]], expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y[a.shape[0] :], 0.0, atol=1e-6)


def test_spmm_weighted():
    rng = np.random.default_rng(2)
    n = 12
    a = np.triu(rng.random((n, n)) * (rng.random((n, n)) < 0.4), 1)
    a = (a + a.T).astype(np.float32)
    g = graph_from_dense(a)
    x = rng.normal(size=(g.n_pad, 5)).astype(np.float32)
    y = np.asarray(spmm_xla(g, jnp.asarray(x), edge_weights=g.weights))
    np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-5, atol=1e-5)


def test_spmm_gradient():
    g, a = _graph_and_dense(11, 0.4, 3)
    n = a.shape[0]

    def f(x):
        return jnp.sum(spmm_xla(g, x) ** 2)

    x = jnp.asarray(np.random.default_rng(4).normal(size=(g.n_pad, 3)), jnp.float32)
    grad = np.asarray(jax.grad(f)(x))
    # dense oracle: f = ||A x||^2, grad = 2 Aᵀ A x
    xd = np.asarray(x)[:n]
    expect = 2 * a.T @ (a @ xd)
    np.testing.assert_allclose(grad[:n], expect, rtol=1e-4, atol=1e-4)


def test_sddmm_matches_dense():
    g, a = _graph_and_dense(15, 0.4, 5)
    n = a.shape[0]
    rng = np.random.default_rng(6)
    s = rng.normal(size=(g.n_pad, 3)).astype(np.float32)
    scores = np.asarray(sddmm(g, jnp.asarray(s), jnp.asarray(s)))
    # Sum over edges of <s_u, s_v> should equal sum(A>0 entries of S Sᵀ)
    gram = s[:n] @ s[:n].T
    expect = float(np.sum((a > 0) * gram))
    np.testing.assert_allclose(float(np.sum(scores)), expect, rtol=1e-4)


def test_segment_sum_edges():
    g, a = _graph_and_dense(9, 0.5, 7)
    ones = jnp.ones((g.e_pad,), jnp.float32)
    deg = np.asarray(segment_sum_edges(g, ones))
    np.testing.assert_allclose(deg, np.asarray(g.degrees))


def test_pin_terminals_forward():
    h = jnp.asarray(np.random.default_rng(8).random((6, 3)), jnp.float32)
    out = np.asarray(pin_terminals(h))
    np.testing.assert_allclose(out[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[1], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(out[2], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(out[3:], np.asarray(h)[3:], atol=1e-6)


def test_pin_terminals_gradient_is_identity():
    # d/dh sum(c * pin(h)) == c everywhere, incl. pinned rows (STE).
    c = jnp.asarray(np.random.default_rng(9).normal(size=(5, 3)), jnp.float32)
    grad = jax.grad(lambda h: jnp.sum(c * pin_terminals(h)))(jnp.ones((5, 3)))
    np.testing.assert_allclose(np.asarray(grad), np.asarray(c), atol=1e-6)


def test_ste_argmax_forward_and_gradient():
    h = jnp.asarray([[0.2, 0.5, 0.3], [0.9, 0.05, 0.05]], jnp.float32)
    out = np.asarray(ste_argmax_onehot(h))
    np.testing.assert_allclose(out, [[0, 1, 0], [1, 0, 0]], atol=1e-6)
    c = jnp.asarray([[1.0, -2.0, 3.0], [0.5, 0.5, 0.5]], jnp.float32)
    grad = jax.grad(lambda x: jnp.sum(c * ste_argmax_onehot(x)))(h)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(c), atol=1e-6)


def test_ste_argmax_tie_breaks_low_index():
    h = jnp.asarray([[0.5, 0.5, 0.0]], jnp.float32)
    out = np.asarray(ste_argmax_onehot(h))
    np.testing.assert_allclose(out, [[1, 0, 0]], atol=1e-6)


def test_ste_threshold():
    h = jnp.asarray([0.2, 0.5, 0.8], jnp.float32)
    out = np.asarray(ste_threshold(h))
    np.testing.assert_allclose(out, [0, 1, 1], atol=1e-6)
    grad = jax.grad(lambda x: jnp.sum(ste_threshold(x) * 2.0))(h)
    np.testing.assert_allclose(np.asarray(grad), [2, 2, 2], atol=1e-6)


def test_ell_path_matches_segment_path():
    g, a = _graph_and_dense(25, 0.3, 11)
    assert g.ell_senders is not None
    x = jnp.asarray(np.random.default_rng(12).normal(size=(g.n_pad, 6)), jnp.float32)
    from gcn_maxcut.ops.segment import spmm, spmm_ell

    np.testing.assert_allclose(
        np.asarray(spmm_ell(g, x, "mask")), np.asarray(spmm_xla(g, x)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(spmm_ell(g, x, "weights")),
        np.asarray(spmm_xla(g, x, edge_weights=g.weights)),
        rtol=1e-5,
    )


def test_ell_bf16_feature_mode_matches_f32():
    """Opt-in bf16 gather path (byte-bound expander lever): output f32,
    values within bf16 read tolerance of the f32 path, fwd and bwd."""
    g, a = _graph_and_dense(25, 0.3, 11)
    assert g.ell_senders is not None
    x = jnp.asarray(
        np.random.default_rng(12).normal(size=(g.n_pad, 6)), jnp.float32
    )
    from gcn_maxcut.ops.segment import spmm

    y32 = np.asarray(spmm(g, x))
    y16 = np.asarray(spmm(g, x, feature_dtype=jnp.bfloat16))
    assert y16.dtype == np.float32
    scale = np.abs(y32).max() + 1e-9
    np.testing.assert_allclose(y16 / scale, y32 / scale, atol=2e-2)
    # bf16 input directly dispatches the same path
    y16b = np.asarray(spmm(g, x.astype(jnp.bfloat16)))
    np.testing.assert_allclose(y16b, y16, rtol=0, atol=0)
    # backward: symmetric gather on the bf16-cast cotangent
    g16 = jax.grad(
        lambda x_: jnp.sum(jnp.tanh(spmm(g, x_, feature_dtype=jnp.bfloat16)))
    )(x)
    g32 = jax.grad(lambda x_: jnp.sum(jnp.tanh(spmm(g, x_))))(x)
    gs = np.abs(np.asarray(g32)).max() + 1e-9
    np.testing.assert_allclose(
        np.asarray(g16) / gs, np.asarray(g32) / gs, atol=3e-2
    )


def test_ell_custom_vjp_matches_autodiff():
    import jax

    g, a = _graph_and_dense(17, 0.4, 13)
    x = jnp.asarray(np.random.default_rng(14).normal(size=(g.n_pad, 4)), jnp.float32)
    from gcn_maxcut.ops.segment import spmm

    g1 = jax.grad(lambda x_: jnp.sum(jnp.tanh(spmm(g, x_))))(x)
    g2 = jax.grad(lambda x_: jnp.sum(jnp.tanh(spmm_xla(g, x_))))(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4, atol=1e-5)


def test_ell_skipped_for_high_degree_rows():
    # a star graph with degree > ELL_MAX_DEGREE falls back to COO-only
    n = 80
    adj = np.zeros((n, n), np.float32)
    adj[0, 1:] = 1.0
    adj[1:, 0] = 1.0
    from gcn_maxcut.core.graph import ELL_MAX_DEGREE

    assert n - 1 > ELL_MAX_DEGREE
    g = graph_from_dense(adj)
    assert g.ell_senders is None
    x = jnp.ones((g.n_pad, 3), jnp.float32)
    from gcn_maxcut.ops.segment import spmm

    y = np.asarray(spmm(g, x))
    assert y[0, 0] == n - 1  # hub aggregates all leaves
