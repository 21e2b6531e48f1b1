"""Cut objectives vs the reference's dense formula and brute force."""

import numpy as np
import jax
import jax.numpy as jnp

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.objectives import (
    relaxed_cut_value,
    compute_loss,
    cut_loss,
    terminal_independence_penalty,
    balance_penalty,
    hard_cut_value,
    find_ac_parameters,
    qubo_loss,
)
from oracle import oracle_hc, dense_pad, oracle_cut_value, brute_force_maxcut


def _rand_graph(n=21, p=0.35, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    if weighted:
        a = a * rng.integers(1, 5, size=a.shape).astype(np.float32)
    a = a + a.T
    return graph_from_dense(a), a


def _rand_probs(rng, n_pad, n, k=3):
    s = rng.random((n_pad, k)).astype(np.float32)
    s /= s.sum(axis=1, keepdims=True)
    s[n:] = 0.0  # padding rows contribute nothing anyway (no incident edges)
    return s


def test_relaxed_cut_matches_dense_formula():
    for seed in range(4):
        g, a = _rand_graph(seed=seed, weighted=(seed % 2 == 0))
        n = a.shape[0]
        rng = np.random.default_rng(seed + 100)
        s = _rand_probs(rng, g.n_pad, n)
        ours = float(relaxed_cut_value(g, jnp.asarray(s)))
        # Reference formula: A padded to n×1000, S Sᵀ padded to same width.
        a_padded = dense_pad(a, 1000)
        expect = oracle_hc(s[:n], a_padded)
        np.testing.assert_allclose(ours, expect, rtol=1e-4)


def test_relaxed_cut_on_onehot_equals_hard_cut():
    g, a = _rand_graph(seed=7)
    n = a.shape[0]
    rng = np.random.default_rng(11)
    asn = rng.integers(0, 3, size=g.n_pad)
    s = np.eye(3, dtype=np.float32)[asn]
    relaxed = float(relaxed_cut_value(g, jnp.asarray(s)))
    hard = float(hard_cut_value(g, jnp.asarray(asn)))
    expect = oracle_cut_value(a, asn[:n])
    np.testing.assert_allclose(relaxed, expect, rtol=1e-5)
    np.testing.assert_allclose(hard, expect, rtol=1e-5)


def test_compute_loss_sign_and_scale():
    g, a = _rand_graph(seed=3)
    n = a.shape[0]
    s = _rand_probs(np.random.default_rng(5), g.n_pad, n)
    hc = float(relaxed_cut_value(g, jnp.asarray(s)))
    loss = float(compute_loss(g, jnp.asarray(s), C=2.5))
    np.testing.assert_allclose(loss, -2.5 * hc, rtol=1e-5)
    assert float(cut_loss(g, jnp.asarray(s))) < 0  # maximizing a positive cut


def test_loss_gradient_matches_dense_oracle():
    g, a = _rand_graph(n=13, seed=9)
    n = a.shape[0]
    s = jnp.asarray(_rand_probs(np.random.default_rng(10), g.n_pad, n))
    grad = np.asarray(jax.grad(lambda s_: cut_loss(g, s_))(s))
    # dense: HC = sum(A (1 - S Sᵀ))/2 ⇒ dHC/dS = -A S; loss = -HC ⇒ grad = A S.
    expect = a @ np.asarray(s)[:n]
    np.testing.assert_allclose(grad[:n], expect, rtol=1e-4, atol=1e-5)


def test_terminal_independence_penalty():
    s = jnp.asarray(
        [[0.5, 0.5, 0.0], [0.5, 0.25, 0.25], [0.0, 0.0, 1.0], [0.1, 0.2, 0.7]],
        jnp.float32,
    )
    got = float(terminal_independence_penalty(s, 3))
    expect = (
        np.dot(s[0], s[1]) + np.dot(s[0], s[2]) + np.dot(s[1], s[2])
    )
    np.testing.assert_allclose(got, float(expect), rtol=1e-6)


def test_balance_penalty_zero_when_balanced():
    g, _ = _rand_graph(n=9, seed=2)
    s = np.zeros((g.n_pad, 3), np.float32)
    for i in range(9):
        s[i, i % 3] = 1.0
    assert float(balance_penalty(g, jnp.asarray(s))) < 1e-6


def test_find_ac_parameters():
    g, a = _rand_graph(seed=4)
    A, C = find_ac_parameters(g)
    maxdeg = a.sum(axis=1).max()
    np.testing.assert_allclose(float(A), maxdeg + 1)
    np.testing.assert_allclose(float(C), maxdeg / 2)


def test_qubo_equals_negative_cut_on_binary():
    g, a = _rand_graph(n=14, seed=6, weighted=True)
    n = a.shape[0]
    rng = np.random.default_rng(12)
    x = rng.integers(0, 2, size=g.n_pad).astype(np.float32)
    got = float(qubo_loss(g, jnp.asarray(x)))
    expect = -oracle_cut_value(a, np.asarray(x)[:n].astype(int))
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_hard_cut_matches_bruteforce_optimum_value():
    # sanity: hard_cut_value agrees with oracle on the brute-force optimum
    rng = np.random.default_rng(13)
    a = np.triu((rng.random((7, 7)) < 0.6).astype(np.float32), 1)
    a = a + a.T
    g = graph_from_dense(a)
    best_val, best_asn = brute_force_maxcut(a, 3)
    asn = np.zeros(g.n_pad, dtype=np.int64)
    asn[:7] = best_asn
    np.testing.assert_allclose(float(hard_cut_value(g, jnp.asarray(asn))), best_val)
