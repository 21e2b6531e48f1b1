"""Baselines: randomized, local search, SA, BLS, exact/flow/anytime solvers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.data import generate_graph, process_graphs, DataConfig
from gcn_maxcut.baselines import (
    randomized_k_way_maxcut,
    evaluate_algorithm_on_graphs,
    test_fixed_terminals as fixed_terminals_harness,
    greedy_flip_local_search,
    simulated_annealing,
    breakout_local_search,
    brute_force_maxcut,
    recursive_flow_min_cut,
    anytime_solver,
    solver_balanced,
)
from gcn_maxcut.objectives import hard_cut_value
from oracle import brute_force_maxcut as oracle_bf, oracle_cut_value


def _graph(n=18, d=4, seed=0):
    spec = generate_graph(n=n, d=d, graph_type="reg", seed=seed)
    ds = process_graphs([spec], DataConfig(max_nodes=n))
    return ds.graphs[0]


def _dense(g):
    n = int(g.n_nodes)
    adj = np.zeros((n, n), np.float32)
    s, r, w = np.asarray(g.senders), np.asarray(g.receivers), np.asarray(g.weights)
    m = np.asarray(g.edge_mask) > 0
    adj[r[m], s[m]] = w[m]
    return adj


def test_randomized_pins_terminals_and_valid_cut():
    g = _graph()
    asn, cut, used = randomized_k_way_maxcut(g, k=3, max_iterations=300, seed=0)
    assert list(asn[:3]) == [0, 1, 2]
    full = np.zeros(g.n_pad, np.int64)
    full[: len(asn)] = asn
    np.testing.assert_allclose(float(hard_cut_value(g, jnp.asarray(full))), cut)
    assert 0 < used <= 300


def test_randomized_early_stop():
    g = _graph()
    _, _, used = randomized_k_way_maxcut(
        g, k=3, max_iterations=100_000, patience=50, seed=1
    )
    assert used < 100_000  # patience must trigger long before the budget


def test_randomized_free_vs_fixed():
    g = _graph(n=20, seed=2)
    out = fixed_terminals_harness(g, iterations=200, seed=2)
    assert out["fixed"]["terminals_ok"] is True
    assert out["free"]["cut"] > 0


def test_evaluate_on_graphs():
    gs = [_graph(n=16, seed=s) for s in range(3)]
    res = evaluate_algorithm_on_graphs(gs, max_iterations=100)
    assert len(res["cuts"]) == 3
    assert res["avg_cut"] > 0


def test_greedy_local_search_reaches_local_opt():
    g = _graph(n=20, seed=3)
    init = jnp.where(
        jnp.arange(g.n_pad) < 3, jnp.arange(g.n_pad), jnp.zeros(g.n_pad, jnp.int32)
    )
    cut0 = float(hard_cut_value(g, init))
    asn, cut = greedy_flip_local_search(g, init.astype(jnp.int32))
    assert float(cut) >= cut0
    # local optimality: no single move improves
    from gcn_maxcut.baselines.local_search import _move_gains

    gains = np.asarray(_move_gains(g, asn, 3, 3))
    assert np.nanmax(gains[np.isfinite(gains)]) <= 1e-5
    # terminals untouched
    assert list(np.asarray(asn)[:3]) == [0, 1, 2]


def test_simulated_annealing_improves_random():
    g = _graph(n=24, d=4, seed=4)
    key = jax.random.PRNGKey(4)
    init = jax.random.randint(key, (g.n_pad,), 0, 3)
    init = jnp.where(jnp.arange(g.n_pad) < 3, jnp.arange(g.n_pad), init)
    cut0 = float(hard_cut_value(g, init))
    asn, cut = simulated_annealing(g, init, jax.random.PRNGKey(5), steps=2000)
    assert float(cut) >= cut0
    # returned cut matches recomputed cut of returned assignment
    np.testing.assert_allclose(float(hard_cut_value(g, asn)), float(cut), rtol=1e-6)
    assert list(np.asarray(asn)[:3]) == [0, 1, 2]


def test_bls_runs_and_beats_init():
    g = _graph(n=20, seed=6)
    asn, cut = breakout_local_search(g, jax.random.PRNGKey(6), rounds=3)
    assert float(cut) > 0
    assert list(np.asarray(asn)[:3]) == [0, 1, 2]


def test_multi_max_cut_recursive():
    """Recursive 2-way-split heuristic (reference huerestics_multi-max.ipynb
    cell 6): valid k-way assignment, terminals in distinct classes, cut
    consistent with the oracle evaluator and at least random-floor quality."""
    from gcn_maxcut.baselines import multi_max_cut_recursive

    g = _graph(n=24, d=4, seed=11)
    asn, cut = multi_max_cut_recursive(g, [0, 1, 2], jax.random.PRNGKey(3))
    a = np.asarray(asn)[: int(g.n_nodes)]
    assert list(a[:3]) == [0, 1, 2]
    assert set(a) <= {0, 1, 2}
    adj = _dense(g)
    assert float(cut) == pytest.approx(oracle_cut_value(adj, a))
    # best-of-10 random bisections recursed should beat a single random cut's
    # expectation (2/3 of edges) on at least this fixed instance
    total_w = adj.sum() / 2
    assert float(cut) >= 0.60 * total_w


def test_multi_max_cut_recursive_k4_separates_terminals():
    from gcn_maxcut.baselines import multi_max_cut_recursive

    g = _graph(n=20, d=4, seed=12)
    asn, cut = multi_max_cut_recursive(g, [0, 1, 2, 3], jax.random.PRNGKey(4))
    a = np.asarray(asn)[: int(g.n_nodes)]
    assert list(a[:4]) == [0, 1, 2, 3]
    assert float(cut) > 0


def test_brute_force_matches_oracle():
    g = _graph(n=10, d=3, seed=7)
    adj = _dense(g)
    expect_val, _ = oracle_bf(adj, 3, fixed={0: 0, 1: 1, 2: 2})
    asn, cut = brute_force_maxcut(g, k=3)
    assert cut == pytest.approx(expect_val)
    assert oracle_cut_value(adj, asn) == pytest.approx(expect_val)
    assert list(asn[:3]) == [0, 1, 2]


def test_anytime_solver_exact_mode():
    g = _graph(n=12, d=3, seed=8)
    res = anytime_solver(g, k=3, time_limit=30)
    assert res["method"] == "exact_brute_force"
    adj = _dense(g)
    expect_val, _ = oracle_bf(adj, 3, fixed={0: 0, 1: 1, 2: 2})
    assert res["cut_value"] == pytest.approx(expect_val)


def test_anytime_solver_sa_mode():
    g = _graph(n=40, d=4, seed=9)
    res = anytime_solver(g, k=3, time_limit=5, sa_steps=1000)
    assert res["method"] == "sa_anytime"
    assert res["restarts"] >= 1
    assert res["cut_value"] > 0
    # SA + greedy should beat a single random assignment handily
    rng = np.random.default_rng(0)
    rand = np.zeros(g.n_pad, np.int64)
    rand[:40] = rng.integers(0, 3, 40)
    rand[:3] = [0, 1, 2]
    assert res["cut_value"] >= float(hard_cut_value(g, jnp.asarray(rand)))


def test_recursive_flow_min_cut_valid():
    g = _graph(n=14, d=3, seed=10)
    asn, val = recursive_flow_min_cut(g)
    assert asn is not None
    assert set(np.unique(asn[:3])) == {0, 1, 2}
    adj = _dense(g)
    assert val == pytest.approx(oracle_cut_value(adj, asn))


def test_solver_balanced_sizes():
    g = _graph(n=18, d=4, seed=11)
    res = solver_balanced(g, k=3, time_limit=5)
    sizes = res["partition_sizes"]
    assert sum(sizes) == 18
    assert max(sizes) - min(sizes) <= 1 + 18 % 3  # near-balanced
    assert res["cut_value"] > 0


def test_analyze_benchmark_results(tmp_path):
    from gcn_maxcut.baselines.analysis import analyze_benchmark_results

    results = {
        (100, 3): {"cut": 300.0, "time": 0.1},
        (100, 4): {"cut": 320.0, "time": 0.12},
        (200, 3): {"cut": 610.0, "time": 0.2},
        (200, 4): {"cut": 640.0, "time": 0.22},
    }
    summary = analyze_benchmark_results(
        results, degree=8, save_path=str(tmp_path / "bench.png")
    )
    assert summary["node_sizes"] == [100, 200]
    assert summary["k_values"] == [3, 4]
    np.testing.assert_allclose(
        summary["by_k"][3]["normalized_cut"], [300 / 400, 610 / 800]
    )
    assert (tmp_path / "bench.png").exists()


def test_greedy_sweep_numpy_fallback_matches_contract():
    """The numpy stochastic-parallel fallback honors the sweep contract:
    terminals fixed, returned cut consistent, beats the random floor."""
    import numpy as np
    from unittest import mock
    from gcn_maxcut.baselines import greedy_sweep_maxcut
    from gcn_maxcut.data.generate import random_regular_edges

    n, d, k = 512, 6, 3
    edges = random_regular_edges(n, d, seed=4)
    rng = np.random.default_rng(1)
    init = rng.integers(0, k, n)
    init[:k] = np.arange(k)
    with mock.patch(
        "gcn_maxcut.native.bindings.greedy_sweep_native",
        return_value=None,
    ):
        asn, cut, sweeps = greedy_sweep_maxcut(edges, n, init, k=k)
    recount = float((asn[edges[:, 0]] != asn[edges[:, 1]]).sum())
    assert recount == cut
    np.testing.assert_array_equal(asn[:k], np.arange(k))
    assert cut / edges.shape[0] > (k - 1) / k + 0.03
    # native path agrees on the contract (values differ by search order)
    asn2, cut2, _ = greedy_sweep_maxcut(edges, n, init.copy(), k=k)
    assert cut2 / edges.shape[0] > (k - 1) / k + 0.03
