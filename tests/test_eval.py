"""Decoders, sampling post-processor, analysis/report contract."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.data import generate_graph, process_graphs, DataConfig
from gcn_maxcut.eval import (
    simple_assignment,
    sample_partitions,
    post_process,
    terminal_permutation_search,
    test_single_graph as eval_single_graph,
    test_multiple_graphs as eval_multiple_graphs,
    analyze_results,
    print_analysis_report,
    generate_summary_report,
    save_results,
    load_results,
)
from gcn_maxcut.models import gcn_softmax_init
from gcn_maxcut.objectives import hard_cut_value
from oracle import oracle_cut_value


def _graph(n=20, seed=0):
    spec = generate_graph(n=n, d=4, graph_type="reg", seed=seed)
    ds = process_graphs([spec], DataConfig(max_nodes=32))
    return ds.graphs[0], ds


def test_simple_assignment_pins_terminals():
    probs = jnp.asarray(np.random.default_rng(0).dirichlet([1, 1, 1], size=8))
    asn = np.asarray(simple_assignment(probs))
    assert asn[0] == 0 and asn[1] == 1 and asn[2] == 2
    expect = np.argmax(np.asarray(probs), axis=1)
    np.testing.assert_array_equal(asn[3:], expect[3:])


def test_sample_partitions_distribution():
    # nodes with deterministic distributions sample deterministically
    probs = jnp.asarray(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0]], jnp.float32
    )
    samples = np.asarray(
        sample_partitions(probs, jax.random.PRNGKey(0), num_samples=50)
    )
    assert samples.shape == (50, 5)
    assert np.all(samples[:, 0] == 0) and np.all(samples[:, 1] == 1)
    assert np.all(samples[:, 3] == 2) and np.all(samples[:, 4] == 0)


def test_sample_partitions_statistics():
    probs = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.6, 0.3, 0.1]])
    samples = np.asarray(
        sample_partitions(probs, jax.random.PRNGKey(1), num_samples=4000)
    )
    freq = np.bincount(samples[:, 3], minlength=3) / 4000
    np.testing.assert_allclose(freq, [0.6, 0.3, 0.1], atol=0.04)


def test_sample_partitions_fallback_last_class():
    # probabilities summing below 1 must fall back to the LAST class
    probs = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.0, 0.0, 0.0]])
    samples = np.asarray(
        sample_partitions(probs, jax.random.PRNGKey(2), num_samples=20)
    )
    assert np.all(samples[:, 3] == 2)


def test_post_process_beats_or_matches_best_sample():
    g, _ = _graph()
    rng = np.random.default_rng(3)
    probs = jnp.asarray(rng.dirichlet([1, 1, 1], size=g.n_pad), jnp.float32)
    asn, cut = post_process(g, probs, jax.random.PRNGKey(3), iterations=100)
    # returned cut must equal the cut of the returned assignment
    np.testing.assert_allclose(float(hard_cut_value(g, asn)), float(cut))
    # and must be >= a single sample's cut (same key, first sample)
    one = sample_partitions(probs, jax.random.PRNGKey(3), 100)[0]
    assert float(cut) >= float(hard_cut_value(g, one))


def test_terminal_permutation_search_improves_or_equal():
    g, _ = _graph(seed=5)
    probs = jnp.asarray(
        np.random.default_rng(5).dirichlet([1, 1, 1], size=g.n_pad), jnp.float32
    )
    base_asn = simple_assignment(probs)
    base_cut = float(hard_cut_value(g, base_asn))
    best_asn, best_cut = terminal_permutation_search(g, probs)
    assert float(best_cut) >= base_cut
    assert np.asarray(best_asn)[0] == 0


def test_single_and_multiple_graphs_end_to_end():
    specs = [generate_graph(n=20, d=4, seed=s) for s in range(4)]
    ds = process_graphs(specs, DataConfig(max_nodes=32))
    params = gcn_softmax_init(jax.random.PRNGKey(0), 32, 16, 3)

    res = eval_single_graph(params, ds.graphs[0], jax.random.PRNGKey(1), 50)
    assert res["success"]
    for key in (
        "nodes", "edges", "simple_cut", "simple_time", "post_cut",
        "post_time", "improvement", "improvement_percent", "node_probabilities",
    ):
        assert key in res
    assert res["post_cut"] >= 0

    results, by_size = eval_multiple_graphs(
        params, ds, graph_sizes=[20], post_processing_iterations=50, verbose=False
    )
    assert len(results) == 4
    analysis = analyze_results(results, by_size, [20])
    assert analysis["total_tests"] == 4
    assert 20 in analysis["size_analysis"]
    assert analysis["better_count"] + analysis["same_count"] + analysis[
        "worse_count"
    ] == 4

    report = print_analysis_report(analysis, [20])
    assert "Performance Analysis" in report
    summary = generate_summary_report(analysis, {"graph_sizes": [20]})
    assert "Recommendation" in summary


def test_size_bucketing_tolerance():
    # 22-node graph buckets into configured size 20 (±5 tolerance)
    specs = [generate_graph(n=22, d=4, seed=9)]
    ds = process_graphs(specs, DataConfig(max_nodes=32))
    params = gcn_softmax_init(jax.random.PRNGKey(0), 32, 16, 3)
    results, by_size = eval_multiple_graphs(
        params, ds, [20], post_processing_iterations=10, verbose=False
    )
    assert len(results) == 1
    assert results[0]["graph_size"] == 20
    # a 40-node graph does not match any configured size -> skipped
    specs2 = [generate_graph(n=40, d=4, seed=10)]
    ds2 = process_graphs(specs2, DataConfig(max_nodes=64))
    results2, _ = eval_multiple_graphs(
        params, ds2, [20], post_processing_iterations=10, verbose=False
    )
    assert results2 == []


def test_save_load_results_roundtrip(tmp_path):
    specs = [generate_graph(n=20, d=4, seed=11)]
    ds = process_graphs(specs, DataConfig(max_nodes=32))
    params = gcn_softmax_init(jax.random.PRNGKey(0), 32, 16, 3)
    results, by_size = eval_multiple_graphs(
        params, ds, [20], post_processing_iterations=10, verbose=False
    )
    analysis = analyze_results(results, by_size, [20])
    p = save_results(
        tmp_path / "results.json", results, by_size, analysis, {"sizes": [20]}
    )
    loaded = load_results(p)
    assert loaded["analysis"]["total_tests"] == 1
    assert "timestamp" in loaded


def test_refine_path_in_harness():
    specs = [generate_graph(n=24, d=4, seed=21)]
    ds = process_graphs(specs, DataConfig(max_nodes=32))
    params = gcn_softmax_init(jax.random.PRNGKey(0), 32, 16, 3)
    res = eval_single_graph(
        params, ds.graphs[0], jax.random.PRNGKey(2), 30, refine=True
    )
    assert res["success"]
    assert "refined_cut" in res and "refined_time" in res
    # refinement never loses cut value
    assert res["refined_cut"] >= res["post_cut"] - 1e-6
    # refined assignment keeps terminals pinned
    np.testing.assert_array_equal(res["refined_assignment"][:3], [0, 1, 2])


def test_enhanced_baseline_stats():
    from gcn_maxcut.data.enhanced import compute_baseline_stats

    specs = [generate_graph(n=14, d=3, seed=22)]
    ds = process_graphs(specs, DataConfig(max_nodes=16))
    stats = compute_baseline_stats(
        ds, randomized_iterations=100, solver_time_limit=5
    )
    rec = stats[0]
    assert rec["n_nodes"] == 14
    assert rec["randomized_cut"] > 0
    assert rec["solver_cut"] >= rec["randomized_cut"] - 1e-6
    assert "flow_min_cut_value" in rec
    assert ds.baseline_stats is stats


def test_refine_multi_start_beats_or_matches_single():
    """The multi-start climb explores >= the single-start basin, so its cut
    is never worse; starts=1 path also works through the harness."""
    from gcn_maxcut.eval.decode import refine_multi_start

    specs = [generate_graph(n=40, d=5, seed=33)]
    ds = process_graphs(specs, DataConfig(max_nodes=48))
    g = ds.graphs[0]
    params = gcn_softmax_init(jax.random.PRNGKey(0), 48, 16, 3)
    res1 = eval_single_graph(
        params, g, jax.random.PRNGKey(5), 30, refine=True, refine_starts=1,
        measure_times=False,
    )
    res4 = eval_single_graph(
        params, g, jax.random.PRNGKey(5), 30, refine=True, refine_starts=4,
        measure_times=False,
    )
    assert res1["success"] and res4["success"]
    assert res4["refined_cut"] >= res1["post_cut"] - 1e-6
    np.testing.assert_array_equal(res4["refined_assignment"][:3], [0, 1, 2])
    # direct API: assignment valid, cut consistent
    from gcn_maxcut.core.graph import dense_adjacency
    from gcn_maxcut.models.gcn import gcn_softmax_apply
    from gcn_maxcut.objectives.cut_loss import hard_cut_value

    probs = gcn_softmax_apply(params, g, dense_adjacency(g, width=48))
    asn, cut = refine_multi_start(g, probs, jax.random.PRNGKey(5), 30, 4)
    assert float(cut) == float(hard_cut_value(g, asn))
