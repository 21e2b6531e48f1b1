"""Loss-variant zoo, QUBO training loop, debug/profiling utilities."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.data import generate_graph, process_graphs, DataConfig
from gcn_maxcut.objectives import relaxed_cut_value
from gcn_maxcut.objectives.variants import (
    ha_one_hot_penalty,
    intra_partition_weight,
    min_cut_intra_inter,
    min_cut_loss_pairwise,
    per_partition_cut,
    weighted_cut_loss,
)
from gcn_maxcut.train.qubo_loop import QuboConfig, run_gnn_training
from oracle import oracle_cut_value


def _graph(n=16, d=4, seed=0):
    spec = generate_graph(n=n, d=d, graph_type="reg", seed=seed)
    ds = process_graphs([spec], DataConfig(max_nodes=n))
    return ds.graphs[0]


def _rand_probs(g, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.dirichlet([1, 1, 1], size=g.n_pad).astype(np.float32)
    return jnp.asarray(s)


def test_ha_zero_on_onehot():
    g = _graph()
    onehot = jax.nn.one_hot(jnp.zeros(g.n_pad, jnp.int32), 3)
    assert float(ha_one_hot_penalty(g, onehot)) == pytest.approx(0.0)
    soft = jnp.full((g.n_pad, 3), 1 / 3)
    # uniform rows: per-node penalty = 1 - 1/3 = 2/3 over real nodes
    assert float(ha_one_hot_penalty(g, soft)) == pytest.approx(
        float(g.n_nodes) * 2 / 3, rel=1e-5
    )


def test_intra_plus_inter_equals_total_weight():
    g = _graph(seed=1)
    s = _rand_probs(g, 1)
    total = float(jnp.sum(g.weights * g.edge_mask)) / 2
    got = float(intra_partition_weight(g, s)) + float(relaxed_cut_value(g, s))
    assert got == pytest.approx(total, rel=1e-5)


def test_min_cut_intra_inter_signs():
    g = _graph(seed=2)
    s = _rand_probs(g, 2)
    v = min_cut_intra_inter(g, s, alpha=1.0, beta=1.0)
    expect = float(relaxed_cut_value(g, s)) - float(intra_partition_weight(g, s))
    assert float(v) == pytest.approx(expect, rel=1e-5)


def test_pairwise_equals_full_cut():
    g = _graph(seed=3)
    s = _rand_probs(g, 3)
    np.testing.assert_allclose(
        float(min_cut_loss_pairwise(g, s)),
        float(relaxed_cut_value(g, s)),
        rtol=1e-4,
    )


def test_per_partition_sums_to_cut():
    g = _graph(seed=4)
    s = _rand_probs(g, 4)
    per = per_partition_cut(g, s)
    assert per.shape == (3,)
    # each crossing edge contributes to exactly the sender's class boundary;
    # summed over classes = relaxed cut
    np.testing.assert_allclose(
        float(jnp.sum(per)), float(relaxed_cut_value(g, s)), rtol=1e-4
    )


def test_weighted_cut_loss_terms():
    g = _graph(seed=5)
    s = _rand_probs(g, 5)
    base = float(weighted_cut_loss(g, s, A=0.0, C=2.0))
    assert base == pytest.approx(-2.0 * float(relaxed_cut_value(g, s)), rel=1e-5)
    with_ha = float(weighted_cut_loss(g, s, A=1.5, C=2.0))
    assert with_ha == pytest.approx(
        base + 1.5 * float(ha_one_hot_penalty(g, s)), rel=1e-5
    )


def test_qubo_training_loop_end_to_end():
    g = _graph(n=24, d=4, seed=6)
    cfg = QuboConfig(
        dim_embedding=16, hidden_dim=8, learning_rate=1e-2,
        number_epochs=300, patience=30, seed=0,
    )
    params, results = run_gnn_training(g, cfg)
    assert results["epochs"] <= 300
    assert results["best_bitstring"] is not None
    bits = np.asarray(results["best_bitstring"])[:24]
    # best_cut must equal the actual 2-way cut of the bitstring
    adj = np.zeros((24, 24), np.float32)
    s, r, w = np.asarray(g.senders), np.asarray(g.receivers), np.asarray(g.weights)
    m = np.asarray(g.edge_mask) > 0
    adj[r[m], s[m]] = w[m]
    assert results["best_cut"] == pytest.approx(oracle_cut_value(adj, bits))
    # training should beat the all-zeros cut (0) clearly
    assert results["best_cut"] > 0


def test_debug_helpers():
    from gcn_maxcut.utils.debug import assert_finite, checked, debug_mode

    assert_finite({"a": jnp.ones(3)}, "params")
    with pytest.raises(FloatingPointError):
        assert_finite({"a": jnp.asarray([1.0, np.nan])})

    def div(x):
        return 1.0 / x

    safe = checked(div)
    assert float(safe(jnp.asarray(2.0))) == pytest.approx(0.5)
    with debug_mode(nans=False, infs=False):
        pass  # context restores config


def test_metrics_logger(tmp_path):
    from gcn_maxcut.utils.profiling import MetricsLogger

    ml = MetricsLogger(tmp_path / "metrics.jsonl")
    ml.log(0, loss=-5.0, cut=5.0)
    ml.log(1, loss=-6.0, cut=6.0)
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    assert ml.edges_per_s(100) > 0


def test_sampled_cut_stats_match_monte_carlo():
    """Closed-form (mean, var) of the sampled-decode cut vs 40k Monte-Carlo
    rollouts of the same independent per-node sampling."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gcn_maxcut.data.generate import generate_graph
    from gcn_maxcut.data.process import process_graphs, DataConfig
    from gcn_maxcut.objectives import sampled_cut_stats, hard_cut_value

    ds = process_graphs(
        [generate_graph(n=24, d=4, graph_type="reg", seed=5)],
        DataConfig(max_nodes=32),
    )
    g = ds.graphs[0]
    key = jax.random.PRNGKey(0)
    logits = jax.random.normal(key, (g.n_pad, 3))
    probs = jax.nn.softmax(logits, axis=-1)

    mean, var = sampled_cut_stats(g, probs)

    ks = jax.random.split(jax.random.PRNGKey(1), 40_000)
    asn = jax.vmap(
        lambda k: jax.random.categorical(k, jnp.log(probs + 1e-12), axis=-1)
    )(ks)
    cuts = np.asarray(jax.vmap(lambda a: hard_cut_value(g, a))(asn))
    np.testing.assert_allclose(float(mean), cuts.mean(), rtol=0.01)
    # variance: covariance between edges sharing a node is dropped in the
    # closed form, so allow a looser band
    assert 0.6 * cuts.var() < float(var) < 1.6 * cuts.var()


def test_quantile_loss_mode_trains():
    import numpy as np
    from gcn_maxcut.data.generate import generate_graph
    from gcn_maxcut.data.process import process_graphs, DataConfig
    from gcn_maxcut.train.config import TrainingConfig
    from gcn_maxcut.train.loop import train_model, pad_graph_batch

    ds = process_graphs(
        [generate_graph(n=24, d=4, graph_type="reg", seed=7)],
        DataConfig(max_nodes=32),
    )
    batch = pad_graph_batch([ds.graphs[0]])
    cfg = TrainingConfig(
        n_nodes=32, number_epochs=60, epochs_per_call=20, patience=100,
        loss_mode="quantile", seed=2,
    )
    params, best, epoch, _, hist = train_model(batch, cfg)
    assert np.isfinite(hist).all()
    # mean+c*std of the final model is well above the uniform-random mean
    assert -best > 2.0 / 3.0 * 48  # E = 24*4/2 = 48
    import pytest
    with pytest.raises(ValueError):
        TrainingConfig(n_nodes=32, loss_mode="bogus")
