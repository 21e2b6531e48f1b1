"""Giant-graph sharded training on the virtual 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.data.generate import random_regular_edges
from gcn_maxcut.parallel.giant import (
    GiantConfig,
    sharded_cut,
    train_giant_graph,
)
from gcn_maxcut.parallel.partition import (
    local_shard,
    shard_graph,
    shard_specs,
)
from gcn_maxcut.parallel.mesh import make_mesh
from jax.sharding import PartitionSpec as P

from gcn_maxcut.core import graph_from_edges
from gcn_maxcut.objectives import relaxed_cut_value


def _coo(n, d, seed):
    e = random_regular_edges(n, d, seed=seed)
    return (
        np.concatenate([e[:, 0], e[:, 1]]),
        np.concatenate([e[:, 1], e[:, 0]]),
        e,
    )


def test_sharded_cut_matches_single_device():
    n = 64
    s_arr, r_arr, e = _coo(n, 4, 0)
    g = graph_from_edges(e, n, n_pad=n)
    sg, g2l = shard_graph(s_arr, r_arr, n, 8)
    n_shard = sg.n_shard

    rng = np.random.default_rng(1)
    probs = rng.dirichlet([1, 1, 1], size=n).astype(np.float32)
    expect = float(relaxed_cut_value(g, jnp.asarray(probs)))

    owner, local = g2l // n_shard, g2l % n_shard
    s_sh = np.zeros((8, n_shard, 3), np.float32)
    s_sh[owner, local] = probs

    mesh = make_mesh(("graph",))
    got = jax.jit(
        jax.shard_map(
            lambda sg_, s_: sharded_cut(local_shard(sg_), s_[0], "graph"),
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P(),
        )
    )(sg, jnp.asarray(s_sh))
    np.testing.assert_allclose(float(got), expect, rtol=1e-4)


def test_train_giant_graph_improves_cut():
    n, d = 128, 4
    s_arr, r_arr, _ = _coo(n, d, 2)
    cfg = GiantConfig(
        dim_embedding=16,
        hidden_dim=8,
        learning_rate=5e-3,
        number_epochs=60,
        log_every=10,
    )
    res = train_giant_graph(s_arr, r_arr, n, cfg)
    total_edges = n * d // 2
    assert res["total_edges"] == total_edges
    # trained cut should beat the uniform-random expectation (2/3 of edges)
    assert res["final_cut"] > total_edges * 2 / 3
    assert res["num_shards"] == 8
    assert np.isfinite(res["edges_per_s"])


def test_train_giant_graph_allgather_schedule():
    n, d = 96, 4
    s_arr, r_arr, _ = _coo(n, d, 3)
    cfg = GiantConfig(
        dim_embedding=8, hidden_dim=8, number_epochs=10,
        schedule="allgather", log_every=5,
    )
    res = train_giant_graph(s_arr, r_arr, n, cfg)
    assert np.isfinite(res["final_cut"])


def test_measure_throughput_amortized():
    # variance-controlled timing path: k_hi/k_lo chunk difference inside
    # one jit each (PARITY §5's trusted method); smoke on the virtual mesh
    n, d = 96, 4
    s_arr, r_arr, _ = _coo(n, d, 4)
    cfg = GiantConfig(
        dim_embedding=8, hidden_dim=8, number_epochs=4,
        epochs_per_call=2, log_every=2,
    )
    res = train_giant_graph(s_arr, r_arr, n, cfg, measure_throughput=True)
    assert res["edges_per_s_amortized"] > 0
    assert res["epoch_time_s_amortized"] > 0
    assert "amortized" in res["timing_method"]
    assert np.isfinite(res["timing_spread_s"])


def test_giant_checkpoint_resume_reproduces_trajectory(tmp_path):
    """Chunk-aligned resume reproduces the uninterrupted run exactly
    (deterministic scanned epochs + full opt-state restore)."""
    import numpy as np
    from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph

    n = 256
    offs = (1, 2, 5)
    s = np.concatenate([np.arange(n) for _ in offs]).astype(np.int64)
    r = np.concatenate([(np.arange(n) + o) % n for o in offs]).astype(
        np.int64
    )
    S, R = np.concatenate([s, r]), np.concatenate([r, s])
    base = dict(
        num_classes=3, dim_embedding=16, hidden_dim=8,
        epochs_per_call=4, log_every=1, seed=0,
    )
    full = train_giant_graph(
        S, R, n, GiantConfig(number_epochs=8, **base)
    )
    ckpt = str(tmp_path / "giant_ck")
    first = train_giant_graph(
        S, R, n, GiantConfig(number_epochs=4, **base),
        checkpoint_path=ckpt,
    )
    resumed = train_giant_graph(
        S, R, n, GiantConfig(number_epochs=8, **base),
        resume_from=ckpt,
    )
    assert resumed["epochs"] == 8
    np.testing.assert_allclose(
        resumed["final_loss"], full["final_loss"], rtol=1e-6
    )


def test_giant_trainer_metis_partition():
    """partition='metis' end-to-end through the sharded trainer on a
    semi-local graph: trains and matches the contiguous-partition cut
    band (the objective is partition-invariant; only ring traffic moves)."""
    import numpy as np
    from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph

    n = 1024
    rng = np.random.default_rng(0)
    offs = rng.choice(np.arange(1, 65), 2, replace=False)
    s = np.concatenate([np.arange(n)] * 2)
    r = np.concatenate([(np.arange(n) + o) % n for o in offs])
    rew = rng.random(r.shape[0]) < 0.05
    r = np.where(rew, rng.integers(0, n, r.shape[0]), r)
    keep = s != r
    s, r = s[keep], r[keep]
    S, R = np.concatenate([s, r]), np.concatenate([r, s])
    base = dict(
        num_classes=3, dim_embedding=16, hidden_dim=8,
        number_epochs=12, epochs_per_call=4, log_every=4, seed=0,
    )
    out_m = train_giant_graph(S, R, n, GiantConfig(partition="metis", **base))
    out_c = train_giant_graph(S, R, n, GiantConfig(**base))
    e_und = S.shape[0] // 2
    assert out_m["final_cut"] / e_und > 0.5
    assert abs(out_m["final_cut"] - out_c["final_cut"]) / e_und < 0.1
