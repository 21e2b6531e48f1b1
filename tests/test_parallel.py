"""Sharded SpMM / DP training on the virtual 8-device CPU mesh.

These exercise the exact shard_map code paths that run across real GPUs
(SURVEY.md §4c): partitioning invariants, ring-vs-allgather equivalence
with the single-device segment-sum SpMM, sharded GCN conv parity, and the
data-parallel epoch step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcn_maxcut.core import graph_from_edges, pad_graph_batch
from gcn_maxcut.data import generate_graph, process_graphs, DataConfig
from gcn_maxcut.models import gcn_conv_init, gcn_conv_apply
from gcn_maxcut.ops import spmm_xla
from gcn_maxcut.parallel import (
    make_mesh,
    shard_graph,
    partition_nodes_contiguous,
    partition_nodes_bfs,
    sharded_spmm_allgather,
    sharded_spmm_ring,
    make_dp_epoch_fn,
    shard_batch_for_dp,
)
from gcn_maxcut.parallel.spmm import sharded_gcn_conv
from gcn_maxcut.parallel.partition import shard_specs, local_shard
from gcn_maxcut.train import TrainingConfig, setup_train_state


D = 8  # virtual device count from conftest


def _random_coo(n, d, seed):
    from gcn_maxcut.data.generate import random_regular_edges

    e = random_regular_edges(n, d, seed=seed)
    senders = np.concatenate([e[:, 0], e[:, 1]])
    receivers = np.concatenate([e[:, 1], e[:, 0]])
    return senders, receivers


def test_partition_contiguous():
    owner = partition_nodes_contiguous(100, 8)
    counts = np.bincount(owner, minlength=8)
    assert counts.max() - counts.min() <= 13
    assert np.all(np.diff(owner) >= 0)


def test_partition_bfs_balanced_and_total():
    s, r = _random_coo(96, 4, 0)
    owner = partition_nodes_bfs(s, r, 96, 8)
    counts = np.bincount(owner, minlength=8)
    assert counts.sum() == 96
    assert counts.max() <= 12 + 4  # near-balanced


def test_shard_graph_grouping_invariant():
    s, r = _random_coo(64, 4, 1)
    sg, g2l = shard_graph(s, r, 64, 4)
    # every real edge must appear exactly once across groups
    total_real = float(np.asarray(sg.edge_mask).sum())
    assert total_real == s.shape[0]
    # degrees sum to directed edge count
    assert float(np.asarray(sg.degrees).sum()) == s.shape[0]


@pytest.mark.parametrize("schedule_fn", [sharded_spmm_allgather, sharded_spmm_ring])
def test_sharded_spmm_matches_single_device(schedule_fn):
    n, deg = 64, 4
    s, r = _random_coo(n, deg, 2)
    g = graph_from_edges(
        np.stack([s[: len(s) // 2], r[: len(s) // 2]], 1), n
    )
    sg, g2l = shard_graph(s, r, n, D)
    n_shard = sg.n_shard

    rng = np.random.default_rng(3)
    x_global = rng.normal(size=(n, 5)).astype(np.float32)
    # reference: dense aggregation
    dense = np.zeros((n, n), np.float32)
    dense[r, s] = 1.0
    expect = dense @ x_global

    # scatter x rows into sharded layout [D, n_shard, F]
    x_sh = np.zeros((D, n_shard, 5), np.float32)
    owner = g2l // n_shard
    local = g2l % n_shard
    x_sh[owner, local] = x_global

    mesh = make_mesh(("graph",))
    out = jax.jit(
        jax.shard_map(
            lambda sg_, x_: schedule_fn(local_shard(sg_), x_[0], "graph")[None],
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P("graph"),
        )
    )(sg, jnp.asarray(x_sh))
    out = np.asarray(out)
    got = out[owner, local]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_sharded_gcn_conv_matches_single_device():
    n, deg = 64, 4
    s, r = _random_coo(n, deg, 4)
    edges = np.stack([s[: len(s) // 2], r[: len(s) // 2]], 1)
    g = graph_from_edges(edges, n, n_pad=n)
    params = gcn_conv_init(jax.random.PRNGKey(0), 5, 3)
    rng = np.random.default_rng(5)
    x_global = rng.normal(size=(n, 5)).astype(np.float32)
    expect = np.asarray(gcn_conv_apply(params, g, jnp.asarray(x_global)))

    sg, g2l = shard_graph(s, r, n, D)
    n_shard = sg.n_shard
    owner, local = g2l // n_shard, g2l % n_shard
    x_sh = np.zeros((D, n_shard, 5), np.float32)
    x_sh[owner, local] = x_global

    mesh = make_mesh(("graph",))
    out = jax.jit(
        jax.shard_map(
            lambda sg_, x_: sharded_gcn_conv(
                params["w"],
                params["b"],
                local_shard(sg_),
                x_[0],
                "graph",
                schedule="ring",
            )[None],
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P("graph"),
        )
    )(sg, jnp.asarray(x_sh))
    got = np.asarray(out)[owner, local]
    np.testing.assert_allclose(got, expect[:n], rtol=1e-4, atol=1e-4)


def test_sharded_spmm_gradients_flow():
    n = 32
    s, r = _random_coo(n, 4, 6)
    sg, g2l = shard_graph(s, r, n, D)
    n_shard = sg.n_shard
    mesh = make_mesh(("graph",))

    def loss(x_sh):
        out = jax.shard_map(
            lambda sg_, x_: sharded_spmm_ring(local_shard(sg_), x_[0], "graph")[None],
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P("graph"),
        )(sg, x_sh)
        return jnp.sum(out**2)

    x = jnp.ones((D, n_shard, 3), jnp.float32)
    grad = jax.jit(jax.grad(loss))(x)
    assert np.isfinite(np.asarray(grad)).all()
    assert float(jnp.sum(jnp.abs(grad))) > 0


def test_dp_epoch_matches_loss_scale():
    # 8 tiny graphs, one per device
    specs = [generate_graph(n=16, d=4, seed=s) for s in range(8)]
    ds = process_graphs(specs, DataConfig(max_nodes=16))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=16, learning_rate=1e-2)
    state = setup_train_state(cfg)
    mesh = make_mesh(("data",))
    dp_fn = make_dp_epoch_fn(cfg, state.optimizer, mesh)
    batch_sh = shard_batch_for_dp(batch, mesh)
    params, opt_state, loss = dp_fn(
        state.params, state.opt_state, batch_sh, jax.random.PRNGKey(0)
    )
    loss0 = float(loss)
    assert np.isfinite(loss0) and loss0 < 0  # -sum of positive cuts
    # several epochs reduce the loss (increase total cut)
    for i in range(20):
        params, opt_state, loss = dp_fn(
            params, opt_state, batch_sh, jax.random.PRNGKey(i + 1)
        )
    assert float(loss) < loss0


def test_dp_epoch_deterministic():
    # deterministic-collectives check (SURVEY §5.2): same seeds -> bitwise
    # identical loss and params across two independent runs
    specs = [generate_graph(n=16, d=4, seed=s) for s in range(8)]
    ds = process_graphs(specs, DataConfig(max_nodes=16))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=16, learning_rate=1e-2)
    mesh = make_mesh(("data",))
    batch_sh = shard_batch_for_dp(batch, mesh)

    results = []
    for _ in range(2):
        state = setup_train_state(cfg)
        dp_fn = make_dp_epoch_fn(cfg, state.optimizer, mesh)
        params, opt_state, loss = dp_fn(
            state.params, state.opt_state, batch_sh, jax.random.PRNGKey(7)
        )
        for i in range(3):
            params, opt_state, loss = dp_fn(
                params, opt_state, batch_sh, jax.random.PRNGKey(i)
            )
        results.append((float(loss), np.asarray(params["conv1"]["w"])))
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])


def _run_in_mesh(fn, sg, x):
    """shard_map helper: fn(local_sg, local_x[n_shard, F]) -> [n_shard, F']."""
    mesh = make_mesh(("graph",))
    return np.asarray(
        jax.jit(
            jax.shard_map(
                lambda sg_, x_: fn(local_shard(sg_), x_[0])[None],
                mesh=mesh,
                in_specs=(shard_specs(sg), P("graph")),
                out_specs=P("graph"),
                check_vma=False,
            )
        )(sg, x)
    )


def test_ell_group_tables_match_coo_aggregation():
    n, deg = 96, 4
    s, r = _random_coo(n, deg, 5)
    sg_ell, _ = shard_graph(s, r, n, D)
    sg_coo, _ = shard_graph(s, r, n, D, build_ell=False)
    assert sg_ell.ell_senders is not None and sg_coo.ell_senders is None

    rng = np.random.default_rng(5)
    x = jnp.asarray(
        rng.normal(size=(D, sg_ell.n_shard, 16)).astype(np.float32)
    )
    run = lambda sg: _run_in_mesh(
        lambda sgl, xl: sharded_spmm_ring(sgl, xl), sg, x
    )
    np.testing.assert_allclose(run(sg_ell), run(sg_coo), rtol=1e-5, atol=1e-5)


def test_sharded_spmm_sym_gradient_matches_autodiff():
    from gcn_maxcut.parallel.spmm import sharded_spmm_sym

    n, deg = 64, 4
    s, r = _random_coo(n, deg, 6)
    sg, _ = shard_graph(s, r, n, D)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(D, sg.n_shard, 8)).astype(np.float32))

    def grad_of(spmm_fn):
        return _run_in_mesh(
            lambda sgl, xl: jax.grad(
                lambda z: jnp.sum(spmm_fn(sgl, z) ** 2)
            )(xl),
            sg, x,
        )

    g_sym = grad_of(lambda sgl, z: sharded_spmm_sym(sgl, z))
    g_ad = grad_of(lambda sgl, z: sharded_spmm_ring(sgl, z))
    np.testing.assert_allclose(g_sym, g_ad, rtol=1e-4, atol=1e-5)


def test_sharded_cut_edgeform_matches_original():
    from gcn_maxcut.parallel.giant import sharded_cut
    from gcn_maxcut.parallel.spmm import sharded_cut_edgeform

    n, deg = 96, 4
    s, r = _random_coo(n, deg, 7)
    sg, _ = shard_graph(s, r, n, D)
    rng = np.random.default_rng(7)
    assign = jax.nn.one_hot(
        jnp.asarray(rng.integers(0, 3, size=(D, sg.n_shard))), 3
    ).astype(jnp.float32)

    old = _run_in_mesh(
        lambda sgl, sl: sharded_cut(sgl, sl)[None] * jnp.ones((sgl.node_mask.shape[-1], 1)),
        sg, assign,
    )
    new = _run_in_mesh(
        lambda sgl, sl: sharded_cut_edgeform(sgl, sl)[None] * jnp.ones((sgl.node_mask.shape[-1], 1)),
        sg, assign,
    )
    np.testing.assert_allclose(old[0, 0, 0], new[0, 0, 0], rtol=1e-5)


def test_asymmetric_graph_falls_back_to_autodiff_backward():
    """A directed (non-symmetrized) COO must get CORRECT gradients.

    Round 1 hard-wired the A^T = A backward into sharded_gcn_conv; for a
    directed graph that silently produced wrong grads (ADVICE r1, medium).
    Now shard_graph detects asymmetry and the conv uses the autodiff
    backward; the sharded gradient must match the dense-operator gradient.
    """
    n = 32
    rng = np.random.default_rng(7)
    # strictly directed edges: i -> {i+1, i+2, i+3} mod n, no reverse
    s = np.repeat(np.arange(n), 3)
    r = (s + np.tile(np.arange(1, 4), n)) % n
    sg, g2l = shard_graph(s, r, n, D)
    assert sg.symmetric is False

    # symmetric control: both directions present
    s2 = np.concatenate([s, r])
    r2 = np.concatenate([r, s])
    sg_sym, _ = shard_graph(s2, r2, n, D)
    assert sg_sym.symmetric is True

    n_shard = sg.n_shard
    owner, local = g2l // n_shard, g2l % n_shard
    x_global = rng.normal(size=(n, 4)).astype(np.float32)
    x_sh = np.zeros((D, n_shard, 4), np.float32)
    x_sh[owner, local] = x_global
    params = gcn_conv_init(jax.random.PRNGKey(0), 4, 4)
    mesh = make_mesh(("graph",))

    def sharded_loss(x_):
        out = jax.shard_map(
            lambda sg_, xx: sharded_gcn_conv(
                params["w"], params["b"], local_shard(sg_), xx[0], "graph"
            )[None],
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P("graph"),
        )(sg, x_)
        return jnp.sum(out**2)

    got_sh = np.asarray(jax.grad(sharded_loss)(jnp.asarray(x_sh)))
    got = got_sh[owner, local]

    # dense-operator reference for the same math (norm='both' conv)
    dense = np.zeros((n, n), np.float32)
    dense[r, s] = 1.0
    deg = np.maximum(dense.sum(1), 1.0)

    def dense_loss(x_):
        norm = jax.lax.rsqrt(jnp.asarray(deg))[:, None]
        h = (jnp.asarray(dense) @ (x_ * norm)) * norm
        return jnp.sum((h @ params["w"] + params["b"]) ** 2)

    expect = np.asarray(jax.grad(dense_loss)(jnp.asarray(x_global)))
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-4)


def test_partition_quality_banded_graph():
    """Contiguous partitioning of a banded graph must keep almost all edges
    local; the quality report quantifies it (VERDICT r1 item 5)."""
    from gcn_maxcut.parallel import partition_quality

    n, W = 512, 4
    offs = np.array([1, 2, 3, 4])
    s = np.repeat(np.arange(n), W)
    r = (s + np.tile(offs, n)) % n
    s2 = np.concatenate([s, r])
    r2 = np.concatenate([r, s])
    owner = partition_nodes_contiguous(n, 8)
    q = partition_quality(owner, s2, r2)
    # only the W rows at each of the 8 shard boundaries cross
    assert q["cross_shard_edge_fraction"] <= (2 * W * 8 * W) / s2.shape[0]
    assert q["cross_shard_edge_fraction"] > 0
    assert q["imbalance"] == pytest.approx(1.0)
    assert sum(q["edges_by_hop"]) == s2.shape[0]
    # a random partition of the same graph is near-total cross traffic
    rng = np.random.default_rng(0)
    q_rand = partition_quality(rng.integers(0, 8, n), s2, r2)
    assert q_rand["cross_shard_edge_fraction"] > 0.8


def test_shard_graph_vectorized_matches_reference_assembly():
    """The lexsort-based assembly must bucket/sort/ELL-pack exactly like a
    straightforward per-bucket reference implementation."""
    n, D_sh = 96, 4
    rng = np.random.default_rng(11)
    s, r = _random_coo(n, 6, 12)
    w = rng.random(s.shape[0]).astype(np.float32)
    sg, g2l = shard_graph(s, r, n, D_sh, weights=w)
    n_shard = sg.n_shard
    owner = g2l // n_shard
    local = g2l % n_shard

    S = np.asarray(sg.senders); R = np.asarray(sg.receivers)
    Wt = np.asarray(sg.weights); M = np.asarray(sg.edge_mask)
    for d in range(D_sh):
        for grp in range(D_sh):
            sel = np.nonzero(
                (owner[r] == d) & ((owner[s] - owner[r]) % D_sh == grp)
            )[0]
            order = np.argsort(local[r[sel]], kind="stable")
            sel = sel[order]
            m = sel.size
            assert M[d, grp, :m].sum() == m and M[d, grp, m:].sum() == 0
            np.testing.assert_array_equal(S[d, grp, :m], local[s[sel]])
            np.testing.assert_array_equal(R[d, grp, :m], local[r[sel]])
            np.testing.assert_allclose(Wt[d, grp, :m], w[sel])


# ---- hop-0 (intra-shard) aggregation on the gather tables ----------------


def _banded_coo(n, offsets, seed=0):
    """Directed symmetric circulant-ish COO with the given offsets."""
    s = np.concatenate([np.arange(n) for _ in offsets]).astype(np.int64)
    r = np.concatenate([(np.arange(n) + o) % n for o in offsets]).astype(
        np.int64
    )
    return np.concatenate([s, r]), np.concatenate([r, s])


def _ring_aggregate_outside_shard_map(sg, x_sh):
    """out[d] = sum_s aggregate(shard d, hop s, x[(d+s) % D]) — the ring
    schedule hop by hop, numerically identical to ``sharded_spmm_ring``."""
    from gcn_maxcut.parallel.spmm import _group_aggregate

    n_shard, F = x_sh.shape[1:]
    out = np.zeros(x_sh.shape, np.float32)
    for d in range(D):
        sgl = jax.tree_util.tree_map(
            lambda a: a[d] if getattr(a, "ndim", 0) > 0 else a, sg
        )
        acc = jnp.zeros((n_shard, F), jnp.float32)
        for s in range(D):
            acc = acc + _group_aggregate(sgl, s, x_sh[(d + s) % D])
        out[d] = np.asarray(acc)
    return out


@pytest.mark.parametrize(
    "local_reorder,F", [("off", 128), ("rcm", 128), ("off", 64), ("off", 3)]
)
def test_shard_graph_hop0_gather_matches_dense(local_reorder, F):
    """Banded graph, every hop on the ELL gather tables (with and without
    the per-shard RCM relabel) equals the dense reference."""
    n = 8192
    senders, receivers = _banded_coo(n, (1, 2, 3, 40), seed=7)
    sg, g2l = shard_graph(
        senders, receivers, n, D, local_reorder=local_reorder,
    )
    assert sg.ell_senders is not None
    n_shard = sg.n_shard
    owner, local = g2l // n_shard, g2l % n_shard

    rng = np.random.default_rng(3)
    x_global = rng.normal(size=(n, F)).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    dense[receivers, senders] = 1.0
    expect = dense @ x_global

    x_sh = np.zeros((D, n_shard, F), np.float32)
    x_sh[owner, local] = x_global
    out = _ring_aggregate_outside_shard_map(sg, jnp.asarray(x_sh))
    np.testing.assert_allclose(out[owner, local], expect, rtol=1e-4, atol=1e-4)


def test_shard_graph_expander_uses_gather_tables():
    s, r = _random_coo(8192, 6, seed=11)
    sg, _ = shard_graph(s, r, 8192, D)
    # uniform random regular graph: every hop on the gather tables
    assert sg.ell_senders is not None
    assert sg.n_shard % 8 == 0


def test_shard_graph_rcm_recovers_shuffled_band():
    """A shuffled banded graph does not band contiguously, but the
    per-shard RCM relabel (on the BFS partition) narrows each shard's
    local band."""
    n = 8192
    senders, receivers = _banded_coo(n, (1, 2, 3), seed=3)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    s2, r2 = perm[senders], perm[receivers]
    owner = partition_nodes_bfs(s2, r2, n, D)

    def local_bandwidth(sg):
        m = np.asarray(sg.edge_mask[:, 0]) > 0
        return int(np.abs(
            np.asarray(sg.senders[:, 0])[m] - np.asarray(sg.receivers[:, 0])[m]
        ).max())

    sg_off, _ = shard_graph(s2, r2, n, D, owner=owner)
    sg_rcm, _ = shard_graph(s2, r2, n, D, owner=owner, local_reorder="rcm")
    assert local_bandwidth(sg_rcm) < local_bandwidth(sg_off) // 4


def test_partition_metis_quality_and_balance():
    """Multilevel partitioner: balanced, complete, and strictly better
    edge-cut than contiguous on a shuffled banded graph (DESIGN.md §7
    measured 0.05% vs 87.5% at 1M; this is the small fast version)."""
    n = 4096
    senders, receivers = _banded_coo(n, (1, 2, 3), seed=1)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    s2, r2 = perm[senders], perm[receivers]
    from gcn_maxcut.parallel import partition_nodes_metis
    from gcn_maxcut.parallel.partition import partition_quality

    owner = partition_nodes_metis(s2, r2, n, 8)
    counts = np.bincount(owner, minlength=8)
    assert counts.sum() == n
    assert counts.max() <= -(-n // 8) * 1.06
    q = partition_quality(owner, s2, r2)
    qc = partition_quality(
        partition_nodes_contiguous(n, 8), s2, r2
    )
    assert q["cross_shard_edge_fraction"] < 0.05
    assert q["cross_shard_edge_fraction"] < qc["cross_shard_edge_fraction"]


def test_shard_graph_weighted_hop0_matches():
    """Weighted edges through the sharded gather tables: the tables carry
    the real edge weights."""
    n = 8192
    senders, receivers = _banded_coo(n, (1, 2, 40), seed=9)
    rng = np.random.default_rng(4)
    half = rng.random(senders.shape[0] // 2).astype(np.float32) + 0.5
    weights = np.concatenate([half, half])  # symmetric weights
    sg, g2l = shard_graph(senders, receivers, n, D, weights=weights)
    assert sg.ell_senders is not None
    n_shard = sg.n_shard
    owner, local = g2l // n_shard, g2l % n_shard

    x_global = rng.normal(size=(n, 128)).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (receivers, senders), weights)
    expect = dense @ x_global

    x_sh = np.zeros((D, n_shard, 128), np.float32)
    x_sh[owner, local] = x_global
    out = _ring_aggregate_outside_shard_map(sg, jnp.asarray(x_sh))
    np.testing.assert_allclose(out[owner, local], expect, rtol=1e-4, atol=1e-4)
