"""Hybrid data x graph parallelism (parallel/hybrid.py) on the virtual
8-device CPU mesh arranged 2 x 4 (SURVEY.md §2.9: DP over graph batch
composed with node sharding)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gcn_maxcut.data.generate import random_regular_edges
from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.parallel.giant import GiantConfig, make_giant_step
from gcn_maxcut.parallel.hybrid import (
    make_hybrid_step,
    stack_sharded_graphs,
    train_hybrid,
)
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.parallel.partition import shard_graph


def _sym_edges(n: int, d: int, seed: int):
    e = random_regular_edges(n, d, seed=seed)
    return (
        np.concatenate([e[:, 0], e[:, 1]]),
        np.concatenate([e[:, 1], e[:, 0]]),
    )


def _make_params(cfg: GiantConfig, D: int, n_shard: int, key):
    k1, k2, k3 = jax.random.split(key, 3)
    conv = {
        "conv1": gcn_conv_init(k1, cfg.dim_embedding, cfg.hidden_dim),
        "conv2": gcn_conv_init(k2, cfg.hidden_dim, cfg.num_classes),
    }
    embed = jax.random.normal(
        k3, (D, n_shard, cfg.dim_embedding), jnp.float32
    )
    return conv, embed


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_hybrid_matches_single_axis_on_duplicated_graph():
    """B=2 copies of the SAME graph with identical embeddings: the hybrid
    2x4 step's conv grads are the mean of two identical per-graph grads,
    so conv params AND both embedding replicas must track the single-axis
    4-device giant step exactly."""
    n, d, D, R = 32, 4, 4, 2
    cfg = GiantConfig(
        dim_embedding=8, hidden_dim=8, epochs_per_call=3, learning_rate=1e-2
    )
    s, r = _sym_edges(n, d, seed=0)
    sg, _ = shard_graph(s, r, n, D)

    conv, embed = _make_params(cfg, D, sg.n_shard, jax.random.PRNGKey(7))
    optimizer = optax.adam(cfg.learning_rate)

    # --- single-axis reference: 4-device "graph" mesh -------------------
    gmesh = make_mesh(("graph",), devices=jax.devices()[:D])
    embed_g = jax.device_put(embed, NamedSharding(gmesh, P("graph")))
    opt_g = optimizer.init((conv, embed_g))
    step_g = make_giant_step(
        sg, gmesh, cfg, optimizer, "graph", opt_g, params=(conv, embed_g)
    )
    conv_g, embed_g, _, losses_g = step_g(conv, embed_g, opt_g)

    # --- hybrid: 2x4 mesh, the same graph duplicated per replica --------
    hmesh = make_mesh(("data", "graph"), shape=(R, D))
    sgb = stack_sharded_graphs([sg, sg])
    embeds = jnp.stack([embed, embed])
    embeds = jax.device_put(
        embeds, NamedSharding(hmesh, P("data", "graph"))
    )
    opt_h = optimizer.init((conv, embeds))
    step_h = make_hybrid_step(
        sgb, hmesh, cfg, optimizer, opt_h, (conv, embeds)
    )
    conv_h, embeds_h, _, losses_h, per_graph = step_h(conv, embeds, opt_h)

    np.testing.assert_allclose(
        np.asarray(losses_h), np.asarray(losses_g), rtol=1e-5
    )
    jax.tree_util.tree_map(
        lambda va, vb: np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-5, atol=1e-6
        ),
        conv_h, conv_g,
    )
    eh = np.asarray(embeds_h)
    np.testing.assert_allclose(eh[0], np.asarray(embed_g), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eh[1], eh[0], rtol=0, atol=0)
    assert per_graph.shape == (2,)
    np.testing.assert_allclose(
        np.asarray(per_graph), np.asarray(losses_h)[-1], rtol=1e-5
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_train_hybrid_end_to_end_improves_cut():
    """Two DIFFERENT graphs on the 2x4 mesh: training runs, the mean loss
    improves, and both decoded cuts beat the uniform-random k=3 floor."""
    n, d = 48, 6
    cfg = GiantConfig(
        dim_embedding=16, hidden_dim=16, number_epochs=60,
        epochs_per_call=10, learning_rate=5e-3, log_every=20,
    )
    out = train_hybrid(
        [_sym_edges(n, d, seed=1), _sym_edges(n, d, seed=2)], n, cfg,
        mesh_shape=(2, 4),
    )
    assert out["mesh_shape"] == (2, 4)
    assert out["num_graphs"] == 2
    assert np.isfinite(out["final_mean_loss"])
    assert out["loss_history"][-1] < out["loss_history"][0]
    total_edges = n * d  # directed/2 per graph... n*d/2 undirected
    floor = (2.0 / 3.0) * (n * d / 2)
    for cut in out["per_graph_cuts"]:
        assert cut > floor, (cut, floor)


def test_stack_sharded_graphs_pads_mismatched_e_group():
    n, D = 32, 4
    s1, r1 = _sym_edges(n, 4, seed=3)
    s2, r2 = _sym_edges(n, 6, seed=4)   # denser -> larger e_group
    sg1, _ = shard_graph(s1, r1, n, D)
    sg2, _ = shard_graph(s2, r2, n, D)
    sgb = stack_sharded_graphs([sg1, sg2])
    assert sgb.senders.shape[0] == 2
    assert sgb.senders.shape[-1] == max(sg1.e_group, sg2.e_group)
    # padding edges must be masked out
    w = np.asarray(sgb.weights[0])
    m = np.asarray(sgb.edge_mask[0])
    assert (w[m == 0] == 0).all()


def test_stack_sharded_graphs_stacks_matching_bell_plans():
    """Two graphs whose ELL tables differ in width stack into one pytree:
    the narrower tables are padded with empty slots."""
    import numpy as np
    from gcn_maxcut.parallel.hybrid import stack_sharded_graphs
    from gcn_maxcut.parallel.partition import shard_graph

    n = 2048

    def coo(offs):
        s = np.concatenate([np.arange(n) for _ in offs]).astype(np.int64)
        r = np.concatenate(
            [(np.arange(n) + o) % n for o in offs]
        ).astype(np.int64)
        return np.concatenate([s, r]), np.concatenate([r, s])

    sgs = []
    for offs in ((1, 2, 5), (1, 2, 5, 9)):
        s, r = coo(offs)
        sg, _ = shard_graph(s, r, n, 1)
        assert sg.ell_senders is not None
        sgs.append(sg)
    assert sgs[0].ell_senders.shape[-1] < sgs[1].ell_senders.shape[-1]
    sgb = stack_sharded_graphs(sgs)
    assert sgb.ell_senders.shape[0] == 2
    assert sgb.ell_senders.shape[-1] == sgs[1].ell_senders.shape[-1]
    w0 = np.asarray(sgb.ell_weights[0])
    assert (w0[..., sgs[0].ell_senders.shape[-1]:] == 0).all()
