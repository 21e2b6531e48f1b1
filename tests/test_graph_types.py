"""Non-regular graph types through the full pipeline (reference parity).

``generate_graph`` supports the reference's four types
(``GraphCreator.py:31-92``): 'reg' (seeded), 'reg_random' (unseeded),
'prob'/'erdos' (G(n, p)).  Only 'reg' was exercised elsewhere; these cover
the others end-to-end: generation invariants -> terminal normalization ->
tensorization -> a forward/loss evaluation.
"""

import numpy as np
import jax
import pytest

from gcn_maxcut.core.graph import dense_adjacency
from gcn_maxcut.data import DataConfig, generate_graph, process_graphs
from gcn_maxcut.data.generate import generate_graph_dataset
from gcn_maxcut.models import gcn_softmax_init, gcn_softmax_apply
from gcn_maxcut.objectives import compute_loss
from gcn_maxcut.ops import pin_terminals, ste_argmax_onehot


@pytest.mark.parametrize("graph_type", ["prob", "erdos", "reg_random"])
def test_type_through_pipeline(graph_type):
    spec = generate_graph(
        n=60, d=4, graph_type=graph_type, p=0.12, seed=3, num_terminals=3
    )
    assert spec.n_nodes == 60 and len(spec.terminals) == 3
    edges = np.asarray(spec.edges)
    assert edges.min() >= 0 and edges.max() < 60
    assert np.all(edges[:, 0] != edges[:, 1])          # no self loops

    ds = process_graphs([spec], DataConfig(max_nodes=64))
    g = ds.graphs[0]
    assert list(ds.specs[0].terminals) == [0, 1, 2]

    params = gcn_softmax_init(jax.random.PRNGKey(0), 64, 32, 3)
    probs = gcn_softmax_apply(params, g, dense_adjacency(g, width=64))
    loss = compute_loss(g, ste_argmax_onehot(pin_terminals(probs)))
    assert np.isfinite(float(loss))
    # relaxed cut is bounded by the (real) edge count
    assert 0.0 <= -float(loss) <= float(g.n_edges)


def test_gnp_seed_determinism():
    a = generate_graph(n=80, graph_type="prob", p=0.1, seed=9)
    b = generate_graph(n=80, graph_type="prob", p=0.1, seed=9)
    np.testing.assert_array_equal(np.asarray(a.edges), np.asarray(b.edges))


def test_dataset_generator_parity_skip_for_gnp_absent():
    # parity constraint applies only to regular types; G(n,p) never skips
    graphs, terminals = generate_graph_dataset(
        num_graphs=4, min_nodes=21, max_nodes=21, min_degree=3, max_degree=3,
        graph_type="prob", base_seed=5,
    )
    assert len(graphs) == 4
    assert all(len(t) == 3 for t in terminals.values())
