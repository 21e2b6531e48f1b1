"""Golden end-to-end configs matching BASELINE.json configs[0..2] shapes.

SURVEY.md §4(d): pin the exact reference configuration — not scaled-down
stand-ins — so a regression in padding, parameter shapes, or the loss
chain shows up against the published numbers' setup.  Full-length training
runs live in the on-card benches; here we pin shapes, the 502,003-parameter
count (``neural_network_testing.ipynb`` cell 6 output), and a few real
optimizer steps on the true config[0] graph.
"""

import numpy as np
import jax

from gcn_maxcut.core.graph import pad_graph_batch
from gcn_maxcut.data import DataConfig, generate_graph, process_graphs
from gcn_maxcut.models import count_params, gcn_softmax_init
from gcn_maxcut.train import TrainingConfig, make_epoch_fn, setup_train_state


def test_config0_exact_shapes_and_param_count():
    # single n=500 d=7 regular graph, 2-layer GCN 1000 -> 500 -> 3
    spec = generate_graph(n=500, d=7, graph_type="reg", seed=0)
    ds = process_graphs([spec], DataConfig(max_nodes=1000))
    g = ds.graphs[0]
    assert g.n_pad >= 500 and int(g.n_edges) == 500 * 7

    cfg = TrainingConfig(n_nodes=1000)
    assert (cfg.dim_embedding, cfg.hidden_dim, cfg.number_classes) == (
        1000, 500, 3,
    )
    params = gcn_softmax_init(jax.random.PRNGKey(0), 1000, 500, 3)
    # the reference's published model size (GCNSoftmax alone)
    assert count_params(params) == 502_003


def test_config0_trains_on_the_real_graph():
    spec = generate_graph(n=500, d=7, graph_type="reg", seed=0)
    ds = process_graphs([spec], DataConfig(max_nodes=1000))
    batch = pad_graph_batch([ds.graphs[0]])
    cfg = TrainingConfig(n_nodes=1000)
    state = setup_train_state(cfg)
    fn = make_epoch_fn(cfg, state.optimizer)
    _, _, losses = fn(
        state.params, state.opt_state, batch, jax.random.PRNGKey(1),
        num_epochs=4,
    )
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    # −loss is the relaxed cut; must improve and be a sane fraction of E
    assert losses[-1] < losses[0]
    assert -losses[-1] > 0.3 * 1750


def test_config1_recipe_shapes():
    # 20 graphs n=500 d in [6,8], padded to 1000 — the training-suite shape
    rng = np.random.default_rng(1000)
    specs = []
    while len(specs) < 5:                       # 5 of the 20 (CI budget)
        d = int(rng.integers(6, 9))
        if (500 * d) % 2:
            continue
        specs.append(
            generate_graph(n=500, d=d, graph_type="reg", seed=1000 + len(specs))
        )
    ds = process_graphs(specs, DataConfig(max_nodes=1000))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    assert batch.degrees.shape[0] == 5
    # terminal normalization invariant (the notebook's smoke check):
    # every processed spec carries terminals [0, 1, 2]
    assert all(list(s.terminals) == [0, 1, 2] for s in ds.specs.values())
