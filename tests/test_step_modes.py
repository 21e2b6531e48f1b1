"""Batched vs per-graph stepping: both modes must train.

"per_graph" reproduces the reference's one-Adam-step-per-graph epoch
(``TrainingNeural.py:341-390``); "batched" is the vmapped variant
(one step per epoch on the vmapped batch).  They are different optimizers
trajectories by construction, so the contract tested is: both strictly
improve the cut objective, and their first-epoch cumulative losses agree
up to the step-ordering difference.
"""

import numpy as np
import jax

from gcn_maxcut.core import graph_from_dense
from gcn_maxcut.core.graph import pad_graph_batch
from gcn_maxcut.train import TrainingConfig, make_epoch_fn, setup_train_state


def _batch(num=4, n=30, p=0.4):
    graphs = []
    for s in range(num):
        rng = np.random.default_rng(s)
        a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
        graphs.append(graph_from_dense(a + a.T, e_pad=512, ell_width=n))
    return pad_graph_batch(graphs)


def _run(step_mode, aggregation, epochs=30):
    cfg = TrainingConfig(
        n_nodes=32, step_mode=step_mode, aggregation=aggregation,
        learning_rate=5e-3,
    )
    state = setup_train_state(cfg)
    fn = make_epoch_fn(cfg, state.optimizer)
    _, _, losses = fn(
        state.params, state.opt_state, _batch(), jax.random.PRNGKey(0),
        num_epochs=epochs,
    )
    return np.asarray(losses)


def test_batched_mode_trains():
    for agg in ("sparse", "dense"):
        losses = _run("batched", agg)
        assert np.isfinite(losses).all()
        # strictly better than the start by a clear margin
        assert losses[-5:].mean() < losses[0] - 10.0, (agg, losses)


def test_modes_reach_similar_quality():
    per_graph = _run("per_graph", "dense", epochs=40)
    batched = _run("batched", "dense", epochs=40)
    # same objective scale; final plateaus within 15% of each other
    assert abs(per_graph[-1] - batched[-1]) < 0.15 * abs(per_graph[-1]), (
        per_graph[-1], batched[-1],
    )
