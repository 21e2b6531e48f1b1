"""Legacy single-graph QUBO (PI-GNN) training loop.

Capability parity with the reference's Schuetz-style recipe
``run_gnn_training`` (``utils.py:179-240``) and its setup ``get_gnn``
(``commons.py:98-128``): a sigmoid-output GCN on one graph, embedding-table
features, QUBO loss xᵀQx, probability-threshold projection, best-bitstring
tracking, and the same tolerance/patience early stopping.  The per-epoch
body is one jit; the epoch loop stays host-side for early stopping.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import optax

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.models.gcn import embedding_init, gcn_dev_apply, gcn_dev_init
from gcn_maxcut.objectives.qubo import qubo_loss
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class QuboConfig:
    """Mirrors the legacy ``gnn_hypers`` dict (``TrainingNeural_load.py:555-565``)."""

    dim_embedding: int = 80
    hidden_dim: int = 40
    learning_rate: float = 1e-4
    number_epochs: int = 100_000
    tolerance: float = 1e-4
    patience: int = 100
    prob_threshold: float = 0.5
    seed: int = 0


def run_gnn_training(
    g: Graph, config: QuboConfig = QuboConfig()
) -> Tuple[Any, Dict[str, Any]]:
    """Train the sigmoid GCN on one graph's QUBO; returns (params, results).

    Results carry the reference's outputs (``utils.py:228-240``): best
    bitstring, best loss, epoch count, final loss, loss history, runtime.
    """
    key = jax.random.PRNGKey(config.seed)
    k1, k2 = jax.random.split(key)
    params = gcn_dev_init(k1, config.dim_embedding, config.hidden_dim, 1)
    params["embed"] = embedding_init(k2, g.n_pad, config.dim_embedding)
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            probs = gcn_dev_apply(
                {"conv1": p["conv1"], "conv2": p["conv2"]}, g, p["embed"]
            )[:, 0]
            return qubo_loss(g, probs), probs

        (loss, probs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        bitstring = (probs >= config.prob_threshold).astype(jnp.int32)
        hard_loss = qubo_loss(g, bitstring.astype(jnp.float32))
        return params, opt_state, loss, bitstring, hard_loss

    best_loss = float("inf")
    best_bitstring = None
    prev_loss = float("inf")
    patience_count = 0
    history: List[float] = []
    t0 = time.time()
    epoch = 0
    for epoch in range(config.number_epochs):
        params, opt_state, loss, bitstring, hard_loss = step(params, opt_state)
        loss_f = float(loss)
        history.append(loss_f)
        if float(hard_loss) < best_loss:
            best_loss = float(hard_loss)
            best_bitstring = bitstring
        if abs(loss_f - prev_loss) <= config.tolerance or loss_f > prev_loss:
            patience_count += 1
            if patience_count >= config.patience:
                logger.info("qubo early stopping at epoch %d", epoch)
                break
        else:
            patience_count = 0
        prev_loss = loss_f
        if epoch % 1000 == 0:
            logger.info("qubo epoch %d: loss %.4f", epoch, loss_f)

    runtime = time.time() - t0
    results = {
        "best_bitstring": best_bitstring,
        "best_loss": best_loss,            # = -cut of best bitstring
        "best_cut": -best_loss,
        "final_loss": history[-1] if history else None,
        "epochs": epoch + 1,
        "loss_history": history,
        "runtime_s": runtime,
    }
    logger.info(
        "qubo training: %d epochs in %.1fs, best cut %.0f",
        epoch + 1, runtime, -best_loss,
    )
    return params, results
