"""Data-parallel training over the graph batch axis.

The reference trains one graph at a time on one device
(``TrainingNeural.py:371``); its natural accelerator scaling for the many-graph
recipes (BASELINE.json configs[1..2]) is one graph (or bucket) per device:
replicate params, shard the stacked dataset's leading axis over the mesh,
``psum`` gradients.  Implemented with ``shard_map`` so the same step runs
from 1 chip to a pod slice.

Semantics note: the reference applies the optimizer per graph sequentially;
synchronous DP averages the per-graph gradients of a device-sized group
instead (standard minibatch semantics).  Loss values are psum-reduced so the
reported cumulative loss matches the reference's sum-over-graphs scale.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.train.loop import _graph_loss


def shard_batch_for_dp(batch: Graph, mesh: Mesh, axis: str = "data") -> Graph:
    """Place a stacked graph batch with its leading axis sharded over ``axis``.

    The batch size must divide the mesh axis size evenly (pad the dataset
    with replica graphs if needed).
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), batch
    )


def make_dp_epoch_fn(
    config: TrainingConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    axis: str = "data",
) -> Callable:
    """jit(epoch) over a mesh: each device scans its local graphs, psums grads.

    Returns ``epoch_fn(params, opt_state, batch, rng) ->
    (params, opt_state, cumulative_loss)`` with params/opt_state replicated.
    """

    def local_epoch(params, opt_state, batch: Graph, rng):
        # batch leaves arrive with a local leading axis of B/D graphs
        n_local = batch.n_nodes.shape[0]
        rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        keys = jax.random.split(rng, n_local)

        def accum(carry, inp):
            grads_sum, loss_sum = carry
            g, key = inp
            loss, grads = jax.value_and_grad(_graph_loss)(params, g, config, key)
            grads_sum = jax.tree_util.tree_map(jnp.add, grads_sum, grads)
            return (grads_sum, loss_sum + loss), None

        zero = jax.tree_util.tree_map(jnp.zeros_like, params)
        (grads, loss), _ = jax.lax.scan(accum, (zero, 0.0), (batch, keys))
        grads = jax.lax.psum(grads, axis)
        loss = jax.lax.psum(loss, axis)
        n_total = jax.lax.psum(jnp.asarray(n_local, jnp.float32), axis)
        grads = jax.tree_util.tree_map(lambda g_: g_ / n_total, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    sharded = jax.shard_map(
        local_epoch,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
