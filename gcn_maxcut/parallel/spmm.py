"""Node-sharded SpMM under ``shard_map``: all-gather and ring-overlap paths.

Two schedules for ``y[r] = Σ w_e · x[s]`` when nodes (and
feature rows) are sharded across a 1-D mesh axis:

  * ``sharded_spmm_allgather`` — ``all_gather`` the full feature matrix,
    then one local masked segment-sum.  Simple; right when F·n fits and
    interconnect bandwidth is plentiful.
  * ``sharded_spmm_ring`` — the halo-overlap schedule of the north star
    (BASELINE.json): features circulate the ring with ``ppermute`` while
    each hop's edge group (pre-bucketed by sender shard,
    ``partition.shard_graph``) is aggregated.  Communication of hop s+1
    overlaps with compute of hop s — the message-passing analog of ring
    attention; peak memory is 2 feature shards instead of D.

Both are pure functions of per-shard values, designed to be called inside
``shard_map`` over axis ``axis_name``; gradients flow through gather /
segment-sum / ppermute (all differentiable), so the same code serves
forward and backward.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.parallel.partition import ShardedGraph


def _local_group_aggregate(
    senders: jnp.ndarray,     # [e_group] local idx in the *source* shard
    receivers: jnp.ndarray,   # [e_group] local idx in this shard
    weights: jnp.ndarray,     # [e_group]
    mask: jnp.ndarray,        # [e_group]
    x_src: jnp.ndarray,       # [n_shard, F] features of the source shard
    n_shard: int,
) -> jnp.ndarray:
    msgs = x_src[senders] * (weights * mask)[:, None]
    return jax.ops.segment_sum(
        msgs, receivers, num_segments=n_shard, indices_are_sorted=True
    )


def _local_group_aggregate_ell(
    ell_senders: jnp.ndarray,  # [n_shard, w] local idx in the source shard
    ell_values: jnp.ndarray,   # [n_shard, w] weights (0 on padding)
    x_src: jnp.ndarray,        # [n_shard, F]
) -> jnp.ndarray:
    """Gather-only group aggregation — no scatter (same formulation as
    ops/segment.py's single-device path)."""
    w = ell_senders.shape[1]
    out = ell_values[:, 0:1] * x_src[ell_senders[:, 0]]
    for j in range(1, w):
        out = out + ell_values[:, j : j + 1] * x_src[ell_senders[:, j]]
    return out


def _group_aggregate(sg_shard: ShardedGraph, s, x_src: jnp.ndarray) -> jnp.ndarray:
    """Aggregate edge group ``s`` of this shard from the source-shard rows,
    via the ELL tables when the partition built them."""
    if sg_shard.ell_senders is not None:
        return _local_group_aggregate_ell(
            sg_shard.ell_senders[s], sg_shard.ell_weights[s], x_src
        )
    return _local_group_aggregate(
        sg_shard.senders[s],
        sg_shard.receivers[s],
        sg_shard.weights[s],
        sg_shard.edge_mask[s],
        x_src,
        sg_shard.node_mask.shape[-1],
    )


def sharded_spmm_allgather(
    sg_shard: ShardedGraph,
    x: jnp.ndarray,
    axis_name: str = "graph",
) -> jnp.ndarray:
    """All-gather schedule.  ``x``: this shard's ``[n_shard, F]`` rows.

    ``sg_shard`` is the per-device slice of `ShardedGraph` (no leading D
    axis) as delivered by ``shard_map``.
    """
    n_shard, _ = x.shape
    num_shards = jax.lax.psum(1, axis_name)
    my = jax.lax.axis_index(axis_name)
    xg = jax.lax.all_gather(x, axis_name)          # [D, n_shard, F]

    out = jnp.zeros_like(x)
    for s in range(num_shards):
        src = (my + s) % num_shards
        out = out + _group_aggregate(sg_shard, s, xg[src])
    return out


def sharded_spmm_ring(
    sg_shard: ShardedGraph,
    x: jnp.ndarray,
    axis_name: str = "graph",
) -> jnp.ndarray:
    """Ring-overlap schedule: hop s aggregates the features of shard
    ``(my + s) mod D`` while ``ppermute`` ships the next hop's features.

    Group s of this shard's edges references exactly shard (my+s)'s nodes
    (``partition.shard_graph`` grouping invariant), so after s backward ring
    hops the circulating buffer holds the right rows.
    """
    n_shard, _ = x.shape
    num_shards = jax.lax.psum(1, axis_name)
    perm = [(i, (i - 1) % num_shards) for i in range(num_shards)]  # send left

    def hop(s: int, carry):
        out, buf = carry
        # start shipping next hop's features; XLA overlaps this ppermute
        # with the local aggregation below (independent dataflow).
        nxt = (
            jax.lax.ppermute(buf, axis_name, perm)
            if s + 1 < num_shards
            else buf
        )
        out = out + _group_aggregate(sg_shard, s, buf)
        return out, nxt

    out = jnp.zeros_like(x)
    buf = x
    for s in range(num_shards):
        out, buf = hop(s, (out, buf))
    return out


def make_sharded_spmm(schedule: str = "ring") -> Callable:
    if schedule == "ring":
        return sharded_spmm_ring
    if schedule == "allgather":
        return sharded_spmm_allgather
    raise ValueError(f"unknown schedule {schedule!r}")


def sharded_gcn_conv(
    w: jnp.ndarray,
    b: jnp.ndarray,
    sg_shard: ShardedGraph,
    x: jnp.ndarray,
    axis_name: str = "graph",
    schedule: str = "ring",
) -> jnp.ndarray:
    """Symmetric-normalized GraphConv on a node-sharded graph.

    Same math as ``models.gcn_conv_apply`` (DGL ``norm='both'``), with the
    aggregation running on the sharded schedule under the symmetric custom
    VJP (backward is the same schedule; no scatters).  Degrees/masks are
    per-shard, so normalization is local.
    """
    deg = jnp.maximum(sg_shard.degrees, 1.0)
    norm = jax.lax.rsqrt(deg)[:, None]
    in_f, out_f = w.shape
    # symmetric custom VJP only when shard_graph verified A^T = A; an
    # asymmetric graph (directed / asymmetric weights) keeps the autodiff
    # backward, which is correct for any operator (ADVICE round 1).
    agg = (
        sharded_spmm_sym
        if sg_shard.symmetric
        else lambda sg, h, ax, sched: make_sharded_spmm(sched)(sg, h, ax)
    )
    h = x * norm
    if in_f > out_f:
        h = h @ w
        h = agg(sg_shard, h, axis_name, schedule)
    else:
        h = agg(sg_shard, h, axis_name, schedule)
        h = h @ w
    return h * norm + b


# ---- symmetric custom VJP ------------------------------------------------
#
# For the undirected graphs this framework builds (both edge directions
# stored with equal weights), the GLOBAL aggregation operator is symmetric:
# A^T = A.  The backward of the sharded SpMM is therefore the same sharded
# SpMM applied to the cotangent — no scatter ever runs (autodiff through
# the gather would emit one), and the ring schedule serves both passes.


def _zeros_tangent(tree):
    from jax import dtypes

    def z(a):
        if jnp.issubdtype(a.dtype, jnp.integer):
            return np.zeros(a.shape, dtypes.float0)
        return jnp.zeros_like(a)

    return jax.tree_util.tree_map(z, tree)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def sharded_spmm_sym(
    sg_shard: ShardedGraph,
    x: jnp.ndarray,
    axis_name: str = "graph",
    schedule: str = "ring",
) -> jnp.ndarray:
    """Sharded SpMM with the symmetric-adjacency backward (A^T = A).

    Requires the symmetrized graphs the framework builds; weight gradients
    are not propagated (aggregation weights are structural)."""
    return make_sharded_spmm(schedule)(sg_shard, x, axis_name)


def _spmm_sym_fwd(sg_shard, x, axis_name, schedule):
    return sharded_spmm_sym(sg_shard, x, axis_name, schedule), sg_shard


def _spmm_sym_bwd(axis_name, schedule, sg_shard, dy):
    dx = make_sharded_spmm(schedule)(sg_shard, dy, axis_name)
    return _zeros_tangent(sg_shard), dx


sharded_spmm_sym.defvjp(_spmm_sym_fwd, _spmm_sym_bwd)


def sharded_cut_edgeform(
    sg_shard: ShardedGraph,
    s: jnp.ndarray,
    axis_name: str = "graph",
    schedule: str = "ring",
) -> jnp.ndarray:
    """Relaxed cut (Σ_E w − ⟨S, A_w S⟩)/2 riding the symmetric SpMM.

    Algebraically identical to ``parallel.giant.sharded_cut`` but its
    backward is gather-only (through ``sharded_spmm_sym``) instead of the
    scatter autodiff emits for per-edge gathers."""
    total_w = jax.lax.psum(
        jnp.sum(sg_shard.weights * sg_shard.edge_mask), axis_name
    )
    As = (
        sharded_spmm_sym(sg_shard, s, axis_name, schedule)
        if sg_shard.symmetric
        else make_sharded_spmm(schedule)(sg_shard, s, axis_name)
    )
    same = jax.lax.psum(jnp.sum(s * As), axis_name)
    return (total_w - same) / 2.0
