"""Hybrid data x graph parallelism: DP replicas over a batch of graphs,
each graph node-sharded over the mesh's "graph" axis.

The BASELINE.json north-star is a 2-host run; on real hardware that is a
DCN data axis times an ICI graph axis (SURVEY.md §2.9 build table: "DP
over graph batch" + "graph parallelism").  The reference has no analog —
its device handling is one ``torch.device`` line (``TrainingNeural.py``).

One ``shard_map`` over a 2-D ``("data", "graph")`` mesh runs everything:

  * the graph batch's leading axis is sharded over ``data`` (B/R local
    graphs per replica group), each graph's nodes over ``graph`` (the
    existing ring/allgather sharded SpMM + symmetric VJP machinery of
    ``parallel.spmm`` runs unchanged — its collectives name only the
    ``graph`` axis, so the data axis composes transparently);
  * conv params are replicated; their grads are accumulated over the
    local graphs and ``pmean``-ed over BOTH axes (the data-axis reduction
    is the only collective that would ride DCN on a 2-host run — one
    small conv-param pmean per epoch, exactly the DCN-friendly layout);
  * per-graph embeddings (and their Adam moments) stay sharded over both
    axes; each graph's embedding sees only its own gradient.

Epochs scan inside the shard_map (``epochs_per_call``), like the
single-axis trainer (``parallel.giant``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.parallel.giant import GiantConfig, _pin_and_ste
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.parallel.partition import (
    ShardedGraph,
    local_shard,
    shard_graph,
)
from gcn_maxcut.parallel.spmm import sharded_cut_edgeform, sharded_gcn_conv
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


def stack_sharded_graphs(sgs: Sequence[ShardedGraph]) -> ShardedGraph:
    """Stack B equally-sharded graphs into leading-axis-[B] leaves.

    Pads every graph's ``e_group`` (and ELL width) to the batch max so the
    leaves stack; padding edges carry zero weight/mask and self-loop-safe
    indices (``n_shard - 1``), the same convention ``shard_graph`` uses.
    """
    if not sgs:
        raise ValueError("need at least one ShardedGraph")
    if len({sg.num_shards for sg in sgs}) != 1:
        raise ValueError("graphs must share num_shards")
    if len({sg.n_shard for sg in sgs}) != 1:
        raise ValueError("graphs must share n_shard (same n, same padding)")
    if len({sg.symmetric for sg in sgs}) != 1:
        raise ValueError("graphs must share the symmetric flag")
    has_ell = {sg.ell_senders is not None for sg in sgs}
    if len(has_ell) != 1:
        raise ValueError("graphs must consistently have/not have ELL tables")

    n_shard = sgs[0].n_shard
    e_group = max(sg.e_group for sg in sgs)

    def pad_edges(a: jnp.ndarray, fill) -> jnp.ndarray:
        pad = e_group - a.shape[-1]
        if pad == 0:
            return a
        cfg = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return jnp.pad(a, cfg, constant_values=fill)

    kw: Dict[str, Any] = dict(
        senders=jnp.stack([pad_edges(sg.senders, n_shard - 1) for sg in sgs]),
        receivers=jnp.stack(
            [pad_edges(sg.receivers, n_shard - 1) for sg in sgs]
        ),
        weights=jnp.stack([pad_edges(sg.weights, 0.0) for sg in sgs]),
        edge_mask=jnp.stack([pad_edges(sg.edge_mask, 0.0) for sg in sgs]),
        degrees=jnp.stack([sg.degrees for sg in sgs]),
        node_mask=jnp.stack([sg.node_mask for sg in sgs]),
        n_nodes=jnp.stack([sg.n_nodes for sg in sgs]),
        symmetric=sgs[0].symmetric,
    )
    if has_ell == {True}:
        ell_w = max(sg.ell_senders.shape[-1] for sg in sgs)

        def pad_ell(a, fill):
            pad = ell_w - a.shape[-1]
            if pad == 0:
                return a
            cfg = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            return jnp.pad(a, cfg, constant_values=fill)

        kw.update(
            ell_senders=jnp.stack(
                [pad_ell(sg.ell_senders, n_shard - 1) for sg in sgs]
            ),
            ell_weights=jnp.stack([pad_ell(sg.ell_weights, 0.0) for sg in sgs]),
            ell_mask=jnp.stack([pad_ell(sg.ell_mask, 0.0) for sg in sgs]),
        )
    return ShardedGraph(**kw)


def _batched_specs(sgb: ShardedGraph, data_axis: str, graph_axis: str):
    """in_specs pytree for a stacked ShardedGraph: [B, D, ...] array leaves
    shard axis 0 over data and axis 1 over graph; [B] scalars-per-graph
    (n_nodes) shard over data only."""
    return jax.tree_util.tree_map(
        lambda a: (
            P(data_axis, graph_axis)
            if getattr(a, "ndim", 0) > 1
            else (P(data_axis) if getattr(a, "ndim", 0) == 1 else P())
        ),
        sgb,
    )


def make_hybrid_step(
    sgb: ShardedGraph,
    mesh: Mesh,
    config: GiantConfig,
    optimizer: optax.GradientTransformation,
    opt_state: Any,
    params: Tuple[Any, jnp.ndarray],
    data_axis: str = "data",
    graph_axis: str = "graph",
):
    """jit(chunk) over the 2-D mesh: ``epochs_per_call`` epochs of hybrid
    DP x node-sharded training scanned inside one ``shard_map``.

    ``sgb``: a :func:`stack_sharded_graphs` batch with leaves ``[B, D, ...]``
    (B graphs, D = graph-axis size); B must divide by the data-axis size.
    ``params = (conv_params, embeds)`` with ``embeds: [B, D, n_shard, F]``.

    Returns ``chunk(conv_params, embeds, opt_state) -> (conv_params,
    embeds, opt_state, losses[K], per_graph_losses[B])`` where
    ``per_graph_losses`` is from the final epoch.
    """
    K = max(1, config.epochs_per_call)
    R = mesh.shape[data_axis]
    D = mesh.shape[graph_axis]
    B = int(sgb.senders.shape[0])
    num_shards = int(sgb.senders.shape[1])  # leaves are [B, D, ...]
    if num_shards != D:
        raise ValueError(
            f"graphs sharded {num_shards}-way != mesh graph axis {D}"
        )
    if B % R:
        raise ValueError(f"batch {B} must divide data axis {R}")
    B_loc = B // R

    def loss_fn(conv_params, embed, sgl):
        h = sharded_gcn_conv(
            conv_params["conv1"]["w"], conv_params["conv1"]["b"],
            sgl, embed, graph_axis, config.schedule,
        )
        h = jax.nn.relu(h)
        h = sharded_gcn_conv(
            conv_params["conv2"]["w"], conv_params["conv2"]["b"],
            sgl, h, graph_axis, config.schedule,
        )
        probs = jax.nn.softmax(h, axis=-1)
        onehot = _pin_and_ste(probs, graph_axis, config.num_classes)
        return -sharded_cut_edgeform(sgl, onehot, graph_axis, config.schedule)

    def local_chunk(conv_params, embeds, opt_state, sgb_dev):
        # sgb_dev leaves: [B_loc, 1, ...]; embeds: [B_loc, 1, n_shard, F]

        def epoch(carry, _):
            conv_params, embeds, opt_state = carry

            def one_graph(acc, inp):
                conv_sum, loss_sum = acc
                sg_b, embed_b = inp            # leaves [1, ...]
                sgl = local_shard(sg_b)
                loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
                    conv_params, embed_b[0], sgl
                )
                conv_sum = jax.tree_util.tree_map(
                    jnp.add, conv_sum, grads[0]
                )
                return (conv_sum, loss_sum + loss), (grads[1][None], loss)

            zero = jax.tree_util.tree_map(jnp.zeros_like, conv_params)
            (conv_sum, loss_sum), (embed_grads, per_graph) = jax.lax.scan(
                one_graph, (zero, 0.0), (sgb_dev, embeds)
            )
            # mean conv grad per graph across the whole batch; graph-axis
            # pmean averages the replicated copies (same value on every
            # graph shard), data-axis pmean averages the replica groups —
            # on a 2-host run this small pmean is the only DCN collective.
            conv_grads = jax.lax.pmean(
                jax.tree_util.tree_map(lambda g_: g_ / B_loc, conv_sum),
                (data_axis, graph_axis),
            )
            updates, opt_state = optimizer.update(
                (conv_grads, embed_grads), opt_state, (conv_params, embeds)
            )
            conv_params, embeds = optax.apply_updates(
                (conv_params, embeds), updates
            )
            mean_loss = jax.lax.pmean(loss_sum / B_loc, data_axis)
            return (conv_params, embeds, opt_state), (mean_loss, per_graph)

        (conv_params, embeds, opt_state), (losses, per_graph) = jax.lax.scan(
            epoch, (conv_params, embeds, opt_state), None, length=K
        )
        return conv_params, embeds, opt_state, losses, per_graph[-1]

    conv_params, embeds = params
    embed_spec = P(data_axis, graph_axis)
    param_specs = (
        jax.tree_util.tree_map(lambda _: P(), conv_params),
        embed_spec,
    )
    param_td = jax.tree_util.tree_structure(params)

    def opt_specs(tree):
        is_param_like = (
            lambda sub: jax.tree_util.tree_structure(sub) == param_td
        )
        return jax.tree_util.tree_map(
            lambda sub: (
                param_specs
                if is_param_like(sub)
                else jax.tree_util.tree_map(lambda _: P(), sub)
            ),
            tree,
            is_leaf=is_param_like,
        )

    smapped = jax.shard_map(
        local_chunk,
        mesh=mesh,
        in_specs=(
            P(),
            embed_spec,
            opt_specs(opt_state),
            _batched_specs(sgb, data_axis, graph_axis),
        ),
        out_specs=(P(), embed_spec, opt_specs(opt_state), P(), P(data_axis)),
        check_vma=False,
    )
    return jax.jit(lambda c, e, o: smapped(c, e, o, sgb))


def train_hybrid(
    edge_lists: List[Tuple[np.ndarray, np.ndarray]],
    n: int,
    config: GiantConfig = GiantConfig(),
    mesh: Mesh | None = None,
    data_axis: str = "data",
    graph_axis: str = "graph",
    mesh_shape: Tuple[int, int] | None = None,
) -> Dict[str, Any]:
    """End-to-end hybrid trainer: B graphs -> 2-D mesh -> per-graph cuts.

    ``edge_lists``: B ``(senders, receivers)`` directed COO pairs, all over
    ``n`` nodes.  ``mesh_shape=(R, D)``: data x graph axis sizes (default:
    2 x rest of the devices).
    """
    if config.number_epochs < 1:
        raise ValueError(
            f"number_epochs must be >= 1, got {config.number_epochs}"
        )
    if mesh is None:
        ndev = jax.device_count()
        if mesh_shape is None:
            r = 2 if ndev % 2 == 0 and ndev > 1 else 1
            mesh_shape = (r, ndev // r)
        mesh = make_mesh((data_axis, graph_axis), shape=mesh_shape)
    R, D = mesh.shape[data_axis], mesh.shape[graph_axis]
    B = len(edge_lists)

    sgs, g2ls = [], []
    for s, r_ in edge_lists:
        owner = None
        if config.partition == "bfs":
            from gcn_maxcut.parallel.partition import partition_nodes_bfs

            owner = partition_nodes_bfs(s, r_, n, D)
        elif config.partition == "metis":
            from gcn_maxcut.parallel.partition import (
                partition_nodes_metis,
            )

            owner = partition_nodes_metis(s, r_, n, D)
        elif config.partition != "contiguous":
            raise ValueError(f"unknown partition {config.partition!r}")
        sg, g2l = shard_graph(
            s, r_, n, D, owner=owner,
            local_reorder=config.local_reorder,
        )
        sgs.append(sg)
        g2ls.append(g2l)
    sgb = stack_sharded_graphs(sgs)

    key = jax.random.PRNGKey(config.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    conv_params = {
        "conv1": gcn_conv_init(k1, config.dim_embedding, config.hidden_dim),
        "conv2": gcn_conv_init(k2, config.hidden_dim, config.num_classes),
    }
    embeds = jax.random.normal(
        k3, (B, D, sgb.n_shard, config.dim_embedding), jnp.float32
    )
    embeds = jax.device_put(
        embeds, NamedSharding(mesh, P(data_axis, graph_axis))
    )
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init((conv_params, embeds))

    step = make_hybrid_step(
        sgb, mesh, config, optimizer, opt_state, (conv_params, embeds),
        data_axis, graph_axis,
    )

    t0 = time.perf_counter()
    K = max(1, config.epochs_per_call)
    epoch = 0
    history = []
    while epoch < config.number_epochs:
        conv_params, embeds, opt_state, losses, per_graph = step(
            conv_params, embeds, opt_state
        )
        chunk = np.asarray(losses)
        for j in range(K):
            if (epoch + j) % config.log_every == 0:
                history.append(float(chunk[j]))
                logger.info(
                    "hybrid epoch %d: mean loss %.1f", epoch + j, chunk[j]
                )
        epoch += K
    per_graph = np.asarray(per_graph)
    return {
        "final_mean_loss": float(chunk[-1]),
        "per_graph_cuts": (-per_graph).tolist(),
        "loss_history": history,
        "train_time_s": time.perf_counter() - t0,
        "epochs": epoch,
        "mesh_shape": (R, D),
        "num_graphs": B,
    }
