"""GCN layers and models, functional-style (params are plain pytrees).

``gcn_conv_apply`` reproduces DGL ``GraphConv(norm='both')`` semantics — the
layer the reference builds in ``GCNSoftmax``
(``Training/TrainingNeural.py:69-85``):

    h' = D̃_dst^{-1/2} · A · ( D̃_src^{-1/2} · X ) · W + b

with no self-loops (the reference feeds ``dgl.from_networkx`` graphs, which
add none), degrees clamped to a minimum of 1 (DGL's zero-in-degree guard),
and edge weights ignored by the aggregation (DGL default).  Like DGL, the
dense projection is applied on the smaller side: W first when
``in_feats > out_feats`` (the cheaper order for 1000 -> 500), aggregation
first otherwise — mathematically identical.

Parameters use Glorot/Xavier-uniform weights and zero biases, matching DGL's
``reset_parameters``.  Models:

  * ``gcn_softmax_*``: conv -> ReLU -> dropout -> conv -> softmax, the
    flagship 3-way model (reference ``GCNSoftmax``, 1000 -> 500 -> 3).
  * ``gcn_dev_*``: conv -> ReLU -> conv -> sigmoid, the legacy 2-way QUBO
    model (reference ``utils.py:12-51``; that variant uses DGL's default
    aggregate-then-project order on both layers, which we mirror).

Params are plain dicts of arrays so they shard transparently under
``jax.sharding``/``shard_map`` (see ``parallel/``).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.ops.segment import spmm

GCNParams = Dict[str, jnp.ndarray]          # one conv layer: {"w", "b"}
GCNSoftmaxParams = Dict[str, Any]           # {"conv1": GCNParams, "conv2": ...}


def _glorot_uniform(key: jax.Array, shape: tuple[int, int]) -> jnp.ndarray:
    fan_in, fan_out = shape
    limit = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def gcn_conv_init(key: jax.Array, in_feats: int, out_feats: int) -> GCNParams:
    return {
        "w": _glorot_uniform(key, (in_feats, out_feats)),
        "b": jnp.zeros((out_feats,), jnp.float32),
    }


def gcn_conv_apply(
    params: GCNParams,
    g: Graph,
    x: jnp.ndarray,
    *,
    a_dense: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Symmetric-normalized graph convolution (DGL ``norm='both'``).

    ``a_dense``: optional ``[n_pad, n_pad]`` unweighted dense adjacency
    (``core.dense_adjacency(g, values="mask")``).  When given, aggregation
    runs as a dense matmul instead of the sparse gather path — for small
    padded graphs (n_pad <= ~2k) one GEMM replaces E row-gathers.
    """
    deg = jnp.maximum(g.degrees, 1.0)
    norm = jax.lax.rsqrt(deg)[:, None]                  # [n_pad, 1]
    aggregate = (lambda h: a_dense @ h) if a_dense is not None else (
        lambda h: spmm(g, h)
    )
    in_feats, out_feats = params["w"].shape
    h = x * norm                                        # src normalization
    if in_feats > out_feats:
        h = h @ params["w"]                             # project, then aggregate
        h = aggregate(h)
    else:
        h = aggregate(h)                                # aggregate, then project
        h = h @ params["w"]
    return h * norm + params["b"]                       # dst normalization + bias


def gcn_softmax_init(
    key: jax.Array, in_feats: int, hidden: int, num_classes: int
) -> GCNSoftmaxParams:
    k1, k2 = jax.random.split(key)
    return {
        "conv1": gcn_conv_init(k1, in_feats, hidden),
        "conv2": gcn_conv_init(k2, hidden, num_classes),
    }


def gcn_softmax_apply(
    params: GCNSoftmaxParams,
    g: Graph,
    x: jnp.ndarray,
    *,
    dropout: float = 0.0,
    train: bool = False,
    dropout_rng: jax.Array | None = None,
    a_dense: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """conv1 -> ReLU -> dropout -> conv2 -> softmax; returns [n_pad, k]."""
    h = gcn_conv_apply(params["conv1"], g, x, a_dense=a_dense)
    h = jax.nn.relu(h)
    if train and dropout > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rng required when train=True and dropout>0")
        keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout, h.shape)
        h = jnp.where(keep, h / (1.0 - dropout), 0.0)
    h = gcn_conv_apply(params["conv2"], g, h, a_dense=a_dense)
    return jax.nn.softmax(h, axis=-1)


def gcn_dev_init(key: jax.Array, in_feats: int, hidden: int, out: int = 1) -> GCNSoftmaxParams:
    k1, k2 = jax.random.split(key)
    return {
        "conv1": gcn_conv_init(k1, in_feats, hidden),
        "conv2": gcn_conv_init(k2, hidden, out),
    }


def gcn_dev_apply(params: GCNSoftmaxParams, g: Graph, x: jnp.ndarray) -> jnp.ndarray:
    """Legacy QUBO model: conv -> ReLU -> conv -> sigmoid (reference utils.py:41-51)."""
    h = gcn_conv_apply(params["conv1"], g, x)
    h = jax.nn.relu(h)
    h = gcn_conv_apply(params["conv2"], g, h)
    return jax.nn.sigmoid(h)


def embedding_init(key: jax.Array, n_nodes: int, dim: int) -> jnp.ndarray:
    """Learnable node-embedding table, N(0, 1) like ``torch.nn.Embedding``.

    The reference allocates this, optimizes it, and checkpoints it as
    ``inputs`` without using it in the active forward pass
    (``TrainingNeural.py:332,359,456``; SURVEY.md §2.3).  Here it is the
    *feature mode for large graphs*, where adjacency-as-features is
    infeasible; small-graph parity mode feeds ``core.dense_adjacency``.
    """
    return jax.random.normal(key, (n_nodes, dim), jnp.float32)


def count_params(params) -> int:
    return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))
