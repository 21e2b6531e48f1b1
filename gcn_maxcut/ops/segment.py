"""Sparse message-passing primitives: ELL row gathers and sorted segment ops.

These replace DGL's C++ SpMM kernels that the reference calls through
``dgl.nn.pytorch.GraphConv`` (``Training/TrainingNeural.py:80,83`` in the
reference tree).  The graph's edge list is sorted by receiver at
construction (``core/graph.py``), so ``jax.ops.segment_sum(...,
indices_are_sorted=True)`` lowers to a sorted scatter-add; gradients flow
through the gather/scatter pair automatically.  Graphs with bounded degree
also carry ELL tables, and :func:`spmm` prefers the gather-only path over
them.  Graphs whose neighbor offsets are bounded (circulant, or
locality-reordered into a band) use ``ops/banded.py``; small padded graphs
can instead use the dense aggregation path
(``models.gcn_conv_apply(a_dense=...)``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph


def spmm_xla(g: Graph, x: jnp.ndarray, edge_weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """y[r] = sum_{(s -> r) in E} w_e * x[s]  — sparse matrix times dense.

    ``x`` is ``[n_pad, F]``; returns ``[n_pad, F]``.  With
    ``edge_weights=None`` the aggregation is unweighted over real edges
    (``edge_mask``), matching DGL GraphConv's default of ignoring edge
    weights; pass ``g.weights`` for weighted aggregation.
    """
    w = g.edge_mask if edge_weights is None else edge_weights
    msgs = x[g.senders] * w[:, None]
    return jax.ops.segment_sum(
        msgs, g.receivers, num_segments=g.n_pad, indices_are_sorted=True
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _ell_gather_sum(
    x: jnp.ndarray, nbr: jnp.ndarray, w: jnp.ndarray, bf16: bool = False
) -> jnp.ndarray:
    """y[i] = Σ_j w[i, j] · x[nbr[i, j]] — gather-only SpMM (no scatter).

    The forward avoids the scatter of segment-sum entirely; the custom VJP
    exploits adjacency symmetry (undirected graphs store both directions
    with equal weights) to make the backward a gather too:
    dL/dx = Aᵀ·dy = A·dy.

    bf16 feature rows: when ``x`` arrives as bfloat16 the gathers move
    half the bytes and accumulation stays f32 (output is f32); the
    backward gathers the cotangent in bf16 too.
    """
    return _ell_sum(x, nbr, w)


def _ell_sum(x, nbr, w):
    # d separate row-gathers: no [n, d, F] intermediate is materialized
    d = nbr.shape[1]
    bf16 = x.dtype == jnp.bfloat16

    def g(j):
        r = x[nbr[:, j]]
        return r.astype(jnp.float32) if bf16 else r

    out = w[:, 0:1] * g(0)
    for j in range(1, d):
        out = out + w[:, j : j + 1] * g(j)
    return out


def _ell_fwd(x, nbr, w, bf16):
    return _ell_sum(x, nbr, w), (nbr, w)


def _ell_bwd(bf16, res, dy):
    nbr, w = res
    # symmetric adjacency: transpose SpMM == same SpMM; keep the bf16
    # byte saving in the backward when the forward opted in
    if bf16:
        dy = dy.astype(jnp.bfloat16)
    dx = _ell_sum(dy, nbr, w)
    if bf16:
        dx = dx.astype(jnp.bfloat16)
    return dx, None, jnp.zeros_like(w)


_ell_gather_sum.defvjp(_ell_fwd, _ell_bwd)


def spmm_ell(g: Graph, x: jnp.ndarray, edge_weights_mode: str = "mask") -> jnp.ndarray:
    """ELL fast-path SpMM.  ``edge_weights_mode``: 'mask' (unweighted
    aggregation over real edges, the GraphConv case) or 'weights'.
    Accepts f32 or bf16 features (bf16 = half the gather bytes, f32
    accumulation, f32 output)."""
    w = g.ell_mask if edge_weights_mode == "mask" else g.ell_weights
    return _ell_gather_sum(x, g.ell_senders, w, x.dtype == jnp.bfloat16)


def spmm(
    g: Graph,
    x: jnp.ndarray,
    edge_weights: jnp.ndarray | None = None,
    feature_dtype: jnp.dtype | str | None = None,
) -> jnp.ndarray:
    """Dispatching SpMM: the ELL gather-only path when the graph carries
    ELL tables and the request matches a stored weighting; else XLA
    segment-sum.

    ``feature_dtype="bfloat16"`` (or passing ``x`` already as bf16)
    opts the gather path into half-width feature rows with f32
    accumulation, at bf16 read precision (~3 decimal digits).

    NOTE: the ELL backward assumes a symmetric adjacency (always true for
    graphs built with ``symmetrize=True``, the framework default).
    """
    if feature_dtype is not None:
        x = x.astype(feature_dtype)
    if g.ell_senders is not None:
        if edge_weights is None:
            return spmm_ell(g, x, "mask")
        if edge_weights is g.weights:
            return spmm_ell(g, x, "weights")
    return spmm_xla(g, x.astype(jnp.float32), edge_weights)


def sddmm(g: Graph, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Per-edge scores  e = <x[sender], y[receiver]>  — sampled dense-dense.

    Returns ``[e_pad]`` with zeros on padded edges.  This is the edge-form
    building block of the cut loss: for assignment matrix S, the relaxed
    same-partition probability of edge (u, v) is ``sddmm(g, S, S)``.
    """
    scores = jnp.sum(x[g.senders] * y[g.receivers], axis=-1)
    return scores * g.edge_mask


def segment_sum_edges(g: Graph, edge_values: jnp.ndarray) -> jnp.ndarray:
    """Sum per-edge values into their receiver nodes: ``[e_pad] -> [n_pad]``."""
    return jax.ops.segment_sum(
        edge_values * g.edge_mask,
        g.receivers,
        num_segments=g.n_pad,
        indices_are_sorted=True,
    )
