"""Static-shape sparse graph container.

The reference pipeline (``/root/reference``) represents each graph twice: as a
DGL graph for message passing and as a dense padded adjacency matrix that
doubles as the node-feature matrix (``graphExtender.py:28-48,106-110``).  Under
``jit`` everything needs static shapes, so this module provides a
single canonical container: a padded COO/CSR edge list sorted by receiver,
stored as a pytree of fixed-shape arrays.  The same container drives

  * sparse neighborhood aggregation (SpMM via the ELL gather path /
    sorted segment-sum in ``ops/segment.py``),
  * the edge-form differentiable cut loss (``objectives/cut_loss.py``),
  * on-device cut evaluation and post-processing sampling (``eval/``).

Padding conventions:
  * nodes:  real nodes occupy ids ``[0, n_nodes)``; ids ``[n_nodes, n_pad)``
    are padding with ``node_mask == 0``.
  * edges:  directed edges (both directions of each undirected edge) occupy
    the first ``n_edges`` slots after sorting by receiver; padded slots have
    ``senders == receivers == n_pad - 1`` and ``weights == edge_mask == 0``
    so they aggregate into the last (padding) row with zero contribution.

Because every field is a fixed-shape array, a list of graphs padded to the
same ``(n_pad, e_pad)`` stacks into a batch that can be ``vmap``-ed or
``lax.scan``-ned over — the replacement for the reference's Python
``for i in dataset`` loop (``TrainingNeural.py:371``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m`` (min ``m``)."""
    return max(m, ((int(x) + m - 1) // m) * m)


def static_field(**kwargs):
    """Dataclass field kept in the pytree's treedef (hashed, not traced)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree.  Fields declared with
    :func:`static_field` are metadata; every other field is a child (``None``
    children are empty subtrees).  Adds ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls


@pytree_dataclass
class Graph:
    """Padded sparse graph (directed COO sorted by receiver + CSR offsets).

    Shapes (static): ``senders/receivers/weights/edge_mask: [e_pad]``,
    ``row_ptr: [n_pad + 1]``, ``degrees/node_mask: [n_pad]``, scalars
    ``n_nodes/n_edges`` (dynamic values, static shapes).
    """

    senders: jnp.ndarray      # int32 [e_pad]
    receivers: jnp.ndarray    # int32 [e_pad], nondecreasing
    weights: jnp.ndarray      # float32 [e_pad], 0 on padding
    edge_mask: jnp.ndarray    # float32 [e_pad], 1 real / 0 padding
    row_ptr: jnp.ndarray      # int32 [n_pad + 1] CSR offsets by receiver
    degrees: jnp.ndarray      # float32 [n_pad], # real incident edges
    node_mask: jnp.ndarray    # float32 [n_pad], 1 real / 0 padding
    n_nodes: jnp.ndarray      # int32 scalar
    n_edges: jnp.ndarray      # int32 scalar (directed count)
    # ELL (padded per-row neighbor lists), the gather-only path for SpMM:
    # no scatter in the forward, and symmetry makes the backward pass a
    # gather too (ops/segment.py spmm_ell custom VJP).  None when rows
    # exceed ELL_MAX_DEGREE (fallback to the COO segment-sum path).
    ell_senders: jnp.ndarray | None = None   # int32 [n_pad, max_deg]
    ell_weights: jnp.ndarray | None = None   # f32   [n_pad, max_deg], 0 pad
    ell_mask: jnp.ndarray | None = None      # f32   [n_pad, max_deg]
    # Locality relabeling record (graph_from_edges(reorder=...)): node id
    # ``i`` of the caller's original edge list lives at id
    # ``reorder_perm[i]`` here.  Map per-node outputs back with
    # ``out_original = out[reorder_perm]``.  None = ids untouched.
    reorder_perm: jnp.ndarray | None = None        # int32 [n_pad]

    @property
    def n_pad(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def e_pad(self) -> int:
        return self.senders.shape[-1]


# Rows with degree above this skip the ELL fast path (padding an ELL table
# to a huge max degree would waste more memory/compute than COO costs).
ELL_MAX_DEGREE = 64


def _build_padded_coo(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_nodes: int,
    n_pad: int,
    e_pad: int,
    ell_width: int | None = None,
) -> Graph:
    """Assemble a `Graph` from host-side directed COO arrays.

    ``ell_width``: ELL table width. None = this graph's max degree (when
    ≤ ELL_MAX_DEGREE); 0 = disable ELL; an explicit positive width lets a
    dataset share one width so its graphs stack into a batch.
    """
    m = src.shape[0]
    if m > e_pad:
        raise ValueError(f"{m} directed edges do not fit in e_pad={e_pad}")
    if n_nodes > n_pad:
        raise ValueError(f"{n_nodes} nodes do not fit in n_pad={n_pad}")

    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]

    senders = np.full(e_pad, n_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_pad - 1, dtype=np.int32)
    weights = np.zeros(e_pad, dtype=np.float32)
    edge_mask = np.zeros(e_pad, dtype=np.float32)
    senders[:m] = src
    receivers[:m] = dst
    weights[:m] = w
    edge_mask[:m] = 1.0

    # CSR offsets over the padded receiver ids (padding edges land in the
    # final row, giving row_ptr[n_pad] == e_pad).
    counts = np.bincount(receivers, minlength=n_pad)
    row_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    degrees = np.zeros(n_pad, dtype=np.float32)
    np.add.at(degrees, dst, 1.0)
    # Exclude the padding contributions accumulated into row n_pad - 1.
    degrees[n_pad - 1] = float(np.sum(dst == n_pad - 1))

    node_mask = np.zeros(n_pad, dtype=np.float32)
    node_mask[:n_nodes] = 1.0

    # ELL tables (receiver-major neighbor lists) when degrees are bounded.
    max_deg = int(degrees.max()) if m else 0
    if ell_width is None:
        ell_width = max_deg if 0 < max_deg <= ELL_MAX_DEGREE else 0
    elif 0 < ell_width < max_deg:
        raise ValueError(
            f"ell_width={ell_width} < graph max degree {max_deg}"
        )
    ell_senders = ell_weights = ell_mask = None
    if ell_width > 0:
        ell_senders = np.zeros((n_pad, ell_width), dtype=np.int32)
        ell_weights = np.zeros((n_pad, ell_width), dtype=np.float32)
        ell_mask = np.zeros((n_pad, ell_width), dtype=np.float32)
        slot = np.zeros(n_pad, dtype=np.int64)
        for e in range(m):
            r = dst[e]
            j = slot[r]
            ell_senders[r, j] = src[e]
            ell_weights[r, j] = w[e]
            ell_mask[r, j] = 1.0
            slot[r] = j + 1

    return Graph(
        senders=jnp.asarray(senders),
        receivers=jnp.asarray(receivers),
        weights=jnp.asarray(weights),
        edge_mask=jnp.asarray(edge_mask),
        row_ptr=jnp.asarray(row_ptr),
        degrees=jnp.asarray(degrees),
        node_mask=jnp.asarray(node_mask),
        n_nodes=jnp.asarray(n_nodes, dtype=jnp.int32),
        n_edges=jnp.asarray(m, dtype=jnp.int32),
        ell_senders=None if ell_senders is None else jnp.asarray(ell_senders),
        ell_weights=None if ell_weights is None else jnp.asarray(ell_weights),
        ell_mask=None if ell_mask is None else jnp.asarray(ell_mask),
    )


def graph_from_edges(
    edges: Sequence[Tuple[int, int]] | np.ndarray,
    n_nodes: int,
    *,
    weights: Sequence[float] | np.ndarray | None = None,
    n_pad: int | None = None,
    e_pad: int | None = None,
    symmetrize: bool = True,
    ell_width: int | None = None,
    reorder: str = "off",
) -> Graph:
    """Build a padded `Graph` from an undirected edge list.

    ``edges`` is a sequence of (u, v) pairs.  When ``symmetrize`` is True
    (the default, matching the reference's undirected NetworkX graphs fed
    through ``dgl.from_networkx``), both directions are stored.

    ``reorder``: locality relabeling, so that neighbor rows sit close
    together in memory and the SpMM's row gathers hit cache:

      * ``"off"`` (default) — node ids untouched;
      * ``"rcm"`` — apply the RCM permutation (``data/reorder.py``).

    A kept permutation RELABELS node ids: original id ``i`` becomes
    ``g.reorder_perm[i]`` (per-node outputs map back via
    ``out[g.reorder_perm]``).  Callers with pinned special ids (terminals)
    should instead reorder at the spec level — ``data.reorder.rcm_reorder``
    + ``normalize_terminals`` — which keeps terminals on ids 0..2 (the few
    band-breaking rows are a handful of long-range gathers).
    """
    if reorder not in ("off", "rcm"):
        raise ValueError(f"unknown reorder {reorder!r}")
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    w = (
        np.ones(e.shape[0], dtype=np.float32)
        if weights is None
        else np.asarray(weights, dtype=np.float32)
    )

    def build(e2, perm=None):
        if symmetrize:
            src = np.concatenate([e2[:, 0], e2[:, 1]])
            dst = np.concatenate([e2[:, 1], e2[:, 0]])
            w2 = np.concatenate([w, w])
        else:
            src, dst = e2[:, 0], e2[:, 1]
            w2 = w
        np_ = n_pad if n_pad is not None else round_up(n_nodes, 8)
        ep_ = e_pad if e_pad is not None else round_up(src.shape[0], 128)
        g = _build_padded_coo(
            src.astype(np.int32), dst.astype(np.int32), w2, n_nodes, np_,
            ep_, ell_width=ell_width,
        )
        if perm is not None:
            perm_pad = np.arange(np_, dtype=np.int32)
            perm_pad[: perm.shape[0]] = perm
            g = g.replace(reorder_perm=jnp.asarray(perm_pad))
        return g

    if reorder == "rcm" and n_nodes > 1 and e.size:
        from gcn_maxcut.data.reorder import rcm_permutation

        perm = rcm_permutation(e, n_nodes)
        return build(perm[e], perm)
    return build(e)


def graph_from_dense(
    adj: np.ndarray,
    *,
    n_pad: int | None = None,
    e_pad: int | None = None,
    ell_width: int | None = None,
) -> Graph:
    """Build a `Graph` from a dense (possibly weighted) adjacency matrix.

    Mirrors the reference's ``gen_adj_matrix`` + ``qubo_dict_to_torch``
    densification (``commons.py:38-77``) in reverse: we sparsify because the
    edge-form loss never materializes n×n (SURVEY.md §7.3).
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    src, dst = np.nonzero(adj)
    w = adj[src, dst].astype(np.float32)
    n_pad = n_pad if n_pad is not None else round_up(n, 8)
    e_pad = e_pad if e_pad is not None else round_up(max(1, src.shape[0]), 128)
    return _build_padded_coo(
        src.astype(np.int32), dst.astype(np.int32), w, n, n_pad, e_pad,
        ell_width=ell_width,
    )


def dense_adjacency(
    g: Graph, width: int | None = None, values: str = "weights"
) -> jnp.ndarray:
    """Densify to ``[n_pad, width]`` (default ``width = n_pad``).

    With ``values="weights"`` this reproduces the reference's padded
    adjacency-as-node-features quirk (``graphExtender.py:28-48``: the
    n×max_nodes zero-extended adjacency is the GCN input,
    ``TrainingNeural.py:373``).  ``values="mask"`` writes 1.0 per real edge —
    the unweighted aggregation operator matching DGL GraphConv's default of
    ignoring edge weights (used by the dense aggregation path).  Stays
    on device, O(E) writes.
    """
    if values not in ("weights", "mask"):
        raise ValueError(f"unknown values mode {values!r}")
    width = g.n_pad if width is None else width
    dense = jnp.zeros((g.n_pad, width), dtype=jnp.float32)
    vals = g.weights * g.edge_mask if values == "weights" else g.edge_mask
    # Padding edges carry weight 0 and land at (n_pad-1, n_pad-1): harmless.
    cols = jnp.minimum(g.senders, width - 1)
    return dense.at[g.receivers, cols].add(vals)


def pad_graph_batch(graphs: List[Graph]) -> Graph:
    """Stack equally-padded graphs into a leading batch dimension.

    All graphs must share (n_pad, e_pad) — use the data pipeline's bucketing
    to arrange that.  The result's fields have shape ``[B, ...]`` and work
    directly with ``jax.vmap``/``lax.scan``.

    ``reorder_perm`` is an optional pytree leaf (array or None), so a mix
    of reordered and non-reordered graphs would be a pytree-structure
    mismatch inside ``tree_map``; any graph missing a perm gets the
    identity materialized so mixed batches stack cleanly.
    """
    shapes = {(g.n_pad, g.e_pad) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"graphs must share padded shapes, got {shapes}")
    if any(g.reorder_perm is not None for g in graphs):
        n_pad = graphs[0].n_pad
        ident = jnp.arange(n_pad, dtype=jnp.int32)
        graphs = [
            g if g.reorder_perm is not None else g.replace(reorder_perm=ident)
            for g in graphs
        ]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *graphs)
