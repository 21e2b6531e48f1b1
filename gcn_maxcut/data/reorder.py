"""Locality reordering: RCM banding so neighbor rows sit close in memory.

Graphs with inherent locality (meshes, lattices, road-like networks, or
any graph that is not a strong expander) can be relabeled so neighbor
offsets are bounded by a small bandwidth W — then the SpMM's row gathers
hit cache, and exactly banded graphs can use ``ops/banded.py``.  This is
the I-GCN "islandization" / production-GNN locality-reordering idea
(PAPERS.md) in its simplest effective form: SciPy's reverse Cuthill–McKee.

Random regular graphs are expanders — no ordering can band them (their
bandwidth stays Θ(n)); ``rcm_reorder`` reports the achieved bandwidth so
callers can decide which SpMM path to use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_maxcut.data.generate import GraphSpec


def rcm_permutation(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill–McKee node permutation (new_id = perm_inv[old_id])."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    adj = csr_matrix(
        (np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, n)
    )
    order = reverse_cuthill_mckee(adj, symmetric_mode=True)  # slot -> old id
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return inv


def graph_bandwidth(edges: np.ndarray) -> int:
    """max |u − v| over edges (0 for an empty edge list)."""
    if edges.size == 0:
        return 0
    return int(np.max(np.abs(edges[:, 0].astype(np.int64) - edges[:, 1])))


def rcm_reorder(spec: GraphSpec) -> Tuple[GraphSpec, int]:
    """Relabel a graph by RCM; returns ``(reordered_spec, bandwidth)``.

    Terminal node ids are mapped through the permutation (re-run
    ``normalize_terminals`` afterwards if the pipeline needs them back on
    ``[0..t-1]``).
    """
    perm = rcm_permutation(spec.edges, spec.n_nodes)
    e = perm[spec.edges]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    edges = np.stack([lo, hi], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    new = GraphSpec(
        n_nodes=spec.n_nodes,
        edges=edges[order],
        terminals=[int(perm[t]) for t in spec.terminals],
        degree=spec.degree,
        weights=None if spec.weights is None else spec.weights[order],
    )
    return new, graph_bandwidth(new.edges)


def is_bandable(spec: GraphSpec, max_bandwidth: int) -> Tuple[bool, int]:
    """Whether RCM brings the graph's bandwidth under ``max_bandwidth``."""
    _, w = rcm_reorder(spec)
    return w <= max_bandwidth, w
