"""Tensorization: terminal normalization + padded `Graph` dataset assembly.

Replaces the reference's ``DataGenerator/graphExtender.py`` pipeline
(``process_graphs_from_folder`` :50-132): each graph's terminals are moved
onto node ids ``[0, 1, 2]``, the graph is converted to the padded sparse
container, and the padded-adjacency node features are produced on demand.

Key differences from the reference, by design:

  * Terminal normalization is a *node-id permutation* applied to the edge
    list (a bijection swapping terminal ids with ``0..t-1``), not repeated
    ``nx.relabel_nodes`` passes (``graphExtender.py:8-26,71-97``).  The
    permutation handles every collision case, so no graph is ever skipped —
    the reference drops graphs whose terminals partially collide with
    ``{0,1,2}`` in unhandled ways (``:95-97``).  A ``skipped`` counter is
    still reported for contract parity (always 0 here).
  * The dense n×max_nodes adjacency used as node features
    (``extend_matrix_torch_2`` :28-48) is *not* stored per graph; it is
    regenerated on device from the sparse container
    (``core.dense_adjacency``), eliminating the reference's O(n²)
    host-side densification (``commons.py:65-77``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from gcn_maxcut.core.graph import Graph, graph_from_edges, round_up
from gcn_maxcut.data.generate import GraphSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Processing parameters (reference ``DataProcessingConfig`` analog,
    ``prepareData.ipynb`` cell 1)."""

    max_nodes: int = 1000          # feature width / padding target
    num_terminals: int = 3
    node_pad_multiple: int = 8
    edge_pad_multiple: int = 128


def terminal_permutation(n: int, terminals: Sequence[int]) -> np.ndarray:
    """Permutation p of node ids with p[terminals[k]] = k for all k.

    Built as a sequence of transpositions (t_k <-> k), which is a bijection
    for every collision pattern — including terminals already inside
    ``{0..t-1}`` in any arrangement.
    """
    perm = np.arange(n, dtype=np.int64)
    for k, t in enumerate(terminals):
        # node t may have been moved by an earlier swap; find its slot
        cur = int(np.nonzero(perm == t)[0][0])
        perm[[k, cur]] = perm[[cur, k]]
    # invert: we built "slot -> node"; we need "node -> new id"
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return inv


def normalize_terminals(spec: GraphSpec) -> GraphSpec:
    """Relabel nodes so terminals become ``[0..t-1]`` (order-preserving).

    After this, terminals are always stored as the literal ``[0, 1, 2]``,
    matching the invariant the whole reference pipeline relies on
    (``graphExtender.py:114``; checked in ``complete_training_pipeline.ipynb``
    cell 10).
    """
    t = len(spec.terminals)
    if list(spec.terminals) == list(range(t)):
        return spec
    p = terminal_permutation(spec.n_nodes, spec.terminals)
    edges = p[spec.edges]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    edges = np.stack([lo, hi], axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    weights = None if spec.weights is None else spec.weights[order]
    return GraphSpec(
        n_nodes=spec.n_nodes,
        edges=edges[order],
        terminals=list(range(t)),
        degree=spec.degree,
        weights=weights,
    )


@dataclasses.dataclass
class ProcessedDataset:
    """Canonical dataset: equally-padded graphs + metadata.

    The static-shape replacement for the reference's 4-tuple record
    ``[dgl_graph, padded_adjacency, nx_graph, [0,1,2]]``
    (``graphExtender.py:114``; SURVEY.md §2.2): the `Graph` container serves
    both the message-passing and adjacency roles; specs retain the host edge
    lists for baselines/reports.
    """

    graphs: Dict[int, Graph]
    specs: Dict[int, GraphSpec]
    config: DataConfig
    skipped: int = 0

    def __len__(self) -> int:
        return len(self.graphs)


def process_graphs(
    specs: Dict[int, GraphSpec] | List[GraphSpec],
    config: DataConfig = DataConfig(),
) -> ProcessedDataset:
    """Normalize terminals and tensorize every graph to shared padding.

    All graphs are padded to the same ``(n_pad, e_pad)`` (the bucket of the
    largest), so the whole dataset stacks via ``core.pad_graph_batch`` and
    trains inside a single scanned jit step.
    """
    if isinstance(specs, list):
        specs = dict(enumerate(specs))
    normed = {i: normalize_terminals(s) for i, s in specs.items()}
    if not normed:
        return ProcessedDataset(graphs={}, specs={}, config=config)
    # Rows pad to the dataset's largest graph; the 1000-wide feature matrix
    # (config.max_nodes) is produced separately at feature-build time, so a
    # 50-node test graph does not cost 1000 rows of SpMM.
    n_pad = round_up(
        max(s.n_nodes for s in normed.values()), config.node_pad_multiple
    )
    e_pad = round_up(
        max(2 * s.n_edges for s in normed.values()), config.edge_pad_multiple
    )
    # Dataset-wide ELL width so every graph stacks into one batch pytree
    # (mixed-degree datasets would otherwise get ragged ELL tables).
    from gcn_maxcut.core.graph import ELL_MAX_DEGREE

    max_deg = max(
        (
            int(np.bincount(s.edges.ravel(), minlength=s.n_nodes).max())
            for s in normed.values()
            if s.n_edges
        ),
        default=0,
    )
    ell_width = max_deg if 0 < max_deg <= ELL_MAX_DEGREE else 0
    graphs = {
        i: graph_from_edges(
            s.edges,
            s.n_nodes,
            weights=s.weights,
            n_pad=n_pad,
            e_pad=e_pad,
            ell_width=ell_width,
        )
        for i, s in normed.items()
    }
    return ProcessedDataset(graphs=graphs, specs=normed, config=config)
