from gcn_maxcut.core.graph import (
    Graph,
    graph_from_edges,
    graph_from_dense,
    dense_adjacency,
    pad_graph_batch,
    round_up,
)

__all__ = [
    "Graph",
    "graph_from_edges",
    "graph_from_dense",
    "dense_adjacency",
    "pad_graph_batch",
    "round_up",
]
