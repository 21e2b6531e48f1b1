from gcn_maxcut.data.generate import (
    generate_graph,
    generate_unique_terminals,
    generate_graph_dataset,
    random_regular_edges,
    gnp_edges,
    regular_graph_on_device,
)
from gcn_maxcut.data.process import (
    normalize_terminals,
    process_graphs,
    ProcessedDataset,
    DataConfig,
)
from gcn_maxcut.data.io import (
    save_dataset,
    load_dataset,
    save_object,
    load_object,
    load_text_graph,
)

__all__ = [
    "generate_graph",
    "generate_unique_terminals",
    "generate_graph_dataset",
    "random_regular_edges",
    "gnp_edges",
    "regular_graph_on_device",
    "normalize_terminals",
    "process_graphs",
    "ProcessedDataset",
    "DataConfig",
    "save_dataset",
    "load_dataset",
    "save_object",
    "load_object",
    "load_text_graph",
]
