from gcn_maxcut.native.bindings import (
    is_available,
    build,
    random_regular_edges_native,
    sort_by_receiver_native,
    bfs_partition_native,
    brute_force_maxcut_native,
    greedy_maxcut_native,
)

__all__ = [
    "is_available",
    "build",
    "random_regular_edges_native",
    "sort_by_receiver_native",
    "bfs_partition_native",
    "brute_force_maxcut_native",
    "greedy_maxcut_native",
]
