from gcn_maxcut.parallel.mesh import make_mesh, multi_host_init, device_count
from gcn_maxcut.parallel.partition import (
    ShardedGraph,
    shard_graph,
    partition_nodes_contiguous,
    partition_nodes_bfs,
    partition_nodes_metis,
    partition_quality,
    is_symmetric_coo,
)
from gcn_maxcut.parallel.spmm import (
    sharded_spmm_allgather,
    sharded_spmm_ring,
    make_sharded_spmm,
)
from gcn_maxcut.parallel.data_parallel import (
    make_dp_epoch_fn,
    shard_batch_for_dp,
)

__all__ = [
    "make_mesh",
    "multi_host_init",
    "device_count",
    "ShardedGraph",
    "shard_graph",
    "partition_nodes_contiguous",
    "partition_nodes_bfs",
    "partition_nodes_metis",
    "partition_quality",
    "is_symmetric_coo",
    "sharded_spmm_allgather",
    "sharded_spmm_ring",
    "make_sharded_spmm",
    "make_dp_epoch_fn",
    "shard_batch_for_dp",
]
