"""Graph partitioning for node-sharded (giant single graph) parallelism.

The GNN analog of sequence/context parallelism (SURVEY.md §5.7): one huge
graph's nodes are split into D ranges, each device owns a node range plus
its incident (incoming) edges, and remote sender features are fetched by
collectives each layer.  Edges are grouped by *sender shard* so the ring
schedule (``spmm.sharded_spmm_ring``) can process the local group while the
next remote shard's features are in flight — the halo-exchange overlap of
the north star.

Partitioners:
  * ``partition_nodes_contiguous`` — equal contiguous ranges (optimal for
    the on-device circulant benchmark graphs whose edges are short-range).
  * ``partition_nodes_bfs`` — BFS-grown blocks (METIS-style locality
    heuristic, no external dependency): peel connected BFS regions of
    n/D nodes each to minimize cross-shard edges on irregular graphs.

All shapes are static per (D, n_shard, e_shard): every device's edge group
buffers are padded to the same size so the whole `ShardedGraph` is a
stackable pytree usable under ``shard_map``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from gcn_maxcut.core.graph import pytree_dataclass, round_up, static_field


@pytree_dataclass
class ShardedGraph:
    """Node-sharded graph: per-device leading axis D on every field.

    Edge groups: for device d, group s holds edges whose receiver is owned
    by d and whose sender is owned by shard ``(d + s) mod D`` — group 0 is
    local, group s>0 arrives via the ring after s hops.  Senders are stored
    as *local indices within their owning shard*; receivers as local
    indices within d.

    Shapes: ``senders/receivers/weights/edge_mask: [D, S, e_group]`` with
    S = D groups, ``degrees/node_mask: [D, n_shard]``, scalars per shard.
    """

    senders: jnp.ndarray     # int32 [D, D, e_group] local idx in sender shard
    receivers: jnp.ndarray   # int32 [D, D, e_group] local idx in own shard
    weights: jnp.ndarray     # f32   [D, D, e_group]
    edge_mask: jnp.ndarray   # f32   [D, D, e_group]
    degrees: jnp.ndarray     # f32   [D, n_shard]
    node_mask: jnp.ndarray   # f32   [D, n_shard]
    n_nodes: jnp.ndarray     # int32 [] total real nodes
    # optional per-group ELL tables (receiver-major): gather-only SpMM with
    # no scatter in either pass (see ops/segment.py)
    ell_senders: jnp.ndarray | None = None   # int32 [D, D, n_shard, ell_w]
    ell_weights: jnp.ndarray | None = None   # f32   [D, D, n_shard, ell_w]
    ell_mask: jnp.ndarray | None = None      # f32   [D, D, n_shard, ell_w]
    # static: True iff the directed COO was verified symmetric (A^T = A) at
    # build time; gates the symmetric custom VJP (spmm.sharded_spmm_sym) —
    # asymmetric graphs fall back to the autodiff backward.
    symmetric: bool = static_field(default=True)

    @property
    def num_shards(self) -> int:
        return self.senders.shape[0]

    @property
    def n_shard(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def e_group(self) -> int:
        return self.senders.shape[-1]


def shard_specs(sg: ShardedGraph, axis: str = "graph"):
    """``shard_map`` in_specs pytree for a `ShardedGraph`: leading-axis
    sharding on array fields, replication for scalars."""
    from jax.sharding import PartitionSpec as P

    return jax.tree_util.tree_map(
        lambda a: P(axis) if getattr(a, "ndim", 0) > 0 else P(), sg
    )


def local_shard(sg: ShardedGraph) -> ShardedGraph:
    """Squeeze the singleton device axis shard_map leaves on array fields."""
    return jax.tree_util.tree_map(
        lambda a: a[0] if getattr(a, "ndim", 0) > 0 else a, sg
    )


def partition_nodes_contiguous(n: int, num_shards: int) -> np.ndarray:
    """Owner shard of each node: equal contiguous ranges."""
    n_shard = -(-n // num_shards)
    return np.minimum(np.arange(n) // n_shard, num_shards - 1)


def partition_nodes_bfs(
    senders: np.ndarray, receivers: np.ndarray, n: int, num_shards: int
) -> np.ndarray:
    """BFS-grown balanced blocks (METIS-style locality without METIS).

    Grows each shard as a BFS region of ~n/D nodes from the lowest-id
    unassigned seed, so most edges stay within a shard on graphs with
    locality.  O(n + E) host-side; for the 10M-node config run once and
    cache alongside the dataset.
    """
    # CSR over undirected adjacency
    order = np.argsort(senders, kind="stable")
    s_sorted, r_sorted = senders[order], receivers[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, s_sorted + 1, 1)
    np.cumsum(indptr, out=indptr)

    target = -(-n // num_shards)
    owner = np.full(n, -1, dtype=np.int64)
    next_seed = 0
    from collections import deque

    for shard in range(num_shards):
        count = 0
        queue: deque[int] = deque()
        while count < target:
            if not queue:
                while next_seed < n and owner[next_seed] != -1:
                    next_seed += 1
                if next_seed >= n:
                    break
                queue.append(next_seed)
                owner[next_seed] = shard
                count += 1
            v = queue.popleft()
            for e in range(indptr[v], indptr[v + 1]):
                u = r_sorted[e]
                if owner[u] == -1 and count < target:
                    owner[u] = shard
                    count += 1
                    queue.append(u)
    owner[owner == -1] = num_shards - 1
    return owner


def partition_nodes_metis(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    imbalance: float = 0.03,
    seed: int = 0,
) -> np.ndarray:
    """Multilevel (METIS-style) partition via the native toolkit: heavy-
    edge-matching coarsening, BFS initial partition on the coarsest graph,
    greedy KL/FM boundary refinement at every uncoarsening level
    (``native/graphtools.cpp::gt_metis_partition`` — the north star's
    "METIS-style edge partitioning" without an external METIS dependency).
    Falls back to :func:`partition_nodes_bfs` when the native library is
    unavailable.  Measured edge-cut vs BFS: DESIGN.md §7 (multilevel wins
    on irregular graphs; both are near-optimal on banded ones).
    """
    from gcn_maxcut.native.bindings import metis_partition_native

    owner = metis_partition_native(
        senders, receivers, n, num_shards,
        weights=weights, imbalance=imbalance, seed=seed,
    )
    if owner is None:
        return partition_nodes_bfs(senders, receivers, n, num_shards)
    return owner


def partition_quality(
    owner: np.ndarray, senders: np.ndarray, receivers: np.ndarray
) -> dict:
    """Edge-cut quality of a node->shard assignment.

    Returns ``cross_shard_edge_fraction`` (the metric that decides ring
    traffic: fraction of directed edges whose endpoints live on different
    shards), ``imbalance`` (max shard size / mean), and per-hop-distance
    edge counts (``edges_by_hop[s]`` = edges the ring serves at hop s) —
    the measured basis for choosing BFS vs contiguous partitioners.
    """
    owner = np.asarray(owner)
    num_shards = int(owner.max()) + 1 if owner.size else 1
    send_shard = owner[senders]
    recv_shard = owner[receivers]
    cross = send_shard != recv_shard
    hops = (send_shard - recv_shard) % num_shards
    sizes = np.bincount(owner, minlength=num_shards)
    return {
        "num_shards": num_shards,
        "cross_shard_edge_fraction": float(cross.mean()) if cross.size else 0.0,
        "imbalance": float(sizes.max() / max(sizes.mean(), 1e-9)),
        "edges_by_hop": np.bincount(hops, minlength=num_shards).tolist(),
        "shard_sizes": sizes.tolist(),
    }


def is_symmetric_coo(
    senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray
) -> bool:
    """True iff the directed COO multiset equals its transpose
    ({(s, r, w)} == {(r, s, w)}).

    Native O(E) order-independent hash when the toolkit is built
    (``native/graphtools.cpp::gt_symmetry_check``); O(E log E) sort-based
    check otherwise.
    """
    if senders.shape[0] != receivers.shape[0]:
        return False
    from gcn_maxcut.native.bindings import symmetry_check_native

    native = symmetry_check_native(senders, receivers, weights)
    if native is not None:
        return native
    fwd = np.lexsort((weights, receivers, senders))
    bwd = np.lexsort((weights, senders, receivers))
    return (
        np.array_equal(senders[fwd], receivers[bwd])
        and np.array_equal(receivers[fwd], senders[bwd])
        and np.allclose(weights[fwd], weights[bwd])
    )


def shard_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    owner: np.ndarray | None = None,
    edge_pad_multiple: int = 128,
    build_ell: bool = True,
    check_symmetry: bool = True,
    ell_budget_bytes: int = 1 << 30,
    use_native: bool = True,
    local_reorder: str = "off",
) -> Tuple[ShardedGraph, np.ndarray]:
    """Build a `ShardedGraph` from directed COO arrays.

    ``owner`` maps node -> shard (default contiguous).  Nodes are relabeled
    so each shard's nodes are locally dense ``[0, n_shard)``; returns
    ``(sharded_graph, global_to_local)`` where ``global_to_local[v]``
    encodes ``owner * n_shard + local_index`` for decoding results.

    ``check_symmetry``: verify A^T = A once at build time (sort-based, a
    few seconds at 80M edges) so the symmetric custom VJP
    (``spmm.sharded_spmm_sym``) is only used when its algebra holds;
    asymmetric inputs get ``symmetric=False`` and the autodiff backward.
    Pass False to skip the check and assert symmetry (trusted callers,
    e.g. the on-device circulant generators).

    ``local_reorder="rcm"``: additionally RCM-relabel each shard's nodes by
    its intra-shard subgraph so local edges band (scipy reverse
    Cuthill-McKee per shard) and the hop-0 row gathers hit cache.  It uses
    the numpy assembly lane (the native fast lane does not build it).
    NOTE: relabeling means
    "shard 0 local rows 0..k-1" are no longer global nodes 0..k-1 — for
    the max-cut objective any k distinct nodes are a valid terminal set
    (the reference also picks arbitrary ids), but decode mappings must go
    through the returned ``global_to_local``.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    w = (
        np.ones(senders.shape[0], dtype=np.float32)
        if weights is None
        else np.asarray(weights, dtype=np.float32)
    )
    symmetric = True
    if check_symmetry:
        symmetric = is_symmetric_coo(senders, receivers, w)
    if owner is None:
        owner = partition_nodes_contiguous(n, num_shards)
    owner = np.asarray(owner, dtype=np.int64)

    # fast lane: the native O(E) counting-sort assembly (same contract;
    # local_reorder needs the numpy lane)
    if use_native and n < (1 << 31) and local_reorder == "off":
        from gcn_maxcut.native.bindings import shard_assembly_native

        res = shard_assembly_native(
            senders, receivers, owner, n, num_shards,
            weights=weights,
            edge_pad_multiple=edge_pad_multiple,
            build_ell=build_ell,
            ell_budget_bytes=ell_budget_bytes,
        )
        if res is not None:
            g2l = owner * res["n_shard"] + res["local"]
            sg = ShardedGraph(
                senders=jnp.asarray(res["S"]),
                receivers=jnp.asarray(res["R"]),
                weights=jnp.asarray(res["W"]),
                edge_mask=jnp.asarray(res["M"]),
                degrees=jnp.asarray(res["degrees"]),
                node_mask=(
                    jnp.arange(res["n_shard"])[None, :]
                    < jnp.asarray(res["shard_sizes"])[:, None]
                ).astype(jnp.float32),
                n_nodes=jnp.asarray(n, dtype=jnp.int32),
                ell_senders=jnp.asarray(res["ES"]) if res["use_ell"] else None,
                ell_weights=jnp.asarray(res["EW"]) if res["use_ell"] else None,
                ell_mask=jnp.asarray(res["EM"]) if res["use_ell"] else None,
                symmetric=symmetric,
            )
            return sg, g2l

    shard_sizes = np.bincount(owner, minlength=num_shards)
    n_shard = round_up(int(shard_sizes.max()), 8)

    # local index of each node within its shard (order-preserving): rank of
    # the node among its shard's members, via one stable sort over owners
    node_order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(shard_sizes)[:-1]])
    local = np.empty(n, dtype=np.int64)
    local[node_order] = np.arange(n) - np.repeat(starts, shard_sizes)

    if local_reorder == "rcm":
        # band each shard's intra-shard subgraph: new local id =
        # rcm_perm[old local id], applied before bucket assembly so every
        # downstream table (incl. other shards' references to this shard's
        # senders) sees the banded order
        from gcn_maxcut.data.reorder import rcm_permutation

        intra = owner[senders] == owner[receivers]
        for sdx in range(num_shards):
            sel = intra & (owner[senders] == sdx)
            e_loc = np.stack(
                [local[senders[sel]], local[receivers[sel]]], axis=1
            )
            sz = int(shard_sizes[sdx])
            if sz == 0:
                continue
            perm = rcm_permutation(e_loc, sz)
            members = np.nonzero(owner == sdx)[0]
            local[members] = perm[local[members]]
    elif local_reorder != "off":
        raise ValueError(f"unknown local_reorder {local_reorder!r}")

    recv_shard = owner[receivers]
    send_shard = owner[senders]
    group = (send_shard - recv_shard) % num_shards  # ring hop distance
    r_loc_all = local[receivers]

    # ---- fully vectorized (shard, group) bucket assembly -------------------
    # One global lexsort orders edges by (recv_shard, group, local receiver);
    # every per-(d, s) quantity then falls out of bincounts and run-length
    # arithmetic.  Round 1 looped over the D^2 buckets in Python with a
    # per-bucket argsort — the host step dominated wall-clock at 10M-node /
    # 8-shard scale (measured; see PARITY.md).
    e_sorted = np.lexsort((r_loc_all, group, recv_shard))
    ds_key = (recv_shard * num_shards + group)[e_sorted]
    counts_flat = np.bincount(ds_key, minlength=num_shards * num_shards)
    e_group = round_up(int(counts_flat.max()) if counts_flat.size else 0,
                       edge_pad_multiple)
    bucket_starts = np.concatenate([[0], np.cumsum(counts_flat)[:-1]])
    # position of each (sorted) edge within its bucket
    pos = np.arange(e_sorted.size) - np.repeat(bucket_starts, counts_flat)

    S = np.full((num_shards, num_shards, e_group), n_shard - 1, dtype=np.int32)
    R = np.full_like(S, n_shard - 1)
    W = np.zeros((num_shards, num_shards, e_group), dtype=np.float32)
    M = np.zeros_like(W)
    flat = ds_key * e_group + pos
    S.reshape(-1)[flat] = local[senders[e_sorted]]
    R.reshape(-1)[flat] = r_loc_all[e_sorted]
    W.reshape(-1)[flat] = w[e_sorted]
    M.reshape(-1)[flat] = 1.0

    # per-(shard, group) in-degree of each local receiver -> ELL width,
    # via bincount on the combined (d, s, r_loc) key
    dsr_key = ds_key * n_shard + r_loc_all[e_sorted]
    deg_group_flat = np.bincount(
        dsr_key, minlength=num_shards * num_shards * n_shard
    )
    ell_w = int(deg_group_flat.max()) if deg_group_flat.size else 0
    # skip the tables when a hub/partition pathology would blow memory or
    # trace size: (a) byte budget across all THREE tables (senders/weights/
    # mask, 4 B each — ell_w is the max per-(shard,group) in-degree, so one
    # hub inflates every D^2 table); (b) skew ceiling — if the max in-degree
    # is far above the mean occupied in-degree, the unrolled gather loop
    # would mostly process padding (and its trace grows with ell_w).
    occupied = deg_group_flat[deg_group_flat > 0]
    mean_deg = float(occupied.mean()) if occupied.size else 0.0
    ell_bytes = 3 * 4 * num_shards * num_shards * n_shard * ell_w
    use_ell = (
        build_ell and ell_w > 0
        and ell_bytes <= ell_budget_bytes
        and ell_w <= max(8.0, 8.0 * mean_deg)
    )
    if use_ell:
        ES = np.full(
            (num_shards, num_shards, n_shard, ell_w), n_shard - 1, np.int32
        )
        EW = np.zeros((num_shards, num_shards, n_shard, ell_w), np.float32)
        EM = np.zeros_like(EW)
        # slot within each run of equal (d, s, r_loc): edges are already
        # sorted by dsr_key, so slot = index − start-of-run
        run_starts = np.concatenate(
            [[0], np.cumsum(np.bincount(dsr_key))[:-1]]
        )
        slot = np.arange(e_sorted.size) - run_starts[dsr_key]
        ell_flat = dsr_key * ell_w + slot
        ES.reshape(-1)[ell_flat] = local[senders[e_sorted]]
        EW.reshape(-1)[ell_flat] = w[e_sorted]
        EM.reshape(-1)[ell_flat] = 1.0

    degrees = np.zeros((num_shards, n_shard), dtype=np.float32)
    deg_flat = np.bincount(
        recv_shard * n_shard + r_loc_all, minlength=num_shards * n_shard
    )
    degrees.reshape(-1)[:] = deg_flat
    node_mask = (
        np.arange(n_shard)[None, :] < shard_sizes[:, None]
    ).astype(np.float32)

    g2l = owner * n_shard + local
    sg = ShardedGraph(
        senders=jnp.asarray(S),
        receivers=jnp.asarray(R),
        weights=jnp.asarray(W),
        edge_mask=jnp.asarray(M),
        degrees=jnp.asarray(degrees),
        node_mask=jnp.asarray(node_mask),
        n_nodes=jnp.asarray(n, dtype=jnp.int32),
        ell_senders=jnp.asarray(ES) if use_ell else None,
        ell_weights=jnp.asarray(EW) if use_ell else None,
        ell_mask=jnp.asarray(EM) if use_ell else None,
        symmetric=symmetric,
    )
    return sg, g2l
