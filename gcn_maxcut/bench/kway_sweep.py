"""BASELINE.json config[3]: large single graph, k-way sweep with terminals.

"Large single graph n=100k d=8, k-way sweep k=3..8 with terminal
constraints — single-host sharded SpMM": for each k, train the sharded
2-layer GCN (``parallel/giant.py``: ring halo-exchange SpMM inside one
``shard_map``-ed jit step, terminals 0..k-1 pinned on their owning shard)
and report the decoded cut as a fraction of total edge weight plus training
edges/s.  The reference has no analog (its max trained size is n=500,
k=3 — SURVEY.md §5.7); the uniform-random expectation (k-1)/k is the
quality floor each k must clearly beat.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


def _regular_edges(n: int, d: int, seed: int) -> np.ndarray:
    """d-regular edge list (``random_regular_edges`` dispatches to the
    native C++ sampler for large n on its own)."""
    from gcn_maxcut.data.generate import random_regular_edges

    return random_regular_edges(n, d, seed=seed)


def kway_sweep(
    n: int = 100_000,
    d: int = 8,
    ks: Sequence[int] = (3, 4, 5, 6, 7, 8),
    epochs: int = 60,
    epochs_per_call: int = 10,
    dim_embedding: int = 128,
    hidden_dim: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    mesh=None,
    partition: str = "contiguous",
) -> List[Dict[str, float]]:
    """Train one n-node d-regular graph at each k; return per-k results.

    Each entry: ``k``, ``final_cut``, ``cut_fraction`` (of total edge
    weight), ``random_fraction`` ((k-1)/k uniform floor), ``edges_per_s``
    (training throughput), ``train_time_s``.

    ``partition`` passes through to :class:`GiantConfig`.
    """
    edges = _regular_edges(n, d, seed)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    total_edges = edges.shape[0]

    results = []
    for k in ks:
        cfg = GiantConfig(
            num_classes=int(k),
            dim_embedding=dim_embedding,
            hidden_dim=hidden_dim,
            learning_rate=learning_rate,
            number_epochs=epochs,
            epochs_per_call=epochs_per_call,
            seed=seed,
            log_every=max(1, epochs // 4),
            partition=partition,
        )
        t0 = time.perf_counter()
        out = train_giant_graph(
            src, dst, n, cfg, mesh=mesh, measure_throughput=True
        )
        res = {
            "k": int(k),
            "n": n,
            "d": d,
            "final_cut": out["final_cut"],
            "cut_fraction": out["final_cut"] / total_edges,
            "random_fraction": (k - 1) / k,
            "edges_per_s": out["edges_per_s"],
            "edges_per_s_amortized": out.get("edges_per_s_amortized"),
            "epoch_time_s_amortized": out.get("epoch_time_s_amortized"),
            "timing_reliable": out.get("timing_reliable"),
            "timing_spread_s": out.get("timing_spread_s"),
            "train_time_s": time.perf_counter() - t0,
            "num_shards": out["num_shards"],
        }
        logger.info(
            "k=%d: cut %.0f/%d (%.1f%%; random floor %.1f%%), "
            "%.2e edges/s (amortized %.2e)",
            k, res["final_cut"], total_edges, 100 * res["cut_fraction"],
            100 * res["random_fraction"], res["edges_per_s"],
            res["edges_per_s_amortized"] or 0.0,
        )
        results.append(res)
    return results
