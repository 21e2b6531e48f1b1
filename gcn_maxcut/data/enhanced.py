"""Enhanced dataset processing: baseline statistics stamped per graph.

Capability parity with the reference's second-generation OO pipeline in
``DataGenerator/prepareData.ipynb``: the ``EnhancedDataProcessor`` (cells
5, 7) stamps ``_baseline_stats`` into each dataset — flow-based exact
2-way/k-way cuts (``recursive_min_cut``/``find_optimal_k_way_cut``, cell 6)
and randomized-baseline values — so downstream evaluation can report
quality ratios without re-solving.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from gcn_maxcut.baselines.exact import anytime_solver, recursive_flow_min_cut
from gcn_maxcut.baselines.randomized import randomized_k_way_maxcut
from gcn_maxcut.data.process import ProcessedDataset
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


def compute_baseline_stats(
    dataset: ProcessedDataset,
    *,
    randomized_iterations: int = 1000,
    solver_time_limit: float = 10.0,
    include_flow: bool = True,
    include_solver: bool = True,
    seed: int = 0,
) -> Dict[int, Dict[str, float]]:
    """Per-graph baseline stats: randomized / flow min-cut / anytime solver.

    Returns ``{graph_index: {...}}`` and also attaches it to the dataset as
    ``dataset.baseline_stats`` (the reference's ``_baseline_stats`` slot).
    """
    stats: Dict[int, Dict[str, float]] = {}
    for i in sorted(dataset.graphs):
        g = dataset.graphs[i]
        rec: Dict[str, float] = {
            "n_nodes": int(g.n_nodes),
            "n_edges": int(g.n_edges) // 2,
        }
        t0 = time.perf_counter()
        _, rand_cut, used = randomized_k_way_maxcut(
            g, 3, randomized_iterations, seed=seed + i
        )
        rec["randomized_cut"] = float(rand_cut)
        rec["randomized_time_s"] = time.perf_counter() - t0
        rec["randomized_iterations"] = used

        if include_flow:
            t0 = time.perf_counter()
            _, flow_val = recursive_flow_min_cut(g)
            rec["flow_min_cut_value"] = float(flow_val)
            rec["flow_time_s"] = time.perf_counter() - t0

        if include_solver:
            t0 = time.perf_counter()
            res = anytime_solver(
                g, 3, time_limit=solver_time_limit, seed=seed + i
            )
            rec["solver_cut"] = float(res["cut_value"])
            rec["solver_method"] = res["method"]
            rec["solver_time_s"] = time.perf_counter() - t0

        stats[i] = rec
        logger.info(
            "baseline stats graph %d (n=%d): randomized %.0f%s",
            i,
            rec["n_nodes"],
            rec["randomized_cut"],
            f", solver {rec['solver_cut']:.0f}" if include_solver else "",
        )
    dataset.baseline_stats = stats  # dynamic attr, mirrors `_baseline_stats`
    return stats
