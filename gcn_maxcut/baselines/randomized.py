"""Randomized k-way max-cut baseline, vmapped on device.

Capability parity with the reference's ``RandomAlgorithm/RandomizedMaxCut.py``:
``randomized_k_way_maxcut`` (:63-122) with its optional terminal pinning,
improvement ``threshold``, and ``patience`` early stopping; the
``evaluate_algorithm_on_graphs`` (:125-160) and ``benchmark_algorithm``
(:163-211) harnesses; ``test_fixed_terminals`` (:283-342); ``quick_demo``
(:345-371).

The reference evaluates one random assignment per Python-loop iteration
(O(n + E) interpreted per iteration).  Here a whole chunk of candidate
assignments is sampled and scored in a single device call (uniform sampling
+ vmapped O(E) segment-sum cut), and the exact sequential
threshold/patience early-stop semantics are replayed over the returned cut
sequence on the host — bitwise-identical stopping decisions at device speed.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.objectives.cut_loss import hard_cut_value
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


@partial(jax.jit, static_argnames=("chunk", "k", "num_fixed"))
def _sample_and_score(
    g: Graph, key: jax.Array, chunk: int, k: int, num_fixed: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sample ``chunk`` uniform assignments (terminals pinned) and score all."""
    n_pad = g.n_pad
    asn = jax.random.randint(key, (chunk, n_pad), 0, k)
    ids = jnp.arange(n_pad)[None, :]
    asn = jnp.where(ids < num_fixed, ids, asn)
    cuts = jax.vmap(lambda a: hard_cut_value(g, a))(asn)
    return asn, cuts


def randomized_k_way_maxcut(
    g: Graph,
    k: int = 3,
    max_iterations: int = 1000,
    threshold: float = 0.0,
    patience: int = 100,
    fixed_terminals: bool = True,
    num_terminals: int = 3,
    seed: int = 0,
    chunk_size: int = 512,
) -> Tuple[np.ndarray, float, int]:
    """Best-of-random-assignments baseline.

    Returns ``(assignment[:n], best_cut, iterations_used)``.
    """
    key = jax.random.PRNGKey(seed)
    num_fixed = num_terminals if fixed_terminals else 0
    n = int(g.n_nodes)

    best_cut, best_asn = -np.inf, None
    used = 0
    remaining = max_iterations
    global_stall = 0
    while remaining > 0:
        chunk = min(chunk_size, remaining)
        key, sub = jax.random.split(key)
        asn, cuts = _sample_and_score(g, sub, chunk_size, k, num_fixed)
        cuts_np = np.asarray(cuts)[:chunk]
        # replay the reference's sequential early-stop semantics relative
        # to the global running best: stop after ``patience`` consecutive
        # iterations whose improvement over it is <= ``threshold``
        # (reference ``RandomizedMaxCut.py:110-121``)
        stall = global_stall
        stopped = False
        for i, c in enumerate(cuts_np):
            used += 1
            if c - best_cut > threshold:
                best_cut = float(c)
                best_asn = np.asarray(asn[i])[:n]
                stall = 0
            else:
                stall += 1
                if stall >= patience:
                    stopped = True
                    break
        global_stall = stall
        if stopped:
            break
        remaining -= chunk
    return best_asn, best_cut, used


def evaluate_algorithm_on_graphs(
    graphs: List[Graph],
    k: int = 3,
    max_iterations: int = 1000,
    seed: int = 0,
    **kwargs,
) -> Dict[str, float]:
    """Mean cut + wall time over a graph list (reference :125-160)."""
    cuts, times = [], []
    for i, g in enumerate(graphs):
        t0 = time.perf_counter()
        _, cut, _ = randomized_k_way_maxcut(
            g, k, max_iterations, seed=seed + i, **kwargs
        )
        times.append(time.perf_counter() - t0)
        cuts.append(cut)
    return {
        "avg_cut": float(np.mean(cuts)),
        "std_cut": float(np.std(cuts)),
        "avg_time": float(np.mean(times)),
        "total_time": float(np.sum(times)),
        "cuts": cuts,
        "times": times,
    }


def benchmark_algorithm(
    node_sizes: List[int] = (1000, 2000, 3000, 4000, 5000),
    k_values: List[int] = (3, 4, 5, 10),
    degree: int = 8,
    iterations: int = 10_000,
    seed: int = 0,
) -> Dict[Tuple[int, int], Dict[str, float]]:
    """Sweep n × k (reference ``benchmark_algorithm`` :163-211)."""
    from gcn_maxcut.data.generate import generate_graph
    from gcn_maxcut.data.process import DataConfig, process_graphs

    results = {}
    for n in node_sizes:
        spec = generate_graph(n=n, d=degree, graph_type="reg", seed=seed + n)
        ds = process_graphs([spec], DataConfig(max_nodes=n))
        g = ds.graphs[0]
        for k in k_values:
            t0 = time.perf_counter()
            _, cut, used = randomized_k_way_maxcut(
                g, k, iterations, seed=seed
            )
            dt = time.perf_counter() - t0
            results[(n, k)] = {
                "cut": cut,
                "time": dt,
                "iterations_used": used,
                "normalized_cut": cut / (n * degree / 2),
            }
            logger.info(
                "benchmark n=%d k=%d: cut=%.0f (%.3fs, %d iters)", n, k, cut, dt, used
            )
    return results


def test_fixed_terminals(
    g: Graph, k: int = 3, iterations: int = 1000, seed: int = 0
) -> Dict[str, Dict]:
    """Constrained-vs-free comparison (reference :283-342)."""
    out = {}
    for fixed in (True, False):
        t0 = time.perf_counter()
        asn, cut, used = randomized_k_way_maxcut(
            g, k, iterations, fixed_terminals=fixed, seed=seed
        )
        out["fixed" if fixed else "free"] = {
            "cut": cut,
            "time": time.perf_counter() - t0,
            "iterations_used": used,
            "terminals_ok": (
                bool(np.all(asn[:3] == np.arange(3))) if fixed else None
            ),
        }
    return out


def quick_demo(n: int = 500, d: int = 8, k: int = 3, seed: int = 0) -> Dict:
    """n=500 d=8 k=3 demo (reference :345-371)."""
    from gcn_maxcut.data.generate import generate_graph
    from gcn_maxcut.data.process import DataConfig, process_graphs

    spec = generate_graph(n=n, d=d, graph_type="reg", seed=seed)
    ds = process_graphs([spec], DataConfig(max_nodes=n))
    g = ds.graphs[0]
    asn, cut, used = randomized_k_way_maxcut(g, k, 1000, seed=seed)
    total_w = n * d / 2
    logger.info(
        "quick demo n=%d d=%d k=%d: cut %.0f / %d edges (%.1f%%), %d iters",
        n, d, k, cut, int(total_w), 100 * cut / total_w, used,
    )
    return {"cut": cut, "edges": total_w, "iterations_used": used}
