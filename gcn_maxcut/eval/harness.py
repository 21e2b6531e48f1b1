"""Evaluation harness: per-graph tests, size-bucketed sweeps, analysis, reports.

Field-for-field parity with the reference's evaluation stack
(``Testing/TestingNeuralNetwork.py``): ``test_single_graph`` (:124-186),
``test_multiple_graphs`` (:188-295), ``analyze_results`` (:297-382),
``print_analysis_report`` (:384-428), ``generate_summary_report``
(:566-639), ``save_results`` (:539-564) — same result-dict keys, so existing
downstream tooling semantics carry over.  The compute is on-device: one jit
per (n_pad, e_pad) signature for the forward + argmax decode + vmapped
sampling post-processor.
"""

from __future__ import annotations

import functools
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.core.graph import Graph, dense_adjacency
from gcn_maxcut.data.process import ProcessedDataset
from gcn_maxcut.eval.decode import post_process_jit, simple_assignment
from gcn_maxcut.models.gcn import gcn_softmax_apply
from gcn_maxcut.objectives.cut_loss import hard_cut_value
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


@functools.partial(jax.jit, static_argnames=("aggregation",))
def _forward(params, g: Graph, aggregation: str = "auto"):
    from gcn_maxcut.train.loop import _resolve_dense_aggregation

    x = dense_adjacency(g, width=params["conv1"]["w"].shape[0])
    # dense aggregation for small padded graphs — literally the same
    # rule as training (``aggregation`` overrides, e.g. "sparse" to rule
    # out 1e-5-level dense/sparse drift when comparing decoders)
    a = (dense_adjacency(g, values="mask")
         if _resolve_dense_aggregation(aggregation, g.n_pad) else None)
    return gcn_softmax_apply(
        {"conv1": params["conv1"], "conv2": params["conv2"]}, g, x, a_dense=a
    )


@jax.jit
def _decode_simple(g: Graph, probs):
    asn = simple_assignment(probs)
    return asn, hard_cut_value(g, asn)


def _stage_time(stage_cut_fn, probs, k_hi: int = 24, k_lo: int = 6) -> float:
    """Amortized in-jit timing of a probs -> cut decode stage.

    Per-stage timings chain K copies of the stage inside one jit via
    ``utils.timing.scan_timeit`` and difference two K values, which cancels
    dispatch overhead; the ``probs + 0·cut`` carry defeats CSE between the
    copies.
    """
    from gcn_maxcut.utils.timing import scan_timeit

    def op(p):
        return p + 0.0 * stage_cut_fn(p)

    return scan_timeit(op, probs, k_hi=k_hi, k_lo=k_lo, reps=2)


def test_single_graph(
    params: Any,
    g: Graph,
    key: jax.Array,
    post_processing_iterations: int = 200,
    terminals: Optional[List[int]] = None,
    refine: bool = False,
    measure_times: bool = True,
    refine_starts: int = 4,
) -> Dict[str, Any]:
    """Simple (argmax) and post-processed decode with timings.

    Returns the reference's result-dict contract
    (``TestingNeuralNetwork.py:164-178``): success/nodes/edges/simple_cut/
    simple_time/simple_assignment/post_cut/post_time/post_assignment/
    improvement/improvement_percent/terminals/node_probabilities.

    ``refine=True`` adds the hybrid decoder: greedy flips from the top
    ``refine_starts - 1`` sampled assignments plus the argmax decode,
    climbed in lockstep by one vmapped while_loop
    (``decode.refine_multi_start``; measured +0.2-0.7% cut over the
    single-start climb for ~2x wall time at these sizes).
    ``refine_starts=1`` recovers the single-start climb from the
    post-processed best.

    Timings use the amortized in-jit method (``utils.timing.scan_timeit``).
    ``measure_times=False`` skips the timing chains (the cut values are
    computed either way) and reports 0.0.
    """
    try:
        probs = _forward(params, g)

        simple_asn, simple_cut = _decode_simple(g, probs)
        simple_time = (
            _stage_time(lambda p: _decode_simple(g, p)[1], probs)
            if measure_times else 0.0
        )

        post_asn, post_cut = post_process_jit(
            g, probs, key, iterations=post_processing_iterations
        )
        post_time = (
            _stage_time(
                lambda p: post_process_jit(
                    g, p, key, iterations=post_processing_iterations
                )[1],
                probs,
            )
            if measure_times else 0.0
        )

        refined: Dict[str, Any] = {}
        if refine and refine_starts > 1:
            from gcn_maxcut.eval.decode import refine_multi_start

            ref_asn, ref_cut = refine_multi_start(
                g, probs, key, post_processing_iterations, refine_starts
            )

            def _refine_cut(p):
                return refine_multi_start(
                    g, p, key, post_processing_iterations, refine_starts
                )[1]

        elif refine:
            from gcn_maxcut.eval.decode import refine_with_local_search

            ref_asn, ref_cut = refine_with_local_search(g, post_asn)

            def _refine_cut(p):
                # re-derive the refine input from p so the chained copies
                # depend on the carry (identical work each iteration)
                asn = post_asn + (p.ravel()[0] * 0.0).astype(post_asn.dtype)
                return refine_with_local_search(g, asn)[1]

        if refine:
            refined = {
                "refined_cut": float(ref_cut),
                "refined_time": (
                    _stage_time(_refine_cut, probs, k_hi=12, k_lo=3)
                    if measure_times else 0.0
                ),
                "refined_assignment": np.asarray(ref_asn)[: int(g.n_nodes)],
            }

        simple_cut = float(simple_cut)
        post_cut = float(post_cut)
        improvement = post_cut - simple_cut
        return refined | {
            "success": True,
            "nodes": int(g.n_nodes),
            "edges": int(g.n_edges) // 2,
            "simple_cut": simple_cut,
            "simple_time": simple_time,
            "simple_assignment": np.asarray(simple_asn)[: int(g.n_nodes)],
            "post_cut": post_cut,
            "post_time": post_time,
            "post_assignment": np.asarray(post_asn)[: int(g.n_nodes)],
            "improvement": improvement,
            "improvement_percent": (
                improvement / simple_cut * 100 if simple_cut > 0 else 0.0
            ),
            "terminals": terminals if terminals is not None else [0, 1, 2],
            "node_probabilities": np.asarray(probs)[: int(g.n_nodes)],
        }
    except Exception as e:  # per-graph error capture, reference :180-186
        return {
            "success": False,
            "error": str(e),
            "nodes": int(g.n_nodes),
            "edges": int(g.n_edges) // 2,
        }


def test_multiple_graphs(
    params: Any,
    dataset: ProcessedDataset,
    graph_sizes: List[int],
    post_processing_iterations: int = 200,
    verbose: bool = True,
    seed: int = 0,
    size_tolerance: int = 5,
    refine: bool = False,
    measure_times: bool = True,
    refine_starts: int = 4,
) -> Tuple[List[Dict], Dict]:
    """Sweep the dataset, bucketing results by nearest configured size.

    Reference ``test_multiple_graphs`` (:188-295) incl. the ±tolerance
    nearest-size matching for integer keys (:242-245) and skip-if-unmatched.
    """
    results_by_size: Dict[int, Dict] = {
        size: {
            "simple": {"cut_values": [], "times": []},
            "post_processed": {"cut_values": [], "times": []},
        }
        for size in graph_sizes
    }
    test_results: List[Dict] = []
    rng = jax.random.PRNGKey(seed)

    items = sorted(dataset.graphs.items())
    for count, (key_idx, g) in enumerate(items, 1):
        n = int(g.n_nodes)
        closest = min(graph_sizes, key=lambda s: abs(s - n))
        graph_size = closest if abs(closest - n) <= size_tolerance else n
        if graph_size not in graph_sizes:
            if verbose:
                logger.info("skipping graph %s: size %d not configured", key_idx, n)
            continue

        rng, sub = jax.random.split(rng)
        result = test_single_graph(
            params,
            g,
            sub,
            post_processing_iterations,
            terminals=dataset.specs[key_idx].terminals,
            refine=refine,
            measure_times=measure_times,
            refine_starts=refine_starts,
        )
        if result["success"]:
            result.update({"graph_name": f"graph_{key_idx}", "graph_size": graph_size})
            test_results.append(result)
            bucket = results_by_size[graph_size]
            bucket["simple"]["cut_values"].append(result["simple_cut"])
            bucket["simple"]["times"].append(result["simple_time"])
            bucket["post_processed"]["cut_values"].append(result["post_cut"])
            bucket["post_processed"]["times"].append(result["post_time"])
            if verbose:
                logger.info(
                    "graph %d/%d n=%d: simple=%.0f (%.4fs) post=%.0f (%.4fs) %+.1f%%",
                    count,
                    len(items),
                    n,
                    result["simple_cut"],
                    result["simple_time"],
                    result["post_cut"],
                    result["post_time"],
                    result["improvement_percent"],
                )
        elif verbose:
            logger.warning("graph %s failed: %s", key_idx, result["error"])

    return test_results, results_by_size


def analyze_results(
    test_results: List[Dict], results_by_size: Dict, graph_sizes: List[int]
) -> Dict[str, Any]:
    """Statistics with the reference's exact output fields (:297-382)."""
    if not test_results:
        return {"error": "No test results available"}

    simple_cuts = [r["simple_cut"] for r in test_results]
    post_cuts = [r["post_cut"] for r in test_results]
    improvements = [r["improvement"] for r in test_results]
    improvement_pcts = [r["improvement_percent"] for r in test_results]
    simple_times = [r["simple_time"] for r in test_results]
    post_times = [r["post_time"] for r in test_results]

    better = sum(1 for i in improvements if i > 0)
    same = sum(1 for i in improvements if i == 0)
    worse = sum(1 for i in improvements if i < 0)
    avg_simple_time = float(np.mean(simple_times))
    avg_post_time = float(np.mean(post_times))

    size_analysis = {}
    for size in sorted(graph_sizes):
        bucket = results_by_size.get(size)
        if not bucket or not bucket["simple"]["cut_values"]:
            continue
        s_vals = bucket["simple"]["cut_values"]
        p_vals = bucket["post_processed"]["cut_values"]
        s_t = bucket["simple"]["times"]
        p_t = bucket["post_processed"]["times"]
        s_avg, p_avg = float(np.mean(s_vals)), float(np.mean(p_vals))
        s_t_avg, p_t_avg = float(np.mean(s_t)), float(np.mean(p_t))
        size_analysis[size] = {
            "count": len(s_vals),
            "simple_avg": s_avg,
            "post_avg": p_avg,
            "improvement_avg": p_avg - s_avg,
            "improvement_pct": (p_avg - s_avg) / s_avg * 100 if s_avg > 0 else 0.0,
            "simple_time_avg": s_t_avg,
            "post_time_avg": p_t_avg,
            "time_ratio": p_t_avg / s_t_avg if s_t_avg > 0 else 0.0,
        }

    total = len(test_results)
    return {
        "total_tests": total,
        "avg_simple_cut": float(np.mean(simple_cuts)),
        "avg_post_cut": float(np.mean(post_cuts)),
        "avg_improvement": float(np.mean(improvements)),
        "avg_improvement_pct": float(np.mean(improvement_pcts)),
        "std_improvement": float(np.std(improvements)),
        "better_count": better,
        "same_count": same,
        "worse_count": worse,
        "avg_simple_time": avg_simple_time,
        "avg_post_time": avg_post_time,
        "avg_overhead": avg_post_time / avg_simple_time if avg_simple_time > 0 else 0.0,
        "size_analysis": size_analysis,
        "improvement_rate": better / total,
    }


def print_analysis_report(analysis: Dict[str, Any], graph_sizes: List[int]) -> str:
    """Text report, reference layout (:384-428); returns (and prints) it."""
    if "error" in analysis:
        text = f"Analysis Error: {analysis['error']}"
        print(text)
        return text

    t = analysis["total_tests"]
    lines = [
        "Performance Analysis",
        "=" * 60,
        f"Overall Results ({t} graphs):",
        "",
        "Cut Value Performance:",
        f"  Simple GCN Average:     {analysis['avg_simple_cut']:.2f}",
        f"  Post-processed Average: {analysis['avg_post_cut']:.2f}",
        f"  Average Improvement:    {analysis['avg_improvement']:+.2f} "
        f"({analysis['avg_improvement_pct']:+.1f}%)",
        f"  Std Dev Improvement:    {analysis['std_improvement']:.2f}",
        "",
        "Improvement Distribution:",
        f"  Post-processing better: {analysis['better_count']}/{t} "
        f"({analysis['improvement_rate'] * 100:.1f}%)",
        f"  Same performance:       {analysis['same_count']}/{t} "
        f"({analysis['same_count'] / t * 100:.1f}%)",
        f"  Post-processing worse:  {analysis['worse_count']}/{t} "
        f"({analysis['worse_count'] / t * 100:.1f}%)",
        "",
        "Runtime Performance:",
        f"  Simple GCN Average:     {analysis['avg_simple_time']:.4f}s",
        f"  Post-processed Average: {analysis['avg_post_time']:.4f}s",
        f"  Runtime Overhead:       {analysis['avg_overhead']:.1f}x",
        "",
        "=" * 60,
        "Results by Graph Size:",
        f"{'Size':<6} {'Count':<6} {'Simple':<8} {'Post':<8} "
        f"{'Improvement':<12} {'Runtime':<10}",
        f"{'-' * 6} {'-' * 6} {'-' * 8} {'-' * 8} {'-' * 12} {'-' * 10}",
    ]
    for size in sorted(graph_sizes):
        sa = analysis["size_analysis"].get(size)
        if sa:
            lines.append(
                f"{size:<6} {sa['count']:<6} {sa['simple_avg']:<8.1f} "
                f"{sa['post_avg']:<8.1f} {sa['improvement_pct']:<+7.1f}%     "
                f"{sa['time_ratio']:<6.1f}x"
            )
    text = "\n".join(lines)
    print(text)
    return text


def generate_summary_report(
    analysis: Dict[str, Any],
    testing_config: Dict[str, Any],
    model_config: Optional[Dict[str, Any]] = None,
) -> str:
    """Markdown summary with recommendation thresholds.

    Reference ``generate_summary_report`` (:566-639): recommendation logic
    ≥70% improvement rate and ≤2× overhead.
    """
    rate = analysis.get("improvement_rate", 0.0)
    overhead = analysis.get("avg_overhead", 0.0)
    if rate >= 0.7 and overhead <= 2.0:
        rec = "RECOMMENDED: post-processing improves most graphs at low cost."
    elif rate >= 0.7:
        rec = (
            "CONDITIONAL: post-processing improves most graphs but costs "
            f"{overhead:.1f}x runtime; use when quality matters more than latency."
        )
    else:
        rec = "NOT RECOMMENDED: post-processing rarely improves results."
    lines = [
        "# Neural Network Testing Summary",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
        "## Testing Configuration",
        "```json",
        json.dumps(testing_config, indent=2, default=str),
        "```",
        "",
        "## Results",
        f"- Graphs tested: {analysis.get('total_tests', 0)}",
        f"- Avg simple cut: {analysis.get('avg_simple_cut', 0):.2f}",
        f"- Avg post-processed cut: {analysis.get('avg_post_cut', 0):.2f}",
        f"- Avg improvement: {analysis.get('avg_improvement_pct', 0):+.1f}%",
        f"- Improvement rate: {rate * 100:.1f}%",
        f"- Runtime overhead: {overhead:.1f}x",
        "",
        "## Recommendation",
        rec,
    ]
    if model_config:
        lines += ["", "## Model Configuration", "```json",
                  json.dumps(model_config, indent=2, default=str), "```"]
    return "\n".join(lines)


def save_results(
    path: str | Path,
    test_results: List[Dict],
    results_by_size: Dict,
    analysis: Dict,
    testing_config: Dict,
    model_config: Optional[Dict] = None,
) -> Path:
    """Results package as JSON (+npz for arrays), reference :539-564 contract."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def clean(obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        if isinstance(obj, dict):
            return {str(k): clean(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [clean(v) for v in obj]
        return obj

    package = {
        "individual_results": clean(
            [
                {k: v for k, v in r.items() if k != "node_probabilities"}
                for r in test_results
            ]
        ),
        "results_by_size": clean(results_by_size),
        "analysis": clean(analysis),
        "testing_config": clean(testing_config),
        "model_config": clean(model_config or {}),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    path.write_text(json.dumps(package, indent=2, default=str))
    return path


def load_results(path: str | Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
