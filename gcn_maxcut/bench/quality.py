"""Cut-quality suite: the reference's headline experiment, end to end.

Reproduces the committed post-processing run of
``neural_network_testing.ipynb`` (BASELINE.md §3): train a GCNSoftmax on
d-regular graphs, then evaluate fresh suites at sizes {50,100,200,300,500}
with simple (argmax), post-processed (200 sampling iterations), and refined
(greedy-flip) decoders, against the 10k-iteration randomized baseline.

Training recipes (``recipe=``):
  * ``"n500"``  — the reference's: 20 graphs n=500 d∈[6,8] (its committed
    model ``final_maxcut_3way_n500_d6_8_t300``).
  * ``"mixed"`` — same budget spread across the evaluation sizes (4 graphs
    per size).  The reference's own per-size ``_100/_200/_300`` series
    (``NeuralTestCode.py:517-558``) shows size-matched training matters;
    a single mixed-size model is the deployable version of that insight.
  * ``"per_size"`` — one model per evaluation size (the literal reference
    series).

Run: ``python -m gcn_maxcut bench --what quality`` or call
:func:`run_quality_suite` directly.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.baselines.randomized import randomized_k_way_maxcut
from gcn_maxcut.core.graph import pad_graph_batch
from gcn_maxcut.data.generate import generate_graph
from gcn_maxcut.data.process import DataConfig, process_graphs
from gcn_maxcut.eval.harness import test_single_graph
from gcn_maxcut.train.loop import train_model
from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)

SIZES = (50, 100, 200, 300, 500)


def _suite_specs(size: int, count: int, d_range=(6, 8), seed_base: int = 1000):
    """Fresh test graphs per size (reference seeds ``size*1000+i``,
    ``neural_network_testing.ipynb`` cell 8)."""
    rng = np.random.default_rng(size * seed_base)
    specs = []
    i = 0
    while len(specs) < count:
        d = int(rng.integers(d_range[0], d_range[1] + 1))
        if (size * d) % 2:
            i += 1
            continue
        specs.append(
            generate_graph(n=size, d=d, graph_type="reg", seed=size * 1000 + i)
        )
        i += 1
    return specs


def _train_specs(
    recipe: str, sizes=SIZES, d_range=(6, 8), seed: int = 1000,
    graphs_per_size: int = 4,
):
    rng = np.random.default_rng(seed)
    out: Dict[str, List] = {}
    if recipe == "n500":
        specs = []
        while len(specs) < 20:
            d = int(rng.integers(d_range[0], d_range[1] + 1))
            if (500 * d) % 2:
                continue
            specs.append(generate_graph(
                n=500, d=d, graph_type="reg", seed=seed + len(specs)
            ))
        out["all"] = specs
    elif recipe == "mixed":
        specs = []
        for s in sizes:
            for j in range(graphs_per_size):
                d = int(rng.integers(d_range[0], d_range[1] + 1))
                if (s * d) % 2:
                    d += 1
                specs.append(generate_graph(
                    n=s, d=d, graph_type="reg", seed=seed + 37 * s + j
                ))
        out["all"] = specs
    elif recipe == "per_size":
        for s in sizes:
            specs = []
            for j in range(10):
                d = int(rng.integers(d_range[0], d_range[1] + 1))
                if (s * d) % 2:
                    d += 1
                specs.append(generate_graph(
                    n=s, d=d, graph_type="reg", seed=seed + 37 * s + j
                ))
            out[str(s)] = specs
    else:
        raise ValueError(f"unknown recipe {recipe!r}")
    return out


def _train(specs, max_nodes: int, restarts: int = 1, **cfg_kwargs) -> Any:
    """Train; with ``restarts > 1``, train that many independently-seeded
    models and keep the one with the best (lowest) training loss — a
    deployable recipe lever (selection uses only training information)."""
    ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    base_seed = cfg_kwargs.pop("seed", 0)
    t0 = time.perf_counter()
    import math

    best_params, best_loss = None, float("inf")
    last_params = None
    for r in range(max(1, restarts)):
        cfg = TrainingConfig(n_nodes=max_nodes, seed=base_seed + r, **cfg_kwargs)
        params, best, epoch, _, hist = train_model(batch, cfg)
        logger.info(
            "restart %d: trained %d graphs, best %.0f at epoch %d (%.1fs cum)",
            r, len(specs), best, epoch, time.perf_counter() - t0,
        )
        last_params = params
        # NaN < inf is False, so an all-NaN sweep would otherwise return
        # None and crash far from the cause — guard on finiteness.
        if math.isfinite(best) and best < best_loss:
            best_params, best_loss = params, best
    if best_params is None:
        logger.warning(
            "_train: no restart reached a finite best loss (%d restarts); "
            "falling back to the last restart's params", max(1, restarts),
        )
        best_params = last_params
    return best_params


def run_quality_suite(
    recipe: str = "mixed",
    sizes=SIZES,
    graphs_per_size: int = 6,
    post_iterations: int = 200,
    randomized_iterations: int = 10_000,
    refine: bool = True,
    max_nodes: int = 1000,
    train_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 1000,
    measure_times: bool = True,
    train_graphs_per_size: int = 4,
) -> Dict[str, Any]:
    """Train (per ``recipe``) and evaluate the per-size suites.

    Returns per-size means for simple/post/refined decodes and the
    randomized baseline, plus the pass/fail of the two quality gates:
    GCN+post ≥ randomized at every size, and simple-decode mean ≥ the
    reference's 547.1 (``BASELINE.md`` §3).
    """
    tk = {
        "learning_rate": 1e-3,
        "number_epochs": 1000,
        "tolerance": 1e-4,
        "patience": 20,
        "epochs_per_call": 10,
        **(train_kwargs or {}),
    }
    restarts = int(tk.pop("restarts", 1))
    models: Dict[str, Any] = {}
    for name, specs in _train_specs(
        recipe, sizes, seed=seed, graphs_per_size=train_graphs_per_size
    ).items():
        models[name] = _train(specs, max_nodes, restarts=restarts, **tk)

    per_size: Dict[int, Dict[str, float]] = {}
    for s in sizes:
        specs = _suite_specs(s, graphs_per_size)
        ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
        params = models.get(str(s), models.get("all"))
        simple, post, refined, rand, post_t, refine_t = [], [], [], [], [], []
        refined_rand = []
        for idx in sorted(ds.graphs):
            g = ds.graphs[idx]
            res = test_single_graph(
                params, g, jax.random.PRNGKey(9000 + s + idx),
                post_processing_iterations=post_iterations,
                refine=refine,
                measure_times=measure_times,
            )
            if not res["success"]:
                logger.info("graph %d/%d failed: %s", s, idx, res["error"])
                continue
            simple.append(res["simple_cut"])
            post.append(res["post_cut"])
            post_t.append(res["post_time"])
            if refine:
                refined.append(res["refined_cut"])
                refine_t.append(res["refined_time"])
            ra, rc, _ = randomized_k_way_maxcut(
                g, k=3, max_iterations=randomized_iterations,
                patience=randomized_iterations, seed=7000 + idx,
            )
            rand.append(rc)
            if refine:
                # attribution ablation: the same multi-start greedy-flip
                # decoder applied to the randomized arm's starts (its
                # best-of-10k assignment + uniform restarts) — isolates
                # the GCN's contribution from the local search's
                from gcn_maxcut.baselines.local_search import (
                    greedy_flip_local_search,
                )

                ra_pad = np.zeros(g.n_pad, np.int32)
                ra_pad[: ra.shape[0]] = ra
                rng_np = np.random.default_rng(8000 + s + idx)
                starts_np = [ra_pad]
                for _ in range(3):
                    u = rng_np.integers(0, 3, g.n_pad).astype(np.int32)
                    u[:3] = [0, 1, 2]
                    starts_np.append(u)
                _, rcuts = jax.vmap(
                    lambda a: greedy_flip_local_search(g, a)
                )(jnp.asarray(np.stack(starts_np)))
                refined_rand.append(float(rcuts.max()))
        per_size[s] = {
            "simple": float(np.mean(simple)),
            "post": float(np.mean(post)),
            "refined": float(np.mean(refined)) if refined else None,
            "randomized": float(np.mean(rand)),
            "refined_random": (
                float(np.mean(refined_rand)) if refined_rand else None
            ),
            "post_time_s": float(np.mean(post_t)),
            "refine_time_s": float(np.mean(refine_t)) if refine_t else None,
            "graphs": len(simple),
        }
        logger.info(
            "size %d: simple %.0f | post %.0f | refined %s | randomized %.0f"
            " | refined-random %s",
            s, per_size[s]["simple"], per_size[s]["post"],
            f"{per_size[s]['refined']:.0f}" if refine else "-",
            per_size[s]["randomized"],
            f"{per_size[s]['refined_random']:.0f}" if refined_rand else "-",
        )

    simple_mean = float(np.mean([v["simple"] for v in per_size.values()]))
    post_beats = all(
        (v["refined"] if refine and v["refined"] is not None else v["post"])
        >= v["randomized"]
        for v in per_size.values()
    )
    post_beats_sizes = sum(
        1 for v in per_size.values() if v["post"] >= v["randomized"]
    )
    refined_vs_refined_random = (
        all(
            v["refined"] >= v["refined_random"]
            for v in per_size.values()
            if v["refined"] is not None and v["refined_random"] is not None
        )
        if refine else None
    )
    result = {
        "recipe": recipe,
        "per_size": per_size,
        "simple_mean": simple_mean,
        "reference_simple_mean": 547.1,
        "default_decode_beats_randomized_all_sizes": bool(post_beats),
        "gcn_post_beats_randomized_sizes": post_beats_sizes,
        # attribution: same flip budget from a random start vs the GCN start
        "refined_gcn_beats_refined_random_all_sizes": refined_vs_refined_random,
        "refine_default": refine,
        "timing_method": (
            "scan_timeit amortized in-jit" if measure_times else "skipped"
        ),
    }
    logger.info(
        "suite done: simple mean %.1f (ref 547.1), default decode beats "
        "randomized at all sizes: %s; GCN+post beats randomized at %d/%d "
        "sizes; refined-GCN >= refined-random at all sizes: %s",
        simple_mean, post_beats, post_beats_sizes, len(per_size),
        refined_vs_refined_random,
    )
    return result


if __name__ == "__main__":
    import sys

    recipe = sys.argv[1] if len(sys.argv) > 1 else "mixed"
    out = run_quality_suite(recipe=recipe)
    print(json.dumps(out, indent=2))
