"""VERDICT r4 #2: put a classical-baseline column on every at-scale
quality table.

The reference never publishes a GCN number without a solver/randomized
number beside it (``/root/reference/python/CPLEX/CplexCode.py:375-421``,
``NeuralTestCode.py:428-758``); our n<=500 suites honor that, but the
n=100k k-way sweep and the 10M-node giant run had only the uniform-random
floor.  This experiment anchors both tables with the scalable classical
baseline — the native first-improvement sweep local search
(``native/graphtools.cpp::gt_greedy_sweep``, O(E) per sweep) — in the
same three-column shape as PARITY §1's attribution ablation:

  * ``gcn``              the trained model's decoded cut (as published)
  * ``gcn_sweep``        sweep refinement STARTED from the GCN decode
  * ``random_sweep``     the same sweep budget from a random assignment
                         (the classical baseline / attribution control)
  * ``random_sweep_b8``  best of 8 random-init sweeps (a stronger
                         time-boxed classical anchor)

Single-move SA / best-improvement greedy (the n<=500 baselines) are O(E)
PER MOVE — physically infeasible at 100k+ nodes (1 move = 1 full edge
pass); the sweep search is the scalable classical analog, and it is a
STRONGER baseline than either at these sizes.

Run:  python experiments/scale_baselines.py [kway|giant|both]
Writes docs/scale_baselines_r5.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gcn_maxcut.utils.cache import enable_compilation_cache

enable_compilation_cache()

RESULTS = "/root/repo/docs/scale_baselines_r5.json"


def _load_results():
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            return json.load(f)
    return {}


def _save_results(res):
    with open(RESULTS, "w") as f:
        json.dump(res, f, indent=2)


def _sweep(edges, n, init, k, seed_note, max_sweeps=100):
    from gcn_maxcut.native.bindings import greedy_sweep_native

    t0 = time.perf_counter()
    out = greedy_sweep_native(edges, n, init, k=k, num_fixed=k,
                              max_sweeps=max_sweeps)
    assert out is not None, "native toolkit required for scale baselines"
    asn, cut, sweeps = out
    return {
        "cut": cut,
        "sweeps": sweeps,
        "time_s": time.perf_counter() - t0,
        "init": seed_note,
    }, asn


def _random_init(n, k, seed):
    rng = np.random.default_rng(seed)
    init = rng.integers(0, k, n).astype(np.int64)
    init[:k] = np.arange(k)
    return init


def run_kway():
    """Baseline columns for the n=100k d=8 k=3..8 sweep (PARITY §5)."""
    from gcn_maxcut.data.generate import random_regular_edges
    from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph

    n, d, seed = 100_000, 8, 0
    edges = random_regular_edges(n, d, seed=seed)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    e_total = edges.shape[0]

    res = _load_results()
    rows = res.setdefault("kway", {})
    for k in (3, 4, 5, 6, 7, 8):
        key = str(k)
        if key in rows:
            continue
        cfg = GiantConfig(
            num_classes=k, dim_embedding=128, hidden_dim=64,
            number_epochs=60, epochs_per_call=10, seed=seed,
            log_every=20,
        )
        out = train_giant_graph(src, dst, n, cfg, return_assignment=True)
        gcn_asn = np.asarray(out["assignment"], dtype=np.int64)
        # the trainer pins shard-local rows 0..k-1 as terminals; map the
        # sweep's fixed ids to match is unnecessary — terminals are k
        # arbitrary distinct nodes, and the sweep never moves ids < k
        gs, _ = _sweep(edges, n, gcn_asn, k, "gcn")
        r1, _ = _sweep(edges, n, _random_init(n, k, 100 + k), k, "random")
        best = None
        t0 = time.perf_counter()
        for rs in range(8):
            rb, _ = _sweep(edges, n, _random_init(n, k, 1000 + 10 * k + rs),
                           k, f"random{rs}")
            if best is None or rb["cut"] > best["cut"]:
                best = rb
        best["time_s"] = time.perf_counter() - t0
        rows[key] = {
            "n": n, "d": d, "e_total": e_total, "k": k,
            "gcn_cut": out["final_cut"],
            "gcn_frac": out["final_cut"] / e_total,
            "gcn_sweep_cut": gs["cut"],
            "gcn_sweep_frac": gs["cut"] / e_total,
            "gcn_sweep_time_s": gs["time_s"],
            "random_sweep_cut": r1["cut"],
            "random_sweep_frac": r1["cut"] / e_total,
            "random_sweep_time_s": r1["time_s"],
            "random_sweep_b8_cut": best["cut"],
            "random_sweep_b8_frac": best["cut"] / e_total,
            "random_sweep_b8_time_s": best["time_s"],
            "random_floor": (k - 1) / k,
        }
        print(json.dumps(rows[key]), flush=True)
        _save_results(res)


def run_giant():
    """Baseline columns for the 10,002,432-node banded run (PARITY §4)."""
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    n, d, k = 10_002_432, 8, 3
    res = _load_results()
    if "giant" in res:
        return
    out = train_banded_giant_packed(
        n=n, epochs=40, return_assignment=True
    )
    offsets = out["offsets"]
    gcn_asn = np.asarray(out["assignment"], dtype=np.int64)
    # rebuild the circulant edge list (u, (u+o) mod n) for o>0 half
    pos = [o for o in offsets if o > 0]
    src = np.concatenate([np.arange(n, dtype=np.int64) for _ in pos])
    dst = np.concatenate(
        [(np.arange(n, dtype=np.int64) + o) % n for o in pos]
    )
    edges = np.stack([src, dst], axis=1)
    e_total = edges.shape[0]
    # verify the decoded assignment reproduces the trainer's cut
    gcn_cut_check = float((gcn_asn[src] != gcn_asn[dst]).sum())
    gs, _ = _sweep(edges, n, gcn_asn, k, "gcn", max_sweeps=60)
    r1, _ = _sweep(edges, n, _random_init(n, k, 7), k, "random",
                   max_sweeps=60)
    res["giant"] = {
        "n": n, "d": d, "k": k, "e_total": e_total,
        "gcn_cut": out["final_cut"],
        "gcn_frac": out["final_cut"] / e_total,
        "gcn_cut_decoded_check": gcn_cut_check,
        "gcn_sweep_cut": gs["cut"],
        "gcn_sweep_frac": gs["cut"] / e_total,
        "gcn_sweep_time_s": gs["time_s"],
        "gcn_sweep_sweeps": gs["sweeps"],
        "random_sweep_cut": r1["cut"],
        "random_sweep_frac": r1["cut"] / e_total,
        "random_sweep_time_s": r1["time_s"],
        "random_sweep_sweeps": r1["sweeps"],
        "random_floor": (k - 1) / k,
        "epoch_time_s": out["epoch_time_s"],
    }
    print(json.dumps(res["giant"]), flush=True)
    _save_results(res)


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "both"
    if what in ("kway", "both"):
        run_kway()
    if what in ("giant", "both"):
        run_giant()


if __name__ == "__main__":
    main()
