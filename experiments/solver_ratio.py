#!/usr/bin/env python
"""Refresh PARITY §2's refined-vs-solver table: the default (multi-start)
decoder against the 20 s anytime SA solver, per size.

Usage: python experiments/solver_ratio.py [out.json] [time_limit]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from gcn_maxcut.baselines.exact import anytime_solver
from gcn_maxcut.bench.quality import _suite_specs, _train, _train_specs
from gcn_maxcut.core.graph import dense_adjacency
from gcn_maxcut.data.process import DataConfig, process_graphs
from gcn_maxcut.eval.decode import refine_multi_start
from gcn_maxcut.models.gcn import gcn_softmax_apply
from gcn_maxcut.utils.cache import enable_compilation_cache


def main():
    enable_compilation_cache()
    out_path = sys.argv[1] if len(sys.argv) > 1 else "docs/solver_ratio_r4.json"
    time_limit = float(sys.argv[2]) if len(sys.argv) > 2 else 20.0
    params = _train(_train_specs("mixed")["all"], 1000)
    rows = {}
    for s in (50, 100, 200, 300, 500):
        specs = _suite_specs(s, 6)
        ds = process_graphs(specs, DataConfig(max_nodes=1000))
        refined, solver = [], []
        for idx in sorted(ds.graphs):
            g = ds.graphs[idx]
            probs = gcn_softmax_apply(params, g, dense_adjacency(g, width=1000))
            _, rc_ = refine_multi_start(
                g, probs, jax.random.PRNGKey(9000 + s + idx), 200, 4
            )
            refined.append(float(rc_))
            solver.append(
                float(anytime_solver(g, time_limit=time_limit)["cut_value"])
            )
        rows[s] = {
            "refined": float(np.mean(refined)),
            "solver": float(np.mean(solver)),
            "ratio": float(np.mean(refined) / np.mean(solver)),
        }
        print(
            f"n={s}: refined {rows[s]['refined']:.0f} vs solver({time_limit:.0f}s) "
            f"{rows[s]['solver']:.0f} -> {100 * rows[s]['ratio']:.1f}%",
            flush=True,
        )
    with open(out_path, "w") as f:
        json.dump({"time_limit_s": time_limit, "per_size": rows}, f, indent=2)
    print(f"[ratio] wrote {out_path}")


if __name__ == "__main__":
    main()
