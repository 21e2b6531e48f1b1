#!/usr/bin/env python
"""Training-recipe sweep for the GCN+post vs randomized gate (VERDICT #2).

Round 2: GCN+post (200 samples, reference decode contract) beat the
10k-randomized baseline at only 1/5 sizes.  This sweeps recipe levers —
longer training, cosine lr, more training graphs, restarts — and reports
the per-size post-vs-randomized margins for each.  Decode semantics are
untouched (the reference contract); only the trained model changes.

Usage: python experiments/quality_sweep.py [variant ...]
Variants: base long cosine big restarts combo
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gcn_maxcut.bench.quality import run_quality_suite

VARIANTS = {
    "base": {},
    "long": {"train_kwargs": {"number_epochs": 3000, "patience": 100,
                              "tolerance": 0.0, "epochs_per_call": 25}},
    "cosine": {"train_kwargs": {"number_epochs": 2000, "patience": 100,
                                "tolerance": 0.0, "epochs_per_call": 25,
                                "lr_schedule": "cosine"}},
    "big": {"train_graphs_per_size": 8,
            "train_kwargs": {"number_epochs": 2000, "patience": 60,
                             "tolerance": 0.0, "epochs_per_call": 25}},
    "restarts": {"train_kwargs": {"number_epochs": 1500, "patience": 50,
                                  "tolerance": 0.0, "epochs_per_call": 25,
                                  "restarts": 3}},
    "combo": {"train_graphs_per_size": 8,
              "train_kwargs": {"number_epochs": 2000, "patience": 60,
                               "tolerance": 0.0, "epochs_per_call": 25,
                               "lr_schedule": "cosine", "restarts": 3}},
    # Entropy bonus: reward per-node entropy so the 200-rollout sampled
    # decode (best-of-N) gets variance to exploit (train/loop._graph_loss).
    "ent02": {"train_kwargs": {"entropy_weight": 0.2}},
    "ent05": {"train_kwargs": {"entropy_weight": 0.5}},
    "ent1": {"train_kwargs": {"entropy_weight": 1.0}},
    "ent2": {"train_kwargs": {"entropy_weight": 2.0}},
    "ent05_restarts": {"train_kwargs": {"entropy_weight": 0.5, "restarts": 3}},
    "ent04": {"train_kwargs": {"entropy_weight": 0.4}},
    "ent06": {"train_kwargs": {"entropy_weight": 0.6}},
    "ent07": {"train_kwargs": {"entropy_weight": 0.7}},
    "big_ent04": {"train_graphs_per_size": 8,
                  "train_kwargs": {"number_epochs": 2000, "patience": 60,
                                   "tolerance": 0.0, "epochs_per_call": 25,
                                   "entropy_weight": 0.4}},
    "big_ent06": {"train_graphs_per_size": 8,
                  "train_kwargs": {"number_epochs": 2000, "patience": 60,
                                   "tolerance": 0.0, "epochs_per_call": 25,
                                   "entropy_weight": 0.6}},
    "big16_ent05": {"train_graphs_per_size": 16,
                    "train_kwargs": {"number_epochs": 2000, "patience": 60,
                                     "tolerance": 0.0, "epochs_per_call": 25,
                                     "entropy_weight": 0.5}},
    "big16": {"train_graphs_per_size": 16,
              "train_kwargs": {"number_epochs": 2000, "patience": 60,
                               "tolerance": 0.0, "epochs_per_call": 25}},
    "big_ent02": {"train_graphs_per_size": 8,
                  "train_kwargs": {"number_epochs": 2000, "patience": 60,
                                   "tolerance": 0.0, "epochs_per_call": 25,
                                   "entropy_weight": 0.2}},
    "big_ent05": {"train_graphs_per_size": 8,
                  "train_kwargs": {"number_epochs": 2000, "patience": 60,
                                   "tolerance": 0.0, "epochs_per_call": 25,
                                   "entropy_weight": 0.5}},
    # Quantile loss: train directly on mean + c*std of the sampled decode
    # (objectives.quantile_cut_loss) — the best-of-200 objective itself.
    "quant": {"train_kwargs": {"loss_mode": "quantile"}},
    "quant_big": {"train_graphs_per_size": 8,
                  "train_kwargs": {"loss_mode": "quantile",
                                   "number_epochs": 2000, "patience": 60,
                                   "tolerance": 0.0, "epochs_per_call": 25}},
    "quant_big_restarts": {
        "train_graphs_per_size": 8,
        "train_kwargs": {"loss_mode": "quantile", "restarts": 3,
                         "number_epochs": 2000, "patience": 60,
                         "tolerance": 0.0, "epochs_per_call": 25}},
    "big16_ent05_restarts": {
        "train_graphs_per_size": 16,
        "train_kwargs": {"number_epochs": 2000, "patience": 60,
                         "tolerance": 0.0, "epochs_per_call": 25,
                         "entropy_weight": 0.5, "restarts": 3}},
}


def main():
    names = sys.argv[1:] or ["base", "long", "cosine"]
    results = {}
    for name in names:
        kw = VARIANTS[name]
        print(f"=== variant {name}: {kw}", flush=True)
        out = run_quality_suite(
            recipe="mixed", refine=False, measure_times=False, **kw
        )
        rows = []
        for s, v in out["per_size"].items():
            margin = v["post"] - v["randomized"]
            rows.append((s, v["post"], v["randomized"], margin))
            print(
                f"  size {s}: post {v['post']:.0f} vs rand "
                f"{v['randomized']:.0f}  margin {margin:+.0f}",
                flush=True,
            )
        wins = sum(1 for r in rows if r[3] >= 0)
        print(f"  -> {name}: wins {wins}/5, simple mean {out['simple_mean']:.1f}",
              flush=True)
        results[name] = {
            "wins": wins,
            "simple_mean": out["simple_mean"],
            "rows": rows,
        }
    print(json.dumps(results, indent=1, default=str), flush=True)


if __name__ == "__main__":
    main()
