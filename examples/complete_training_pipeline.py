"""The reference's flagship `complete_training_pipeline.ipynb` as a
LIBRARY-API walkthrough — every stage through the public Python API the
README advertises, cell by cell (reference §2.8; 35 cells):

  1. generate d-regular graphs with 3 terminals   (data.generate_graph)
  2. tensorize + terminal normalization + padding (data.process_graphs)
  3. train GCNSoftmax on the cut loss             (train.train_model)
  4. checkpoint the trained model                 (train.save_checkpoint)
  5. evaluate held-out graphs: argmax / 200-rollout post-processing /
     greedy-flip refinement                       (eval.test_single_graph)
  6. randomized baseline comparison               (baselines.randomized)
  7. analysis report + summary                    (eval.analyze_results)
  8. loss-curve + comparison charts               (viz, when matplotlib)

Run (CPU ok; pass --quick for a ~1-minute toy run):

    python examples/complete_training_pipeline.py [workdir] [--quick]

The one-command equivalent of this file is the CLI pipeline:

    python -m gcn_maxcut pipeline --workdir out --num-graphs 20 \
        --nodes 500 --min-degree 6 --max-degree 8 --pad-to 1000 \
        --epochs 1000 --seed 1000
"""

import os
import sys

import jax
import numpy as np


def main(workdir: str = "pipeline_out", quick: bool = False) -> int:
    os.makedirs(workdir, exist_ok=True)

    # --- cell 1-4: generation (reference seeds 1000+i, d in [6, 8]) -----
    from gcn_maxcut.data import DataConfig, generate_graph, process_graphs

    n, pad, num_train, epochs = (
        (60, 64, 6, 120) if quick else (500, 1000, 20, 1000)
    )
    rng = np.random.default_rng(1000)
    train_specs = []
    while len(train_specs) < num_train:
        d = int(rng.integers(6, 9))
        if (n * d) % 2:           # parity: n*d must be even for d-regular
            continue
        train_specs.append(
            generate_graph(
                n=n, d=d, graph_type="reg", seed=1000 + len(train_specs)
            )
        )
    print(f"generated {len(train_specs)} training graphs (n={n})")

    # --- cell 5-8: processing (terminals -> ids 0..2, adjacency-as-
    # features via the padded rectangular quirk, stacked batch) ----------
    from gcn_maxcut.core import pad_graph_batch

    ds = process_graphs(train_specs, DataConfig(max_nodes=pad))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    print(f"processed to n_pad={batch.n_pad}, batch of {len(ds.graphs)}")

    # --- cell 9-14: training (lr 1e-3, tolerance 1e-4, patience 20 — the
    # reference recipe; epochs_per_call scans epochs inside one jit) -----
    from gcn_maxcut.train import (
        TrainingConfig,
        save_checkpoint,
        train_model,
    )

    cfg = TrainingConfig(
        n_nodes=pad,
        learning_rate=1e-3,
        number_epochs=epochs,
        tolerance=1e-4,
        patience=20,
        epochs_per_call=10,
    )
    params, best_loss, final_epoch, _, history = train_model(batch, cfg)
    print(
        f"trained to best loss {best_loss:.0f} at epoch {final_epoch} "
        f"({len(history)} epochs recorded)"
    )
    ckpt = save_checkpoint(
        os.path.join(workdir, "final_maxcut3way"),
        params=params, config=cfg, epoch=final_epoch, loss_history=history,
    )
    print(f"checkpoint -> {ckpt}")

    # --- cell 15-24: held-out evaluation (argmax + 200-rollout post +
    # greedy-flip refinement per graph, bucketed by size) ----------------
    from gcn_maxcut.baselines import randomized_k_way_maxcut
    from gcn_maxcut.eval import (
        analyze_results,
        generate_summary_report,
        print_analysis_report,
        save_results,
        test_multiple_graphs,
    )

    test_specs = [
        generate_graph(n=n, d=6, graph_type="reg", seed=9000 + i)
        for i in range(3 if quick else 6)
    ]
    test_ds = process_graphs(test_specs, DataConfig(max_nodes=pad))
    results, results_by_size = test_multiple_graphs(
        params, test_ds, graph_sizes=[n],
        post_processing_iterations=200,
        refine=True,                # greedy-flip refinement (default decode)
        seed=42,
    )
    # cell 22: the 10k-iteration randomized baseline on the same graphs
    for idx, res in zip(sorted(test_ds.graphs), results):
        _, rand_cut, _ = randomized_k_way_maxcut(
            test_ds.graphs[idx], k=3,
            max_iterations=1000 if quick else 10_000,
            patience=1000 if quick else 10_000,
            seed=7000 + idx,
        )
        res["randomized_cut"] = float(rand_cut)
        print(
            f"graph {idx}: simple {res['simple_cut']:.0f} | "
            f"post {res['post_cut']:.0f} | "
            f"refined {res.get('refined_cut', float('nan')):.0f} | "
            f"randomized {rand_cut:.0f}"
        )

    # --- cell 25-30: analysis + reports (reference output-dict parity) --
    analysis = analyze_results(results, results_by_size, [n])
    print_analysis_report(analysis, [n])
    testing_config = {
        "graph_sizes": [n],
        "num_test_graphs": len(results),
        "post_processing_iterations": 200,
    }
    summary = generate_summary_report(
        analysis, testing_config, model_config={"n_nodes": pad}
    )
    with open(os.path.join(workdir, "SUMMARY.md"), "w") as f:
        f.write(summary)
    save_results(
        os.path.join(workdir, "results.json"),
        results, results_by_size, analysis, testing_config,
    )
    print(f"reports -> {workdir}/SUMMARY.md, {workdir}/results.json")

    # --- cell 31-35: charts (skipped gracefully without matplotlib) -----
    from gcn_maxcut.viz import HAS_MATPLOTLIB

    if HAS_MATPLOTLIB:
        from gcn_maxcut.viz import bar_plot_3, plot_loss_history

        plot_loss_history(
            history, save_path=os.path.join(workdir, "loss_curve.png")
        )
        bar_plot_3(
            [f"g{idx}" for idx in sorted(test_ds.graphs)],
            {
                "GCN argmax": [r["simple_cut"] for r in results],
                "GCN + post": [r["post_cut"] for r in results],
                "randomized": [r["randomized_cut"] for r in results],
            },
            save_path=os.path.join(workdir, "comparison.png"),
        )
        print(f"charts -> {workdir}/loss_curve.png, {workdir}/comparison.png")
    else:
        print("matplotlib not available; charts skipped")

    post_mean = float(np.mean([r["post_cut"] for r in results]))
    rand_mean = float(np.mean([r["randomized_cut"] for r in results]))
    print(
        f"\nGCN+post mean {post_mean:.0f} vs randomized {rand_mean:.0f} "
        f"({'beats' if post_mean >= rand_mean else 'trails'} the baseline)"
    )
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    raise SystemExit(
        main(
            workdir=args[0] if args else "pipeline_out",
            quick="--quick" in sys.argv[1:],
        )
    )
