"""The reference's `neural_network_testing.ipynb` recipe as a script.

Mirrors the notebook (reference §2.8): load a trained checkpoint, generate
10 test graphs per size {50, 100, 200, 300, 500} (d∈[6,8], seeds
size*1000+i), run the 200-iteration post-processing comparison, print the
analysis report, save results + visualizations.

    python examples/neural_network_testing.py <final_checkpoint.npz> [outdir]
"""

import sys
from pathlib import Path

import jax

from gcn_maxcut.data import DataConfig, generate_graph_dataset, process_graphs
from gcn_maxcut.eval import (
    analyze_results,
    generate_summary_report,
    print_analysis_report,
    save_results,
    test_multiple_graphs,
)
from gcn_maxcut.train import TrainingConfig, load_checkpoint, setup_train_state
from gcn_maxcut.viz import HAS_MATPLOTLIB, create_test_visualizations

GRAPH_SIZES = [50, 100, 200, 300, 500]
GRAPHS_PER_SIZE = 10
POST_ITERATIONS = 200


def main(checkpoint: str, outdir: str = "testing_out") -> int:
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    cfg = TrainingConfig(n_nodes=1000)
    state = setup_train_state(cfg)
    params, _, _, meta = load_checkpoint(checkpoint, state.params)
    print(f"loaded checkpoint (epoch {meta['epoch']})")

    all_results, merged_by_size = [], {}
    for size in GRAPH_SIZES:
        graphs, _ = generate_graph_dataset(
            GRAPHS_PER_SIZE, size, size, 6, 8, base_seed=size * 1000
        )
        ds = process_graphs(graphs, DataConfig(max_nodes=1000))
        results, by_size = test_multiple_graphs(
            params, ds, [size], post_processing_iterations=POST_ITERATIONS
        )
        all_results.extend(results)
        merged_by_size.update(by_size)

    analysis = analyze_results(all_results, merged_by_size, GRAPH_SIZES)
    print_analysis_report(analysis, GRAPH_SIZES)

    summary = generate_summary_report(
        analysis,
        {"graph_sizes": GRAPH_SIZES, "graphs_per_size": GRAPHS_PER_SIZE,
         "post_processing_iterations": POST_ITERATIONS},
        model_config={"checkpoint": checkpoint},
    )
    (out / "SUMMARY.md").write_text(summary)
    save_results(
        out / "results.json", all_results, merged_by_size, analysis,
        {"sizes": GRAPH_SIZES},
    )
    if HAS_MATPLOTLIB:
        create_test_visualizations(
            all_results, merged_by_size, GRAPH_SIZES,
            save_path=str(out / "test_panel.png"),
        )
    print(f"artifacts in {out}/")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__)
        raise SystemExit(1)
    raise SystemExit(main(*sys.argv[1:3]))
