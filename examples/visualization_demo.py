"""Publication-figure generation from saved results.

The reference's `neural_network_visualization.ipynb` as a script: loads a
results package (from `eval.save_results` / `examples/neural_network_testing.py`)
and renders the comparison / runtime / scalability / improvement charts.

    python examples/visualization_demo.py <results.json> [outdir]
"""

import sys
from pathlib import Path

import numpy as np

from gcn_maxcut.eval import load_results
from gcn_maxcut.viz import (
    HAS_MATPLOTLIB,
    bar_plot_3,
    bar_plot_speedup,
    create_line_graph,
    create_test_visualizations,
)


def main(results_path: str, outdir: str = "viz_out") -> int:
    if not HAS_MATPLOTLIB:
        print("matplotlib unavailable; nothing to render")
        return 1
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    pkg = load_results(results_path)
    by_size = {int(k): v for k, v in pkg["results_by_size"].items()}
    sizes = sorted(
        s for s in by_size if by_size[s]["simple"]["cut_values"]
    )
    cats = [f"n={s}" for s in sizes]
    simple = [float(np.mean(by_size[s]["simple"]["cut_values"])) for s in sizes]
    post = [
        float(np.mean(by_size[s]["post_processed"]["cut_values"])) for s in sizes
    ]

    bar_plot_3(
        cats,
        {"GCN": simple, "GCN + post-processing": post},
        title="Cut value by method",
        annotate_percent_of="GCN + post-processing",
        save_path=str(out / "comparison.png"),
    )
    bar_plot_speedup(
        cats,
        {
            "GCN": [float(np.mean(by_size[s]["simple"]["times"])) for s in sizes],
            "GCN + post": [
                float(np.mean(by_size[s]["post_processed"]["times"])) for s in sizes
            ],
        },
        save_path=str(out / "runtime.png"),
    )
    create_line_graph(
        sizes,
        {"GCN": simple, "GCN + post": post},
        title="Scalability",
        save_path=str(out / "scalability.png"),
    )
    create_test_visualizations(
        pkg["individual_results"], by_size, sizes,
        save_path=str(out / "panel.png"),
    )
    print(f"figures written to {out}/")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__)
        raise SystemExit(1)
    raise SystemExit(main(*sys.argv[1:3]))
