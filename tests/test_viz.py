"""Chart library: figures render and save without errors."""

import numpy as np
import pytest

from gcn_maxcut.viz import (
    HAS_MATPLOTLIB,
    bar_plot_3,
    bar_plot_2,
    bar_plot_speedup,
    create_line_graph,
    create_test_visualizations,
    plot_loss_history,
)

pytestmark = pytest.mark.skipif(not HAS_MATPLOTLIB, reason="matplotlib missing")


def test_bar_plot_3_with_annotations(tmp_path):
    fig = bar_plot_3(
        ["n=50", "n=100"],
        {"Solver": [100, 200], "Randomized": [80, 150], "GCN": [95, 190]},
        annotate_percent_of="Solver",
        save_path=str(tmp_path / "b3.png"),
    )
    assert (tmp_path / "b3.png").exists()


def test_bar_plot_2_and_speedup(tmp_path):
    bar_plot_2(["a", "b"], [1, 2], [3, 4], labels=("x", "y"))
    fig = bar_plot_speedup(
        ["n=50"], {"Solver": [3.0], "GCN": [0.4]}, save_path=str(tmp_path / "sp.png")
    )
    assert (tmp_path / "sp.png").exists()


def test_line_graph_pct_of_optimum(tmp_path):
    fig = create_line_graph(
        [50, 100], {"GCN": [90, 180]}, optimum=[100, 200],
        save_path=str(tmp_path / "line.png"),
    )
    assert (tmp_path / "line.png").exists()


def test_panel_and_loss_history(tmp_path):
    results = [
        {"improvement_percent": 5.0},
        {"improvement_percent": -1.0},
    ]
    by_size = {
        50: {
            "simple": {"cut_values": [10, 12], "times": [0.1, 0.2]},
            "post_processed": {"cut_values": [11, 13], "times": [0.3, 0.4]},
        }
    }
    fig = create_test_visualizations(
        results, by_size, [50], save_path=str(tmp_path / "panel.png")
    )
    assert (tmp_path / "panel.png").exists()
    plot_loss_history([-10, -50, -100], save_path=str(tmp_path / "loss.png"))
    assert (tmp_path / "loss.png").exists()


def test_bar_plot_generic_dot_full_surface(tmp_path):
    from gcn_maxcut.viz import bar_plot_generic_dot

    cats = ["n=50", "n=100", "n=200"]
    series = {
        "CPLEX": [100, 200, 400],
        "Randomized Algorithm": [80, 150, 320],
        "GCN With Post-processing": [95, 190, 390],
    }
    fig = bar_plot_generic_dot(
        cats,
        series,
        std_percent={"Randomized Algorithm": [8, 9, 10],
                     "GCN With Post-processing": [4, 5, 6]},
        dot_overlay={"GCN With Post-processing": [90, 180, 370]},
        annotate_percent_of="CPLEX",
        y_lim=450,
        save_path=str(tmp_path / "gd.png"),
    )
    assert (tmp_path / "gd.png").exists()
    # parameterized labels end up in the legend
    labels = [t.get_text() for t in fig.axes[0].get_legend().get_texts()]
    assert labels == list(series)


def test_bar_plot_speedup_dot_and_2_speedup(tmp_path):
    from gcn_maxcut.viz import bar_plot_2_speedup, bar_plot_speedup_dot

    fig = bar_plot_speedup_dot(
        ["n=50", "n=100"],
        {"Solver": [3.0, 5.0], "GCN": [0.4, 0.6]},
        std_percent={"GCN": [5, 5]},
        dot_overlay={"GCN": [0.3, 0.5]},
        save_path=str(tmp_path / "spd.png"),
    )
    assert (tmp_path / "spd.png").exists()
    fig2 = bar_plot_2_speedup(
        ["n=50", "n=100"], [0.4, 0.6], [1.2, 1.9],
        std_percent=[5, 7], save_path=str(tmp_path / "sp2.png"),
    )
    assert (tmp_path / "sp2.png").exists()


def test_generate_sample_baseline_data_shapes():
    from gcn_maxcut.viz import generate_sample_baseline_data

    results = {
        50: {
            "simple": {"cut_values": [90, 92], "times": [0.01, 0.01]},
            "post_processed": {"cut_values": [100, 104], "times": [0.2, 0.2]},
        },
        100: {"simple": {"cut_values": []}, "post_processed": {"cut_values": []}},
    }
    synth = generate_sample_baseline_data(results, seed=1)
    assert set(synth) == {50}  # empty sizes skipped, like the reference
    for algo in ("solver", "randomized", "gcn_simple", "gcn_post"):
        assert len(synth[50][algo]["cut_values"]) == 2
        assert len(synth[50][algo]["std_percent"]) == 2
    # solver never below GCN+post; randomized drawn around 0.9x
    assert all(
        s >= g
        for s, g in zip(
            synth[50]["solver"]["cut_values"], synth[50]["gcn_post"]["cut_values"]
        )
    )
    # deterministic under a fixed seed
    assert synth == generate_sample_baseline_data(results, seed=1)
