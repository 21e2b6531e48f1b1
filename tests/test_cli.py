"""CLI driver subcommands end-to-end (tiny configs)."""

import json

import numpy as np
import pytest

from gcn_maxcut.cli import main


def test_generate_train_test_roundtrip(tmp_path, capsys):
    ds_path = str(tmp_path / "ds.npz")
    rc = main(
        [
            "generate", "--num-graphs", "3", "--min-nodes", "20",
            "--max-nodes", "24", "--min-degree", "4", "--max-degree", "4",
            "--pad-to", "32", "--seed", "7", "--output", ds_path,
        ]
    )
    assert rc == 0
    assert (tmp_path / "ds.npz").exists()

    model = str(tmp_path / "m")
    rc = main(
        [
            "train", "--dataset", ds_path, "--model-name", model,
            "--epochs", "5", "--learning-rate", "0.01",
            "--save-frequency", "10",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    stats = json.loads(out)
    assert stats["epochs"] <= 5 and stats["best_loss"] < 0

    ckpt = str(tmp_path / f"final_{model.split('/')[-1]}.npz")
    import os

    finals = [f for f in os.listdir(tmp_path) if f.startswith("final_")]
    assert finals
    rc = main(
        [
            "test", "--dataset", ds_path,
            "--checkpoint", str(tmp_path / finals[0]),
            "--sizes", "20,24", "--iterations", "20",
            "--output", str(tmp_path / "results.json"),
        ]
    )
    assert rc == 0
    assert (tmp_path / "results.json").exists()


def test_solve_command(capsys):
    rc = main(["solve", "--n", "12", "--d", "4", "--time-limit", "5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["method"] == "exact_brute_force"
    assert out["cut_value"] >= out["randomized_cut"] - 1e-6


def test_pipeline_command(tmp_path, capsys):
    rc = main(
        [
            "pipeline", "--workdir", str(tmp_path), "--num-graphs", "4",
            "--nodes", "20", "--min-degree", "4", "--max-degree", "4",
            "--pad-to", "32", "--epochs", "20", "--learning-rate", "0.01",
        ]
    )
    assert rc == 0
    files = {p.name for p in tmp_path.iterdir()}
    assert any(f.endswith("_SUMMARY.md") for f in files)
    assert any(f.endswith("_dataset.npz") for f in files)
    out = capsys.readouterr().out
    assert "pipeline summary" in out
    assert "Randomized baseline" in out


def test_train_metrics_and_resume(tmp_path, capsys):
    ds_path = str(tmp_path / "ds.npz")
    assert main(
        [
            "generate", "--num-graphs", "2", "--min-nodes", "20",
            "--max-nodes", "20", "--min-degree", "4", "--max-degree", "4",
            "--pad-to", "32", "--seed", "3", "--output", ds_path,
        ]
    ) == 0
    model = str(tmp_path / "m")
    metrics = tmp_path / "metrics.jsonl"
    assert main(
        [
            "train", "--dataset", ds_path, "--model-name", model,
            "--epochs", "4", "--metrics", str(metrics),
        ]
    ) == 0
    recs = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert len(recs) == 4 and all("loss" in r and "step_time_s" in r for r in recs)

    import os

    final = [f for f in os.listdir(tmp_path) if f.startswith("final_")][0]
    assert main(
        [
            "train", "--dataset", ds_path, "--model-name", model,
            "--epochs", "6", "--resume", str(tmp_path / final),
        ]
    ) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs"] >= 4  # history includes the resumed epochs
