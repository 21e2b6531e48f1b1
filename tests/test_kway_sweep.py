"""config[3] harness: k-way sweep on the sharded giant-graph trainer.

Runs tiny instances on the virtual 8-device CPU mesh (same shard_map code
path as a multi-GPU mesh) and checks structure + that training beats the
uniform-random cut floor (k-1)/k for each k.
"""

import numpy as np

from gcn_maxcut.bench.kway_sweep import kway_sweep


def test_kway_sweep_tiny():
    results = kway_sweep(
        n=256, d=4, ks=(3, 5), epochs=40, dim_embedding=16, hidden_dim=8,
        learning_rate=5e-3, seed=1,
    )
    assert [r["k"] for r in results] == [3, 5]
    for r in results:
        assert np.isfinite(r["final_cut"])
        assert 0.0 < r["cut_fraction"] <= 1.0
        # trained cut must clearly beat the uniform-random expectation
        assert r["cut_fraction"] > r["random_fraction"], r
        assert r["edges_per_s"] > 0
        assert r["num_shards"] == 8


def test_kway_quality_bound_n4096():
    """Scaled-down config[3] quality REGRESSION bound: k=3 at n=4096 on the
    8-device virtual mesh must land >= +10 points over the uniform-random
    floor (the measured hardware run lands at +16, PARITY §5; 150 epochs
    here reach ~+22 on the virtual mesh — a real quality regression in the
    sharded trainer drops well below +10, a shape bug drops to ~0)."""
    (r,) = kway_sweep(
        n=4096, d=8, ks=(3,), epochs=150, dim_embedding=16, hidden_dim=16,
        learning_rate=5e-3, seed=1,
    )
    margin = 100.0 * (r["cut_fraction"] - r["random_fraction"])
    assert margin >= 10.0, (
        f"k=3 margin over the random floor collapsed to {margin:.1f} points "
        f"(cut {100 * r['cut_fraction']:.1f}% vs floor "
        f"{100 * r['random_fraction']:.1f}%)"
    )
