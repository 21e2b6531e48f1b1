"""Multi-device halo giant trainers on the virtual CPU mesh."""

import numpy as np
import jax
import pytest

from gcn_maxcut.parallel.giant_banded import HaloGiantConfig, train_halo_giant
from gcn_maxcut.parallel.mesh import make_mesh


def test_halo_giant_improves_cut_on_4_devices():
    mesh = make_mesh(("graph",), devices=jax.devices()[:4])
    cfg = HaloGiantConfig(
        d=4, dim_embedding=16, hidden_dim=16, epochs=10, epochs_per_call=5,
        bandwidth=15, learning_rate=5e-3,
    )
    res = train_halo_giant(n_shard=128, config=cfg, mesh=mesh)
    assert res["num_devices"] == 4
    assert res["n"] == 512
    assert res["final_cut"] > res["initial_cut"]
    assert np.isfinite(res["final_cut"])


def test_halo_giant_quality_bound():
    """Quality REGRESSION bound for the banded giant path: the toy run
    (n=512, d=4, 40 epochs) must cut >= 90% of edges (this scaled config
    reaches ~93% at 40 epochs).  Shape-only checks (final > initial) would
    pass a trainer that converges to a much worse cut; this one fails on
    quality."""
    mesh = make_mesh(("graph",), devices=jax.devices()[:4])
    cfg = HaloGiantConfig(
        d=4, dim_embedding=16, hidden_dim=16, epochs=40, epochs_per_call=20,
        bandwidth=15, learning_rate=1e-2,
    )
    res = train_halo_giant(n_shard=128, config=cfg, mesh=mesh)
    assert res["cut_fraction"] >= 0.90, res["cut_fraction"]


def test_halo_giant_single_device_consistency():
    # D=1: the halo wraps onto the same device (== circulant)
    mesh = make_mesh(("graph",), devices=jax.devices()[:1])
    cfg = HaloGiantConfig(
        d=4, dim_embedding=8, hidden_dim=8, epochs=5, epochs_per_call=5,
        bandwidth=7, learning_rate=5e-3,
    )
    res = train_halo_giant(n_shard=128, config=cfg, mesh=mesh)
    assert res["final_cut"] >= res["initial_cut"]


# ---- packed interleaved-order multi-device trainer ---------------------------

from gcn_maxcut.parallel.giant_banded import (
    PackedHaloGiantConfig,
    train_halo_giant_packed,
)


def test_packed_halo_giant_improves_cut_on_4_devices():
    mesh = make_mesh(("graph",), devices=jax.devices()[:4])
    cfg = PackedHaloGiantConfig(
        d=4, dim_embedding=32, epochs=10, epochs_per_call=5,
        bandwidth=15, r=8, learning_rate=5e-3,
    )
    res = train_halo_giant_packed(n_shard=256, config=cfg, mesh=mesh)
    assert res["num_devices"] == 4
    assert res["n"] == 1024
    assert res["layout"] == "packed"
    assert res["final_cut"] > res["initial_cut"]
    assert np.isfinite(res["final_cut"])


def test_packed_halo_giant_matches_single_chip_demo():
    """The 4-device packed halo trainer and the single-device packed trainer
    share init keys, objective and optimizer — loss histories must agree
    (the per-shard gradient formulation is exact, so sharding is
    numerics-only)."""
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    n, n_dev = 1024, 4
    kw = dict(d=4, dim_embedding=32, learning_rate=5e-3,
              epochs=10, epochs_per_call=5, bandwidth=15, seed=0)
    mesh = make_mesh(("graph",), devices=jax.devices()[:n_dev])
    # f32 streams on both sides: this test isolates the SHARDING exactness
    # (bf16 default streams round the sharded wrap vs circulant paths
    # differently at the last bit, which is dtype noise, not a bug)
    cfg = PackedHaloGiantConfig(r=8, agg_dtype=None, **kw)
    multi = train_halo_giant_packed(
        n_shard=n // n_dev, config=cfg, mesh=mesh
    )
    single = train_banded_giant_packed(
        n=n, hidden_dim=16, r=8, num_classes=3, agg_dtype=None, **kw
    )
    assert multi["n"] == single["n"] == n
    np.testing.assert_allclose(
        multi["initial_cut"], single["initial_cut"], rtol=1e-4
    )
    np.testing.assert_allclose(
        multi["final_cut"], single["final_cut"], rtol=1e-3
    )


def test_packed_giant_bf16_activation_knob():
    """The opt-in bf16-activation pipeline trains and lands in the same
    cut band as the default f32 pipeline."""
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    f32 = train_banded_giant_packed(
        n=4096, epochs=20, epochs_per_call=5, bandwidth=31,
    )
    bf16 = train_banded_giant_packed(
        n=4096, epochs=20, epochs_per_call=5, bandwidth=31,
        act_dtype="bfloat16",
    )
    assert bf16["final_cut"] > bf16["initial_cut"]
    assert bf16["cut_fraction"] > 0.7
    # bf16 converges SLOWER at a fixed epoch count (90.7% vs 93.6% cut at
    # 10M nodes / 40 epochs); it must still be in a sane band below/near
    # the f32 run, not collapsed
    assert bf16["cut_fraction"] > f32["cut_fraction"] - 0.15
    assert bf16["cut_fraction"] < f32["cut_fraction"] + 0.05


def test_packed_halo_bf16_activation_matches_single_chip_twin():
    """act_dtype=bfloat16 on the multi-device packed halo trainer mirrors
    the single-device trainer's bf16 pipeline (same init/objective): loss
    histories must agree (sharding exactness is dtype-independent)."""
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    n, n_dev = 1024, 4
    kw = dict(d=4, dim_embedding=32, learning_rate=5e-3,
              epochs=10, epochs_per_call=5, bandwidth=15, seed=0)
    mesh = make_mesh(("graph",), devices=jax.devices()[:n_dev])
    cfg = PackedHaloGiantConfig(
        r=8, agg_dtype=None, act_dtype="bfloat16", mu_dtype=None, **kw
    )
    multi = train_halo_giant_packed(
        n_shard=n // n_dev, config=cfg, mesh=mesh
    )
    single = train_banded_giant_packed(
        n=n, hidden_dim=16, r=8, num_classes=3, agg_dtype=None,
        act_dtype="bfloat16", mu_dtype=None, **kw
    )
    np.testing.assert_allclose(
        multi["initial_cut"], single["initial_cut"], rtol=1e-3
    )
    np.testing.assert_allclose(
        multi["final_cut"], single["final_cut"], rtol=5e-3
    )


def test_packed_demo_checkpoint_resume(tmp_path):
    """Packed giant trainer (small twin): chunk-aligned resume
    reproduces the uninterrupted trajectory."""
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    kw = dict(n=1024, d=4, bandwidth=15, epochs_per_call=5, seed=0)
    full = train_banded_giant_packed(epochs=20, **kw)
    ck = str(tmp_path / "packed_ck")
    # note: epochs <= epochs_per_call runs one forced steady-timing
    # chunk, so this trains (and records) exactly 10 epochs
    train_banded_giant_packed(epochs=10, checkpoint_path=ck, **kw)
    resumed = train_banded_giant_packed(
        epochs=20, resume_from=ck, **kw
    )
    assert resumed["epochs"] == 20
    np.testing.assert_allclose(
        resumed["final_cut"], full["final_cut"], rtol=1e-6
    )
