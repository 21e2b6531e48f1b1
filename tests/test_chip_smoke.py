"""chip_smoke.py phases at tiny sizes on the CPU; only ``main()`` demands a
GPU."""

import jax
import pytest

import chip_smoke


def test_phase_recipe_small():
    res = chip_smoke.phase_recipe(
        num_graphs=3, n=40, max_nodes=64, epochs=20, rollouts=50
    )
    assert res["loss_last"] < res["loss_first"]
    assert res["cut_fraction_mean"] > 2 / 3


def test_phase_general_small():
    res = chip_smoke.phase_general(n=2000, d=8, epochs=20, feature_dim=16)
    assert 2 / 3 < res["cut_fraction"] <= 1.0


def test_phase_giant_small():
    res = chip_smoke.phase_giant(n=8192, epochs=20, r=8, bandwidth=15)
    assert res["cut_fraction"] > 2 / 3


def test_phase_four_cards_small():
    res = chip_smoke.phase_four_cards(
        n_shard=1024, epochs=20, bandwidth=15, devices=jax.devices()[:4]
    )
    assert res["cut_fraction"] > 2 / 3


def test_compare_reports_and_fails_beyond_tolerance():
    chip_smoke.compare("equal", [1.0, 2.0], [1.0, 2.0], 0.0, 0.0, "f32")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare("off", [1.0, 2.1], [1.0, 2.0], 1e-3, 0.0, "f32")


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())
