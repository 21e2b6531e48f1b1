"""Banded/circulant SpMM (XLA form): parity with numpy oracles + VJP math."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcn_maxcut.ops.banded import (
    banded_spmm,
    banded_spmm_reference,
    banded_spmm_unit,
    banded_spmm_unit_packed,
    pack_interleaved,
    unpack_interleaved,
)


def _oracle(x, w, offsets):
    return sum(
        np.asarray(w)[:, k : k + 1] * np.roll(np.asarray(x), -o, axis=0)
        for k, o in enumerate(offsets)
    )


def _dense_operator(n, offsets, w=None):
    """A[i, (i + o_k) mod n] += w[i, k] — the circulant as a dense matrix."""
    a = np.zeros((n, n), np.float64)
    for k, o in enumerate(offsets):
        vals = np.ones(n) if w is None else np.asarray(w, np.float64)[:, k]
        np.add.at(a, (np.arange(n), (np.arange(n) + o) % n), vals)
    return a


@pytest.mark.parametrize(
    "n,F,offsets",
    [
        (64, 8, (1, -1, 3, -3)),
        (64, 3, (5, -5)),
        (128, 16, (0, 7, -7, 31, -31)),
    ],
)
def test_banded_weighted_matches_oracle(n, F, offsets):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, F)), jnp.float32)
    w = jnp.asarray(rng.random((n, len(offsets))), jnp.float32)
    y = banded_spmm(x, w, offsets)
    np.testing.assert_allclose(
        np.asarray(y), _oracle(x, w, offsets), rtol=1e-5, atol=1e-5
    )


def test_banded_reference_matches_oracle():
    rng = np.random.default_rng(1)
    offsets = (2, -2, 9)
    x = jnp.asarray(rng.normal(size=(48, 4)), jnp.float32)
    w = jnp.asarray(rng.random((48, 3)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(banded_spmm_reference(x, offsets, w)),
        _oracle(x, w, offsets),
        rtol=1e-5,
    )


def test_banded_vjp_math_matches_autodiff():
    # transpose algebra: Aᵀ is the same banded form with negated offsets
    # and weights rolled by their own offset
    rng = np.random.default_rng(2)
    offsets = (1, -4, 6)
    x = jnp.asarray(rng.normal(size=(32, 5)), jnp.float32)
    w = jnp.asarray(rng.random((32, 3)), jnp.float32)

    gx_ref, gw_ref = jax.grad(
        lambda x_, w_: jnp.sum(jnp.sin(banded_spmm(x_, w_, offsets))),
        argnums=(0, 1),
    )(x, w)

    y = banded_spmm(x, w, offsets)
    dy = jnp.cos(y)
    neg = tuple(-o for o in offsets)
    w_t = jnp.stack([jnp.roll(w[:, k], o) for k, o in enumerate(offsets)], axis=1)
    dx = banded_spmm(dy, w_t, neg)
    dw = jnp.stack(
        [jnp.sum(dy * jnp.roll(x, -o, axis=0), axis=1) for o in offsets], axis=1
    )
    np.testing.assert_allclose(np.asarray(dx), np.asarray(gx_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dw), np.asarray(gw_ref), rtol=1e-4, atol=1e-5)


def test_banded_rejects_bandwidth_beyond_rows():
    with pytest.raises(ValueError, match="bandwidth"):
        banded_spmm(jnp.ones((16, 4)), jnp.ones((16, 2)), (17, -17))
    with pytest.raises(ValueError, match="bandwidth"):
        banded_spmm_unit_packed(jnp.ones((64, 4)), (9, -9), 8)


def test_banded_unit_any_feature_width():
    # no lane-width constraint: any F, including 1 and odd widths
    rng = np.random.default_rng(3)
    for F in (1, 3, 128, 130):
        x = jnp.asarray(rng.normal(size=(64, F)), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(banded_spmm_unit(x, (1, -1, 4))),
            _oracle(x, np.ones((64, 3)), (1, -1, 4)),
            rtol=1e-5, atol=1e-5,
        )


# ---- interleaved packed variant (narrow F) -------------------------------

def test_pack_unpack_roundtrip():
    x = jnp.asarray(np.arange(64 * 5, dtype=np.float32).reshape(64, 5))
    for r in (4, 8, 16):
        y = unpack_interleaved(pack_interleaved(x, r), r)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize(
    "n,F,r,offsets",
    [
        (4096, 16, 8, (1, -1, 5, -5)),
        (8192, 4, 32, (2, -2, 7, -7, 63, -63)),
        (4096, 32, 8, (33, -33, 1, -1)),
        (8192, 16, 32, (9, -9, 2, -2)),
        (4096, 16, 8, (3, 11)),            # one-sided, no ± symmetry
    ],
)
def test_packed_unit_matches_rolls(n, F, r, offsets):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, F)).astype(np.float32))
    yp = banded_spmm_unit_packed(pack_interleaved(x, r), offsets, r)
    y = unpack_interleaved(yp, r)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(banded_spmm_reference(x, offsets)),
        rtol=1e-5, atol=1e-5,
    )


def test_packed_unit_gradient_matches_rolls():
    rng = np.random.default_rng(1)
    n, F, r, offsets = 4096, 16, 8, (1, -1, 9, -9)
    x = jnp.asarray(rng.normal(size=(n, F)).astype(np.float32))
    xp = pack_interleaved(x, r)
    g = jax.grad(
        lambda z: jnp.sum(banded_spmm_unit_packed(z, offsets, r) ** 2)
    )(xp)
    g_ref = jax.grad(
        lambda z: jnp.sum(banded_spmm_reference(z, offsets) ** 2)
    )(x)
    np.testing.assert_allclose(
        np.asarray(unpack_interleaved(g, r)), np.asarray(g_ref),
        rtol=1e-4, atol=1e-4,
    )


def test_packed_unit_any_row_width():
    # r*F of any size (here 20 lanes): the packed form has no lane tiling
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(120, 5)).astype(np.float32))
    y = unpack_interleaved(
        banded_spmm_unit_packed(pack_interleaved(x, 4), (1, -1), 4), 4
    )
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(banded_spmm_reference(x, (1, -1))),
        rtol=1e-5,
    )


def test_packed_giant_trainer_improves_cut():
    from gcn_maxcut.bench.giant_demo import train_banded_giant_packed

    r = train_banded_giant_packed(
        n=8192, epochs=20, epochs_per_call=5, bandwidth=31
    )
    assert r["final_cut"] > r["initial_cut"]
    assert r["cut_fraction"] > 0.75
    assert r["step_memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("r", [1, 4])
def test_packed_wrap_matches_dense_operator(r):
    # the lane-rotated wrap rows reproduce the global circulant exactly
    n, F, offsets = 96, 3, (2, -2, 7, -5)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, F)).astype(np.float32)
    a = _dense_operator(n, offsets)
    y = unpack_interleaved(
        banded_spmm_unit_packed(pack_interleaved(jnp.asarray(x), r), offsets, r),
        r,
    )
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-5, atol=1e-5)


def test_packed_rejects_n_not_multiple_of_r():
    with pytest.raises(ValueError, match="multiple"):
        banded_spmm_unit_packed(jnp.ones((100, 16)), (1, -1), 8)


def test_weighted_matches_dense_operator():
    n, F = 256, 8
    offsets = (3, -3, 17, -17)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.uniform(0.25, 4.0, size=(n, 4)).astype(np.float32)
    y = banded_spmm(jnp.asarray(x), jnp.asarray(w), offsets)
    np.testing.assert_allclose(
        np.asarray(y), _dense_operator(n, offsets, w) @ x, rtol=1e-5, atol=1e-4
    )


def test_weighted_gradient_matches_dense_operator():
    n, F = 128, 4
    offsets = (5, -5)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(n, 2)).astype(np.float32)
    gx, gw = jax.grad(
        lambda a, b: jnp.sum(banded_spmm(a, b, offsets) ** 2), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    a = _dense_operator(n, offsets, w)
    y = a @ x
    np.testing.assert_allclose(np.asarray(gx), 2 * a.T @ y, rtol=1e-4, atol=1e-4)
    gw_ref = np.stack(
        [np.sum(2 * y * np.roll(x, -o, axis=0), axis=1) for o in offsets], 1
    )
    np.testing.assert_allclose(np.asarray(gw), gw_ref, rtol=1e-4, atol=1e-4)


def test_unit_vjp_is_negated_offsets():
    # one-sided offsets: the operator is not self-adjoint, so the backward
    # must be the same op with negated offsets (the transpose)
    rng = np.random.default_rng(5)
    n, F, offsets = 64, 6, (1, 3, 10)
    x = jnp.asarray(rng.normal(size=(n, F)), jnp.float32)
    ct = jnp.asarray(rng.normal(size=(n, F)), jnp.float32)
    _, pull = jax.vjp(lambda z: banded_spmm_unit(z, offsets), x)
    (dx,) = pull(ct)
    a = _dense_operator(n, offsets)
    np.testing.assert_allclose(
        np.asarray(dx), a.T @ np.asarray(ct), rtol=1e-5, atol=1e-5
    )


def test_unit_kernels_bf16_streams():
    """bf16 unit streams: output dtype follows input, values match the f32
    path to bf16 read tolerance (f32 accumulation), fwd and bwd,
    plain and packed variants."""
    rng = np.random.default_rng(7)
    offsets = (1, -1, 9, -9)
    n, F = 2048, 128
    x = jnp.asarray(rng.normal(size=(n, F)).astype(np.float32))
    y16 = banded_spmm_unit(x.astype(jnp.bfloat16), offsets)
    assert y16.dtype == jnp.bfloat16
    ref = banded_spmm_reference(x, offsets)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(
        np.asarray(y16, np.float32) / scale, np.asarray(ref) / scale,
        atol=3e-2,
    )
    # backward: cotangent of a bf16 output is bf16; same op
    g16 = jax.grad(
        lambda z: jnp.sum(
            banded_spmm_unit(z, offsets).astype(jnp.float32) ** 2
        )
    )(x.astype(jnp.bfloat16))
    gref = jax.grad(
        lambda z: jnp.sum(banded_spmm_reference(z, offsets) ** 2)
    )(x)
    gs = float(jnp.max(jnp.abs(gref)))
    np.testing.assert_allclose(
        np.asarray(g16, np.float32) / gs, np.asarray(gref) / gs,
        atol=5e-2,
    )
    # packed variant
    r = 8
    xp = pack_interleaved(x[:, :16], r).astype(jnp.bfloat16)
    yp = banded_spmm_unit_packed(xp, offsets, r)
    assert yp.dtype == jnp.bfloat16
    y = unpack_interleaved(yp.astype(jnp.float32), r)
    refp = banded_spmm_reference(x[:, :16], offsets)
    sp = float(jnp.max(jnp.abs(refp)))
    np.testing.assert_allclose(
        np.asarray(y) / sp, np.asarray(refp) / sp, atol=3e-2
    )


def test_weighted_rejects_bf16():
    x = jnp.ones((256, 128), jnp.bfloat16)
    w = jnp.ones((256, 2), jnp.float32)
    with pytest.raises(ValueError, match="f32"):
        banded_spmm(x, w, (1, -1))
