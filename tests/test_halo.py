"""Halo-exchange banded SpMM (``ppermute`` under ``shard_map``) on the
virtual CPU mesh, against the single-device circulant reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from gcn_maxcut.ops.banded import (
    banded_spmm_reference,
    halo_banded_spmm,
    halo_banded_spmm_unit_packed,
    pack_interleaved,
    unpack_interleaved,
)


def _expect(x_global, w_global, offsets):
    out = np.zeros_like(x_global)
    for k, o in enumerate(offsets):
        out += w_global[:, k : k + 1] * np.roll(x_global, -o, axis=0)
    return out


def _run_halo(xg, wg, offsets, n_dev):
    n, F = xg.shape
    n_shard = n // n_dev
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("graph",))
    fn = jax.shard_map(
        lambda x, w: halo_banded_spmm(x[0], w[0], offsets, "graph")[None],
        mesh=mesh,
        in_specs=(P("graph"), P("graph")),
        out_specs=P("graph"),
        check_vma=False,
    )
    out = jax.jit(fn)(
        jnp.asarray(xg).reshape(n_dev, n_shard, F),
        jnp.asarray(wg).reshape(n_dev, n_shard, wg.shape[1]),
    )
    return out


@pytest.mark.parametrize("n_dev", [4, 2, 8])
def test_halo_spmm_matches_global_circulant(n_dev):
    n_shard, F = 64, 16
    offsets = (1, -1, 5, -5, 13, -13)
    n = n_dev * n_shard
    rng = np.random.default_rng(0)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    wg = rng.random((n, len(offsets))).astype(np.float32)
    out = np.asarray(_run_halo(xg, wg, offsets, n_dev))
    np.testing.assert_allclose(
        out.reshape(n, F), _expect(xg, wg, offsets), rtol=1e-5, atol=1e-5
    )


def test_halo_spmm_single_device_wraps():
    # D=1: ppermute over one device sends the halo to itself == wrap
    n_shard, F = 64, 8
    offsets = (2, -2)
    rng = np.random.default_rng(1)
    xg = rng.normal(size=(n_shard, F)).astype(np.float32)
    wg = rng.random((n_shard, 2)).astype(np.float32)
    out = np.asarray(_run_halo(xg, wg, offsets, 1))[0]
    np.testing.assert_allclose(out, _expect(xg, wg, offsets), rtol=1e-5, atol=1e-5)


def test_halo_spmm_shape_validation():
    with pytest.raises(ValueError, match="bandwidth"):
        halo_banded_spmm(jnp.ones((8, 4)), jnp.ones((8, 2)), (9, -9), "graph")


# ---- packed interleaved-order halo ----------------------------------------


def _run_packed_halo(xg, offsets, r, n_dev):
    """Shard pack_interleaved(xg) contiguously over n_dev and run the
    packed halo SpMM; returns the result in global NODE order."""
    n, F = xg.shape
    n_loc = n // n_dev
    pg = np.asarray(pack_interleaved(jnp.asarray(xg), r))
    x_sh = jnp.asarray(pg.reshape(n_dev, n_loc, F))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("graph",))
    fn = jax.shard_map(
        lambda x: halo_banded_spmm_unit_packed(x[0], offsets, r, "graph")[None],
        mesh=mesh,
        in_specs=(P("graph"),),
        out_specs=P("graph"),
        check_vma=False,
    )
    out = np.asarray(jax.jit(fn)(x_sh))
    return np.asarray(
        unpack_interleaved(jnp.asarray(out.reshape(n, F)), r)
    )


@pytest.mark.parametrize("n_dev", [4, 2, 8])
def test_packed_halo_matches_global_circulant(n_dev):
    r, F, m_loc = 4, 32, 64
    offsets = (1, -1, 5, -5, 13, -13)
    n = n_dev * m_loc * r
    rng = np.random.default_rng(0)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    out = _run_packed_halo(xg, offsets, r, n_dev)
    ref = np.asarray(banded_spmm_reference(jnp.asarray(xg), offsets))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_packed_halo_bandwidth_equals_shard_rows():
    # W == m_loc: every output row of a shard reads the neighbor's halo
    r, F, m_loc, n_dev = 4, 8, 7, 4
    offsets = (3, -3, 7, -7)
    n = n_dev * m_loc * r
    rng = np.random.default_rng(1)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    out = _run_packed_halo(xg, offsets, r, n_dev)
    ref = np.asarray(banded_spmm_reference(jnp.asarray(xg), offsets))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_packed_halo_odd_row_width():
    # L = r*F = 24 lanes: no tiling constraint on the row width
    r, F, m_loc, n_dev = 3, 8, 32, 4
    offsets = (2, -2, 9, -9)
    n = n_dev * m_loc * r
    rng = np.random.default_rng(2)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    out = _run_packed_halo(xg, offsets, r, n_dev)
    ref = np.asarray(banded_spmm_reference(jnp.asarray(xg), offsets))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_packed_halo_grad_is_transpose():
    # d/dx <ct, A x> = A^T ct == circulant with negated offsets
    r, F, m_loc, n_dev = 4, 32, 32, 4
    offsets = (1, -1, 6, -6, 11)
    n = n_dev * m_loc * r
    n_loc = n // n_dev
    rng = np.random.default_rng(3)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    ct = rng.normal(size=(n, F)).astype(np.float32)
    pg = np.asarray(pack_interleaved(jnp.asarray(xg), r))
    ct_p = np.asarray(pack_interleaved(jnp.asarray(ct), r))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("graph",))

    # explicit vjp pull with ct as the cotangent (a psum'd scalar loss would
    # double-count under check_vma=False: psum transposes to psum again)
    def pull(x_sh, ct_sh):
        _, vjp_fn = jax.vjp(
            lambda x: halo_banded_spmm_unit_packed(
                x[0], offsets, r, "graph"
            )[None],
            x_sh,
        )
        return vjp_fn(ct_sh)[0]

    fn = jax.shard_map(
        pull,
        mesh=mesh,
        in_specs=(P("graph"), P("graph")),
        out_specs=P("graph"),
        check_vma=False,
    )
    g = np.asarray(
        jax.jit(fn)(
            jnp.asarray(pg.reshape(n_dev, n_loc, F)),
            jnp.asarray(ct_p.reshape(n_dev, n_loc, F)),
        )
    )
    g_node = np.asarray(
        unpack_interleaved(jnp.asarray(g.reshape(n, F)), r)
    )
    neg = tuple(-o for o in offsets)
    ref = np.asarray(banded_spmm_reference(jnp.asarray(ct), neg))
    np.testing.assert_allclose(g_node, ref, rtol=1e-5, atol=1e-5)


def test_halo_spmm_bf16_streams():
    """bf16 halo streams: output dtype follows input, values within bf16
    read tolerance of the f32 path, wrap included."""
    n_dev, n_shard, F = 4, 64, 16
    offsets = (1, -1, 5, -5)
    n = n_dev * n_shard
    rng = np.random.default_rng(3)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    wg = np.ones((n, len(offsets)), np.float32)
    y = _run_halo(xg.astype(jnp.bfloat16), wg, offsets, n_dev)
    assert y.dtype == jnp.bfloat16
    expect = _expect(xg, wg, offsets)
    scale = np.abs(expect).max()
    np.testing.assert_allclose(
        np.asarray(y, np.float32).reshape(n, F) / scale, expect / scale,
        atol=3e-2,
    )
