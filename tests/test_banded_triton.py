"""The banded-stream Pallas kernel (Triton route): the kernel itself in
interpret mode on the CPU, and compiled on the card under the ``gpu``
marker."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from gcn_maxcut.ops import banded
from gcn_maxcut.ops.banded_triton import banded_stream, block_rows


def _masked_reference(p, offsets):
    """y[j] = Σ_k p[j + o_k], rows outside [0, m) contributing zero."""
    p = np.asarray(p, np.float64)
    m = p.shape[0]
    y = np.zeros_like(p)
    for o in offsets:
        src = np.arange(m) + o
        ok = (src >= 0) & (src < m)
        y[ok] += p[src[ok]]
    return y


@pytest.mark.parametrize(
    "m,width,offsets,dtype",
    [
        (200, 128, (1, -1, 9, -9), jnp.float32),
        (333, 24, (3, -3, 17), jnp.float32),       # width not a power of 2
        (64, 3, (0, 5, -5), jnp.float32),
        (257, 256, (2, -2, 63, -63), jnp.bfloat16),
    ],
)
def test_stream_kernel_matches_masked_reference(m, width, offsets, dtype):
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.normal(size=(m, width)), jnp.float32).astype(dtype)
    y = banded_stream(p, offsets, interpret=True)
    assert y.dtype == dtype and y.shape == (m, width)
    ref = _masked_reference(p.astype(jnp.float32), offsets)
    tol = 1e-5 if dtype == jnp.float32 else 2.0 ** -7
    np.testing.assert_allclose(
        np.asarray(y, np.float64), ref, rtol=tol, atol=tol * 4
    )


@pytest.mark.parametrize(
    "m,width,F,offsets",
    [
        (512, 128, 16, (1, -1, 9, -9)),
        (40, 24, 8, (3, -3, 7, -7, 13)),           # m < 2W: edges overlap
        (13, 8, 8, (13, -13, 1)),                  # W == m
    ],
)
def test_gpu_composition_matches_window_sum(m, width, F, offsets):
    # the kernel plus the recomputed head/tail rows equals the XLA window
    # sum, wrap rows (lane-rotated) included
    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.normal(size=(m, width)), jnp.float32)
    W = max(abs(o) for o in offsets)
    pre, post = banded._local_wrap(p, W, F)
    got = banded._gpu_shift_sum(p, pre, post, offsets=offsets, interpret=True)
    want = banded._window_sum(p, offsets, pre, post)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gpu_composition_negated_offsets_is_transpose():
    # the unit op's VJP is the same op with negated offsets; on the kernel
    # route that must still be the exact transpose of the forward
    rng = np.random.default_rng(2)
    m, F, r, offsets = 96, 4, 4, (1, 5, 11)
    n = m * r
    a = np.zeros((n, n))
    for o in offsets:
        np.add.at(a, (np.arange(n), (np.arange(n) + o) % n), 1.0)
    ct = rng.normal(size=(n, F)).astype(np.float32)
    p = banded.pack_interleaved(jnp.asarray(ct), r).reshape(m, r * F)
    neg = tuple(-o for o in offsets)
    W = max(offsets)
    pre, post = banded._local_wrap(p, W, F)
    got = banded._gpu_shift_sum(p, pre, post, offsets=neg, interpret=True)
    got = banded.unpack_interleaved(got.reshape(n, F), r)
    np.testing.assert_allclose(np.asarray(got), a.T @ ct, rtol=1e-5, atol=1e-5)


def test_gpu_composition_with_halo_rows():
    # inside shard_map the head/tail rows come from the ppermute halo
    n_dev, m_loc, r, F = 4, 32, 4, 8
    offsets = (1, -1, 6, -6)
    n = n_dev * m_loc * r
    rng = np.random.default_rng(3)
    xg = rng.normal(size=(n, F)).astype(np.float32)
    pg = np.asarray(banded.pack_interleaved(jnp.asarray(xg), r))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("graph",))

    def local(x):
        p = x[0].reshape(m_loc, r * F)
        pre, post = banded._halo_wrap(p, 6, F, "graph")
        y = banded._gpu_shift_sum(p, pre, post, offsets=offsets,
                                  interpret=True)
        return y.reshape(1, m_loc * r, F)

    out = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("graph"),), out_specs=P("graph"),
        check_vma=False,
    ))(jnp.asarray(pg.reshape(n_dev, m_loc * r, F)))
    got = banded.unpack_interleaved(jnp.asarray(out).reshape(n, F), r)
    ref = banded.banded_spmm_reference(jnp.asarray(xg), offsets)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_block_rows_power_of_two():
    for width, rows in ((128, 64), (256, 32), (16, 512), (3, 2048),
                        (24, 256), (20000, 1)):
        assert block_rows(width) == rows


@pytest.mark.gpu
def test_kernel_route_compiled_on_card(gpu):
    """On the card the unit op lowers to the kernel and matches the XLA
    window sum at the giant trainer's packed shape."""
    m, r, F = 1_250_304, 8, 16
    offsets = (1, -1, 9, -9, 33, -33, 63, -63)
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(0), (m * r, F)), gpu
    )
    fn = jax.jit(lambda z: banded.banded_spmm_unit_packed(z, offsets, r))
    assert "banded_stream" in fn.lower(x).as_text()
    window_sum = jax.jit(lambda a, b, c: banded._window_sum(a, offsets, b, c))
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 2.0 ** -8)):
        xd = x.astype(dtype)                  # materialized stream values
        got = fn(xd).astype(jnp.float32).reshape(m, r * F)
        p = xd.astype(jnp.float32).reshape(m, r * F)
        ref = window_sum(p, *banded._local_wrap(p, 63, F))
        # the bf16 output is the f32 sum rounded once: half a bf16 ulp
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=tol, atol=1e-5)
