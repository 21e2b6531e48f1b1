"""Pallas kernel (Triton route) for the unit-weight banded stream.

On a ``[m, L]`` array it computes y[j] = Σ_k p[j + o_k], where a row
index that falls outside ``[0, m)`` contributes zero.  ``ops.banded`` adds
the wrap (or halo) rows by recomputing the first and last W output rows.

One program per block of rows.  For each offset the program loads the
shifted ``[block, L]`` rows under a mask that drops rows past either end of
the array, and stores its block of y in one dense write; rows ±W apart overlap between offsets and between neighboring
blocks, so they come from L1/L2 and device memory sees about one read of
``p`` and one write of ``y``.  Sums are f32 whatever the stream dtype.
The block is a power of two sized so that a block holds ~8K elements (the
best of 32/64/128 rows at L=128 and L=256 on an H100).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLOCK_ELEMS = 8192


def _stream_kernel(x_ref, o_ref, *, offsets, m, width, block):
    rows = pl.program_id(0) * block + jnp.arange(block)
    lanes = jnp.arange(o_ref.shape[1])[None, :]
    if o_ref.shape[1] == width:
        # plain iota columns keep the loads contiguous (vectorized)
        cols, lane_ok = lanes, True
    else:
        cols, lane_ok = jnp.minimum(lanes, width - 1), lanes < width
    acc = None
    for o in offsets:
        q = rows + o
        ok = ((q >= 0) & (q < m))[:, None] & lane_ok
        v = plgpu.load(
            x_ref.at[jnp.clip(q, 0, m - 1)[:, None], cols], mask=ok, other=0
        ).astype(jnp.float32)
        acc = v if acc is None else acc + v
    o_ref[...] = acc.astype(o_ref.dtype)


def block_rows(width: int) -> int:
    """Rows per program: a power of two with ~_BLOCK_ELEMS elements."""
    return max(1, _BLOCK_ELEMS // pl.next_power_of_2(width))


def banded_stream(
    p: jnp.ndarray, offsets: tuple[int, ...], interpret: bool = False
) -> jnp.ndarray:
    """y[j] = Σ_k p[j + o_k] over rows inside ``[0, m)`` (zero outside).

    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests); production calls compile it for the GPU."""
    m, width = p.shape
    block = block_rows(width)
    lanes = pl.next_power_of_2(width)
    grid = pl.cdiv(m, block)
    # the output is padded to whole blocks and lanes (a no-op slice at the
    # trainers' shapes), so every program stores one dense, unmasked block
    y = pl.pallas_call(
        functools.partial(
            _stream_kernel, offsets=tuple(offsets), m=m, width=width,
            block=block,
        ),
        out_shape=jax.ShapeDtypeStruct((grid * block, lanes), p.dtype),
        grid=(grid,),
        in_specs=[pl.no_block_spec],
        out_specs=pl.BlockSpec((block, lanes), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="banded_stream",
    )(p)
    return y[:m, :width]
