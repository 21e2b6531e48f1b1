"""Banded (circulant) SpMM, on one device and node-sharded over a mesh.

Graphs with *locality* — circulant benchmark graphs from
``data.generate.regular_graph_on_device``, or any graph reordered by
BFS/RCM/METIS into a band (``parallel.partition``) — have neighbor offsets
bounded by a bandwidth ``W``:

    y[i] = Σ_k  w[i, k] · x[(i + o_k) mod n]        |o_k| ≤ W.

The op is a memory-bound stencil: D shifted row slices of the window
``[pre; x; post]``, where ``pre``/``post`` are the W rows that precede row 0
and follow row n-1 of the circulant.  Sums accumulate in f32 whatever the
stream dtype.  On the GPU the unit-weight stream runs the Pallas kernel of
``ops/banded_triton.py`` (one read of x, one write of y; XLA's fusion of the
same slices reached less than half the bytes/s of a copy, see PERF.md), and
only the first and last W output rows — the ones that read wrap rows — are
recomputed here from ``[3W, L]`` tiles.  On other platforms, and for the
weighted op, XLA fuses the slices and the multiply-adds.

On one device the wrap rows come from the array's own ends.  Node-sharded
(inside ``shard_map``, global node i on shard i // n_shard), they come from
the ring neighbors by two ``lax.ppermute`` calls — the halo exchange — and
the wrap between the last and the first shard closes the circulant.  A
one-device mesh wraps onto itself, so the same code serves any mesh size.

Interleaved ("packed") order serves narrow feature widths: node u·m + j is
stored at position j·r + u (r nodes per packed row, m = n/r rows).  The
packed ``[m, r·F]`` view turns every node shift o into a row shift by o;
only the W wrap rows at each end have their F-lane groups rotated by one
group.  GEMMs, elementwise ops, softmax, STE and the cut objective are all
row-wise, so a whole training pipeline can live in interleaved order
(``bench/giant_demo.py``, ``parallel/giant_banded.py``);
:func:`pack_interleaved`/:func:`unpack_interleaved` convert at the
boundaries.

Gradients: the transpose of Σ_k S_{o_k} is Σ_k S_{-o_k}, so the backward of
the unit-weight ops is the same op with negated offsets (self-adjoint for
the symmetric ±o shift sets this framework builds).  The weighted op is
differentiated by autodiff.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from gcn_maxcut.ops.banded_triton import banded_stream


def _bandwidth(offsets: Sequence[int], rows: int) -> int:
    W = int(max(abs(o) for o in offsets))
    if W > rows:
        raise ValueError(f"bandwidth {W} exceeds the {rows} rows it shifts")
    return W


def _slice_sum(win, offsets, W, rows, w=None):
    """Σ_k [w_k ·] win[W + o_k : W + o_k + rows], summed in f32."""
    acc = jnp.zeros((rows, win.shape[1]), jnp.float32)
    for k, o in enumerate(offsets):
        t = win[W + o : W + o + rows].astype(jnp.float32)
        acc = acc + (t if w is None else w[:, k : k + 1] * t)
    return acc


def _window_sum(p, offsets, pre, post, w=None):
    """Σ_k [w_k ·] win[W + o_k : W + o_k + m]  over  win = [pre; p; post]."""
    win = jnp.concatenate([pre, p, post], axis=0)
    return _slice_sum(win, offsets, pre.shape[0], p.shape[0], w)


def _gpu_shift_sum(p, pre, post, *, offsets, interpret=False):
    """Unit-weight window sum: the kernel for every row, then the first and
    last W rows (the ones that read ``pre``/``post``) recomputed exactly
    from the rows within W of them."""
    W, m = pre.shape[0], p.shape[0]
    y = banded_stream(p, offsets, interpret)
    k = max(0, 2 * W - m)          # shards shorter than 2W reach past p
    head = jnp.concatenate([pre, p[: 2 * W], post[:k]])
    tail = jnp.concatenate([pre[W - k :], p[max(0, m - 2 * W) :], post])
    y = y.at[:W].set(_slice_sum(head, offsets, W, W).astype(y.dtype))
    return y.at[m - W :].set(_slice_sum(tail, offsets, W, W).astype(y.dtype))


def _unit_shift_sum(p, pre, post, offsets):
    return jax.lax.platform_dependent(
        p, pre, post,
        cuda=functools.partial(_gpu_shift_sum, offsets=offsets),
        default=lambda p, pre, post: _window_sum(
            p, offsets, pre, post
        ).astype(p.dtype),
    )


def _local_wrap(p, W, F):
    """Wrap rows of a single-device circulant: the last W rows precede row
    0 and the first W rows follow row m-1, lane groups rotated by F (the
    identity when F spans the whole row)."""
    m = p.shape[0]
    return jnp.roll(p[m - W :], F, axis=1), jnp.roll(p[:W], -F, axis=1)


def _halo_wrap(p, W, F, axis_name):
    """Halo rows of a node-sharded circulant: the left neighbor's last W
    rows and the right neighbor's first W rows.  The global wrap (last
    shard <-> shard 0) rotates lane groups by F on the sender."""
    n_dev = jax.lax.axis_size(axis_name)
    my = jax.lax.axis_index(axis_name)
    up = p[p.shape[0] - W :]
    up = jnp.where(my == n_dev - 1, jnp.roll(up, F, axis=1), up)
    pre = jax.lax.ppermute(
        up, axis_name, [(j, (j + 1) % n_dev) for j in range(n_dev)]
    )
    down = p[:W]
    down = jnp.where(my == 0, jnp.roll(down, -F, axis=1), down)
    post = jax.lax.ppermute(
        down, axis_name, [(j, (j - 1) % n_dev) for j in range(n_dev)]
    )
    return pre, post


def _unit_packed(x, offsets, r, axis_name):
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    p = x.reshape(n // r, r * F)
    W = _bandwidth(offsets, p.shape[0])
    if axis_name is None:
        pre, post = _local_wrap(p, W, F)
    else:
        pre, post = _halo_wrap(p, W, F, axis_name)
    return _unit_shift_sum(p, pre, post, offsets).reshape(n, F)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _unit_packed_vjp(x, offsets, r, axis_name):
    return _unit_packed(x, offsets, r, axis_name)


def _unit_packed_fwd(x, offsets, r, axis_name):
    return _unit_packed(x, offsets, r, axis_name), None


def _unit_packed_bwd(offsets, r, axis_name, _, dy):
    neg = tuple(-o for o in offsets)
    return (_unit_packed(dy, neg, r, axis_name),)


_unit_packed_vjp.defvjp(_unit_packed_fwd, _unit_packed_bwd)


def banded_spmm_unit(x: jnp.ndarray, offsets: tuple[int, ...]) -> jnp.ndarray:
    """y[i] = Σ_k x[(i + o_k) mod n]  — unit edge weights, no weight table.

    The memory-lean path for exactly-regular circulant graphs (a [n, D]
    weight table would cost n·D·4 bytes for constant 1s).  Accepts f32 or
    bf16 ``x`` (output dtype follows input; bf16 halves the bytes streamed
    while the sum stays f32).  Backward is the same op with negated
    offsets.
    """
    return _unit_packed_vjp(x, tuple(offsets), 1, None)


def banded_spmm_unit_packed(
    x: jnp.ndarray, offsets: tuple[int, ...], r: int
) -> jnp.ndarray:
    """Unit-weight circulant SpMM on arrays stored in interleaved node
    order (:func:`pack_interleaved`): y_pos(i) = Σ_k x_pos((i + o_k) mod n).

    Row shifts of the packed ``[n/r, r·F]`` view plus lane-rotated wrap
    rows; backward is the same op with negated offsets.
    """
    return _unit_packed_vjp(x, tuple(offsets), r, None)


def banded_spmm(
    x: jnp.ndarray, w: jnp.ndarray, offsets: tuple[int, ...]
) -> jnp.ndarray:
    """y[i] = Σ_k w[i, k] · x[(i + o_k) mod n]  (weighted circulant SpMM).

    ``x``: [n, F] f32 features; ``w``: [n, D] per-row shift weights (zeros
    mask padded rows).  Differentiable in x and w by autodiff.
    """
    if x.dtype != jnp.float32:
        raise ValueError("weighted banded_spmm takes f32 features")
    W = _bandwidth(offsets, x.shape[0])
    pre, post = _local_wrap(x, W, x.shape[1])
    return _window_sum(x, tuple(offsets), pre, post, w)


def banded_spmm_reference(
    x: jnp.ndarray, offsets: Sequence[int], w: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Plain reference: Σ_k [w_k ·] roll(x, -o_k) in x's dtype."""
    out = jnp.zeros_like(x)
    for k, o in enumerate(offsets):
        t = jnp.roll(x, -o, axis=0)
        out = out + (t if w is None else w[:, k : k + 1] * t)
    return out


def pack_interleaved(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """Reorder nodes so node u·m + j lands at position j·r + u (m = n/r)."""
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    m = n // r
    return x.reshape(r, m, F).transpose(1, 0, 2).reshape(n, F)


def unpack_interleaved(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """Inverse of :func:`pack_interleaved`."""
    n, F = x.shape
    m = n // r
    return x.reshape(m, r, F).transpose(1, 0, 2).reshape(n, F)


# ---- node-sharded (halo exchange) variants: call inside shard_map --------


def halo_banded_spmm(
    x: jnp.ndarray,
    w: jnp.ndarray,
    offsets: tuple[int, ...],
    axis_name: str = "graph",
) -> jnp.ndarray:
    """Node-sharded weighted banded SpMM.  ``x``: this shard's
    ``[n_shard, F]`` rows; ``w``: its ``[n_shard, D]`` weights.  Requires
    ``W ≤ n_shard``.  Differentiable by autodiff (``ppermute`` transposes to
    the reverse permutation)."""
    W = _bandwidth(offsets, x.shape[0])
    pre, post = _halo_wrap(x, W, x.shape[1], axis_name)
    return _window_sum(x, tuple(offsets), pre, post, w).astype(x.dtype)


def halo_banded_spmm_unit(
    x: jnp.ndarray, offsets: tuple[int, ...], axis_name: str = "graph"
) -> jnp.ndarray:
    """Node-sharded unit-weight banded SpMM; backward is the same halo op
    with negated offsets."""
    return _unit_packed_vjp(x, tuple(offsets), 1, axis_name)


def halo_banded_spmm_unit_packed(
    x: jnp.ndarray,
    offsets: tuple[int, ...],
    r: int,
    axis_name: str = "graph",
) -> jnp.ndarray:
    """Node-sharded unit-weight SpMM on interleaved-packed arrays.

    ``x``: this shard's [n_loc, F] rows in interleaved position order; the
    global packed [m, r·F] matrix is row-sharded contiguously, so shard c
    holds positions [c·n_loc, (c+1)·n_loc).
    """
    return _unit_packed_vjp(x, tuple(offsets), r, axis_name)
