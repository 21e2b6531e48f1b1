"""Single-device giant-graph training: 10M-node circulant regular graph.

BASELINE.json config[4] scale on ONE device: the circulant structure keeps
everything banded, so both GCN convs use the banded SpMM
(``ops.banded.banded_spmm_unit``), the cut loss reduces to
``E − ½⟨S, A S⟩`` (one more banded SpMM), and the whole epoch — forward,
STE, loss, backward, Adam — is a single jit with no host transfers except
the scalar loss.  Memory at n=10M, dim=32: embedding + Adam ≈ 3.8 GB,
activations a few GB.

For the node-sharded version of the same computation see
``parallel/giant_banded.py`` (halo exchange).
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.ops.banded import banded_spmm_unit, banded_spmm_unit_packed
from gcn_maxcut.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut.utils.logging import get_logger
from gcn_maxcut.utils.profiling import memory_stats

logger = get_logger(__name__)


def banded_gcn_conv(params, x, offsets, degree):
    """GraphConv (norm='both') on an exactly-regular circulant graph.

    Aggregates on the narrower side of the projection, like DGL.
    """
    norm = 1.0 / jnp.sqrt(float(degree))
    in_f, out_f = params["w"].shape
    h = x * norm
    if out_f < in_f:
        h = h @ params["w"]
        h = banded_spmm_unit(h, offsets)
    else:
        h = banded_spmm_unit(h, offsets)
        h = h @ params["w"]
    return h * norm + params["b"]


def train_banded_giant(
    n: int = 10_002_432,
    d: int = 8,
    dim_embedding: int = 32,
    hidden_dim: int = 16,
    num_classes: int = 3,
    learning_rate: float = 1e-3,
    epochs: int = 50,
    epochs_per_call: int = 10,
    bandwidth: int = 63,
    seed: int = 0,
) -> Dict[str, float]:
    """Train the 2-layer banded GCN on one device; returns cut + edges/s."""
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    offsets = tuple(int(o) for s in half for o in (s, -s))
    e_undirected = n * d // 2

    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    params = {
        "conv1": gcn_conv_init(k1, dim_embedding, hidden_dim),
        "conv2": gcn_conv_init(k2, hidden_dim, num_classes),
        "embed": jax.random.normal(k3, (n, dim_embedding), jnp.float32) * 0.1,
    }
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(params)

    def loss_fn(params):
        h = banded_gcn_conv(params["conv1"], params["embed"], offsets, d)
        h = jax.nn.relu(h)
        h = banded_gcn_conv(params["conv2"], h, offsets, d)
        probs = jax.nn.softmax(h, axis=-1)
        onehot = ste_argmax_onehot(pin_terminals(probs))
        # cut = E - ½·Σ_i <s_i, (A s)_i>  for unit weights
        same = jnp.vdot(onehot, banded_spmm_unit(onehot, offsets))
        return -(e_undirected - 0.5 * same)

    @jax.jit
    def steps(params, opt_state, _):
        def body(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=epochs_per_call
        )
        return params, opt_state, losses

    # first chunk compiles; the host fetch of the losses waits for it
    t0 = time.perf_counter()
    params, opt_state, losses = steps(params, opt_state, None)
    history = [float(x) for x in np.asarray(losses)]
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    done = epochs_per_call
    # always time at least one steady-state chunk (epochs <= epochs_per_call
    # would otherwise report a ~0-second epoch)
    while done < epochs or done == epochs_per_call:
        params, opt_state, losses = steps(params, opt_state, None)
        history += [float(x) for x in np.asarray(losses)]  # hard sync
        done += epochs_per_call
    steady = time.perf_counter() - t0
    timed_epochs = max(1, done - epochs_per_call)
    epoch_time = steady / timed_epochs

    final_cut = -history[-1]
    res = {
        "n": n,
        "d": d,
        "edges": e_undirected,
        "epochs": done,
        "compile_time_s": compile_time,
        "epoch_time_s": epoch_time,
        # 2 convs + loss ≈ 3 SpMM fwd + 2 bwd per epoch over E directed edges
        "edges_per_s_per_epoch": n * d / epoch_time,
        "initial_cut": -history[0],
        "final_cut": final_cut,
        "cut_fraction": final_cut / e_undirected,
    }
    logger.info(
        "banded giant n=%d d=%d: epoch %.3fs (%.2e edges/s), cut %.3g/%.3g (%.1f%%)",
        n, d, epoch_time, res["edges_per_s_per_epoch"],
        final_cut, e_undirected, 100 * res["cut_fraction"],
    )
    return res


# ---- wide interleaved-layout variant ------------------------------------
#
# This variant keeps every array in the interleaved node order of
# ``ops.banded.banded_spmm_unit_packed`` and carries the wide [m, r·F]
# shape everywhere, so narrow logical widths (16 hidden, 3 classes) become
# r·16-lane rows:
#
#   * GEMMs run as [m, r·F_in] @ kron(I_r, W): r× redundant FLOPs in a
#     memory-bound epoch;
#   * per-node ops (softmax over classes, STE argmax, terminal pinning)
#     become group-of-16-lane ops via reshape reductions + repeat;
#   * classes are padded 3 -> 16 with a lane mask.
#
# Node identity: position p = j·r + u is node u·m + j; terminals are the
# nodes at positions 0, 1, 2 (i.e. nodes {0, m, 2m} — any 3 distinct nodes
# are a valid terminal set, and the cut objective is order-agnostic).

G = 16                                   # lane-group width (classes padded)


def _group_max(h, r):
    """[m, r·G] -> [m, r]: max over each G-lane group."""
    return h.reshape(h.shape[0], r, G).max(axis=-1)


def _group_sum(h, r):
    """[m, r·G] -> [m, r]: f32 sum over each G-lane group (exact; no
    matmul, so no reduced-precision rounding of softmax denominators)."""
    s = h.reshape(h.shape[0], r, G).sum(axis=-1, dtype=jnp.float32)
    return s.astype(h.dtype)


def _bcast(g):
    """[m, r] -> [m, r·G]: repeat each group value over its lanes."""
    return jnp.repeat(g, G, axis=1)


def train_banded_giant_packed(
    n: int = 10_002_432,
    d: int = 8,
    dim_embedding: int = 32,
    hidden_dim: int = 16,
    num_classes: int = 3,
    learning_rate: float = 1e-3,
    epochs: int = 50,
    epochs_per_call: int = 10,
    bandwidth: int = 63,
    r: int = 8,
    seed: int = 0,
    agg_dtype="bfloat16",
    act_dtype=None,
    mu_dtype="bfloat16",
    return_assignment: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int | None = None,
    resume_from: str | None = None,
) -> Dict[str, float]:
    """10M-node banded training with every array in interleaved order and
    every aggregation on the packed banded SpMM.  Same objective/optimizer
    as ``train_banded_giant``.

    ``agg_dtype="bfloat16"`` (default): stream the three per-epoch
    aggregations (and their backward passes) as bf16, halving their
    bytes; sums stay f32, only the streamed values are bf16-rounded (~3
    decimal digits).  Cut quality matched f32 at 10M nodes (93.55% vs
    93.56% after 40 epochs); ``agg_dtype=None`` keeps f32 streams.

    ``mu_dtype="bfloat16"`` (default): Adam's first moment in bf16
    (93.57% vs 93.55% cut at 40 epochs, 10M nodes).

    ``act_dtype="bfloat16"`` (opt-in): run the whole activation pipeline
    (GEMMs, softmax/STE head, cotangents) in bf16 with f32 parameters,
    f32 matmul accumulation and an f32 loss reduction.  The rounding slows
    convergence (90.7% cut at 40 epochs vs f32's 93.6%, 94.1% at 60,
    95.2% at 80), so f32 stays the default."""
    if hidden_dim != G or dim_embedding % G:
        raise ValueError("packed demo expects hidden_dim=16, emb % 16 == 0")
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    act = jnp.dtype(act_dtype if act_dtype is not None else jnp.float32)
    m = n // r
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    offsets = tuple(int(o) for s in half for o in (s, -s))
    e_undirected = n * d // 2
    inv_d = 1.0 / d

    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    params = {
        "conv1": gcn_conv_init(k1, dim_embedding, G),
        "conv2": gcn_conv_init(k2, G, G),   # classes padded 3 -> 16
        "embed": jax.random.normal(
            k3, (m, r * dim_embedding), jnp.float32) * 0.1,
    }
    optimizer = optax.adam(
        learning_rate,
        mu_dtype=None if mu_dtype is None else jnp.dtype(mu_dtype),
    )
    opt_state = optimizer.init(params)

    lane = jax.lax.broadcasted_iota(jnp.int32, (1, r * G), 1)
    class_ok = (lane % G < num_classes).astype(act)              # [1, r*G]
    # terminals: positions 0..k-1 (row 0, lane groups 0..k-1) pinned to
    # class == their own group index
    grp = lane // G
    term_cols = (grp < num_classes).astype(act)                  # [1, r*G]
    term_onehot = ((lane % G) == grp).astype(act) * term_cols
    eye_r = jnp.eye(r, dtype=jnp.float32)

    def spmm(h):
        # wide in, wide out; (m, L) -> (n, L/r) view only inside the op
        L = h.shape[1]
        hh = h.reshape(n, L // r)
        if agg_dtype is not None and act == jnp.float32:
            hh = hh.astype(agg_dtype)
        out = banded_spmm_unit_packed(hh, offsets, r)
        return out.astype(act).reshape(m, L)

    def loss_fn(params):
        k1w = jnp.kron(eye_r, params["conv1"]["w"]).astype(act)
        k2w = jnp.kron(eye_r, params["conv2"]["w"]).astype(act)
        b1 = jnp.tile(params["conv1"]["b"], r).astype(act)
        b2 = jnp.tile(params["conv2"]["b"], r).astype(act)
        h = params["embed"].astype(act) @ k1w
        h = spmm(h) * act.type(inv_d) + b1
        h = jax.nn.relu(h)
        h = h @ k2w
        h = spmm(h) * act.type(inv_d) + b2
        # masked group softmax over the k classes in each 16-lane group
        # (max is shift-invariant -> stop_gradient)
        gmax = jax.lax.stop_gradient(
            _bcast(_group_max(h + (class_ok - 1.0) * 1e9, r))
        )
        e = jnp.exp(h - gmax) * class_ok
        probs = e / _bcast(_group_sum(e, r))
        # terminal pinning (row 0, groups 0..k-1), straight-through
        row0 = jnp.zeros((m, 1), act).at[0, 0].set(1.0)
        is_term = row0 * term_cols
        pinned_hard = is_term * term_onehot + (1.0 - is_term) * probs
        pinned = jax.lax.stop_gradient(pinned_hard - probs) + probs
        # straight-through group argmax (hard path carries no gradient)
        hard = jax.lax.stop_gradient(
            (pinned >= _bcast(_group_max(pinned, r))).astype(act)
            * class_ok
        )
        onehot = jax.lax.stop_gradient(hard - pinned) + pinned
        # f32 reduction: the cut is ~4e7, far past bf16 resolution
        same = jnp.vdot(
            onehot.astype(jnp.float32), spmm(onehot).astype(jnp.float32)
        )
        return -(e_undirected - 0.5 * same)

    @jax.jit
    def steps(params, opt_state, _):
        def body(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=epochs_per_call
        )
        return params, opt_state, losses

    history = []
    start_done = 0
    if resume_from is not None:
        from gcn_maxcut.train.checkpoint import load_checkpoint

        params, opt_state, _, meta = load_checkpoint(
            resume_from, params, opt_state
        )
        params = jax.tree_util.tree_map(jnp.asarray, params)
        start_done = int(meta["epoch"])
        history = list(meta["loss_history"])
        logger.info("resumed %s at epoch %d", resume_from, start_done)
        if start_done >= epochs:
            raise ValueError(
                f"checkpoint already at epoch {start_done} >= epochs={epochs}"
            )

    def _save(tag_epoch):
        from gcn_maxcut.train.checkpoint import save_checkpoint

        save_checkpoint(
            checkpoint_path,
            params=jax.device_get(params),
            opt_state=jax.device_get(opt_state),
            epoch=tag_epoch,
            loss_history=history,
        )
        logger.info("checkpoint @ epoch %d -> %s", tag_epoch, checkpoint_path)

    t0 = time.perf_counter()
    steps = steps.lower(params, opt_state, None).compile()
    params, opt_state, losses = steps(params, opt_state, None)
    history += [float(x) for x in np.asarray(losses)]
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    done = start_done + epochs_per_call
    # always time at least one steady-state chunk (epochs <= epochs_per_call
    # would otherwise report a ~0-second epoch); resumed runs train exactly
    # to `epochs` so resume reproduces the uninterrupted trajectory
    while done < epochs or (start_done == 0 and done == epochs_per_call):
        params, opt_state, losses = steps(params, opt_state, None)
        history += [float(x) for x in np.asarray(losses)]  # hard sync
        done += epochs_per_call
        if checkpoint_path is not None and checkpoint_every is not None:
            iv = max(epochs_per_call,
                     (checkpoint_every // epochs_per_call) * epochs_per_call)
            if done % iv == 0 and done < epochs:
                _save(done)
    steady = time.perf_counter() - t0
    timed_epochs = max(1, done - start_done - epochs_per_call)
    epoch_time = steady / timed_epochs
    if checkpoint_path is not None:
        _save(done)

    final_cut = -history[-1]
    res = {
        "n": n,
        "d": d,
        "edges": e_undirected,
        "epochs": done,
        "compile_time_s": compile_time,
        "epoch_time_s": epoch_time,
        "edges_per_s_per_epoch": n * d / epoch_time,
        "initial_cut": -history[0],
        "final_cut": final_cut,
        "cut_fraction": final_cut / e_undirected,
        "layout": "packed",
        "offsets": list(offsets),
        "step_memory": memory_stats(steps),
    }
    if return_assignment:
        # decode once: forward to pinned probs, group argmax, then map
        # position p = j*r + u back to node u*m + j (transpose)
        @jax.jit
        def _decode(params):
            k1w = jnp.kron(eye_r, params["conv1"]["w"])
            k2w = jnp.kron(eye_r, params["conv2"]["w"])
            b1 = jnp.tile(params["conv1"]["b"], r)
            b2 = jnp.tile(params["conv2"]["b"], r)
            h = params["embed"] @ k1w
            h = spmm(h) * inv_d + b1
            h = jax.nn.relu(h)
            h = h @ k2w
            h = spmm(h) * inv_d + b2
            gmax = _bcast(_group_max(h + (class_ok - 1.0) * 1e9, r))
            e = jnp.exp(h - gmax) * class_ok
            probs = e / _bcast(_group_sum(e, r))
            row0 = jnp.zeros((m, 1), jnp.float32).at[0, 0].set(1.0)
            is_term = row0 * term_cols
            pinned = is_term * term_onehot + (1.0 - is_term) * probs
            masked = jnp.where(class_ok > 0, pinned, -jnp.inf)
            cls = jnp.argmax(masked.reshape(m, r, G), axis=-1)  # [m, r]
            return cls.T.reshape(n).astype(jnp.int32)           # node-major

        res["assignment"] = np.asarray(_decode(params))
    logger.info(
        "packed giant n=%d d=%d: epoch %.3fs (%.2e edges/s), cut %.3g/%.3g (%.1f%%)",
        n, d, epoch_time, res["edges_per_s_per_epoch"],
        final_cut, e_undirected, 100 * res["cut_fraction"],
    )
    return res
