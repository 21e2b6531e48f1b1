"""Multi-device giant banded-graph training with the halo-exchange SpMM.

BASELINE config[4] as one program: a circulant/banded regular graph
node-sharded contiguously across the mesh, every SpMM (two GCN convs, the
cut loss's A·S product, and all their backward passes via the symmetric
custom VJP) running the halo-exchange banded SpMM (``ops/banded.py``):
each shard's W boundary rows travel to its ring neighbors by
``lax.ppermute``.  The other collectives are the scalar ``psum`` of the
loss and the reduction of the conv gradients.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcn_maxcut.bench.giant_demo import G, _bcast, _group_max, _group_sum
from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.ops.banded import (
    halo_banded_spmm_unit,
    halo_banded_spmm_unit_packed,
)
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.utils.logging import get_logger
from gcn_maxcut.utils.profiling import memory_stats

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class HaloGiantConfig:
    d: int = 8
    num_classes: int = 3
    dim_embedding: int = 128
    hidden_dim: int = 128
    learning_rate: float = 1e-3
    epochs: int = 40
    epochs_per_call: int = 10
    bandwidth: int = 63
    seed: int = 0
    axis: str = "graph"


def _halo_conv(params, x, offsets, degree, axis):
    """GraphConv (norm='both') with the halo SpMM doing the aggregation,
    on the narrower side of the projection like DGL."""
    norm = 1.0 / jnp.sqrt(float(degree))
    in_f, out_f = params["w"].shape
    h = x * norm
    if out_f < in_f:
        h = h @ params["w"]
        h = halo_banded_spmm_unit(h, offsets, axis)
    else:
        h = halo_banded_spmm_unit(h, offsets, axis)
        h = h @ params["w"]
    return h * norm + params["b"]


def make_halo_giant_step(
    mesh: Mesh, offsets: tuple[int, ...], config: HaloGiantConfig,
    optimizer: optax.GradientTransformation, n_shard: int,
):
    axis = config.axis
    k = config.num_classes

    def local_step(conv_params, embed, opt_state):
        x = embed[0]                                     # [n_shard, F]

        def loss_fn(conv_params, embed_rows):
            h = _halo_conv(
                conv_params["conv1"], embed_rows, offsets, config.d, axis
            )
            h = jax.nn.relu(h)
            h = _halo_conv(conv_params["conv2"], h, offsets, config.d, axis)
            probs = jax.nn.softmax(h, axis=-1)
            # terminal pinning on shard 0 rows 0..k-1 + STE argmax
            my = jax.lax.axis_index(axis)
            rows = jnp.arange(probs.shape[0])[:, None]
            cols = jnp.arange(k)[None, :]
            onehot_rows = (rows == cols).astype(probs.dtype)
            is_term = ((rows < k) & (my == 0)).astype(probs.dtype)
            pinned = is_term * onehot_rows + (1.0 - is_term) * probs
            pinned = jax.lax.stop_gradient(pinned - probs) + probs
            hard = jax.nn.one_hot(jnp.argmax(pinned, -1), k, dtype=probs.dtype)
            s = jax.lax.stop_gradient(hard - pinned) + pinned
            # cut = E_total − ½·Σ ⟨s, A s⟩ ; A s via the halo SpMM too
            same = jnp.vdot(s, halo_banded_spmm_unit(s, offsets, axis))
            same = jax.lax.psum(same, axis)
            n_total = n_shard * jax.lax.psum(1, axis)
            e_total = n_total * config.d / 2.0
            return -(e_total - 0.5 * same)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            conv_params, x
        )
        conv_grads = jax.lax.pmean(grads[0], axis)
        updates, opt_state = optimizer.update(
            (conv_grads, grads[1][None]), opt_state, (conv_params, embed)
        )
        conv_params, embed = optax.apply_updates((conv_params, embed), updates)
        return conv_params, embed, opt_state, loss

    def chunk(conv_params, embed, opt_state):
        def body(carry, _):
            conv_params, embed, opt_state = carry
            conv_params, embed, opt_state, loss = local_step(
                conv_params, embed, opt_state
            )
            return (conv_params, embed, opt_state), loss

        (conv_params, embed, opt_state), losses = jax.lax.scan(
            body, (conv_params, embed, opt_state), None,
            length=config.epochs_per_call,
        )
        return conv_params, embed, opt_state, losses

    def opt_state_specs(opt_state):
        # adam moments for the embedding are [D, n_shard, F] (sharded);
        # everything else (conv moments, counts) is replicated
        return jax.tree_util.tree_map(
            lambda a: P(config.axis) if getattr(a, "ndim", 0) == 3 else P(),
            opt_state,
        )

    def build(opt_state):
        return jax.jit(
            jax.shard_map(
                chunk,
                mesh=mesh,
                in_specs=(P(), P(config.axis), opt_state_specs(opt_state)),
                out_specs=(
                    P(), P(config.axis), opt_state_specs(opt_state), P(),
                ),
                check_vma=False,
            )
        )

    return build


# ---- packed interleaved-order multi-device trainer ------------------------
#
# The node-sharded analog of ``bench.giant_demo.train_banded_giant_packed``:
# every array lives in the interleaved node order of
# ``ops.banded.banded_spmm_unit_packed`` and carries the wide [m_loc, r·F]
# shape through the whole epoch, so all three aggregations (two convs + the
# cut loss's A·S) run the packed halo SpMM
# (``ops.banded.halo_banded_spmm_unit_packed``).  GEMMs run as kron(I_r, W);
# group softmax/argmax/pinning are reshape reductions + masks exactly as in
# the single-device trainer.
#
# Gradient formulation: the loss the grads flow through is the PER-SHARD
# slice -(E_loc - ½⟨s_loc, (A s)_loc⟩); summing it over shards is the
# global objective, and the packed halo SpMM's symmetric custom VJP
# imports neighbor cotangents in the backward, so each shard's autodiff
# gradient is exactly its slice of the global gradient — no psum inside
# the differentiated region (under check_vma=False the transpose of psum
# is psum again, which would scale cotangents by the device count).
# Conv-weight gradients are therefore combined with psum (sum of true
# per-shard contributions), and the scalar loss is psum'd only for
# reporting.


@dataclasses.dataclass(frozen=True)
class PackedHaloGiantConfig:
    d: int = 8
    num_classes: int = 3
    dim_embedding: int = 32
    learning_rate: float = 1e-3
    epochs: int = 40
    epochs_per_call: int = 10
    bandwidth: int = 63
    r: int = 8                      # interleave factor (nodes per row)
    seed: int = 0
    axis: str = "graph"
    # dtypes as in the single-device trainer (bench.giant_demo.
    # train_banded_giant_packed): bf16 aggregation streams with f32 sums,
    # bf16 Adam first moment, f32 activations; None = f32
    agg_dtype: str | None = "bfloat16"
    mu_dtype: str | None = "bfloat16"
    act_dtype: str | None = None


def make_packed_halo_step(
    mesh: Mesh, offsets: tuple[int, ...], config: PackedHaloGiantConfig,
    optimizer: optax.GradientTransformation, m_shard: int,
):
    """Builds the jitted shard_map chunk step for the packed halo trainer.

    ``m_shard``: packed rows per device (n_shard = m_shard * r nodes).
    """
    axis = config.axis
    k = config.num_classes
    r = config.r
    if k > G or k > r:
        raise ValueError(f"need num_classes <= {min(G, r)}")
    if config.dim_embedding % G:
        raise ValueError("dim_embedding must be a multiple of 16")
    inv_d = 1.0 / config.d

    act = jnp.dtype(
        config.act_dtype if config.act_dtype is not None else jnp.float32
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, r * G), 1)
    class_ok = (lane % G < k).astype(act)                        # [1, r*16]
    grp = lane // G
    term_cols = (grp < k).astype(act)
    term_onehot = ((lane % G) == grp).astype(act) * term_cols
    eye_r = jnp.eye(r, dtype=jnp.float32)

    def local_step(conv_params, embed, opt_state):
        wide = embed[0]                                 # [m_shard, r*emb]
        n_loc = m_shard * r
        e_local = n_loc * config.d / 2.0

        def spmm(h):
            L = h.shape[1]
            hh = h.reshape(n_loc, L // r)
            if config.agg_dtype is not None and act == jnp.float32:
                hh = hh.astype(config.agg_dtype)
            out = halo_banded_spmm_unit_packed(hh, offsets, r, axis)
            return out.astype(act).reshape(m_shard, L)

        def loss_fn(conv_params, wide_rows):
            k1w = jnp.kron(eye_r, conv_params["conv1"]["w"]).astype(act)
            k2w = jnp.kron(eye_r, conv_params["conv2"]["w"]).astype(act)
            b1 = jnp.tile(conv_params["conv1"]["b"], r).astype(act)
            b2 = jnp.tile(conv_params["conv2"]["b"], r).astype(act)
            h = wide_rows.astype(act) @ k1w
            h = spmm(h) * act.type(inv_d) + b1
            h = jax.nn.relu(h)
            h = h @ k2w
            h = spmm(h) * act.type(inv_d) + b2
            # masked group softmax (max is shift-invariant -> stop_gradient)
            gmax = jax.lax.stop_gradient(
                _bcast(_group_max(h + (class_ok - 1.0) * 1e9, r))
            )
            e = jnp.exp(h - gmax) * class_ok
            probs = e / _bcast(_group_sum(e, r))
            # terminals: global packed row 0 (shard 0), lane groups 0..k-1
            my = jax.lax.axis_index(axis)
            row0 = (
                (jnp.arange(m_shard)[:, None] == 0) & (my == 0)
            ).astype(act)
            is_term = row0 * term_cols
            pinned_hard = is_term * term_onehot + (1.0 - is_term) * probs
            pinned = jax.lax.stop_gradient(pinned_hard - probs) + probs
            hard = jax.lax.stop_gradient(
                (pinned >= _bcast(_group_max(pinned, r))).astype(act)
                * class_ok
            )
            onehot = jax.lax.stop_gradient(hard - pinned) + pinned
            # f32 reduction (cut ~ n*d/2, beyond bf16 resolution)
            same = jnp.vdot(
                onehot.astype(jnp.float32), spmm(onehot).astype(jnp.float32)
            )
            return -(e_local - 0.5 * same)

        loss_loc, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            conv_params, wide
        )
        conv_grads = jax.lax.psum(grads[0], axis)       # true global sum
        updates, opt_state = optimizer.update(
            (conv_grads, grads[1][None]), opt_state, (conv_params, embed)
        )
        conv_params, embed = optax.apply_updates((conv_params, embed), updates)
        return conv_params, embed, opt_state, jax.lax.psum(loss_loc, axis)

    def chunk(conv_params, embed, opt_state):
        def body(carry, _):
            conv_params, embed, opt_state = carry
            conv_params, embed, opt_state, loss = local_step(
                conv_params, embed, opt_state
            )
            return (conv_params, embed, opt_state), loss

        (conv_params, embed, opt_state), losses = jax.lax.scan(
            body, (conv_params, embed, opt_state), None,
            length=config.epochs_per_call,
        )
        return conv_params, embed, opt_state, losses

    def opt_state_specs(opt_state):
        return jax.tree_util.tree_map(
            lambda a: P(config.axis) if getattr(a, "ndim", 0) == 3 else P(),
            opt_state,
        )

    def build(opt_state):
        return jax.jit(
            jax.shard_map(
                chunk,
                mesh=mesh,
                in_specs=(P(), P(config.axis), opt_state_specs(opt_state)),
                out_specs=(
                    P(), P(config.axis), opt_state_specs(opt_state), P(),
                ),
                check_vma=False,
            )
        )

    return build


def train_halo_giant_packed(
    n_shard: int,
    config: PackedHaloGiantConfig = PackedHaloGiantConfig(),
    mesh: Mesh | None = None,
) -> Dict[str, Any]:
    """Multi-device giant banded training with every aggregation on the
    packed halo SpMM.

    ``n_shard`` nodes per device; requires ``n_shard % r == 0``.  Uses the
    same parameter shapes, init keys and objective as the single-device
    ``bench.giant_demo.train_banded_giant_packed`` (hidden = 16 lanes,
    classes padded 3 -> 16), so loss histories are directly comparable.
    """
    mesh = mesh or make_mesh((config.axis,))
    n_dev = int(np.prod(mesh.devices.shape))
    if n_shard % config.r:
        raise ValueError(f"n_shard={n_shard} must be a multiple of r={config.r}")
    n = n_shard * n_dev
    m_shard = n_shard // config.r
    rng = np.random.default_rng(config.seed)
    half = rng.choice(
        np.arange(1, config.bandwidth + 1), size=config.d // 2, replace=False
    )
    offsets = tuple(int(o) for s in half for o in (s, -s))

    key = jax.random.PRNGKey(config.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    conv_params = {
        "conv1": gcn_conv_init(k1, config.dim_embedding, G),
        "conv2": gcn_conv_init(k2, G, G),
    }
    # same global init as the single-device packed demo, then row-sharded
    embed = jax.random.normal(
        k3, (n // config.r, config.r * config.dim_embedding), jnp.float32
    ) * 0.1
    embed = embed.reshape(n_dev, m_shard, config.r * config.dim_embedding)
    embed = jax.device_put(embed, NamedSharding(mesh, P(config.axis)))
    optimizer = optax.adam(
        config.learning_rate,
        mu_dtype=None if config.mu_dtype is None
        else jnp.dtype(config.mu_dtype),
    )
    opt_state = optimizer.init((conv_params, embed))

    step = make_packed_halo_step(mesh, offsets, config, optimizer, m_shard)(
        opt_state
    ).lower(conv_params, embed, opt_state).compile()

    t0 = time.perf_counter()
    history = []
    done = 0
    while done < config.epochs:
        conv_params, embed, opt_state, losses = step(
            conv_params, embed, opt_state
        )
        history += [float(x) for x in np.asarray(losses)]
        done += config.epochs_per_call
    total = time.perf_counter() - t0

    e_total = n * config.d // 2
    res = {
        "n": n,
        "num_devices": n_dev,
        "edges": e_total,
        "epochs": done,
        "initial_cut": -history[0],
        "final_cut": -history[-1],
        "cut_fraction": -history[-1] / e_total,
        "total_time_s": total,
        "layout": "packed",
        "step_memory": memory_stats(step),
    }
    logger.info(
        "packed halo giant n=%d over %d devices: cut %.3g/%.3g (%.1f%%) in %.1fs",
        n, n_dev, res["final_cut"], e_total, 100 * res["cut_fraction"], total,
    )
    return res


def train_halo_giant(
    n_shard: int,
    config: HaloGiantConfig = HaloGiantConfig(),
    mesh: Mesh | None = None,
) -> Dict[str, Any]:
    """Train on an (n_shard × D_devices)-node banded regular graph."""
    mesh = mesh or make_mesh((config.axis,))
    n_dev = int(np.prod(mesh.devices.shape))
    n = n_shard * n_dev
    rng = np.random.default_rng(config.seed)
    half = rng.choice(
        np.arange(1, config.bandwidth + 1), size=config.d // 2, replace=False
    )
    offsets = tuple(int(o) for s in half for o in (s, -s))

    key = jax.random.PRNGKey(config.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    conv_params = {
        "conv1": gcn_conv_init(k1, config.dim_embedding, config.hidden_dim),
        "conv2": gcn_conv_init(k2, config.hidden_dim, config.num_classes),
    }
    embed = jax.random.normal(
        k3, (n_dev, n_shard, config.dim_embedding), jnp.float32
    ) * 0.1
    embed = jax.device_put(embed, NamedSharding(mesh, P(config.axis)))
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init((conv_params, embed))

    step = make_halo_giant_step(mesh, offsets, config, optimizer, n_shard)(
        opt_state
    )

    t0 = time.perf_counter()
    history = []
    done = 0
    while done < config.epochs:
        conv_params, embed, opt_state, losses = step(
            conv_params, embed, opt_state
        )
        history += [float(x) for x in np.asarray(losses)]
        done += config.epochs_per_call
    total = time.perf_counter() - t0

    e_total = n * config.d // 2
    res = {
        "n": n,
        "num_devices": n_dev,
        "edges": e_total,
        "epochs": done,
        "initial_cut": -history[0],
        "final_cut": -history[-1],
        "cut_fraction": -history[-1] / e_total,
        "total_time_s": total,
    }
    logger.info(
        "halo giant n=%d over %d devices: cut %.3g/%.3g (%.1f%%) in %.1fs",
        n, n_dev, res["final_cut"], e_total, 100 * res["cut_fraction"], total,
    )
    return res
