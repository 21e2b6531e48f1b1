"""Giant-graph training: one node-sharded graph across the mesh.

BASELINE.json configs[3..4]: a single large regular graph (100k .. 10M
nodes) with k-way terminals, trained with embedding-table features (the
adjacency-as-features quirk is infeasible at this scale — the embedding is
the reference's own `nn.Embedding` in its intended role).  Everything runs
inside one ``shard_map``-ed jit step:

  * features: per-shard embedding rows ``[n_shard, F]`` (sharded, trained);
  * 2× ``sharded_gcn_conv`` with the ring halo-exchange SpMM (ppermute
    overlap) + softmax head;
  * terminal pinning on the owning shard (terminals are global nodes
    0..k-1, which the contiguous partition places on shard 0);
  * straight-through argmax + the relaxed cut loss evaluated directly on
    the sharded edge groups with a second feature ring (``sharded_cut``);
  * conv grads ``psum``-replicated, embedding grads stay sharded; one Adam
    step per epoch.

The same step compiles for any mesh size (tests use the virtual 8-device
CPU mesh; several GPUs or hosts just change the mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.parallel.partition import (
    ShardedGraph,
    local_shard,
    shard_graph,
    shard_specs,
)
from gcn_maxcut.parallel.spmm import make_sharded_spmm, sharded_gcn_conv
from gcn_maxcut.utils.logging import get_logger
from gcn_maxcut.utils.profiling import memory_stats

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class GiantConfig:
    num_classes: int = 3
    dim_embedding: int = 128
    hidden_dim: int = 64
    learning_rate: float = 1e-3
    number_epochs: int = 200
    schedule: str = "ring"           # ring | allgather
    seed: int = 0
    log_every: int = 20
    epochs_per_call: int = 1         # >1 scans epochs inside one jit
                                     # (one host round-trip per chunk)
    partition: str = "contiguous"    # contiguous | bfs | metis (node->shard)
    local_reorder: str = "off"       # off | rcm (band each shard's local
                                     # subgraph; see partition.shard_graph)


def sharded_cut(
    sg_shard: ShardedGraph,
    s: jnp.ndarray,
    axis_name: str = "graph",
) -> jnp.ndarray:
    """Relaxed cut Σ_E w·(1 − ⟨s_u, s_v⟩)/2 on sharded edge groups.

    Same ring schedule as the SpMM: hop h scores the edge group whose
    senders live h shards away, while ppermute ships the next hop's rows.
    Returns the full-graph scalar (psum'd).
    """
    num_shards = jax.lax.psum(1, axis_name)
    perm = [(i, (i - 1) % num_shards) for i in range(num_shards)]

    total = jnp.zeros(())
    buf = s
    for h in range(num_shards):
        nxt = jax.lax.ppermute(buf, axis_name, perm) if h + 1 < num_shards else buf
        su = buf[sg_shard.senders[h]]                    # [e_group, k]
        sv = s[sg_shard.receivers[h]]
        same = jnp.sum(su * sv, axis=-1)
        w = sg_shard.weights[h] * sg_shard.edge_mask[h]
        total = total + jnp.sum(w * (sg_shard.edge_mask[h] - same * sg_shard.edge_mask[h]))
        buf = nxt
    return jax.lax.psum(total, axis_name) / 2.0


def _pin_and_ste(probs: jnp.ndarray, axis_name: str, k: int) -> jnp.ndarray:
    """Terminal pinning (shard 0 rows 0..k-1) + straight-through argmax."""
    my = jax.lax.axis_index(axis_name)
    rows = jnp.arange(probs.shape[0])[:, None]
    cols = jnp.arange(k)[None, :]
    onehot_rows = (rows == cols).astype(probs.dtype)
    is_term = ((rows < k) & (my == 0)).astype(probs.dtype)
    pinned = is_term * onehot_rows + (1.0 - is_term) * probs
    pinned = jax.lax.stop_gradient(pinned - probs) + probs
    hard = jax.nn.one_hot(jnp.argmax(pinned, axis=-1), k, dtype=probs.dtype)
    return jax.lax.stop_gradient(hard - pinned) + pinned


def make_giant_step(
    sg: ShardedGraph,
    mesh: Mesh,
    config: GiantConfig,
    optimizer: optax.GradientTransformation,
    axis: str = "graph",
    opt_state: Any = None,
    params: Tuple[Any, jnp.ndarray] | None = None,
    dynamic_epochs: bool = False,
):
    """jit(chunk): ``epochs_per_call`` full forward/backward/Adam updates
    scanned INSIDE one shard_map (no host round-trips between epochs).

    ``opt_state`` (an initialized state) is needed to derive its sharding
    specs: the embedding's Adam moments are [num_shards, n_shard, F] and
    must travel sharded like the embedding itself — a replicated ``P()``
    spec would broadcast the update to the wrong shape (latent in the
    original per-epoch version, exposed by the in-map scan's carry-shape
    check).  Returns ``chunk(conv_params, embed, opt_state) ->
    (conv_params, embed, opt_state, losses[epochs_per_call])``.

    ``dynamic_epochs=True`` instead returns ``chunk(conv_params, embed,
    opt_state, k)`` where ``k`` is a *traced* epoch count driving a
    ``fori_loop`` (lowers to while_loop) — ONE executable serves every k,
    so timing with two chunk lengths does not pay a double compile.
    Per-epoch losses can't
    have a dynamic length, so it returns only the final scalar loss.
    """
    K = max(1, config.epochs_per_call)

    def local_chunk(conv_params, embed, opt_state, k, sg_dev):
        sgl = local_shard(sg_dev)

        def loss_fn(conv_params, embed):
            h = sharded_gcn_conv(
                conv_params["conv1"]["w"], conv_params["conv1"]["b"],
                sgl, embed[0], axis, config.schedule,
            )
            h = jax.nn.relu(h)
            h = sharded_gcn_conv(
                conv_params["conv2"]["w"], conv_params["conv2"]["b"],
                sgl, h, axis, config.schedule,
            )
            probs = jax.nn.softmax(h, axis=-1)
            onehot = _pin_and_ste(probs, axis, config.num_classes)
            from gcn_maxcut.parallel.spmm import sharded_cut_edgeform

            return -sharded_cut_edgeform(sgl, onehot, axis, config.schedule)

        def body(carry, _):
            conv_params, embed, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
                conv_params, embed
            )
            conv_grads = jax.lax.pmean(grads[0], axis)
            updates, opt_state = optimizer.update(
                (conv_grads, grads[1]), opt_state, (conv_params, embed)
            )
            conv_params, embed = optax.apply_updates(
                (conv_params, embed), updates
            )
            return (conv_params, embed, opt_state), loss

        if dynamic_epochs:
            carry, loss = jax.lax.fori_loop(
                0, k,
                lambda _, c: body(c[0], None),
                ((conv_params, embed, opt_state), jnp.zeros(())),
            )
            conv_params, embed, opt_state = carry
            return conv_params, embed, opt_state, loss
        (conv_params, embed, opt_state), losses = jax.lax.scan(
            body, (conv_params, embed, opt_state), None, length=K
        )
        return conv_params, embed, opt_state, losses

    if opt_state is None:
        raise ValueError("make_giant_step needs the initialized opt_state "
                         "to derive its sharding specs")
    if params is None:
        raise ValueError("make_giant_step needs the (conv_params, embed) "
                         "example to derive opt-state sharding structurally")
    # derive opt-state specs STRUCTURALLY: any opt_state subtree that
    # mirrors the param tree (Adam mu/nu, any future per-param state)
    # inherits the param specs; everything else (counts) is replicated.
    # Rank-based sniffing mis-shards a hypothetical 3-D conv-side leaf.
    param_specs = (
        jax.tree_util.tree_map(lambda _: P(), params[0]),
        P(axis),
    )
    param_td = jax.tree_util.tree_structure(params)

    def opt_specs(tree):
        is_param_like = (
            lambda sub: jax.tree_util.tree_structure(sub) == param_td
        )
        return jax.tree_util.tree_map(
            lambda sub: (
                param_specs
                if is_param_like(sub)
                else jax.tree_util.tree_map(lambda _: P(), sub)
            ),
            tree,
            is_leaf=is_param_like,
        )

    smapped = jax.shard_map(
        local_chunk,
        mesh=mesh,
        in_specs=(
            P(), P(axis), opt_specs(opt_state), P(), shard_specs(sg, axis)
        ),
        out_specs=(P(), P(axis), opt_specs(opt_state), P()),
        check_vma=False,
    )
    if dynamic_epochs:
        return jax.jit(lambda c, e, o, k: smapped(c, e, o, jnp.int32(k), sg))
    return jax.jit(lambda c, e, o: smapped(c, e, o, jnp.int32(K), sg))


def decode_assignment(
    sg: ShardedGraph,
    mesh: Mesh,
    config: GiantConfig,
    conv_params: Any,
    embed: jnp.ndarray,
    axis: str = "graph",
) -> np.ndarray:
    """One sharded forward -> per-node argmax class, in SHARDED layout
    ``[num_shards, n_shard]`` (map back to global node order with the
    ``global_to_local`` array from ``shard_graph``).  Same pinning
    semantics as the training step (shard 0 rows 0..k-1)."""

    def local_fwd(conv_params, embed, sg_dev):
        sgl = local_shard(sg_dev)
        h = sharded_gcn_conv(
            conv_params["conv1"]["w"], conv_params["conv1"]["b"],
            sgl, embed[0], axis, config.schedule,
        )
        h = jax.nn.relu(h)
        h = sharded_gcn_conv(
            conv_params["conv2"]["w"], conv_params["conv2"]["b"],
            sgl, h, axis, config.schedule,
        )
        probs = jax.nn.softmax(h, axis=-1)
        onehot = _pin_and_ste(probs, axis, config.num_classes)
        return jnp.argmax(onehot, axis=-1).astype(jnp.int32)[None]

    fn = jax.jit(
        jax.shard_map(
            local_fwd,
            mesh=mesh,
            in_specs=(P(), P(axis), shard_specs(sg, axis)),
            out_specs=P(axis),
            check_vma=False,
        )
    )
    return np.asarray(fn(conv_params, embed, sg))


def measure_epoch_time(
    sg: ShardedGraph,
    mesh: Mesh,
    config: GiantConfig,
    optimizer: optax.GradientTransformation,
    params: Tuple[Any, jnp.ndarray],
    opt_state: Any,
    k_hi: int = 20,
    k_lo: int = 5,
    reps: int = 3,
    axis: str = "graph",
) -> Dict[str, float]:
    """Variance-controlled per-epoch seconds for the sharded trainer.

    The chunk-loop wall clock in :func:`train_giant_graph` includes one
    host round-trip per chunk.  This uses the repo's amortized method
    (``utils/timing.scan_timeit`` semantics): chunks of ``k_hi`` and
    ``k_lo`` epochs run through ONE
    dynamic-k executable (``dynamic_epochs=True`` — a while_loop over a
    traced epoch count, so the two lengths share a single compile);
    best-of-``reps`` wall times are differenced so the per-call RTT and
    dispatch overhead cancel exactly.  Returns per-epoch seconds plus the
    raw spread so run variance is visible.

    With noisy timings a small ``reps`` can yield min(t_hi) < min(t_lo);
    rather than clamping to an absurd throughput, that case returns
    ``epoch_time_s = NaN`` with ``reliable = False`` — callers must check.
    """
    conv_params, embed = params
    step = make_giant_step(
        sg, mesh, config, optimizer, axis, opt_state, params=params,
        dynamic_epochs=True,
    )
    _, _, _, loss = step(conv_params, embed, opt_state, k_lo)  # compile
    float(np.asarray(loss))
    times: Dict[int, list] = {}
    for k in (k_hi, k_lo):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, _, _, loss = step(conv_params, embed, opt_state, k)
            float(np.asarray(loss))                            # hard sync
            ts.append(time.perf_counter() - t0)
        times[k] = ts
    diff = min(times[k_hi]) - min(times[k_lo])
    reliable = diff > 0
    per_epoch = diff / (k_hi - k_lo) if reliable else float("nan")
    if not reliable:
        logger.warning(
            "measure_epoch_time: min(t_hi)=%.4fs <= min(t_lo)=%.4fs with "
            "reps=%d — measurement unreliable (timing variance); returning "
            "NaN. Raise reps or k_hi-k_lo.",
            min(times[k_hi]), min(times[k_lo]), reps,
        )
    return {
        "epoch_time_s": per_epoch,
        "reliable": reliable,
        "k_hi": k_hi,
        "k_lo": k_lo,
        "reps": reps,
        "spread_hi_s": max(times[k_hi]) - min(times[k_hi]),
        "spread_lo_s": max(times[k_lo]) - min(times[k_lo]),
        "best_hi_s": min(times[k_hi]),
        "method": "amortized in-jit chunk difference (best-of-reps, "
                  "single dynamic-k executable)",
    }


def train_giant_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n: int,
    config: GiantConfig = GiantConfig(),
    mesh: Mesh | None = None,
    axis: str = "graph",
    measure_throughput: bool = False,
    return_assignment: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int | None = None,
    resume_from: str | None = None,
) -> Dict[str, Any]:
    """End-to-end: partition -> sharded training -> decoded cut value.

    ``measure_throughput``: additionally run :func:`measure_epoch_time`
    (amortized in-jit, RTT-cancelling) and report ``edges_per_s_amortized``
    + spread.
    ``return_assignment``: additionally decode the trained model once
    (:func:`decode_assignment`) and return ``assignment`` in GLOBAL node
    order — the input to classical refinement / at-scale baseline tables.

    ``checkpoint_path``/``checkpoint_every``/``resume_from``: at-scale
    failure recovery (SURVEY §5.3/§5.4 for the giant configs): the full
    (conv params, sharded embedding, Adam state) pytree saves as the same
    portable flattened-``.npz`` the reference-scale loop uses
    (``train/checkpoint.py``), every ``checkpoint_every`` epochs (rounded
    to chunk boundaries) and at the end; ``resume_from`` restores and
    continues — chunk-aligned resume reproduces the uninterrupted
    trajectory exactly (deterministic scanned epochs).  Checkpoints are
    written at 10M-node scale too (embedding 1.3 GB; ~seconds of host
    IO).
    """
    if config.number_epochs < 1:
        raise ValueError(
            f"number_epochs must be >= 1, got {config.number_epochs}"
        )
    mesh = mesh or make_mesh((axis,))
    num_shards = int(np.prod(mesh.devices.shape))
    owner = None
    if config.partition == "bfs":
        from gcn_maxcut.parallel.partition import partition_nodes_bfs

        owner = partition_nodes_bfs(senders, receivers, n, num_shards)
    elif config.partition == "metis":
        from gcn_maxcut.parallel.partition import partition_nodes_metis

        owner = partition_nodes_metis(senders, receivers, n, num_shards)
    elif config.partition != "contiguous":
        raise ValueError(f"unknown partition {config.partition!r}")
    sg, g2l = shard_graph(
        senders, receivers, n, num_shards, owner=owner,
        local_reorder=config.local_reorder,
    )
    n_shard = sg.n_shard

    key = jax.random.PRNGKey(config.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    conv_params = {
        "conv1": gcn_conv_init(k1, config.dim_embedding, config.hidden_dim),
        "conv2": gcn_conv_init(k2, config.hidden_dim, config.num_classes),
    }
    embed = jax.random.normal(
        k3, (num_shards, n_shard, config.dim_embedding), jnp.float32
    )
    embed = jax.device_put(embed, NamedSharding(mesh, P(axis)))
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init((conv_params, embed))

    history = []
    epoch = 0
    if resume_from is not None:
        from gcn_maxcut.train.checkpoint import load_checkpoint

        conv_params, opt_state, embed_h, meta = load_checkpoint(
            resume_from, conv_params, opt_state, embed
        )
        embed = jax.device_put(
            jnp.asarray(embed_h), NamedSharding(mesh, P(axis))
        )
        epoch = int(meta["epoch"])
        history = list(meta["loss_history"])
        logger.info("resumed %s at epoch %d", resume_from, epoch)

    step = make_giant_step(
        sg, mesh, config, optimizer, axis, opt_state,
        params=(conv_params, embed),
    ).lower(conv_params, embed, opt_state).compile()

    def _save(tag_epoch, losses_hist):
        from gcn_maxcut.train.checkpoint import save_checkpoint

        save_checkpoint(
            checkpoint_path,
            params=conv_params,
            opt_state=opt_state,
            embed=jax.device_get(embed),
            epoch=tag_epoch,
            loss_history=losses_hist,
        )
        logger.info("checkpoint @ epoch %d -> %s", tag_epoch, checkpoint_path)

    t0 = time.perf_counter()
    steady_t0 = None
    chunk_losses = None
    K = max(1, config.epochs_per_call)
    # chunks are fixed-size (scan length is static); total epochs round up
    # to a multiple of epochs_per_call, like the giant_demo trainers
    if config.number_epochs % K:
        logger.info(
            "number_epochs=%d rounds up to %d (epochs_per_call=%d chunks)",
            config.number_epochs, -(-config.number_epochs // K) * K, K,
        )
    while epoch < config.number_epochs:
        conv_params, embed, opt_state, losses = step(
            conv_params, embed, opt_state
        )
        chunk_losses = np.asarray(losses)      # hard sync per chunk
        if steady_t0 is None:
            steady_t0 = time.perf_counter()    # first chunk paid the compile
        for j in range(K):
            if (epoch + j) % config.log_every == 0:
                lf = float(chunk_losses[j])
                history.append(lf)
                logger.info(
                    "giant epoch %d: loss %.1f (cut %.0f)", epoch + j, lf, -lf
                )
        epoch += K
        if checkpoint_path is not None and checkpoint_every is not None:
            interval = max(K, (checkpoint_every // K) * K)  # chunk-aligned
            if epoch % interval == 0 and epoch < config.number_epochs:
                _save(epoch, history)
    final_loss = (
        float(chunk_losses[-1]) if chunk_losses is not None
        else (history[-1] if history else float("nan"))
    )  # a resume at/past number_epochs runs no chunks
    if checkpoint_path is not None:
        _save(epoch, history)
    train_time = time.perf_counter() - t0

    e_directed = int(senders.shape[0])
    if epoch > K:
        # steady-state throughput: excludes the first chunk's jit compile
        edges_per_s = e_directed * (epoch - K) / (time.perf_counter() - steady_t0)
    else:
        edges_per_s = e_directed * epoch / train_time  # single chunk: incl. compile
    timed = {}
    if measure_throughput:
        m = measure_epoch_time(
            sg, mesh, config, optimizer,
            params=(conv_params, embed), opt_state=opt_state, axis=axis,
        )
        timed = {
            "edges_per_s_amortized": e_directed / m["epoch_time_s"],
            "epoch_time_s_amortized": m["epoch_time_s"],
            "timing_reliable": m["reliable"],
            "timing_spread_s": m["spread_hi_s"],
            "timing_method": m["method"],
        }
    extra = {}
    if return_assignment:
        sharded_asn = decode_assignment(
            sg, mesh, config, conv_params, embed, axis
        )
        owner, local_ix = g2l // n_shard, g2l % n_shard
        extra["assignment"] = sharded_asn[owner, local_ix]
    return {
        **timed,
        **extra,
        "final_loss": final_loss,
        "final_cut": -final_loss,
        "total_edges": e_directed // 2,
        "loss_history": history,
        "train_time_s": train_time,
        "epochs": epoch,
        "edges_per_s": edges_per_s,
        "num_shards": num_shards,
        "step_memory": memory_stats(step),
    }
