"""Training orchestration: one jit-compiled, scanned epoch; host-side control.

Accelerator-native redesign of the reference's training stack
(``Training/TrainingNeural.py``):

  * ``train_single_epoch`` (:341-390) — a Python loop doing one forward/
    backward/Adam step per graph — becomes ``make_epoch_fn``: a single jit
    whose ``lax.scan`` carries (params, opt_state) across the stacked graph
    batch, performing the same per-graph optimizer step semantics with zero
    host round-trips inside an epoch.
  * the loss chain forward -> ``override_fixed_nodes`` ->
    ``apply_max_to_one_hot`` -> ``compute_loss`` (:371-386) maps to
    ``gcn_softmax_apply`` -> ``pin_terminals`` -> ``ste_argmax_onehot`` ->
    ``objectives.compute_loss``.
  * ``train_model`` (:392-484) — epoch loop, early stopping (patience on
    non-improving / plateaued cumulative loss), best-state tracking and
    restore, periodic + final checkpoints — is reproduced line of intent by
    line of intent on the host, with only one scalar device->host transfer
    per epoch.
  * adjacency-as-features (the reference's load-bearing quirk, SURVEY.md
    §2.3) is built on device from the sparse container each step; the
    embedding table is created, optimized, and checkpointed exactly like the
    reference's unused ``nn.Embedding`` (``:332,359,456``), and is the real
    feature source in ``feature_mode="embedding"``.

Optimizer: optax Adam with torch defaults (b1=0.9, b2=0.999, eps=1e-8),
matching ``torch.optim.Adam`` in ``setup_model_and_optimizer`` (:336-337).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from gcn_maxcut.core.graph import Graph, dense_adjacency, pad_graph_batch
from gcn_maxcut.data.process import ProcessedDataset
from gcn_maxcut.models.gcn import (
    embedding_init,
    gcn_softmax_apply,
    gcn_softmax_init,
)
from gcn_maxcut.objectives.cut_loss import (
    compute_loss,
    quantile_cut_loss,
    terminal_independence_penalty,
)
from gcn_maxcut.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut.train.checkpoint import checkpoint_name, save_checkpoint
from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainState:
    params: Any                 # {"conv1": .., "conv2": .., "embed": ..}
    opt_state: Any
    config: TrainingConfig
    optimizer: optax.GradientTransformation


def setup_train_state(
    config: TrainingConfig, steps_per_epoch: int = 1
) -> TrainState:
    """Model + embedding + single Adam over both (reference :311-339).

    In adjacency-feature mode the embedding receives no gradients (it is
    created, checkpointed, but unused in the forward pass — the reference's
    quirk, SURVEY.md §2.3).  torch's Adam skips params with ``grad=None``,
    so the reference never pays optimizer traffic for it; ``optax.masked``
    reproduces that (and saves ~3× the table size in HBM traffic per graph
    step).  In embedding mode the table trains normally.

    ``steps_per_epoch``: optimizer steps per epoch (the graph count in
    ``per_graph`` step mode), used to size the cosine horizon when
    ``config.lr_schedule == "cosine"``.
    """
    key = jax.random.PRNGKey(config.seed)
    k_model, k_embed = jax.random.split(key)
    params = gcn_softmax_init(
        k_model, config.dim_embedding, config.hidden_dim, config.number_classes
    )
    params["embed"] = embedding_init(k_embed, config.n_nodes, config.dim_embedding)
    if config.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(
            config.learning_rate,
            decay_steps=max(1, config.number_epochs * steps_per_epoch),
            alpha=config.lr_final_fraction,
        )
    else:
        lr = config.learning_rate
    adam = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    if config.feature_mode == "adjacency":
        optimizer = optax.masked(
            adam, {"conv1": True, "conv2": True, "embed": False}
        )
    else:
        optimizer = adam
    opt_state = optimizer.init(params)
    return TrainState(params, opt_state, config, optimizer)


def _embed_rows(embed: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    """Fit the (n_nodes, dim) embedding table to the graph's n_pad rows."""
    n_table = embed.shape[0]
    if n_pad <= n_table:
        return embed[:n_pad]
    return jnp.pad(embed, ((0, n_pad - n_table), (0, 0)))


def _resolve_dense_aggregation(
    aggregation: str, n_pad: int, n_graphs: int = 1
) -> bool:
    """Trace-time choice of the aggregation backend.

    ``aggregation`` is the ``TrainingConfig.aggregation`` policy string
    ("auto" | "dense" | "sparse").  "dense" turns neighborhood aggregation
    into an ``n_pad x n_pad`` matmul (and, in adjacency-feature mode,
    reuses that matrix as the node features with ``W1`` contracted over its
    first ``n_pad`` rows — the remaining feature columns are identically
    zero).  "auto" picks dense for small padded graphs where the densified
    batch stays well under the device-memory budget.
    """
    if aggregation == "dense":
        return True
    if aggregation == "sparse":
        return False
    return n_pad <= 2048 and n_graphs * n_pad * n_pad <= (1 << 27)


def _graph_loss(
    params: Any,
    g: Graph,
    config: TrainingConfig,
    dropout_rng: jax.Array,
    a_mask: jnp.ndarray | None = None,
    a_feat: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reference loss chain for one graph (``TrainingNeural.py:371-381``).

    ``a_mask``/``a_feat``: optional pre-densified unweighted adjacency
    (aggregation operator) and weighted adjacency (feature matrix), hoisted
    out of the epoch scan by ``make_epoch_fn`` on the dense path.  The
    feature matrix is ``[n_pad, min(n_pad, dim_embedding)]``: columns past
    ``n_pad`` of the reference's ``n x max_nodes`` padded features are
    identically zero, so ``x @ W1 == a_feat @ W1[:width]`` exactly.
    """
    conv1 = params["conv1"]
    if config.feature_mode == "adjacency":
        if a_feat is not None:
            x = a_feat
            conv1 = dict(conv1, w=conv1["w"][: a_feat.shape[-1]])
        else:
            x = dense_adjacency(g, width=config.dim_embedding)
    else:
        x = _embed_rows(params["embed"], g.n_pad)
    probs = gcn_softmax_apply(
        {"conv1": conv1, "conv2": params["conv2"]},
        g,
        x,
        dropout=config.dropout,
        train=True,
        dropout_rng=dropout_rng,
        a_dense=a_mask,
    )
    pinned = pin_terminals(probs)
    if config.loss_mode == "quantile":
        # train on the sampled decode's best-of-N objective (mean + c·std)
        loss = quantile_cut_loss(g, pinned, c=config.quantile_c, C=config.C)
        if config.use_penalty:
            loss = loss + config.penalty * terminal_independence_penalty(
                pinned, 3
            )
    else:
        onehot = ste_argmax_onehot(pinned)
        loss = compute_loss(
            g,
            onehot,
            A=config.A,
            C=config.C,
            penalty=config.penalty if config.use_penalty else 0.0,
            num_terminals=3,
        )
    if config.entropy_weight:
        # Best-of-N sampled decode improves with sampling variance: reward
        # per-node entropy over real nodes (pinned terminals are one-hot and
        # contribute zero).  The STE cut term keeps the argmax good while
        # this term keeps the distribution around it diverse.
        ent = -jnp.sum(pinned * jnp.log(pinned + 1e-12), axis=-1)
        loss = loss - config.entropy_weight * jnp.sum(ent * g.node_mask)
    return loss


def make_epoch_fn(
    config: TrainingConfig, optimizer: optax.GradientTransformation
) -> Callable:
    """jit(epoch): scan per-graph Adam steps over the stacked dataset.

    Returns ``epoch_fn(params, opt_state, batch, rng) ->
    (params, opt_state, cumulative_loss)``.
    """

    def step(carry, inp):
        params, opt_state = carry
        g, key = inp["g"], inp["key"]
        loss, grads = jax.value_and_grad(_graph_loss)(
            params, g, config, key,
            inp.get("a_mask"), inp.get("a_feat"),
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    def _epoch_inputs(batch: Graph):
        """Per-chunk loop invariants: the densified adjacency operators are
        built ONCE per device call, outside both scans, and re-sliced per
        step — XLA will not hoist them across the nested scans on its own."""
        n_graphs = batch.n_nodes.shape[0]
        n_pad = batch.degrees.shape[-1]
        xs = {"g": batch}
        if _resolve_dense_aggregation(config.aggregation, n_pad, n_graphs):
            xs["a_mask"] = jax.vmap(
                lambda g: dense_adjacency(g, values="mask")
            )(batch)
            if config.feature_mode == "adjacency":
                width = min(n_pad, config.dim_embedding)
                xs["a_feat"] = jax.vmap(
                    lambda g: dense_adjacency(g, width=width)
                )(batch)
        return xs, n_graphs

    def run_epoch(params, opt_state, xs, n_graphs, key):
        """One epoch over the dataset; returns (params, opt_state, loss)."""
        keys = jax.random.split(key, n_graphs)
        if config.step_mode == "batched":
            # one Adam step per epoch: the whole batch runs in parallel
            # under vmap (batched GEMMs), gradients summed; "per_graph"
            # scans sequential steps
            # for exact reference-semantics parity.
            def total_loss(params):
                losses = jax.vmap(
                    lambda inp: _graph_loss(
                        params, inp["g"], config, inp["key"],
                        inp.get("a_mask"), inp.get("a_feat"),
                    )
                )({**xs, "key": keys})
                return jnp.sum(losses)

            loss, grads = jax.value_and_grad(total_loss)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss
        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), {**xs, "key": keys}
        )
        return params, opt_state, jnp.sum(losses)

    @partial(jax.jit, static_argnames=("num_epochs",))
    def epoch_fn(params, opt_state, batch: Graph, rng: jax.Array, num_epochs: int = 1):
        """Run ``num_epochs`` epochs in one device call; returns the
        per-epoch cumulative-loss vector.  num_epochs > 1 amortizes the
        host round-trip."""
        xs, n_graphs = _epoch_inputs(batch)

        def one_epoch(carry, key):
            params, opt_state = carry
            params, opt_state, loss = run_epoch(params, opt_state, xs, n_graphs, key)
            return (params, opt_state), loss

        keys = jax.random.split(rng, num_epochs)
        (params, opt_state), losses = jax.lax.scan(
            one_epoch, (params, opt_state), keys
        )
        return params, opt_state, losses

    epoch_fn.run_epoch = run_epoch
    epoch_fn.epoch_inputs = _epoch_inputs
    return epoch_fn


def init_early_stop_state(
    params: Any,
    best_loss: float = float("inf"),
    prev_loss: float = float("inf"),
    epoch: int = 0,
) -> Dict[str, Any]:
    """Device-side early-stopping/best-tracking state for
    :func:`make_monitored_epoch_fn`.  ``best_params`` starts as a copy of
    ``params`` (exactly what the reference would restore if no epoch ever
    improves — the warm-start params on resume)."""
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    return {
        "best_loss": big if best_loss == float("inf") else jnp.float32(best_loss),
        "prev_loss": big if prev_loss == float("inf") else jnp.float32(prev_loss),
        "patience": jnp.int32(0),
        "epoch": jnp.int32(epoch),
        "stopped": jnp.asarray(False),
        "best_params": jax.tree_util.tree_map(jnp.asarray, params),
    }


def make_monitored_epoch_fn(
    config: TrainingConfig, optimizer: optax.GradientTransformation
) -> Callable:
    """Chunked epochs with the reference's early-stop/best-restore semantics
    executed ON DEVICE, inside the epoch scan.

    Round-1 tracked "best params" at chunk granularity: with
    ``epochs_per_call = K > 1`` the restored model could be up to K-1
    optimizer steps past the true best epoch (the reference restores the
    exact best epoch, ``TrainingNeural.py:440-442``).  Here the scan carry
    holds ``(best_loss, best_params, prev_loss, patience, stopped)`` and
    replays the reference's per-epoch control flow exactly
    (``TrainingNeural.py:430-444``):

      * patience increments when the cumulative loss worsens or moves less
        than ``tolerance`` (only from epoch 1 on);
      * when patience trips, training stops AT that epoch — later epochs in
        the same chunk become frozen no-ops (``lax.cond`` skips their
        compute), so K=1 and K=8 runs produce bit-identical results;
      * the stopping epoch itself is not eligible for "best" (the reference
        breaks out of the loop before its best-tracking line).

    Returns ``chunk_fn(params, opt_state, es, batch, rng, num_epochs) ->
    (params, opt_state, es, losses, stopped_flags)`` where ``es`` comes from
    :func:`init_early_stop_state`.
    """
    base = make_epoch_fn(config, optimizer)
    run_epoch, epoch_inputs = base.run_epoch, base.epoch_inputs

    @partial(jax.jit, static_argnames=("num_epochs",))
    def chunk_fn(params, opt_state, es, batch: Graph, rng: jax.Array,
                 num_epochs: int = 1):
        xs, n_graphs = epoch_inputs(batch)

        def one_epoch(carry, key):
            params, opt_state, es = carry
            params, opt_state, loss = jax.lax.cond(
                es["stopped"],
                lambda p, o, k: (p, o, es["prev_loss"]),
                lambda p, o, k: run_epoch(p, o, xs, n_graphs, k),
                params, opt_state, key,
            )
            live = jnp.logical_not(es["stopped"])
            worse = (es["epoch"] > 0) & (
                (loss > es["prev_loss"])
                | (jnp.abs(es["prev_loss"] - loss) <= config.tolerance)
            )
            patience = jnp.where(
                live, jnp.where(worse, es["patience"] + 1, 0), es["patience"]
            )
            stop_now = live & (patience >= config.patience)
            is_best = live & ~stop_now & (loss < es["best_loss"])
            new_es = {
                "best_loss": jnp.where(is_best, loss, es["best_loss"]),
                "prev_loss": jnp.where(live, loss, es["prev_loss"]),
                "patience": patience,
                "epoch": es["epoch"] + live.astype(jnp.int32),
                "stopped": es["stopped"] | stop_now,
                "best_params": jax.tree_util.tree_map(
                    lambda new, old: jnp.where(is_best, new, old),
                    params, es["best_params"],
                ),
            }
            return (params, opt_state, new_es), (loss, new_es["stopped"])

        keys = jax.random.split(rng, num_epochs)
        (params, opt_state, es), (losses, stops) = jax.lax.scan(
            one_epoch, (params, opt_state, es), keys
        )
        return params, opt_state, es, losses, stops

    return chunk_fn


def train_model(
    dataset_batch: Graph,
    config: TrainingConfig,
    state: TrainState | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    resume_from: Optional[str] = None,
) -> Tuple[Any, float, int, jnp.ndarray, List[float]]:
    """Epoch loop with early stopping / best-restore / checkpoints.

    Mirrors reference ``train_model`` (:392-484) control flow; returns the
    same tuple shape ``(params, best_loss, final_epoch, embed, history)``.
    ``dataset_batch`` is the stacked `Graph` from `pad_graph_batch`.

    ``resume_from``: checkpoint path for warm-start/crash recovery (the
    reference's legacy ``train1`` warm-start, ``TrainingNeural_load.py:569``,
    plus full optimizer-state + epoch + history restoration).
    """
    n_graphs = int(dataset_batch.n_nodes.shape[0])
    state = state or setup_train_state(
        config,
        steps_per_epoch=n_graphs if config.step_mode == "per_graph" else 1,
    )
    chunk_fn = make_monitored_epoch_fn(config, state.optimizer)
    params, opt_state = state.params, state.opt_state

    loss_history: List[float] = []
    best_loss = float("inf")
    prev_loss = float("inf")
    start_epoch = 0
    if resume_from is not None:
        from gcn_maxcut.train.checkpoint import load_checkpoint

        params, opt_state, _, meta = load_checkpoint(
            resume_from, params, opt_state
        )
        loss_history = list(meta.get("loss_history") or [])
        start_epoch = int(meta.get("epoch", 0)) + 1
        if loss_history:
            prev_loss = loss_history[-1]
            best_loss = min(loss_history)
        logger.info(
            "resumed from %s at epoch %d (history %d)",
            resume_from, start_epoch, len(loss_history),
        )
    es = init_early_stop_state(
        params, best_loss=best_loss, prev_loss=prev_loss, epoch=start_epoch
    )
    rng = jax.random.PRNGKey(config.seed + 1)

    logger.info(
        "training: %d epochs, %d graphs, %d nodes, %d classes",
        config.number_epochs,
        int(dataset_batch.n_nodes.shape[0]),
        config.n_nodes,
        config.number_classes,
    )
    start = time.time()
    epoch = start_epoch
    stop = False
    K = max(1, config.epochs_per_call)
    while epoch < config.number_epochs and not stop:
        chunk = min(K, config.number_epochs - epoch)
        rng, sub = jax.random.split(rng)
        params, opt_state, es, losses, stops = chunk_fn(
            params, opt_state, es, dataset_batch, sub, num_epochs=chunk
        )
        chunk_losses = np.asarray(losses)
        chunk_stops = np.asarray(stops)

        for j in range(chunk):
            e = epoch + j
            cumulative_loss = float(chunk_losses[j])
            loss_history.append(cumulative_loss)

            if chunk_stops[j]:
                # early stop triggered AT epoch e (device-side patience);
                # epochs after j in this chunk were frozen no-ops
                logger.info("early stopping at epoch %d", e)
                epoch = e
                stop = True

            if e % config.save_frequency == 0:
                logger.info("epoch %d: cumulative loss %.6f", e, cumulative_loss)
                if config.save_directory:
                    save_checkpoint(
                        checkpoint_name(
                            config.save_directory, e, cumulative_loss
                        ),
                        params=params,
                        opt_state=opt_state,
                        epoch=e,
                        loss_history=loss_history,
                        config=config,
                    )
            if callback is not None:
                callback(e, cumulative_loss)
            if stop:
                break
        else:
            epoch += chunk

    best_loss = float(es["best_loss"])
    if best_loss >= float(jnp.finfo(jnp.float32).max):
        best_loss = float("inf")
    if loss_history:
        # exact-epoch best restore (reference ``TrainingNeural.py:440-442``)
        params = es["best_params"]

    final_epoch = len(loss_history) - 1
    logger.info(
        "training done in %.2fs, best loss %.6f", time.time() - start, best_loss
    )
    if config.save_directory:
        final = save_checkpoint(
            checkpoint_name(config.save_directory),
            params=params,
            opt_state=opt_state,
            epoch=final_epoch,
            loss_history=loss_history,
            config=config,
        )
        logger.info("final model saved to %s", final)

    return params, best_loss, final_epoch, params.get("embed"), loss_history


def train_dataset(
    dataset: ProcessedDataset,
    model_name: str | None = None,
    callback: Optional[Callable[[int, float], None]] = None,
    resume_from: Optional[str] = None,
    **config_kwargs,
) -> Tuple[Any, float, int, jnp.ndarray, List[float]]:
    """Convenience wrapper (reference ``train_from_pickle`` :486-513).

    Derives ``n_nodes`` (feature width) from the dataset's ``max_nodes``
    unless overridden.  ``callback``/``resume_from`` pass through to
    ``train_model`` (per-epoch metrics hook; checkpoint warm start).
    """
    params = {
        "n_nodes": dataset.config.max_nodes,
        "save_directory": model_name,
        **config_kwargs,
    }
    config = TrainingConfig(**params)
    batch = pad_graph_batch([dataset.graphs[k] for k in sorted(dataset.graphs)])
    return train_model(batch, config, callback=callback, resume_from=resume_from)


def train_from_files(
    dataset_paths: List[str],
    model_name: str | None = None,
    **config_kwargs,
) -> Tuple[Any, float, int, jnp.ndarray, List[float]]:
    """Train over several dataset files merged into one batch.

    Parity with the reference's multi-pickle streaming epoch
    (``train_single_epoch``'s ``dataset_files``, ``TrainingNeural.py:361-369``
    and the legacy ``run_gnn_training2`` 3-file loop,
    ``TrainingNeural_load.py:651-653``): datasets are loaded, re-padded to a
    common shape, and trained as one stacked batch (same per-graph step
    order; no host I/O inside the epoch).
    """
    from gcn_maxcut.data.io import load_dataset
    from gcn_maxcut.data.process import process_graphs

    datasets = [load_dataset(p) for p in dataset_paths]
    specs = {}
    for ds in datasets:
        for _, spec in sorted(ds.specs.items()):
            specs[len(specs)] = spec
    merged = process_graphs(specs, datasets[0].config)
    return train_dataset(merged, model_name=model_name, **config_kwargs)


def evaluate_model(
    params: Any, dataset_batch: Graph, config: TrainingConfig
) -> Dict[str, float]:
    """Average no-grad loss over the dataset (reference :537-570).

    Notebooks read ``-average_loss`` as the estimated average cut value.
    """

    @jax.jit
    def eval_loss(params, batch):
        def one(g):
            if config.feature_mode == "adjacency":
                x = dense_adjacency(g, width=config.dim_embedding)
            else:
                x = _embed_rows(params["embed"], g.n_pad)
            a = (dense_adjacency(g, values="mask")
                 if _resolve_dense_aggregation(
                     config.aggregation, g.n_pad,
                     int(dataset_batch.n_nodes.shape[0]),
                 ) else None)
            probs = gcn_softmax_apply(
                {"conv1": params["conv1"], "conv2": params["conv2"]}, g, x,
                a_dense=a,
            )
            onehot = ste_argmax_onehot(pin_terminals(probs))
            return compute_loss(g, onehot, A=config.A, C=config.C)

        return jax.vmap(one)(batch)

    losses = eval_loss(params, dataset_batch)
    total = float(jnp.sum(losses))
    n = losses.shape[0]
    return {
        "total_loss": total,
        "average_loss": total / n,
        "num_graphs": n,
        "estimated_avg_cut": -total / n,
    }
