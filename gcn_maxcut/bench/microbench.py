"""Microbenchmarks: SpMM edges/s, training epoch, post-processing throughput.

The performance surface BASELINE.json cares about: SpMM fwd+bwd edges/s per
device vs roofline, the reference-recipe training epoch (20×n500 graphs,
reference: ~0.354 s/epoch on CPU, ``BASELINE.md`` §4), and the 200-iteration
post-processing pass (reference: ~374× its forward pass, ``BASELINE.md`` §3).
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.bench.roofline import RooflineModel, device_specs
from gcn_maxcut.core.graph import Graph, pad_graph_batch
from gcn_maxcut.data.generate import generate_graph, regular_graph_on_device
from gcn_maxcut.data.process import DataConfig, process_graphs
from gcn_maxcut.ops.segment import spmm
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


from gcn_maxcut.utils.timing import scan_timeit_stats as _scan_timeit_stats


def _device_graph(n: int, d: int, seed: int = 0) -> Graph:
    """Exactly d-regular circulant graph assembled fully on device."""
    senders, receivers = regular_graph_on_device(n, d, jax.random.PRNGKey(seed))
    order = jnp.argsort(receivers, stable=True)
    senders, receivers = senders[order], receivers[order]
    e = senders.shape[0]
    # receivers sorted with uniform degree d: row i owns slots [i*d, (i+1)*d)
    ell_senders = senders.reshape(n, d)
    return Graph(
        senders=senders,
        receivers=receivers,
        weights=jnp.ones((e,), jnp.float32),
        edge_mask=jnp.ones((e,), jnp.float32),
        row_ptr=jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(jnp.full((n,), d, jnp.int32))]
        ),
        degrees=jnp.full((n,), float(d), jnp.float32),
        node_mask=jnp.ones((n,), jnp.float32),
        n_nodes=jnp.asarray(n, jnp.int32),
        n_edges=jnp.asarray(e, jnp.int32),
        ell_senders=ell_senders,
        ell_weights=jnp.ones((n, d), jnp.float32),
        ell_mask=jnp.ones((n, d), jnp.float32),
    )


def _banded_regular_graph(n: int, d: int, w: int, seed: int = 0) -> Graph:
    """Exact d-regular random graph with latent locality, in RCM order.

    Built as d/2 distinct circulant shifts within ±w/2, relabeled by a
    random *local* permutation (shuffles within blocks of w/4) so per-row
    neighbor structure is arbitrary, then globally shuffled and put back in
    order by RCM (``data/reorder.py``) — what a graph with locality looks
    like after the framework's reordering.
    """
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, max(2, w // 2)), size=d // 2, replace=False)
    perm = np.arange(n)
    r = max(8, w // 4)
    for s in range(0, n, r):
        rng.shuffle(perm[s:s + r])
    u = np.tile(perm, d // 2)
    v = np.concatenate([perm[(np.arange(n) + o) % n] for o in half])
    shuffle = rng.permutation(n)
    from gcn_maxcut.core.graph import graph_from_edges

    return graph_from_edges(
        np.stack([shuffle[u], shuffle[v]], axis=1), n, reorder="rcm"
    )


def bench_spmm(
    n: int = 100_000,
    d: int = 8,
    feature_dim: int = 128,
    locality: int = 255,
) -> Dict[str, float]:
    """General-graph SpMM (ELL gather path, ``ops/segment.spmm``) fwd and
    fwd+bwd edges/s and bytes/s against the device roofline, in two node
    orders:

      * ``expander`` — random circulant offsets spanning the whole id
        space; no ordering gives locality, so neighbor rows are scattered
        over the whole feature matrix;
      * ``rcm`` — a d-regular graph with latent locality (offsets within
        ±``locality``) shuffled and then RCM-reordered, so neighbor rows
        sit close together and the gathers can hit cache.

    Bytes are the no-reuse model of :class:`RooflineModel` (one feature row
    read per edge plus index, weight and the output write).
    """
    spec = device_specs(jax.devices()[0].device_kind)
    x = jax.random.normal(jax.random.PRNGKey(1), (n, feature_dim), jnp.float32)
    e = n * d
    model = RooflineModel(spec, feature_dim, n, e)
    scale = 1.0 / d
    res = {
        "device_kind": jax.devices()[0].device_kind,
        "n": n,
        "d": d,
        "feature_dim": feature_dim,
        "edges_directed": e,
        "bytes_per_edge_fwd": model.bytes_per_edge_fwd,
        "peak_gbps": spec.hbm_gbps,
        "roofline_fwd_edges_per_s": model.edges_per_s(fwd_bwd=False),
        "roofline_fwdbwd_edges_per_s": model.edges_per_s(fwd_bwd=True),
    }
    graphs = {
        "expander": _device_graph(n, d),
        "rcm": _banded_regular_graph(n, d, locality),
    }
    for name, g in graphs.items():
        st_fwd = _scan_timeit_stats(lambda x_: spmm(g, x_) * scale, x)
        grad = jax.grad(lambda x_: jnp.sum(spmm(g, x_) ** 2))
        st_fb = _scan_timeit_stats(
            lambda x_: grad(x_) * (scale * scale * 0.5), x
        )
        fwd_eps = e / st_fwd["best_s"]
        fb_eps = e / st_fb["best_s"]
        res[name] = {
            "fwd_stats": st_fwd,
            "fwdbwd_stats": st_fb,
            "fwd_edges_per_s": fwd_eps,
            "fwdbwd_edges_per_s": fb_eps,
            "fwd_gbps": fwd_eps * model.bytes_per_edge_fwd / 1e9,
            "fraction_of_roofline_fwd": model.fraction_of_roofline(
                fwd_eps, fwd_bwd=False
            ),
            "fraction_of_roofline_fwdbwd": model.fraction_of_roofline(
                fb_eps, fwd_bwd=True
            ),
        }
        logger.info(
            "spmm %s n=%d d=%d F=%d: fwd %.3e edges/s (%.1f GB/s, %.1f%% of "
            "roofline), fwd+bwd %.3e edges/s",
            name, n, d, feature_dim, fwd_eps, res[name]["fwd_gbps"],
            100 * res[name]["fraction_of_roofline_fwd"], fb_eps,
        )
    return res


def bench_spmm_banded(
    n: int = 10_002_432,
    d: int = 8,
    feature_dim: int = 16,
    r: int = 8,
    bandwidth: int = 63,
) -> Dict[str, float]:
    """Packed banded SpMM (``ops/banded.banded_spmm_unit_packed``) at the
    giant trainer's shape, f32 and bf16 streams.  Bytes = read x once +
    write y once, the stencil's roofline."""
    from gcn_maxcut.ops.banded import banded_spmm_unit_packed

    if d % 2:
        raise ValueError("banded bench requires even d")
    spec = device_specs(jax.devices()[0].device_kind)
    rng = np.random.default_rng(0)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    offsets = tuple(int(o) for s in half for o in (s, -s))
    res = {
        "device_kind": jax.devices()[0].device_kind,
        "n": n, "d": d, "feature_dim": feature_dim, "r": r,
        "bandwidth": bandwidth, "peak_gbps": spec.hbm_gbps,
    }
    for dtype in (jnp.float32, jnp.bfloat16):
        x = jax.random.normal(
            jax.random.PRNGKey(1), (n, feature_dim), jnp.float32
        ).astype(dtype)
        st = _scan_timeit_stats(
            lambda x_: (banded_spmm_unit_packed(x_, offsets, r)
                        * (1.0 / d)).astype(dtype),
            x, k_hi=40, k_lo=8,
        )
        nbytes = 2 * x.size * x.dtype.itemsize
        res[jnp.dtype(dtype).name] = {
            "stats": st,
            "time_s": st["best_s"],
            "edges_per_s": n * d / st["best_s"],
            "gbps": nbytes / st["best_s"] / 1e9,
            "fraction_of_roofline": nbytes / st["best_s"] / 1e9
            / spec.hbm_gbps,
        }
        logger.info(
            "banded packed n=%d F=%d %s: %.3f ms (%.0f GB/s)",
            n, feature_dim, jnp.dtype(dtype).name, st["best_s"] * 1e3,
            res[jnp.dtype(dtype).name]["gbps"],
        )
    return res


def bench_train_epoch(
    num_graphs: int = 20,
    n: int = 500,
    d_range=(6, 8),
    max_nodes: int = 1000,
    epochs_timed: int = 10,
    seed: int = 1000,
) -> Dict[str, float]:
    """The reference recipe's epoch (20 graphs n=500 d∈[6,8], 1000-wide
    features, per-graph Adam steps) timed end-to-end on device.

    Reference baseline: 171.81 s / 486 epochs ≈ 0.354 s/epoch on CPU
    (``BASELINE.md`` §4).
    """
    from gcn_maxcut.train.config import TrainingConfig
    from gcn_maxcut.train.loop import make_epoch_fn, setup_train_state

    rng = np.random.default_rng(seed)
    specs = []
    while len(specs) < num_graphs:
        deg = int(rng.integers(d_range[0], d_range[1] + 1))
        if (n * deg) % 2:
            continue
        specs.append(
            generate_graph(n=n, d=deg, graph_type="reg", seed=seed + len(specs))
        )
    ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])

    cfg = TrainingConfig(n_nodes=max_nodes)
    state = setup_train_state(cfg)
    epoch_fn = make_epoch_fn(cfg, state.optimizer)

    params, opt_state = state.params, state.opt_state
    key = jax.random.PRNGKey(0)

    # amortized timing with ONE compile: the epoch count is a *dynamic*
    # scalar driving a fori_loop (lowers to while_loop), so the k_hi and
    # k_lo runs share a single executable; the difference cancels dispatch
    # overhead.
    @jax.jit
    def run_k(params, opt_state, rng, k):
        xs, n_graphs = epoch_fn.epoch_inputs(batch)

        def body(i, carry):
            params, opt_state, _ = carry
            params, opt_state, loss = epoch_fn.run_epoch(
                params, opt_state, xs, n_graphs, jax.random.fold_in(rng, i)
            )
            return (params, opt_state, loss)

        params, opt_state, loss = jax.lax.fori_loop(
            0, k, body, (params, opt_state, jnp.float32(0))
        )
        return params, opt_state, loss

    k_hi, k_lo = max(20, 2 * epochs_timed), 5
    t0 = time.perf_counter()
    _, _, loss = run_k(params, opt_state, key, k_lo)
    float(loss)
    compile_time = time.perf_counter() - t0

    # outer best-of-3 of the full differenced estimate
    estimates = []
    for _ in range(3):
        best = {}
        for k in (k_hi, k_lo):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                _, _, loss = run_k(params, opt_state, key, k)
                float(loss)
                ts.append(time.perf_counter() - t0)
            best[k] = min(ts)
        d_t = best[k_hi] - best[k_lo]
        if d_t > 0:
            estimates.append(d_t / (k_hi - k_lo))
    epoch_time = min(estimates) if estimates else float("nan")
    # advance params for a meaningful final loss
    params, opt_state, loss = run_k(params, opt_state, key, k_hi)
    losses = [loss]

    ref_epoch_time = 171.81 / 486.0
    res = {
        "num_graphs": num_graphs,
        "n": n,
        "epoch_time_s": epoch_time,
        "epoch_time_stats": {
            "best_s": epoch_time,
            "mean_s": (
                sum(estimates) / len(estimates)
                if estimates else float("nan")
            ),
            "spread_s": (
                max(estimates) - min(estimates)
                if estimates else float("nan")
            ),
            "n": 3,
            "n_valid": len(estimates),
        },
        "compile_time_s": compile_time,
        "final_epoch_loss": float(losses[-1]),
        "reference_epoch_time_s": ref_epoch_time,
        "speedup_vs_reference": ref_epoch_time / epoch_time,
    }
    logger.info(
        "train epoch (%dx n=%d): %.4f s/epoch (ref CPU %.4f, %.1fx), compile %.1fs",
        num_graphs, n, epoch_time, ref_epoch_time,
        res["speedup_vs_reference"], compile_time,
    )
    return res


def bench_post_processing(
    n: int = 500, d: int = 8, iterations: int = 200, iters: int = 10
) -> Dict[str, float]:
    """Post-processing sampling throughput (reference overhead: ~374×)."""
    from gcn_maxcut.eval.decode import post_process

    spec = generate_graph(n=n, d=d, graph_type="reg", seed=0)
    ds = process_graphs([spec], DataConfig(max_nodes=n))
    g = ds.graphs[0]
    probs = jax.nn.softmax(
        jax.random.normal(jax.random.PRNGKey(0), (g.n_pad, 3)), axis=-1
    )

    from functools import partial

    @partial(jax.jit, static_argnames=("k",))
    def chain(key, k):
        def body(carry, _):
            key, acc = carry
            key, sub = jax.random.split(key)
            _, cut = post_process(g, probs, sub, iterations=iterations)
            return (key, acc + cut), None

        (key, acc), _ = jax.lax.scan(body, (key, 0.0), None, length=k)
        return acc

    k_hi, k_lo = 400, 50
    float(chain(jax.random.PRNGKey(1), k_hi))
    float(chain(jax.random.PRNGKey(1), k_lo))
    best = {}
    for k in (k_hi, k_lo):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(chain(jax.random.PRNGKey(1), k))
            ts.append(time.perf_counter() - t0)
        best[k] = min(ts)
    t = max(1e-6, (best[k_hi] - best[k_lo]) / (k_hi - k_lo))
    res = {
        "n": n,
        "iterations": iterations,
        "time_s": t,
        "samples_per_s": iterations / t,
    }
    logger.info(
        "post-processing n=%d, %d iters: %.4f s (%.0f samples/s)",
        n, iterations, t, res["samples_per_s"],
    )
    return res
