#!/usr/bin/env python
"""On-card smoke test: drive the trainers' main paths once on the GPU.

    python chip_smoke.py               # one card: recipe, general, giant
    python chip_smoke.py --four-cards  # four cards: packed halo trainer
                                       # against the one-card trainer

Phases (each compares with the repo's plain reference and raises on any
mismatch; nothing is swallowed):

  recipe   the reference model at full width — GCNSoftmax 1000 -> 500 -> 3
           on 20 graphs of n=500, d in [6, 8], padded to 1000, per-graph
           Adam epochs (``train.loop.make_epoch_fn``), then the 200-rollout
           decode (``eval.post_process``);
  general  ``parallel.giant.train_giant_graph`` on a one-device mesh at
           n=100k, d=8, k=3, and the ELL-gather SpMM against the
           segment-sum reference at F=128;
  giant    ``bench.giant_demo.train_banded_giant_packed`` at n=10,002,432
           for 20 epochs, and its packed aggregation against the rolls
           reference on the unpacked array;
  four     (``--four-cards`` only) ``parallel.giant_banded.
           train_halo_giant_packed`` on a 4-device ("graph",) mesh, ~10M
           nodes per card, against ``train_banded_giant_packed`` on one card
           on the same graph and seed.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit from ``nvidia-smi``.
Without a GPU the script exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.bench.giant_demo import train_banded_giant_packed
from gcn_maxcut.core.graph import (
    dense_adjacency,
    graph_from_edges,
    pad_graph_batch,
)
from gcn_maxcut.data.generate import generate_graph, random_regular_edges
from gcn_maxcut.data.process import DataConfig, process_graphs
from gcn_maxcut.eval.decode import post_process
from gcn_maxcut.models.gcn import gcn_softmax_apply
from gcn_maxcut.objectives.cut_loss import compute_loss
from gcn_maxcut.ops.banded import (
    banded_spmm_reference,
    banded_spmm_unit_packed,
    pack_interleaved,
    unpack_interleaved,
)
from gcn_maxcut.ops.segment import spmm, spmm_xla
from gcn_maxcut.ops.ste import pin_terminals, ste_argmax_onehot
from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph
from gcn_maxcut.parallel.giant_banded import (
    PackedHaloGiantConfig,
    train_halo_giant_packed,
)
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.train.config import TrainingConfig
from gcn_maxcut.train.loop import make_epoch_fn, setup_train_state
from gcn_maxcut.utils.cache import enable_compilation_cache
from gcn_maxcut.utils.profiling import memory_stats

GIANT_N = 10_002_432


class SmokeFailure(RuntimeError):
    """A phase's output disagreed with its reference or its bound."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    log(("  PASS " if ok else "  FAIL ") + msg)
    if not ok:
        raise SmokeFailure(msg)


def compare(name, got, ref, rtol, atol, precision):
    """Elementwise |got - ref| <= atol + rtol·|ref|; prints the worst
    error beside the tolerance and the precision of each side."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    check(got.shape == ref.shape, f"{name}: shape {got.shape} == {ref.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: all finite")
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    excess = float(np.max(np.abs(got - ref) - rtol * np.abs(ref)))
    check(
        excess <= atol,
        f"{name}: max |err| {err:.3e} within atol {atol:g} + rtol {rtol:g}"
        f"·|ref| ({precision})",
    )
    return err


def show_memory(step: str, stats: dict) -> None:
    log(f"  memory_analysis[{step}]: " + json.dumps(stats))


def _recipe_batch(num_graphs, n, max_nodes, seed=1000):
    rng = np.random.default_rng(seed)
    specs = []
    while len(specs) < num_graphs:
        deg = int(rng.integers(6, 9))
        if (n * deg) % 2:
            continue
        specs.append(
            generate_graph(n=n, d=deg, graph_type="reg", seed=seed + len(specs))
        )
    ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
    return [ds.graphs[k] for k in sorted(ds.graphs)]


def phase_recipe(num_graphs=20, n=500, max_nodes=1000, epochs=20,
                 rollouts=200):
    """Reference recipe at full width, then the sampled decode."""
    log(f"[recipe] {num_graphs} graphs n={n} padded to {max_nodes}, "
        f"{epochs} per-graph Adam epochs, {rollouts}-rollout decode")
    graphs = _recipe_batch(num_graphs, n, max_nodes)
    batch = pad_graph_batch(graphs)
    cfg = TrainingConfig(n_nodes=max_nodes)
    state = setup_train_state(cfg)
    n_params = sum(
        int(np.prod(v.shape))
        for k in ("conv1", "conv2") for v in state.params[k].values()
    )
    log(f"  model {cfg.dim_embedding}->{cfg.hidden_dim}->{cfg.number_classes}"
        f", {n_params} conv parameters")
    epoch_fn = make_epoch_fn(cfg, state.optimizer)
    key = jax.random.PRNGKey(0)
    compiled = epoch_fn.lower(
        state.params, state.opt_state, batch, key, num_epochs=epochs
    ).compile()
    show_memory("recipe epoch_fn", memory_stats(compiled))
    t0 = time.perf_counter()
    params, _, losses = compiled(state.params, state.opt_state, batch, key)
    losses = np.asarray(losses)
    log(f"  {epochs} epochs in {time.perf_counter() - t0:.3f} s; "
        f"cumulative loss {losses[0]:.1f} -> {losses[-1]:.1f}")
    check(bool(np.isfinite(losses).all()), "recipe: losses finite")
    check(bool(losses[-1] < losses[0]), "recipe: loss falls over training")

    def forward(params, g):
        a = dense_adjacency(g, values="mask")
        x = dense_adjacency(g, width=cfg.dim_embedding)
        probs = gcn_softmax_apply(params, g, x, a_dense=a)
        loss = compute_loss(g, ste_argmax_onehot(pin_terminals(probs)))
        return probs, loss

    fwd = jax.jit(jax.vmap(forward, in_axes=(None, 0)))
    probs, loss = fwd(params, batch)
    with jax.default_matmul_precision("highest"):
        probs_hi, loss_hi = jax.jit(jax.vmap(forward, in_axes=(None, 0)))(
            params, batch
        )
    # default f32 dots may run in TF32 (10-bit mantissa, ~5e-4 relative)
    # on the card, the reference in full f32; a hard-argmax flip of a
    # near-tied node moves the summed cut by at most its degree
    compare("recipe probs", probs, probs_hi, 0.0, 2e-3,
            "default matmul precision vs highest")
    compare("recipe summed loss", np.sum(loss), np.sum(loss_hi), 1e-2, 0.0,
            "default matmul precision vs highest")

    fracs = []
    keys = jax.random.split(jax.random.PRNGKey(1), len(graphs))
    decode = jax.jit(post_process, static_argnames=("iterations",))
    for g, p, k in zip(graphs, probs, keys):
        _, cut = decode(g, p, k, iterations=rollouts)
        fracs.append(float(cut) / (int(g.n_edges) / 2))
    log(f"  decoded cut fraction: mean {np.mean(fracs):.4f}, "
        f"min {np.min(fracs):.4f} (random 3-way floor 0.6667)")
    check(min(fracs) > 2.0 / 3.0, "recipe: every decoded cut beats 2/3")
    return {"loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "cut_fraction_mean": float(np.mean(fracs))}


def phase_general(n=100_000, d=8, epochs=20, feature_dim=128):
    """Node-sharded general-graph trainer on a one-device mesh, and the
    ELL gather SpMM against the segment-sum reference."""
    log(f"[general] train_giant_graph n={n} d={d} k=3, {epochs} epochs, "
        "one-device mesh")
    e = random_regular_edges(n, d, seed=0)
    src = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
    dst = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
    cfg = GiantConfig(number_epochs=epochs, epochs_per_call=10,
                      log_every=1, learning_rate=1e-2)
    mesh = make_mesh(("graph",), devices=jax.devices()[:1])
    res = train_giant_graph(src, dst, n, cfg, mesh=mesh)
    show_memory("general giant step", res["step_memory"])
    hist = np.asarray(res["loss_history"])
    frac = res["final_cut"] / res["total_edges"]
    log(f"  cut {-hist[0]:.0f} -> {-hist[-1]:.0f} of {res['total_edges']} "
        f"edges ({frac:.4f}); {res['edges_per_s']:.3e} edges/s")
    check(bool(np.isfinite(hist).all()), "general: losses finite")
    check(bool(hist[-1] < hist[0]), "general: cut grows over training")

    g = graph_from_edges(e, n)
    x = jax.random.normal(jax.random.PRNGKey(2), (g.n_pad, feature_dim))
    y = jax.jit(spmm)(g, x)
    with jax.default_matmul_precision("highest"):
        y_ref = jax.jit(spmm_xla)(g, x)
    # same f32 sums in another order: d=8 terms of |x| ~ 1
    compare(f"general spmm (ELL gather) F={feature_dim}", y, y_ref, 0.0,
            1e-4, "f32 gather-sum vs f32 segment-sum, highest precision")
    return {"cut_fraction": frac, "edges_per_s": res["edges_per_s"]}


def phase_giant(n=GIANT_N, epochs=20, r=8, d=8, bandwidth=63):
    """Packed banded giant trainer, and its aggregation against the rolls
    reference on the unpacked array."""
    log(f"[giant] train_banded_giant_packed n={n} d={d} W={bandwidth} "
        f"r={r}, {epochs} epochs")
    res = train_banded_giant_packed(
        n=n, d=d, epochs=epochs, epochs_per_call=10, bandwidth=bandwidth,
        r=r,
    )
    show_memory("giant packed step", res["step_memory"])
    log(f"  cut {res['initial_cut']:.0f} -> {res['final_cut']:.0f} of "
        f"{res['edges']} ({res['cut_fraction']:.4f}); epoch "
        f"{res['epoch_time_s'] * 1e3:.3f} ms, compile+first chunk "
        f"{res['compile_time_s']:.1f} s")
    check(bool(np.isfinite(res["final_cut"])), "giant: cut finite")
    check(res["cut_fraction"] > 2.0 / 3.0, "giant: cut beats the 2/3 floor")

    offsets = tuple(res["offsets"])
    for F, dtype, atol in ((16, jnp.float32, 1e-5),
                           (16, jnp.bfloat16, 0.0)):
        x = jax.random.normal(jax.random.PRNGKey(3), (n, F)).astype(dtype)
        got = jax.jit(
            lambda x_: unpack_interleaved(
                banded_spmm_unit_packed(pack_interleaved(x_, r), offsets, r),
                r,
            )
        )(x)
        # reference sums in f32 and rounds once, like the op under test
        ref = jax.jit(
            lambda x_: banded_spmm_reference(
                x_.astype(jnp.float32), offsets
            ).astype(dtype)
        )(x)
        name = jnp.dtype(dtype).name
        compare(f"giant packed aggregation F={F} {name}", got, ref,
                0.0 if dtype == jnp.float32 else 2.0 ** -8, atol,
                f"{name} stream, f32 sums vs rolls reference")
    return {"cut_fraction": res["cut_fraction"],
            "epoch_time_s": res["epoch_time_s"]}


def phase_four_cards(n_shard=GIANT_N, epochs=20, r=8, d=8, bandwidth=63,
                     devices=None):
    """Packed halo trainer on four devices against the one-device trainer
    on the same graph and seed."""
    devices = list(devices if devices is not None else jax.devices()[:4])
    n = n_shard * len(devices)
    log(f"[four] train_halo_giant_packed {len(devices)} devices x "
        f"{n_shard} nodes (n={n}) vs train_banded_giant_packed on one")
    # f32 streams on both sides isolate the sharding: bf16 streams round
    # the wrap rows of the two layouts at different points
    kw = dict(d=d, dim_embedding=32, learning_rate=1e-3, epochs=epochs,
              epochs_per_call=10, bandwidth=bandwidth, seed=0)
    mesh = make_mesh(("graph",), devices=devices)
    multi = train_halo_giant_packed(
        n_shard=n_shard, config=PackedHaloGiantConfig(r=r, agg_dtype=None,
                                                      **kw),
        mesh=mesh,
    )
    show_memory("four-card packed halo step", multi["step_memory"])
    with jax.default_device(devices[0]):
        single = train_banded_giant_packed(n=n, r=r, agg_dtype=None, **kw)
    show_memory("one-card packed step", single["step_memory"])
    log(f"  cut fraction: {len(devices)} cards {multi['cut_fraction']:.6f}, "
        f"one card {single['cut_fraction']:.6f}")
    check(multi["n"] == single["n"] == n, "four: same graph size")
    # identical math; the per-device matmuls and sums may pick other
    # kernels and orders than the one-device run, which flips the hard
    # argmax of a few near-tied nodes
    compare("four initial cut", multi["initial_cut"], single["initial_cut"],
            1e-4, 0.0, "f32 streams, default matmul precision, both sides")
    compare("four final cut", multi["final_cut"], single["final_cut"],
            1e-3, 0.0, "f32 streams, default matmul precision, both sides")
    check(multi["cut_fraction"] > 2.0 / 3.0, "four: cut beats the 2/3 floor")
    return {"cut_fraction": multi["cut_fraction"]}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card halo phase")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    if args.four_cards and len(jax.devices()) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    log(f"cache: {enable_compilation_cache()}")
    devs = jax.devices()[:4] if args.four_cards else jax.devices()[:1]
    log(f"devices: {[d.device_kind for d in devs]}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(devices=devs)
    else:
        phase_recipe()
        phase_general()
        phase_giant()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
