"""Command-line driver — the replacement for the reference's notebook layer.

The reference is driven by notebooks (SURVEY.md §2.8: no CLI, no main()).
Here every recipe is a subcommand:

  python -m gcn_maxcut generate --num-graphs 20 --min-nodes 500 ...
  python -m gcn_maxcut train    --dataset ds.npz --model-name m ...
  python -m gcn_maxcut test     --dataset test.npz --checkpoint final_m.npz
  python -m gcn_maxcut solve    --n 100 --d 8 --time-limit 60
  python -m gcn_maxcut bench    --what spmm|train|post
  python -m gcn_maxcut pipeline --workdir out/   (the full
      complete_training_pipeline.ipynb recipe: generate -> process ->
      train -> evaluate -> baselines -> SUMMARY.md)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _cmd_generate(args) -> int:
    from gcn_maxcut.data import (
        DataConfig,
        generate_graph_dataset,
        process_graphs,
        save_dataset,
    )

    graphs, _ = generate_graph_dataset(
        num_graphs=args.num_graphs,
        min_nodes=args.min_nodes,
        max_nodes=args.max_nodes,
        min_degree=args.min_degree,
        max_degree=args.max_degree,
        graph_type=args.graph_type,
        base_seed=args.seed,
    )
    ds = process_graphs(graphs, DataConfig(max_nodes=args.pad_to))
    save_dataset(ds, args.output)
    print(f"wrote {len(ds)} graphs to {args.output}")
    return 0


def _cmd_train(args) -> int:
    from gcn_maxcut.data import load_dataset
    from gcn_maxcut.train import train_dataset

    ds = load_dataset(args.dataset)
    callback = None
    if args.metrics:
        from gcn_maxcut.utils.profiling import MetricsLogger

        ml = MetricsLogger(args.metrics)
        callback = lambda epoch, loss: ml.log(epoch, loss=loss)  # noqa: E731
    params, best_loss, epochs, _, history = train_dataset(
        ds,
        model_name=args.model_name,
        callback=callback,
        resume_from=args.resume,
        number_epochs=args.epochs,
        learning_rate=args.learning_rate,
        dropout=args.dropout,
        patience=args.patience,
        save_frequency=args.save_frequency,
        seed=args.seed,
        loss_mode=args.loss_mode,
        quantile_c=args.quantile_c,
        entropy_weight=args.entropy_weight,
        lr_schedule=args.lr_schedule,
    )
    print(
        json.dumps(
            {"best_loss": best_loss, "epochs": epochs + 1, "final_loss": history[-1]}
        )
    )
    return 0


def _cmd_test(args) -> int:
    import jax

    from gcn_maxcut.data import load_dataset
    from gcn_maxcut.eval import (
        analyze_results,
        print_analysis_report,
        save_results,
        test_multiple_graphs,
    )
    from gcn_maxcut.models import gcn_softmax_init
    from gcn_maxcut.train import TrainingConfig, load_checkpoint, setup_train_state

    ds = load_dataset(args.dataset)
    sizes = (
        [int(s) for s in args.sizes.split(",")]
        if args.sizes
        else sorted({s.n_nodes for s in ds.specs.values()})
    )
    cfg = TrainingConfig(n_nodes=ds.config.max_nodes)
    state = setup_train_state(cfg)
    params, _, _, meta = load_checkpoint(args.checkpoint, state.params)
    results, by_size = test_multiple_graphs(
        params, ds, sizes,
        post_processing_iterations=args.iterations,
        refine=args.refine,
        refine_starts=args.refine_starts,
    )
    analysis = analyze_results(results, by_size, sizes)
    print_analysis_report(analysis, sizes)
    if args.output:
        save_results(args.output, results, by_size, analysis, vars(args))
        print(f"results saved to {args.output}")
    return 0


def _cmd_solve(args) -> int:
    from gcn_maxcut.baselines import anytime_solver, randomized_k_way_maxcut
    from gcn_maxcut.data import DataConfig, generate_graph, process_graphs

    if args.method == "sweep":
        # the scalable classical search (O(E) per sweep, native) — right
        # for n where the SA solver's O(E)-per-move chains cannot run
        import time as _time

        import numpy as _np

        from gcn_maxcut.baselines import greedy_sweep_maxcut
        from gcn_maxcut.data.generate import random_regular_edges

        edges = random_regular_edges(args.n, args.d, seed=args.seed)
        rng = _np.random.default_rng(args.seed)
        init = rng.integers(0, args.k, args.n)
        init[: args.k] = _np.arange(args.k)
        t0 = _time.perf_counter()
        _, cut, sweeps = greedy_sweep_maxcut(edges, args.n, init, k=args.k)
        print(json.dumps({
            "n": args.n, "d": args.d, "k": args.k, "method": "greedy_sweep",
            "cut_value": cut, "cut_fraction": cut / edges.shape[0],
            "sweeps": sweeps,
            "solve_time_s": round(_time.perf_counter() - t0, 3),
        }))
        return 0

    spec = generate_graph(n=args.n, d=args.d, graph_type="reg", seed=args.seed)
    ds = process_graphs([spec], DataConfig(max_nodes=args.n))
    g = ds.graphs[0]
    res = anytime_solver(g, k=args.k, time_limit=args.time_limit, seed=args.seed)
    _, rand_cut, _ = randomized_k_way_maxcut(g, args.k, 1000, seed=args.seed)
    print(
        json.dumps(
            {
                "n": args.n,
                "d": args.d,
                "k": args.k,
                "method": res["method"],
                "cut_value": res["cut_value"],
                "solve_time_s": round(res["solve_time"], 3),
                "randomized_cut": rand_cut,
            }
        )
    )
    return 0


def _cmd_convert(args) -> int:
    """Migrate checkpoints: reference ``.pth`` <-> our ``.npz``."""
    import json as _json

    import numpy as np

    from gcn_maxcut.train import (
        TrainingConfig,
        load_checkpoint,
        load_torch_checkpoint,
        save_checkpoint,
        save_torch_checkpoint,
        setup_train_state,
    )

    src, dst = args.input, args.output
    if src.endswith((".pth", ".pt")):
        from gcn_maxcut.train.torch_compat import adam_state_from_torch

        params, _, meta = load_torch_checkpoint(src)
        cfg = meta.get("config") or TrainingConfig()
        state = setup_train_state(cfg)
        if "embed" not in params:           # keep template embedding
            params["embed"] = state.params["embed"]
        opt_state = (
            adam_state_from_torch(
                state.optimizer, state.params, meta["torch_optimizer"]
            )
            if meta.get("torch_optimizer") else state.opt_state
        )
        out = save_checkpoint(
            dst, params=params, opt_state=opt_state,
            epoch=meta.get("epoch", 0),
            loss_history=meta.get("loss_history"), config=cfg,
        )
        print(_json.dumps({"converted": str(out), "direction": "torch->npz",
                           "epoch": meta.get("epoch", 0)}))
    else:
        with np.load(src if src.endswith(".npz") else src + ".npz") as d:
            meta_raw = _json.loads(bytes(d["_meta"]).decode())
        cfg = (TrainingConfig.from_json(meta_raw["config"])
               if meta_raw.get("config") else TrainingConfig())
        state = setup_train_state(cfg)
        params, opt_state, _, meta = load_checkpoint(
            src, state.params, state.opt_state
        )
        out = save_torch_checkpoint(
            dst, params, epoch=meta.get("epoch", 0),
            loss_history=meta.get("loss_history"), config=cfg,
            opt_state=opt_state,
        )
        print(_json.dumps({"converted": str(out), "direction": "npz->torch",
                           "epoch": meta.get("epoch", 0)}))
    return 0


def _cmd_bench(args) -> int:
    from gcn_maxcut.bench import (
        bench_post_processing,
        bench_spmm,
        bench_train_epoch,
    )

    if args.what in ("spmm", "all"):
        print(json.dumps({"spmm": bench_spmm(n=args.n, d=args.d)}, default=float))
    if args.what in ("banded", "all"):
        from gcn_maxcut.bench.microbench import bench_spmm_banded

        print(json.dumps({"banded": bench_spmm_banded()}, default=float))
    if args.what in ("train", "all"):
        print(json.dumps({"train": bench_train_epoch()}, default=float))
    if args.what in ("post", "all"):
        print(json.dumps({"post": bench_post_processing()}, default=float))
    if args.what == "giant":
        from gcn_maxcut.bench.giant_demo import (
            train_banded_giant,
            train_banded_giant_packed,
        )

        if args.giant_layout == "packed":
            res = train_banded_giant_packed(
                n=args.giant_nodes, d=args.d, epochs=args.giant_epochs,
                act_dtype=(None if args.act_dtype == "float32"
                           else args.act_dtype),
            )
        else:
            res = train_banded_giant(
                n=args.giant_nodes, d=args.d, epochs=args.giant_epochs
            )
        print(json.dumps({"giant": res}, default=float))
    if args.what == "scaling":
        from gcn_maxcut.bench.scaling import scaling_sweep

        print(json.dumps({"scaling": scaling_sweep(n=args.n, d=args.d)}, default=float))
    if args.what == "kway":
        from gcn_maxcut.bench.kway_sweep import kway_sweep

        res = kway_sweep(
            n=args.n, d=args.d, epochs=args.giant_epochs,
            partition=args.partition,
        )
        print(json.dumps({"kway": res}, default=float))
    if args.what == "quality":
        from gcn_maxcut.bench.quality import run_quality_suite

        res = run_quality_suite(recipe=args.recipe)
        print(json.dumps({"quality": res}, default=float))
    if args.what == "hybrid":
        # hybrid data x graph parallelism demo: a small graph batch over a
        # (data, graph) 2-D mesh (SURVEY §2.9; 2 x n/2 on multi-device,
        # degenerate 1 x 1 on a single device)
        import jax as _jax
        import numpy as _np

        from gcn_maxcut.data.generate import random_regular_edges
        from gcn_maxcut.parallel.giant import GiantConfig
        from gcn_maxcut.parallel.hybrid import train_hybrid

        ndev = _jax.device_count()
        r_ax = 2 if ndev % 2 == 0 and ndev > 1 else 1
        n = max(256, args.n // 100)
        lists = []
        for s in range(r_ax):
            e = random_regular_edges(n, args.d, seed=s)
            lists.append((
                _np.concatenate([e[:, 0], e[:, 1]]),
                _np.concatenate([e[:, 1], e[:, 0]]),
            ))
        res = train_hybrid(
            lists, n,
            GiantConfig(dim_embedding=32, hidden_dim=16,
                        number_epochs=args.giant_epochs, epochs_per_call=10),
            mesh_shape=(r_ax, ndev // r_ax),
        )
        print(json.dumps({"hybrid": res}, default=float))
    return 0


def _cmd_pipeline(args) -> int:
    """The complete_training_pipeline recipe end-to-end (SURVEY.md §2.8)."""
    from gcn_maxcut.baselines import randomized_k_way_maxcut
    from gcn_maxcut.data import (
        DataConfig,
        generate_graph_dataset,
        process_graphs,
        save_dataset,
    )
    from gcn_maxcut.eval import analyze_results, test_multiple_graphs
    from gcn_maxcut.train import train_dataset
    from gcn_maxcut.utils.timing import PhaseTimer
    from gcn_maxcut.viz import HAS_MATPLOTLIB, plot_loss_history

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    timer = PhaseTimer()
    name = f"maxcut_{args.classes}way_n{args.nodes}_d{args.min_degree}_{args.max_degree}"

    with timer.phase("generation"):
        graphs, _ = generate_graph_dataset(
            args.num_graphs, args.nodes, args.nodes,
            args.min_degree, args.max_degree, base_seed=args.seed,
        )
    with timer.phase("processing"):
        ds = process_graphs(graphs, DataConfig(max_nodes=args.pad_to))
        save_dataset(ds, workdir / f"{name}_dataset.npz")
    with timer.phase("training"):
        params, best_loss, epochs, _, history = train_dataset(
            ds,
            model_name=str(workdir / f"{name}_model"),
            number_epochs=args.epochs,
            learning_rate=args.learning_rate,
            save_frequency=max(1, args.epochs // 5),
            seed=args.seed,
        )
    with timer.phase("evaluation"):
        test_graphs, _ = generate_graph_dataset(
            max(2, args.num_graphs // 4), args.nodes, args.nodes,
            args.min_degree, args.max_degree, base_seed=args.seed + 5000,
        )
        tds = process_graphs(test_graphs, DataConfig(max_nodes=args.pad_to))
        results, by_size = test_multiple_graphs(
            params, tds, [args.nodes], post_processing_iterations=200,
            verbose=False,
        )
        analysis = analyze_results(results, by_size, [args.nodes])
        rand = [
            randomized_k_way_maxcut(tds.graphs[k], args.classes, 1000, seed=k)[1]
            for k in sorted(tds.graphs)
        ]

    if HAS_MATPLOTLIB:
        plot_loss_history(history, save_path=str(workdir / f"{name}_loss.png"))

    avg_deg = float(
        np.mean([2 * s.n_edges / s.n_nodes for s in ds.specs.values()])
    )
    summary = "\n".join(
        [
            f"# {name} — pipeline summary",
            "",
            f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
            "",
            "## Dataset",
            f"- Graphs: {len(ds)} (n={args.nodes}, d∈[{args.min_degree},{args.max_degree}], actual avg degree {avg_deg:.2f})",
            f"- Padding: {args.pad_to}-wide features",
            "",
            "## Timing",
            *(f"- {k}: {v:.2f} s" for k, v in timer.phases.items()),
            "",
            "## Training",
            f"- Epochs: {epochs + 1}/{args.epochs}",
            f"- Best loss: {best_loss:.1f}  (≈ cut {-best_loss:.0f} summed over graphs)",
            "",
            "## Evaluation (held-out graphs)",
            f"- GCN argmax avg cut: {analysis['avg_simple_cut']:.1f}",
            f"- GCN + post-processing avg cut: {analysis['avg_post_cut']:.1f} ({analysis['avg_improvement_pct']:+.1f}%)",
            f"- Randomized baseline avg cut: {float(np.mean(rand)):.1f}",
            f"- Post-processing overhead: {analysis['avg_overhead']:.1f}x",
        ]
    )
    (workdir / f"{name}_SUMMARY.md").write_text(summary)
    print(summary)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gcn_maxcut")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate + process a graph dataset")
    g.add_argument("--num-graphs", type=int, default=20)
    g.add_argument("--min-nodes", type=int, default=500)
    g.add_argument("--max-nodes", type=int, default=500)
    g.add_argument("--min-degree", type=int, default=6)
    g.add_argument("--max-degree", type=int, default=8)
    g.add_argument("--graph-type", default="reg")
    g.add_argument("--pad-to", type=int, default=1000)
    g.add_argument("--seed", type=int, default=1000)
    g.add_argument("--output", default="dataset.npz")
    g.set_defaults(fn=_cmd_generate)

    t = sub.add_parser("train", help="train GCNSoftmax on a dataset")
    t.add_argument("--dataset", required=True)
    t.add_argument("--model-name", default="maxcut_model")
    t.add_argument("--epochs", type=int, default=1000)
    t.add_argument("--learning-rate", type=float, default=1e-3)
    t.add_argument("--dropout", type=float, default=0.0)
    t.add_argument("--patience", type=int, default=20)
    t.add_argument("--save-frequency", type=int, default=100)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument(
        "--loss-mode", default="ste", choices=("ste", "quantile"),
        help="ste = reference-parity STE argmax loss; quantile = train on "
             "mean + c*std of the sampled decode (best-of-N objective)",
    )
    t.add_argument("--quantile-c", type=float, default=2.6)
    t.add_argument(
        "--entropy-weight", type=float, default=0.0,
        help="reward per-node entropy (sampled-decode diversity lever)",
    )
    t.add_argument(
        "--lr-schedule", default="constant", choices=("constant", "cosine"),
    )
    t.add_argument(
        "--metrics", default=None,
        help="write per-epoch JSONL metrics (loss, step time) to this path",
    )
    t.add_argument(
        "--resume", default=None,
        help="warm-start from a checkpoint (.npz) incl. optimizer state",
    )
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("test", help="evaluate a checkpoint on a dataset")
    e.add_argument("--dataset", required=True)
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--sizes", default=None, help="comma-separated size buckets")
    e.add_argument("--iterations", type=int, default=200)
    e.add_argument(
        "--refine",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="on-device greedy-flip refinement after post-processing "
        "(DEFAULT: on; costs ~0.2-0.4s per graph and lifts cuts to "
        "96-99%% of the anytime solver — see PARITY.md §2; "
        "--no-refine reproduces the reference's two-decoder contract)",
    )
    e.add_argument(
        "--refine-starts",
        type=int,
        default=4,
        help="local-search starts for the refined decode: top N-1 sampled "
        "assignments + the argmax, climbed in one vmapped while_loop "
        "(1 = single-start from the post-processed best)",
    )
    e.add_argument("--output", default=None)
    e.set_defaults(fn=_cmd_test)

    s = sub.add_parser("solve", help="run a classical solver on a random graph")
    s.add_argument("--n", type=int, default=100)
    s.add_argument("--d", type=int, default=8)
    s.add_argument("--k", type=int, default=3)
    s.add_argument("--time-limit", type=float, default=60.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument(
        "--method", choices=["anytime", "sweep"], default="anytime",
        help="anytime = SA+greedy (CPLEX stand-in, n<=~1k); sweep = the "
             "native O(E)-per-sweep search for 100k..10M-node graphs",
    )
    s.set_defaults(fn=_cmd_solve)

    c = sub.add_parser(
        "convert",
        help="migrate checkpoints between reference .pth and our .npz",
    )
    c.add_argument("input", help="source checkpoint (.pth/.pt or .npz)")
    c.add_argument("output", help="destination checkpoint path")
    c.set_defaults(fn=_cmd_convert)

    b = sub.add_parser("bench", help="microbenchmarks")
    b.add_argument(
        "--what",
        choices=["spmm", "banded", "train", "post", "giant", "scaling",
                 "kway", "quality", "hybrid", "all"],
        default="all",
    )
    b.add_argument(
        "--recipe", choices=["n500", "mixed", "per_size"], default="mixed",
        help="quality-suite training recipe (see bench/quality.py)",
    )
    b.add_argument("--n", type=int, default=100_000)
    b.add_argument("--d", type=int, default=8)
    b.add_argument("--giant-nodes", type=int, default=10_002_432)
    b.add_argument("--giant-epochs", type=int, default=40)
    b.add_argument(
        "--giant-layout", choices=["packed", "plain"], default="packed",
        help="packed = interleaved node order, r nodes per wide row",
    )
    b.add_argument(
        "--act-dtype", choices=["float32", "bfloat16"], default="float32",
        help="packed giant activation dtype (bfloat16 needs ~1.3x the "
             "epochs to reach f32's cut quality)",
    )
    b.add_argument(
        "--partition", choices=["contiguous", "bfs", "metis"],
        default="contiguous",
        help="node->shard partitioner for the kway sharded trainer "
             "(metis = native multilevel, DESIGN.md §7)",
    )
    b.set_defaults(fn=_cmd_bench)

    pl = sub.add_parser("pipeline", help="full generate->train->eval recipe")
    pl.add_argument("--workdir", default="pipeline_out")
    pl.add_argument("--num-graphs", type=int, default=20)
    pl.add_argument("--nodes", type=int, default=500)
    pl.add_argument("--min-degree", type=int, default=6)
    pl.add_argument("--max-degree", type=int, default=8)
    pl.add_argument("--pad-to", type=int, default=1000)
    pl.add_argument("--classes", type=int, default=3)
    pl.add_argument("--epochs", type=int, default=300)
    pl.add_argument("--learning-rate", type=float, default=1e-3)
    pl.add_argument("--seed", type=int, default=1000)
    pl.set_defaults(fn=_cmd_pipeline)

    args = p.parse_args(argv)
    from gcn_maxcut.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeat CLI runs skip the XLA compile cost
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
