#!/usr/bin/env python
"""Benchmark: reference-recipe training epoch on the accelerator.

Prints ONE JSON line:
  {"metric": "train_epoch_time_n500x20", "value": <s/epoch>, "unit": "s",
   "vs_baseline": <reference_cpu_epoch_time / ours>, ...}

The metric is the full hot path of the reference pipeline — 20 graphs
(n=500, d∈[6,8], 1000-wide adjacency features), per-graph forward + STE +
cut loss + backward + Adam — as one scanned jit step.  Baseline:
171.81 s / 486 epochs ≈ 0.3535 s/epoch on the reference's CPU
(BASELINE.md §4).  The device and extra context (SpMM edges/s,
post-processing) go to stderr.
"""

import json
import sys


def main():
    import jax

    from gcn_maxcut.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    dev = jax.devices()[0]
    print(
        f"[bench] device: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}; compilation cache: {cache_dir}",
        file=sys.stderr,
    )

    from gcn_maxcut.bench.microbench import (
        bench_post_processing,
        bench_spmm,
        bench_train_epoch,
    )

    train = bench_train_epoch(epochs_timed=10)
    ts = train["epoch_time_stats"]
    print(
        f"[bench] train-epoch compile {train['compile_time_s']:.1f}s, "
        f"steady {train['epoch_time_s'] * 1e3:.3f} ms/epoch "
        f"(best of {ts['n_valid']}/{ts['n']}, spread {ts['spread_s'] * 1e3:.3f} ms)",
        file=sys.stderr,
    )

    def _kernel_entry(stats, edges, sol_denom):
        best = edges / stats["best_s"]
        return {
            "best_edges_per_s": best,
            "mean_edges_per_s": edges / stats["mean_s"],
            "spread_frac": stats["spread_frac"],
            "n_valid": stats["n_valid"],
            "sol_frac": best / sol_denom,
        }

    spmm = bench_spmm(n=100_000, d=8, feature_dim=128)
    post = bench_post_processing()
    e = spmm["edges_directed"]
    kernels = {}
    for order in ("expander", "rcm"):
        kernels[f"{order}_gather_fwd"] = _kernel_entry(
            spmm[order]["fwd_stats"], e, spmm["roofline_fwd_edges_per_s"]
        )
        kernels[f"{order}_gather_fwdbwd"] = _kernel_entry(
            spmm[order]["fwdbwd_stats"], e, spmm["roofline_fwdbwd_edges_per_s"]
        )
    print(
        f"[bench] expander gather fwd+bwd: "
        f"{spmm['expander']['fwdbwd_edges_per_s']:.3e} edges/s; "
        f"rcm gather fwd+bwd: {spmm['rcm']['fwdbwd_edges_per_s']:.3e} edges/s; "
        f"post-processing 200 iters: {post['time_s'] * 1e3:.3f} ms",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "train_epoch_time_n500x20",
                "value": train["epoch_time_s"],
                "unit": "s",
                "vs_baseline": train["speedup_vs_reference"],
                "epoch_time_spread_s": ts["spread_s"],
                "best_of": ts["n"],
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "kernels": kernels,
            }
        )
    )


if __name__ == "__main__":
    main()
