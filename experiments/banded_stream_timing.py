#!/usr/bin/env python
"""Banded stream on the GPU: the Pallas kernel route against XLA's fused
form, per op and per epoch of the packed giant trainer; and the ELL
gather's bytes/s in expander and RCM order.

Run on a machine with one GPU:

    python experiments/banded_stream_timing.py [out.json]

Writes the results to ``out.json`` (default ``banded_stream_timing.json``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gcn_maxcut.bench.giant_demo import train_banded_giant_packed
from gcn_maxcut.bench.microbench import bench_spmm
from gcn_maxcut.ops import banded
from gcn_maxcut.utils.cache import enable_compilation_cache

N, R, D, W = 10_002_432, 8, 8, 63


def _time(fn, x, iters=50, reps=5):
    """Median over ``reps`` of the mean wall time of ``iters`` back-to-back
    calls, ended by block_until_ready."""
    jax.block_until_ready(fn(x))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(x)
        jax.block_until_ready(y)
        out.append((time.perf_counter() - t0) / iters)
    return float(np.median(out)), out


def _xla_fused(p, pre, post, offsets):
    return banded._window_sum(p, offsets, pre, post).astype(p.dtype)


def _xla_materialized(p, pre, post, offsets):
    # the window copied once, then pure slices of it
    win = jax.lax.optimization_barrier(jnp.concatenate([pre, p, post]))
    return banded._slice_sum(
        win, offsets, pre.shape[0], p.shape[0]).astype(p.dtype)


ROUTES = {
    "kernel": banded._unit_shift_sum,
    "xla_fused": _xla_fused,
    "xla_materialized": _xla_materialized,
}


def _dump(res):
    out = sys.argv[1] if len(sys.argv) > 1 else "banded_stream_timing.json"
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=float)


def main():
    enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    half = rng.choice(np.arange(1, W + 1), size=D // 2, replace=False)
    offsets = tuple(int(o) for s in half for o in (s, -s))
    res = {"card": smi, "device_kind": jax.devices()[0].device_kind,
           "n": N, "r": R, "d": D, "W": W, "ops": {}, "epochs": {}}

    copy = jax.jit(lambda x: x + 1)
    for F in (16, 32):
        for dtype in (jnp.float32, jnp.bfloat16):
            x = jax.random.normal(jax.random.PRNGKey(1), (N, F)).astype(dtype)
            nbytes = 2 * x.size * x.dtype.itemsize
            tag = f"F{F}_{jnp.dtype(dtype).name}"
            t_copy, _ = _time(copy, x)
            row = {"bytes": nbytes, "copy_s": t_copy,
                   "copy_gbps": nbytes / t_copy / 1e9}
            want = None
            for name, route in ROUTES.items():
                banded._unit_shift_sum = route
                fn = jax.jit(lambda x_: banded.banded_spmm_unit_packed(
                    x_, offsets, R))
                got = np.asarray(fn(x).astype(jnp.float32))
                if want is None:
                    want = got
                t, reps = _time(fn, x)
                row[f"{name}_s"] = t
                row[f"{name}_gbps"] = nbytes / t / 1e9
                row[f"{name}_maxdiff"] = float(np.max(np.abs(got - want)))
                row[f"{name}_reps"] = reps
            banded._unit_shift_sum = ROUTES["kernel"]
            res["ops"][tag] = row
            print(tag, json.dumps({k: v for k, v in row.items()
                                   if not k.endswith("reps")}), flush=True)
            del x, want
    _dump(res)

    for i, name in enumerate(["xla_fused", "kernel", "kernel", "xla_fused"]):
        banded._unit_shift_sum = ROUTES[name]
        out = train_banded_giant_packed(
            n=N, d=D, epochs=30, epochs_per_call=10, bandwidth=W, r=R
        )
        res["epochs"][f"{i}_{name}"] = {
            "epoch_time_s": out["epoch_time_s"],
            "cut_fraction": out["cut_fraction"],
            "compile_time_s": out["compile_time_s"],
        }
        print(i, name, json.dumps(res["epochs"][f"{i}_{name}"]), flush=True)
    banded._unit_shift_sum = ROUTES["kernel"]
    _dump(res)

    res["ell_gather"] = bench_spmm(n=100_000, d=8, feature_dim=128)
    for order in ("expander", "rcm"):
        print(order, json.dumps({k: v for k, v in res["ell_gather"][order].items()
                                 if not k.endswith("stats")}), flush=True)
    _dump(res)


if __name__ == "__main__":
    main()
