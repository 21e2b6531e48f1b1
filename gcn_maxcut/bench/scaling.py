"""Scaling harness: sharded SpMM / giant-graph training across mesh sizes.

BASELINE.json configs[3..4]: edges/s for a single large graph at 1 chip ->
1 host -> N hosts.  The harness runs identically on a multi-GPU host and on
the virtual CPU mesh (functional validation); device subsets let a single
run produce a scaling curve on one host.

Usage:
    from gcn_maxcut.bench.scaling import scaling_sweep
    scaling_sweep(n=1_000_000, d=8, feature_dim=128)
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from gcn_maxcut.data.generate import random_regular_edges
from gcn_maxcut.models.gcn import gcn_conv_init
from gcn_maxcut.parallel.mesh import make_mesh
from gcn_maxcut.parallel.partition import (
    local_shard,
    shard_graph,
    shard_specs,
)
from gcn_maxcut.parallel.spmm import sharded_gcn_conv
from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)


def bench_sharded_conv(
    n: int,
    d: int,
    feature_dim: int = 128,
    out_dim: int = 128,
    num_devices: Optional[int] = None,
    schedule: str = "ring",
    iters: int = 10,
    seed: int = 0,
    edges: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Fwd+bwd of one sharded GCN conv on an n-node d-regular graph."""
    devices = jax.devices()[: num_devices or jax.device_count()]
    mesh = make_mesh(("graph",), devices=devices)
    D = len(devices)

    if edges is None:
        edges = random_regular_edges(n, d, seed=seed)
    senders = np.concatenate([edges[:, 0], edges[:, 1]])
    receivers = np.concatenate([edges[:, 1], edges[:, 0]])
    t0 = time.perf_counter()
    sg, _ = shard_graph(senders, receivers, n, D)
    partition_time = time.perf_counter() - t0

    params = gcn_conv_init(jax.random.PRNGKey(1), feature_dim, out_dim)
    x = jax.device_put(
        jax.random.normal(
            jax.random.PRNGKey(2), (D, sg.n_shard, feature_dim), jnp.float32
        ),
        NamedSharding(mesh, P("graph")),
    )

    def loss(w, b, x_):
        def local(sg_, x__):
            y = sharded_gcn_conv(w, b, local_shard(sg_), x__[0], "graph", schedule)
            return jax.lax.psum(jnp.sum(y**2), "graph")

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(shard_specs(sg), P("graph")),
            out_specs=P(),
        )(sg, x_)

    fwd = jax.jit(lambda x_: loss(params["w"], params["b"], x_))
    grad = jax.jit(jax.grad(lambda x_: loss(params["w"], params["b"], x_)))

    def timeit(fn, *a):
        for _ in range(2):
            jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters

    t_fwd = timeit(fwd, x)
    t_bwd = timeit(grad, x)
    e = int(senders.shape[0])
    res = {
        "n": n,
        "d": d,
        "num_devices": D,
        "schedule": schedule,
        "partition_time_s": partition_time,
        "fwd_time_s": t_fwd,
        "fwd_edges_per_s": e / t_fwd,
        "fwdbwd_time_s": t_bwd,
        "fwdbwd_edges_per_s": e / t_bwd,
    }
    logger.info(
        "sharded conv n=%d d=%d D=%d (%s): fwd %.2e edges/s, fwd+bwd %.2e",
        n, d, D, schedule, res["fwd_edges_per_s"], res["fwdbwd_edges_per_s"],
    )
    return res


def scaling_sweep(
    n: int,
    d: int = 8,
    feature_dim: int = 128,
    device_counts: Optional[Sequence[int]] = None,
    schedule: str = "ring",
) -> List[Dict[str, float]]:
    """edges/s at increasing device counts (1, 2, 4, ..., all)."""
    total = jax.device_count()
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= total]
        if total not in device_counts:
            device_counts.append(total)
    edges = random_regular_edges(n, d, seed=0)
    out = []
    for c in device_counts:
        out.append(
            bench_sharded_conv(
                n, d, feature_dim, num_devices=c, schedule=schedule, edges=edges
            )
        )
    base = out[0]["fwdbwd_edges_per_s"]
    for r in out:
        r["scaling_efficiency"] = (
            r["fwdbwd_edges_per_s"] / (base * r["num_devices"])
        )
    return out
