"""Scalable classical max-cut baseline: first-improvement sweep search.

The n<=500 baselines (``local_search.greedy_flip_local_search``,
``simulated_annealing``) cost O(E) PER MOVE — right for exactness
comparisons at reference scale, physically infeasible at the 100k/10M
node scales of BASELINE configs[3..4] (one flip = one full edge pass).
The scalable classical greedy is the SWEEP search: one pass moves every
node to its best class in index order (Gauss-Seidel — later nodes see
earlier moves), O(E) per sweep, converging in tens of sweeps.  It is the
baseline column of every at-scale quality table (PARITY §4–5) and the
at-scale analog of the refine decoder: sweeping from the GCN's decode
measures the model's warm-start value against sweeping from random.

Fast path: ``native/graphtools.cpp::gt_greedy_sweep`` (~0.03 s at 100k,
~7 s at 10M/80M edges).  Fallback (no native toolkit): a vectorized
numpy *stochastic parallel* sweep — all improving nodes flip with
probability 1/2 each round (simultaneous flipping of ALL improving nodes
oscillates on bipartite-ish structures; the random half-subset breaks
the symmetry).  Same fixed-terminal contract; converges to a local
optimum of the same neighborhood, but is not bit-identical to the
Gauss-Seidel order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def greedy_sweep_maxcut(
    edges: np.ndarray,
    n: int,
    init_assignment: np.ndarray,
    k: int = 3,
    num_fixed: int = 3,
    weights: np.ndarray | None = None,
    max_sweeps: int = 100,
    seed: int = 0,
) -> Tuple[np.ndarray, float, int]:
    """Sweep local search from ``init_assignment``.

    ``edges``: [E, 2] undirected pairs.  Returns ``(assignment,
    cut_value, sweeps_used)``.  Terminals ``0..num_fixed-1`` never move.
    """
    from gcn_maxcut.native.bindings import greedy_sweep_native

    out = greedy_sweep_native(
        edges, n, init_assignment, k=k, num_fixed=num_fixed,
        weights=weights, max_sweeps=max_sweeps,
    )
    if out is not None:
        return out

    # numpy fallback: stochastic parallel sweeps
    rng = np.random.default_rng(seed)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    w = (
        np.ones(edges.shape[0], np.float32)
        if weights is None
        else np.asarray(weights, np.float32)
    )
    w2 = np.concatenate([w, w])
    asn = np.asarray(init_assignment, np.int64).copy()
    movable = np.arange(n) >= num_fixed
    sweeps = 0
    for sweeps in range(1, max_sweeps + 1):
        # cw[i, c] = weight from node i into class c
        cw = np.zeros((n, k), np.float32)
        np.add.at(cw, (src, asn[dst]), w2)
        best_c = np.argmin(cw, axis=1)
        gain = cw[np.arange(n), asn] - cw[np.arange(n), best_c]
        improving = movable & (best_c != asn) & (gain > 1e-9)
        improving &= rng.random(n) < 0.5
        if not improving.any():
            # re-check without the coin flip: converged?
            if not (movable & (best_c != asn) & (gain > 1e-9)).any():
                break
            continue
        asn[improving] = best_c[improving]
    cut = float(w[asn[edges[:, 0]] != asn[edges[:, 1]]].sum())
    return asn, cut, sweeps


__all__ = ["greedy_sweep_maxcut"]
