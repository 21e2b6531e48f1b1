"""Graph generation: seeded random regular / G(n,p) graphs with terminals.

Capability parity with the reference's ``DataGenerator/GraphCreator.py``
(``generate_graph`` :31-92, ``generate_unique_terminals`` :93-109,
``generate_graph_dataset`` :112-183) without NetworkX in the core path:

  * ``random_regular_edges`` — pairing-model sampler with suitability checks
    (Steger–Wormald style restarts), pure NumPy, seeded and deterministic.
  * ``gnp_edges`` — G(n, p) Erdős–Rényi sampler ('prob'/'erdos' types).
  * ``generate_graph_dataset`` — batch generation with random (n, d) per
    graph, parity skipping (n·d odd), and a retry budget, returning the
    same ``(graphs, terminals)`` dict-of-index contract as the reference.
  * ``regular_graph_on_device`` — jit-compiled on-device generator for very
    large benchmark graphs (union of d/2 independent random cyclic shifts:
    exactly d-regular, static shapes, no host loops) — the scale path the
    reference has no analog for (SURVEY.md §2.9).

Graphs are represented as ``GraphSpec`` (edge array + n + terminals); the
tensorization to padded `Graph` pytrees lives in ``data/process.py``.

Seed discipline: one ``numpy.random.Generator`` per call, derived from the
integer seed.  Sequences intentionally differ from NetworkX's sampler (the
reference's); distributional properties match (documented divergence,
SURVEY.md §7.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class GraphSpec:
    """Host-side graph record: undirected edge list + metadata."""

    n_nodes: int
    edges: np.ndarray                 # int64 [m, 2], u < v
    terminals: List[int]
    degree: int | None = None         # for regular graphs
    weights: np.ndarray | None = None # optional [m] float32; default all-1

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def random_regular_edges(n: int, d: int, seed: int | None = None, max_restarts: int = 200) -> np.ndarray:
    """Sample a simple d-regular graph on n nodes via the pairing model.

    Repeatedly draws a random perfect matching on the n·d stubs, restarting
    whenever only unsuitable pairs (self-loops / multi-edges) remain — the
    standard Steger–Wormald scheme, asymptotically uniform for small d.

    For large n the C++ sampler (``native/graphtools.cpp``,
    ``gt_random_regular``) is used when available; it implements the same
    scheme (different RNG stream, same distribution).
    """
    if n * d % 2 != 0:
        raise ValueError(f"n*d must be even (n={n}, d={d})")
    if not 0 <= d < n:
        raise ValueError(f"need 0 <= d < n (n={n}, d={d})")
    if d == 0:
        return np.empty((0, 2), dtype=np.int64)

    if n >= 20_000:
        try:
            from gcn_maxcut.native import (
                is_available,
                random_regular_edges_native,
            )

            if is_available():
                return random_regular_edges_native(
                    n, d, seed=0 if seed is None else int(seed)
                )
        except Exception:  # native path is best-effort
            pass

    rng = np.random.default_rng(seed)
    for _ in range(max_restarts):
        # stubs[i] = node owning stub i
        stubs = np.repeat(np.arange(n, dtype=np.int64), d)
        rng.shuffle(stubs)
        edges: set[tuple[int, int]] = set()
        stalled = False
        while stubs.size:
            # Pair consecutive stubs; keep the suitable pairs, re-shuffle rest.
            pairs = stubs.reshape(-1, 2)
            lo = np.minimum(pairs[:, 0], pairs[:, 1])
            hi = np.maximum(pairs[:, 0], pairs[:, 1])
            good = lo != hi
            fresh: set[tuple[int, int]] = set()
            retry: list[np.ndarray] = []
            for u, v, ok in zip(lo, hi, good):
                key = (int(u), int(v))
                if ok and key not in edges and key not in fresh:
                    fresh.add(key)
                else:
                    retry.append(np.array([u, v]))
            edges |= fresh
            if not retry:
                stubs = np.empty((0,), dtype=np.int64)
                break
            leftover = np.concatenate(retry)
            if not fresh and leftover.size == stubs.size:
                # no progress possible without breaking simplicity
                stalled = True
                break
            stubs = leftover
            rng.shuffle(stubs)
        if not stalled and len(edges) == n * d // 2:
            out = np.array(sorted(edges), dtype=np.int64)
            return out
    raise RuntimeError(f"failed to sample {d}-regular graph on {n} nodes")


def gnp_edges(n: int, p: float, seed: int | None = None) -> np.ndarray:
    """G(n, p) Erdős–Rényi undirected edge list (vectorized Bernoulli)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p
    return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int64)


def generate_unique_terminals(n: int, num_terminals: int = 3, seed: int | None = None) -> List[int]:
    """``num_terminals`` distinct node ids (reference ``GraphCreator.py:93-109``)."""
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.choice(n, size=num_terminals, replace=False)]


def generate_graph(
    n: int,
    d: int = 3,
    graph_type: str = "reg",
    p: float = 0.1,
    seed: int | None = None,
    num_terminals: int = 3,
) -> GraphSpec:
    """One graph with terminals; types mirror reference ``generate_graph``.

    ``'reg'`` seeded d-regular, ``'reg_random'`` unseeded d-regular,
    ``'prob'``/``'erdos'`` G(n, p).  Node ids are already ``0..n-1`` in
    sorted order (the reference relabels to achieve this,
    ``GraphCreator.py:82-85``).  Every edge carries weight/capacity 1
    (``:88-90``) — represented implicitly (weights None ⇒ all-1).
    """
    if graph_type == "reg":
        edges = random_regular_edges(n, d, seed=seed)
        deg = d
    elif graph_type == "reg_random":
        edges = random_regular_edges(n, d, seed=None)
        deg = d
    elif graph_type in ("prob", "erdos"):
        edges = gnp_edges(n, p, seed=seed)
        deg = None
    else:
        raise ValueError(f"unknown graph_type {graph_type!r}")
    terminals = generate_unique_terminals(
        n, num_terminals, seed=None if seed is None else seed + 1
    )
    return GraphSpec(n_nodes=n, edges=edges, terminals=terminals, degree=deg)


def generate_graph_dataset(
    num_graphs: int,
    min_nodes: int,
    max_nodes: int,
    min_degree: int,
    max_degree: int,
    graph_type: str = "reg",
    num_terminals: int = 3,
    base_seed: int | None = None,
) -> Tuple[Dict[int, GraphSpec], Dict[int, List[int]]]:
    """Batch generation with random (n, d), parity skip, and retry budget.

    Mirrors reference ``generate_graph_dataset`` (``GraphCreator.py:112-183``):
    n ~ U[min,max], d ~ U[min,max]; (n·d) odd combos are resampled; a budget
    of ``2·num_graphs`` attempts bounds the loop.  Returns dicts keyed by
    graph index, the contract every downstream stage consumes.
    """
    rng = np.random.default_rng(base_seed)
    graphs: Dict[int, GraphSpec] = {}
    terminals: Dict[int, List[int]] = {}
    attempts, max_attempts = 0, 2 * num_graphs
    i = 0
    while i < num_graphs and attempts < max_attempts:
        attempts += 1
        n = int(rng.integers(min_nodes, max_nodes + 1))
        d = int(rng.integers(min_degree, max_degree + 1))
        if graph_type in ("reg", "reg_random") and (n * d) % 2 != 0:
            continue
        seed = None if base_seed is None else base_seed + 1000 + i
        try:
            spec = generate_graph(
                n, d, graph_type, seed=seed, num_terminals=num_terminals
            )
        except RuntimeError:
            continue
        graphs[i] = spec
        terminals[i] = spec.terminals
        i += 1
    if i < num_graphs:
        raise RuntimeError(
            f"generated only {i}/{num_graphs} graphs in {max_attempts} attempts"
        )
    return graphs, terminals


def regular_graph_on_device(
    n: int, d: int, key: jax.Array
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exactly d-regular graph on device: union of d/2 random circulant shifts.

    Returns directed COO ``(senders, receivers)`` with ``n*d`` entries
    (both directions).  Each of the d/2 rounds picks a distinct random shift
    ``o_k ∈ [1, n/2]`` and adds edges ``(i, (i + o_k) mod n)`` — a circulant
    graph: every node gets degree exactly 2 per round, no self-loops, no
    multi-edges (shifts distinct, and o = n−o excluded by range).  Static
    shapes, O(n·d) work, no host transfer — the generator used for the
    100k/10M-node scaling configs (BASELINE.json configs[3..4]) where Python
    loops are infeasible.  Not a uniform regular-graph sampler; benchmark
    structure only (documented divergence).
    """
    if d % 2 != 0:
        raise ValueError("on-device generator requires even d")
    half = n // 2 - 1 if n % 2 == 0 else n // 2
    if d // 2 > half:
        raise ValueError(f"d={d} too large for distinct shifts with n={n}")
    # distinct shifts in [1, half]
    shifts = 1 + jax.random.choice(key, half, shape=(d // 2,), replace=False)
    nodes = jnp.arange(n, dtype=jnp.int32)
    src = jnp.tile(nodes, d // 2)
    dst = jnp.concatenate([(nodes + s) % n for s in shifts]).astype(jnp.int32)
    senders = jnp.concatenate([src, dst])
    receivers = jnp.concatenate([dst, src])
    return senders, receivers
