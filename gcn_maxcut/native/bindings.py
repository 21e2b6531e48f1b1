"""ctypes bindings for the native host toolkit (``native/graphtools.cpp``).

Builds ``libgraphtools.so`` from source on first use, and again whenever
``graphtools.cpp`` is newer than the library (``make -C native``); every entry
point has a pure-Python fallback elsewhere in the package
(``data.generate.random_regular_edges``, ``parallel.partition_nodes_bfs``,
``baselines.brute_force_maxcut``), so the framework works without a
compiler — the native path is the fast lane for 10M-node-scale host work.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gcn_maxcut.utils.logging import get_logger

logger = get_logger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SRC_PATH = _NATIVE_DIR / "graphtools.cpp"
_LIB_PATH = _NATIVE_DIR / "libgraphtools.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _up_to_date() -> bool:
    return (
        _LIB_PATH.exists()
        and _LIB_PATH.stat().st_mtime >= _SRC_PATH.stat().st_mtime
    )


def build(force: bool = False) -> bool:
    """Compile the shared library when it is missing or older than its
    source (or always, with ``force``); returns success.

    The compiler writes a file private to this process, which then
    replaces the library in one rename, so concurrent builders (test
    workers) never load a half-written library."""
    if _up_to_date() and not force:
        return True
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}")
    try:
        subprocess.run(
            ["make", "-B", "-C", str(_NATIVE_DIR), f"LIB={tmp.name}"],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        logger.warning("native build failed: %s", e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.gt_random_regular.restype = ctypes.c_int64
    lib.gt_random_regular.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, i32p, i32p,
    ]
    lib.gt_sort_by_receiver.restype = None
    lib.gt_sort_by_receiver.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, f32p,
    ]
    lib.gt_bfs_partition.restype = None
    lib.gt_bfs_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, ctypes.c_int32, i32p,
    ]
    lib.gt_brute_force_maxcut.restype = ctypes.c_double
    lib.gt_brute_force_maxcut.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    lib.gt_greedy_maxcut.restype = ctypes.c_double
    lib.gt_greedy_maxcut.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int64,
    ]
    lib.gt_greedy_sweep.restype = ctypes.c_double
    lib.gt_greedy_sweep.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32, i32p,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gt_shard_counts.restype = ctypes.c_int64
    lib.gt_shard_counts.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p, i32p, i32p,
        ctypes.c_int64, i32p, i64p, i64p, i32p,
    ]
    lib.gt_shard_fill.restype = None
    lib.gt_shard_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, f32p, i32p, i32p,
        i64p, i32p, i32p, i32p, f32p, f32p, f32p, i32p, f32p, f32p,
    ]
    lib.gt_symmetry_check.restype = ctypes.c_int32
    lib.gt_symmetry_check.argtypes = [ctypes.c_int64, i32p, i32p, f32p]
    lib.gt_metis_partition.restype = None
    lib.gt_metis_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, f32p,
        ctypes.c_int32, ctypes.c_float, ctypes.c_uint64, i32p,
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def random_regular_edges_native(
    n: int, d: int, seed: int = 0
) -> Optional[np.ndarray]:
    """Undirected edge list [m, 2] (src < dst), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    m = n * d // 2
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    got = lib.gt_random_regular(
        n, d, seed,
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
    )
    if got < 0:
        raise RuntimeError(f"native regular sampler failed (n={n}, d={d})")
    edges = np.stack([src, dst], axis=1).astype(np.int64)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


def sort_by_receiver_native(
    src: np.ndarray, dst: np.ndarray, n: int, w: np.ndarray | None = None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    lib = _load()
    if lib is None:
        order = np.argsort(dst, kind="stable")
        return src[order], dst[order], None if w is None else w[order]
    s = _i32(src).copy()
    d = _i32(dst).copy()
    ww = None if w is None else np.ascontiguousarray(w, dtype=np.float32).copy()
    lib.gt_sort_by_receiver(
        s.shape[0], n,
        _ptr(s, ctypes.POINTER(ctypes.c_int32)),
        _ptr(d, ctypes.POINTER(ctypes.c_int32)),
        _ptr(ww, ctypes.POINTER(ctypes.c_float)) if ww is not None else None,
    )
    return s, d, ww


def bfs_partition_native(
    src: np.ndarray, dst: np.ndarray, n: int, num_shards: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    s, d = _i32(src), _i32(dst)
    owner = np.empty(n, dtype=np.int32)
    lib.gt_bfs_partition(
        n, s.shape[0],
        _ptr(s, ctypes.POINTER(ctypes.c_int32)),
        _ptr(d, ctypes.POINTER(ctypes.c_int32)),
        num_shards,
        _ptr(owner, ctypes.POINTER(ctypes.c_int32)),
    )
    return owner.astype(np.int64)


def brute_force_maxcut_native(
    edges: np.ndarray, n: int, k: int = 3, num_fixed: int = 3,
    weights: np.ndarray | None = None,
) -> Optional[Tuple[np.ndarray, float]]:
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(edges[:, 0]), _i32(edges[:, 1])
    w = (
        None if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    asn = np.empty(n, dtype=np.int32)
    val = lib.gt_brute_force_maxcut(
        n, src.shape[0],
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
        _ptr(w, ctypes.POINTER(ctypes.c_float)) if w is not None else None,
        k, num_fixed,
        _ptr(asn, ctypes.POINTER(ctypes.c_int32)),
    )
    if val < 0:
        raise ValueError("problem too large for native brute force")
    return asn.astype(np.int64), float(val)


def greedy_maxcut_native(
    edges: np.ndarray, n: int, init_asn: np.ndarray, k: int = 3,
    num_fixed: int = 3, weights: np.ndarray | None = None,
    max_steps: int = 100_000,
) -> Optional[Tuple[np.ndarray, float]]:
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(edges[:, 0]), _i32(edges[:, 1])
    w = (
        None if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    asn = _i32(init_asn).copy()
    val = lib.gt_greedy_maxcut(
        n, src.shape[0],
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
        _ptr(w, ctypes.POINTER(ctypes.c_float)) if w is not None else None,
        k, num_fixed,
        _ptr(asn, ctypes.POINTER(ctypes.c_int32)),
        max_steps,
    )
    return asn.astype(np.int64), float(val)


def greedy_sweep_native(
    edges: np.ndarray, n: int, init_asn: np.ndarray, k: int = 3,
    num_fixed: int = 3, weights: np.ndarray | None = None,
    max_sweeps: int = 100,
) -> Optional[Tuple[np.ndarray, float, int]]:
    """First-improvement sweep local search (``gt_greedy_sweep``): O(E)
    per full node sweep, Gauss-Seidel within a sweep, until converged or
    ``max_sweeps``.  THE scalable classical greedy for the 100k/10M-node
    quality tables (:func:`greedy_maxcut_native` is best-improvement —
    one flip per O(n*d) scan — exact-style but infeasible at scale).

    Returns ``(assignment, cut_value, sweeps_used)`` or None if the
    native toolkit is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(edges[:, 0]), _i32(edges[:, 1])
    w = (
        None if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    asn = _i32(init_asn).copy()
    used = np.zeros(1, dtype=np.int32)
    val = lib.gt_greedy_sweep(
        n, src.shape[0],
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
        _ptr(w, ctypes.POINTER(ctypes.c_float)) if w is not None else None,
        k, num_fixed,
        _ptr(asn, ctypes.POINTER(ctypes.c_int32)),
        max_sweeps,
        _ptr(used, ctypes.POINTER(ctypes.c_int32)),
    )
    return asn.astype(np.int64), float(val), int(used[0])


def metis_partition_native(
    senders: np.ndarray, receivers: np.ndarray, n: int, num_parts: int,
    weights: np.ndarray | None = None, imbalance: float = 0.03,
    seed: int = 0,
) -> Optional[np.ndarray]:
    """Multilevel (METIS-style) node partition: heavy-edge-matching
    coarsening -> BFS initial partition -> KL/FM-style boundary refinement
    at each uncoarsening level (``gt_metis_partition``).  Takes the
    DIRECTED COO (both edge directions); returns node -> part, or None if
    the native toolkit is unavailable.  Quality vs the single-level BFS
    partitioner: experiments/partition_quality_r5.py / DESIGN.md.
    """
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(senders), _i32(receivers)
    w = (
        None if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    owner = np.zeros(n, dtype=np.int32)
    lib.gt_metis_partition(
        n, src.shape[0],
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
        _ptr(w, ctypes.POINTER(ctypes.c_float)) if w is not None else None,
        num_parts, imbalance, seed,
        _ptr(owner, ctypes.POINTER(ctypes.c_int32)),
    )
    return owner.astype(np.int64)


def symmetry_check_native(
    senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray | None
) -> Optional[bool]:
    """Order-independent hashed A^T = A check, O(E) single pass; None if
    the library is unavailable (callers fall back to the sort-based check)."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _i32(senders), _i32(receivers)
    w = (
        None if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    ok = lib.gt_symmetry_check(
        src.shape[0],
        _ptr(src, ctypes.POINTER(ctypes.c_int32)),
        _ptr(dst, ctypes.POINTER(ctypes.c_int32)),
        _ptr(w, ctypes.POINTER(ctypes.c_float)) if w is not None else None,
    )
    return bool(ok)


def shard_assembly_native(
    senders: np.ndarray,
    receivers: np.ndarray,
    owner: np.ndarray,
    n: int,
    num_shards: int,
    weights: np.ndarray | None = None,
    edge_pad_multiple: int = 128,
    build_ell: bool = True,
    ell_budget_bytes: int = 1 << 30,
) -> Optional[dict]:
    """O(E) native assembly of the node-sharded edge-group buffers.

    The C++ twin of ``parallel.partition.shard_graph``'s bucket assembly
    (same output contract, bit-for-bit): counting-sort by (receiver shard,
    ring hop, local receiver) with one read pass and one write pass —
    replaces the NumPy lexsort path at 10M-node scale (measured ~10x on the
    build host).  Returns None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None

    def _round_up(x: int, m: int) -> int:
        return ((x + m - 1) // m) * m if x else 0

    src, dst, own = _i32(senders), _i32(receivers), _i32(owner)
    e = src.shape[0]
    w = (
        None
        if weights is None
        else np.ascontiguousarray(weights, dtype=np.float32)
    )
    sizes = np.bincount(own, minlength=num_shards)
    n_shard = max(_round_up(int(sizes.max()) if sizes.size else 0, 8), 8)

    D = num_shards
    local = np.empty(n, dtype=np.int32)
    shard_sizes = np.empty(D, dtype=np.int64)
    counts = np.empty(D * D, dtype=np.int64)
    deg_group = np.zeros(D * D * n_shard, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    ell_w = lib.gt_shard_counts(
        e, n, D, _ptr(src, i32p), _ptr(dst, i32p), _ptr(own, i32p),
        n_shard, _ptr(local, i32p), _ptr(shard_sizes, i64p),
        _ptr(counts, i64p), _ptr(deg_group, i32p),
    )
    if ell_w < 0:
        raise ValueError("shard assembly: node id or owner out of range")

    e_group = _round_up(int(counts.max()) if counts.size else 0,
                        edge_pad_multiple)
    nz = int(np.count_nonzero(deg_group))
    mean_deg = (e / nz) if nz else 0.0
    ell_bytes = 3 * 4 * D * D * n_shard * int(ell_w)
    use_ell = (
        build_ell and ell_w > 0
        and ell_bytes <= ell_budget_bytes
        and ell_w <= max(8.0, 8.0 * mean_deg)
    )
    ell_w_eff = int(ell_w) if use_ell else 0

    S = np.empty((D, D, e_group), dtype=np.int32)
    R = np.empty_like(S)
    W = np.empty((D, D, e_group), dtype=np.float32)
    M = np.empty_like(W)
    degrees = np.empty((D, n_shard), dtype=np.float32)
    if use_ell:
        ES = np.empty((D, D, n_shard, ell_w_eff), dtype=np.int32)
        EW = np.empty((D, D, n_shard, ell_w_eff), dtype=np.float32)
        EM = np.empty_like(EW)
    else:
        ES = EW = EM = None
    lib.gt_shard_fill(
        e, n, D, n_shard, e_group, ell_w_eff,
        _ptr(src, i32p), _ptr(dst, i32p),
        _ptr(w, f32p) if w is not None else None,
        _ptr(own, i32p), _ptr(local, i32p),
        _ptr(counts, i64p), _ptr(deg_group, i32p),
        _ptr(S, i32p), _ptr(R, i32p), _ptr(W, f32p), _ptr(M, f32p),
        _ptr(degrees, f32p),
        _ptr(ES, i32p) if use_ell else None,
        _ptr(EW, f32p) if use_ell else None,
        _ptr(EM, f32p) if use_ell else None,
    )
    return {
        "local": local.astype(np.int64),
        "shard_sizes": shard_sizes,
        "n_shard": n_shard,
        "e_group": e_group,
        "S": S, "R": R, "W": W, "M": M,
        "degrees": degrees,
        "ES": ES, "EW": EW, "EM": EM,
        "use_ell": use_ell,
    }
