"""NumPy oracle reproducing the reference's dense semantics for parity tests.

Written from the math in SURVEY.md §2.3/§7.3 (dense HC formula, DGL
GraphConv norm='both', straight-through detach algebra); used to verify that
the edge-form implementations are algebraically identical.
"""

from __future__ import annotations

import numpy as np


def dense_pad(mat: np.ndarray, width: int) -> np.ndarray:
    """Zero-extend columns of an n×n matrix to n×width (rows stay n).

    Mirrors ``extend_matrix_torch`` semantics (reference
    ``TrainingNeural.py:137-152``): rectangular padding.
    """
    n = mat.shape[0]
    out = np.zeros((n, width), dtype=mat.dtype)
    out[:, : mat.shape[1]] = mat
    return out


def oracle_hc(s: np.ndarray, adj_padded: np.ndarray) -> float:
    """Reference dense relaxed cut: sum(A ⊙ (1 − pad(S Sᵀ))) / 2."""
    n = s.shape[0]
    width = adj_padded.shape[1]
    ssT = s @ s.T
    return float(np.sum(adj_padded * (1.0 - dense_pad(ssT, width))) / 2.0)


def oracle_gcn_conv(
    adj: np.ndarray, x: np.ndarray, w: np.ndarray, b: np.ndarray
) -> np.ndarray:
    """Dense DGL GraphConv norm='both': D̃^{-1/2} A D̃^{-1/2} X W + b."""
    deg = np.maximum(adj.sum(axis=1), 1.0)
    dinv = deg ** -0.5
    return dinv[:, None] * (adj @ (dinv[:, None] * (x @ w))) + b


def oracle_cut_value(adj: np.ndarray, assignment: np.ndarray) -> float:
    """Exact cut of an integer assignment from a dense weighted adjacency."""
    differs = assignment[:, None] != assignment[None, :]
    return float(np.sum(adj * differs) / 2.0)


def brute_force_maxcut(
    adj: np.ndarray, k: int, fixed: dict[int, int] | None = None
) -> tuple[float, np.ndarray]:
    """Exhaustive k-way max-cut for tiny n (oracle for solver tests)."""
    n = adj.shape[0]
    fixed = fixed or {}
    free = [i for i in range(n) if i not in fixed]
    best_val, best_asn = -1.0, None
    asn = np.zeros(n, dtype=np.int64)
    for i, c in fixed.items():
        asn[i] = c
    for code in range(k ** len(free)):
        c = code
        for i in free:
            asn[i] = c % k
            c //= k
        val = oracle_cut_value(adj, asn)
        if val > best_val:
            best_val, best_asn = val, asn.copy()
    return best_val, best_asn
