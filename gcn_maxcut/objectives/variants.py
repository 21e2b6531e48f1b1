"""Legacy loss-variant zoo for ablations — edge/segment form.

The reference accumulated ~15 loss variants across its history
(``Training/TrainingNeural_load.py``; SURVEY.md §2.3 "loss-variant zoo")
that its old notebooks ablate (``oldFiles/NeuralTesting_max.ipynb``).  The
actively-used loss lives in ``objectives.cut_loss``; this module provides
the ablation set, each O(E·k) without materializing n×n:

  * ``ha_one_hot_penalty``   — HA: rows should be one-hot
    (``calculate_HA_vectorized``, ``TrainingNeural_load.py:202-210``:
    Σ_i (1 − Σ_c s_ic²) for normalized rows).
  * ``min_cut_intra_inter``  — intra-partition reward minus inter-partition
    penalty (``calculate_HC_min_cut_intra_inter``(+2), ``:212-248``).
  * ``min_cut_loss_pairwise``— Σ over partition pairs k<l of the relaxed
    inter-partition weight (``min_cut_loss``, ``:289-318``).
  * ``per_partition_cut``    — per-class cut contributions
    (``calculate_HC_vectorized`` per-partition form, ``:351-374``).
  * ``weighted_cut_loss``    — C·(−HC) + A·HA, the general two-term form the
    legacy ``hyperParameters`` tuples configure (``:113-118``).
"""

from __future__ import annotations

import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.objectives.cut_loss import relaxed_cut_value
from gcn_maxcut.ops.segment import sddmm


def ha_one_hot_penalty(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """HA: Σ over real nodes of (1 − ||s_i||²); zero iff every row one-hot."""
    sq = jnp.sum(s * s, axis=-1)
    return jnp.sum(g.node_mask * (1.0 - sq))


def intra_partition_weight(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """Relaxed weight of edges inside partitions: Σ_E w·⟨s_u, s_v⟩."""
    same = sddmm(g, s, s)
    return jnp.sum(g.weights * same) / 2.0


def min_cut_intra_inter(
    g: Graph, s: jnp.ndarray, alpha: float = 1.0, beta: float = 1.0
) -> jnp.ndarray:
    """min-cut flavored loss: β·inter − α·intra (lower = denser partitions)."""
    inter = relaxed_cut_value(g, s)
    intra = intra_partition_weight(g, s)
    return beta * inter - alpha * intra


def min_cut_loss_pairwise(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """Σ_{k<l} relaxed weight between partitions k and l.

    Algebraically equal to the full relaxed cut (every crossing edge has
    exactly one (k, l) endpoint pair in expectation of one-hot rows), kept
    separate for parity with the legacy pairwise formulation.
    """
    k = s.shape[-1]
    total = jnp.zeros(())
    for a in range(k):
        for b in range(a + 1, k):
            cross = sddmm(g, s[:, a : a + 1], s[:, b : b + 1]) + sddmm(
                g, s[:, b : b + 1], s[:, a : a + 1]
            )
            total = total + jnp.sum(g.weights * cross) / 2.0
    return total


def per_partition_cut(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """[k] vector: each class's relaxed boundary weight Σ_E w·s_u,c(1−s_v,c)."""
    su = s[g.senders]
    sv = s[g.receivers]
    contrib = su * (1.0 - sv) * (g.weights * g.edge_mask)[:, None]
    return jnp.sum(contrib, axis=0) / 2.0


def weighted_cut_loss(
    g: Graph, s: jnp.ndarray, A: float = 0.0, C: float = 1.0
) -> jnp.ndarray:
    """General two-term legacy objective: C·(−HC) + A·HA."""
    loss = C * (-relaxed_cut_value(g, s))
    if A:
        loss = loss + A * ha_one_hot_penalty(g, s)
    return loss
