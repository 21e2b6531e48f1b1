"""Differentiable k-way cut objectives in edge (segment-sum) form.

The reference computes the relaxed cut with a dense n×n product
(``calculate_HC_vectorized``, ``Training/TrainingNeural.py:154-176``):

    HC(S, A) = sum( A ⊙ (1 − pad(S Sᵀ)) ) / 2

with A the n×max_nodes zero-padded adjacency.  Since A is zero outside the
real n×n block and symmetric, this is algebraically identical to the edge sum

    HC(S, A) = Σ_{(u,v) ∈ E_undirected} w_uv · (1 − ⟨s_u, s_v⟩)
             = ½ Σ_{(u,v) ∈ E_directed}  w_uv · (1 − ⟨s_u, s_v⟩)

which is what we evaluate — O(E·k) instead of O(n²·k), never materializing
n×n (SURVEY.md §7.3), and exactly equal in infinite precision.  The training
loss is the negative relaxed cut scaled by C
(``compute_loss``, reference ``TrainingNeural.py:291-309``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.ops.segment import sddmm


def relaxed_cut_value(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """HC: total (relaxed) weight of edges whose endpoints differ.

    ``s`` is ``[n_pad, k]`` — softmax probabilities, straight-through
    one-hots, or hard assignments; with one-hot rows this is the exact cut.
    Equals the reference's dense ``calculate_HC_vectorized`` formula
    (``TrainingNeural.py:154-176``) for any S, including relaxed S.
    """
    same_prob = sddmm(g, s, s)                      # [e_pad], <s_u, s_v>
    per_edge = g.weights * (g.edge_mask - same_prob * g.edge_mask)
    return jnp.sum(per_edge) / 2.0                  # directed edges double-count


def sampled_cut_stats(g: Graph, s: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(mean, variance) of the cut under independent per-node sampling.

    The 200-rollout decode (``eval/decode.post_process``, reference
    ``NeuralTestCode.py`` post-processing) draws each node's class
    independently from its probability row, so the sampled cut has
    closed-form statistics: per undirected edge the crossing indicator is
    Bernoulli(p_e) with ``p_e = 1 - <s_u, s_v>``, giving

        mean = Σ_e w_e p_e          variance ≈ Σ_e w_e² p_e (1 - p_e)

    (covariance between edges sharing a node is dropped — exact for
    uniform rows, small otherwise).  Both reduce over the directed edge
    list with the ½ correction, same as :func:`relaxed_cut_value`.
    """
    same = sddmm(g, s, s)                           # [e_pad], <s_u, s_v>
    pe = (1.0 - same) * g.edge_mask                 # crossing prob, masked
    mean = jnp.sum(g.weights * pe) / 2.0
    var = jnp.sum(g.weights ** 2 * pe * same) / 2.0  # p(1-p), mask via pe
    return mean, var


def quantile_cut_loss(
    g: Graph, s: jnp.ndarray, c: float = 2.6, C: float = 1.0
) -> jnp.ndarray:
    """loss = -C · (mean + c·std) of the sampled-decode cut.

    Trains the network for what the deployed decode actually reports —
    the best of N sampled assignments, whose expectation is ≈ mean +
    E[max of N standard normals]·std (c ≈ 2.6 for N = 200).  Unlike the
    STE argmax loss this rewards distributions that are *good on average
    and diverse where diversity is cheap* (near-tied nodes), which is
    exactly the slack the best-of-N decode exploits.
    """
    mean, var = sampled_cut_stats(g, s)
    return -C * (mean + c * jnp.sqrt(var + 1e-9))


def cut_loss(g: Graph, s: jnp.ndarray, C: float = 1.0) -> jnp.ndarray:
    """loss = C · (−HC): maximizing the cut by gradient descent."""
    return C * (-relaxed_cut_value(g, s))


def compute_loss(
    g: Graph,
    s: jnp.ndarray,
    A: float = 0.0,
    C: float = 1.0,
    penalty: float = 0.0,
    num_terminals: int = 3,
) -> jnp.ndarray:
    """Full training loss, mirroring reference ``compute_loss`` (:291-309).

    ``A`` is accepted for config parity (unused by the reference's active
    path too); ``penalty > 0`` additionally enables the terminal-independence
    term that the reference keeps available but commented out (``:308``).
    """
    del A
    loss = cut_loss(g, s, C)
    if penalty:
        loss = loss + penalty * terminal_independence_penalty(s, num_terminals)
    return loss


def terminal_independence_penalty(s: jnp.ndarray, num_terminals: int = 3) -> jnp.ndarray:
    """Σ_{i<j} <s_ti, s_tj> over terminal rows 0..t-1.

    Reference ``terminal_independence_penalty`` (``TrainingNeural.py:178-195``)
    with terminals normalized onto the leading rows.
    """
    t = s[:num_terminals]                           # [t, k]
    gram = t @ t.T                                  # [t, t]
    return (jnp.sum(gram) - jnp.trace(gram)) / 2.0


def balance_penalty(g: Graph, s: jnp.ndarray) -> jnp.ndarray:
    """Squared deviation of (masked) partition sizes from n/k.

    Differentiable analog of the CPLEX balanced variant's hard constraint
    ``|P_i| == n // 3`` (reference ``CPLEX/CplexCode.py:258-267``).
    """
    sizes = jnp.sum(s * g.node_mask[:, None], axis=0)       # [k]
    target = g.n_nodes.astype(s.dtype) / s.shape[-1]
    return jnp.sum((sizes - target) ** 2)


def hard_cut_value(g: Graph, assignment: jnp.ndarray) -> jnp.ndarray:
    """Exact cut value of an integer assignment ``[n_pad] -> {0..k-1}``.

    O(E) segment evaluation — the on-device replacement for the reference's
    Python edge loop ``calculate_cut_value``
    (``Testing/TestingNeuralNetwork.py:48-64``).
    """
    differs = (assignment[g.senders] != assignment[g.receivers]).astype(jnp.float32)
    return jnp.sum(g.weights * g.edge_mask * differs) / 2.0


def find_ac_parameters(g: Graph) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(A, C) = (maxdeg + 1, maxdeg / 2) heuristic.

    Reference ``find_ac_parameters`` (``TrainingNeural.py:197-210``).
    """
    max_degree = jnp.max(g.degrees * g.node_mask)
    return max_degree + 1.0, max_degree / 2.0
