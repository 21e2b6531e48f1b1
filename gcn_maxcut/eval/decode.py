"""Decoders: argmax assignment, vmapped sampling post-processor, perm search.

Accelerator-native redesign of the reference's evaluation hot loop
(``Testing/TestingNeuralNetwork.py``): the reference samples assignments with
a per-node Python inverse-CDF loop repeated 200× per graph
(``assign_partitions`` :18-46 inside ``post_processing_optimization``
:66-98), measured at ~374× the forward-pass runtime (SURVEY.md §3.2).  Here
all ``iterations`` rollouts are one ``vmap``-ed device call: sample a
``[iters, n]`` assignment matrix from the categorical distributions, pin
terminals, evaluate every cut with an O(E) segment sum, and argmax — no host
transfer until the final scalar.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph
from gcn_maxcut.objectives.cut_loss import hard_cut_value
from gcn_maxcut.ops.ste import pin_terminals


def simple_assignment(probs: jnp.ndarray, num_terminals: int = 3) -> jnp.ndarray:
    """Row argmax, then force terminals ``0..t-1`` to their own classes.

    Reference ``simple_partition_assignment``
    (``TestingNeuralNetwork.py:100-122``).
    """
    assignment = jnp.argmax(probs, axis=-1)
    ids = jnp.arange(assignment.shape[0])
    return jnp.where(ids < num_terminals, ids, assignment)


def sample_partitions(
    probs: jnp.ndarray, key: jax.Array, num_samples: int, num_terminals: int = 3
) -> jnp.ndarray:
    """``[num_samples, n]`` categorical samples; terminals pinned.

    Inverse-CDF semantics identical to reference ``assign_partitions``
    (``TestingNeuralNetwork.py:18-46``) including its fallback-to-last-class
    when a row's probabilities sum below the uniform draw.
    """
    n, k = probs.shape
    cdf = jnp.cumsum(probs, axis=-1)                    # [n, k]
    u = jax.random.uniform(key, (num_samples, n, 1))
    # first class whose cumulative prob exceeds u == count of classes with
    # cdf <= u; clipping implements the reference's last-class fallback.
    sampled = jnp.sum(u >= cdf[None, :, :], axis=-1)
    sampled = jnp.clip(sampled, 0, k - 1)
    ids = jnp.arange(n)[None, :]
    return jnp.where(ids < num_terminals, ids, sampled)


def post_process(
    g: Graph,
    probs: jnp.ndarray,
    key: jax.Array,
    iterations: int = 200,
    num_terminals: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best-of-N sampled rounding: returns ``(best_assignment, best_cut)``.

    Reference ``post_processing_optimization``
    (``TestingNeuralNetwork.py:66-98``) as one jitted device call.
    """
    samples = sample_partitions(probs, key, iterations, num_terminals)
    cuts = jax.vmap(lambda a: hard_cut_value(g, a))(samples)
    best = jnp.argmax(cuts)
    return samples[best], cuts[best]


post_process_jit = jax.jit(post_process, static_argnames=("iterations", "num_terminals"))


def refine_with_local_search(
    g: Graph,
    assignment: jnp.ndarray,
    k: int = 3,
    num_terminals: int = 3,
    max_steps: int = 500,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy single-node flips from a decoded assignment to a local optimum.

    The hybrid GNN + local-search decoder (no reference analog; opt-in):
    starts from the argmax/post-processed assignment and applies
    best-improvement moves on device.  Strictly improves the cut; costs one
    ``lax.while_loop`` of O(E) steps.
    """
    from gcn_maxcut.baselines.local_search import greedy_flip_local_search

    return greedy_flip_local_search(
        g, assignment.astype(jnp.int32), k, num_terminals, max_steps
    )


def refine_multi_start(
    g: Graph,
    probs: jnp.ndarray,
    key: jax.Array,
    iterations: int = 200,
    starts: int = 4,
    k: int = 3,
    num_terminals: int = 3,
    max_steps: int = 500,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy-flip refinement from the top-``starts`` sampled assignments
    (plus the argmax decode), best result returned.

    The single-start refiner climbs from ONE local-search basin; vmapping
    the climb over the best few sampled rounding outcomes explores
    ``starts`` basins for nearly the same wall time (the vmapped
    ``while_loop`` runs all climbs in lockstep on an otherwise
    underutilized chip at these sizes).  Extends the hybrid decoder; no
    reference analog.
    """
    from gcn_maxcut.baselines.local_search import greedy_flip_local_search

    samples = sample_partitions(probs, key, iterations, num_terminals)
    cuts = jax.vmap(lambda a: hard_cut_value(g, a))(samples)
    top = jnp.argsort(cuts)[-max(1, starts - 1):]
    argmax_start = simple_assignment(probs, num_terminals)[None]
    starts_asn = jnp.concatenate(
        [samples[top].astype(jnp.int32), argmax_start.astype(jnp.int32)]
    )
    asns, rcuts = jax.vmap(
        lambda a: greedy_flip_local_search(g, a, k, num_terminals, max_steps)
    )(starts_asn)
    best = jnp.argmax(rcuts)
    return asns[best], rcuts[best]


def terminal_permutation_search(
    g: Graph, probs: jnp.ndarray, num_terminals: int = 3
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best argmax decode over all k! class-relabelings of the head.

    Capability parity with ``evaluate_optimal_partitioning`` /
    ``generate_terminal_permutations`` (reference
    ``TrainingNeural.py:212-289``): the class indices are permuted before
    decoding (terminals stay pinned to 0/1/2), and the best resulting cut is
    returned as ``(best_assignment, best_cut)``.
    """
    from itertools import permutations

    k = probs.shape[-1]
    perms = jnp.asarray(list(permutations(range(k))), dtype=jnp.int32)  # [k!, k]

    def decode_with(perm):
        asn = simple_assignment(probs[:, perm], num_terminals)
        return asn, hard_cut_value(g, asn)

    assignments, cuts = jax.vmap(decode_with)(perms)
    best = jnp.argmax(cuts)
    return assignments[best], cuts[best]
