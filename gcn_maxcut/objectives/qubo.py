"""QUBO objective for the legacy 2-way (PI-GNN) formulation — edge form.

The reference's legacy path builds a dense Q from the max-cut Hamiltonian
(``commons.py:38-63`` via ``gen_q_dict_maxcut``-style dicts) and evaluates
``loss = xᵀ Q x`` (``utils.py:127-141``).  For max-cut, Q decomposes over
edges:  Q_uv = w_uv (u≠v, both triangles),  Q_uu = −deg_w(u),  so

    xᵀ Q x = Σ_{(u,v) ∈ E} w_uv · (2 x_u x_v − x_u − x_v)
           = −cut(x)            for binary x,

which we evaluate as a segment sum without materializing Q.
"""

from __future__ import annotations

import jax.numpy as jnp

from gcn_maxcut.core.graph import Graph


def maxcut_qubo_edges(g: Graph, x: jnp.ndarray) -> jnp.ndarray:
    """Per-directed-edge QUBO contribution ``w·(2 x_u x_v − x_u − x_v)/2``."""
    xu = x[g.senders]
    xv = x[g.receivers]
    return g.weights * g.edge_mask * (2.0 * xu * xv - xu - xv) / 2.0


def qubo_loss(g: Graph, x: jnp.ndarray) -> jnp.ndarray:
    """xᵀ Q x for the max-cut QUBO; equals −cut(x) on binary x.

    ``x`` is ``[n_pad]`` (relaxed probabilities in [0, 1]).
    """
    return jnp.sum(maxcut_qubo_edges(g, x))
