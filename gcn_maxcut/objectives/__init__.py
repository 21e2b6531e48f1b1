from gcn_maxcut.objectives.cut_loss import (
    relaxed_cut_value,
    cut_loss,
    compute_loss,
    sampled_cut_stats,
    quantile_cut_loss,
    terminal_independence_penalty,
    balance_penalty,
    find_ac_parameters,
    hard_cut_value,
)
from gcn_maxcut.objectives.qubo import qubo_loss, maxcut_qubo_edges

__all__ = [
    "relaxed_cut_value",
    "cut_loss",
    "compute_loss",
    "sampled_cut_stats",
    "quantile_cut_loss",
    "terminal_independence_penalty",
    "balance_penalty",
    "find_ac_parameters",
    "hard_cut_value",
    "qubo_loss",
    "maxcut_qubo_edges",
]
