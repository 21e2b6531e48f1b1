from gcn_maxcut.baselines.randomized import (
    randomized_k_way_maxcut,
    evaluate_algorithm_on_graphs,
    benchmark_algorithm,
    test_fixed_terminals,
    quick_demo,
)
from gcn_maxcut.baselines.local_search import (
    greedy_flip_local_search,
    simulated_annealing,
    breakout_local_search,
    multi_max_cut_recursive,
)
from gcn_maxcut.baselines.sweep import greedy_sweep_maxcut
from gcn_maxcut.baselines.exact import (
    brute_force_maxcut,
    recursive_flow_min_cut,
    anytime_solver,
    solver_balanced,
)

__all__ = [
    "randomized_k_way_maxcut",
    "evaluate_algorithm_on_graphs",
    "benchmark_algorithm",
    "test_fixed_terminals",
    "quick_demo",
    "greedy_flip_local_search",
    "greedy_sweep_maxcut",
    "simulated_annealing",
    "breakout_local_search",
    "multi_max_cut_recursive",
    "brute_force_maxcut",
    "recursive_flow_min_cut",
    "anytime_solver",
    "solver_balanced",
]
