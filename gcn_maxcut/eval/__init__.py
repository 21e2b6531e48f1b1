from gcn_maxcut.eval.decode import (
    simple_assignment,
    sample_partitions,
    post_process,
    terminal_permutation_search,
)
from gcn_maxcut.eval.harness import (
    test_single_graph,
    test_multiple_graphs,
    analyze_results,
    print_analysis_report,
    generate_summary_report,
    save_results,
    load_results,
)

__all__ = [
    "simple_assignment",
    "sample_partitions",
    "post_process",
    "terminal_permutation_search",
    "test_single_graph",
    "test_multiple_graphs",
    "analyze_results",
    "print_analysis_report",
    "generate_summary_report",
    "save_results",
    "load_results",
]
