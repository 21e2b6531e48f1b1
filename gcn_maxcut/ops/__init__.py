from gcn_maxcut.ops.segment import (
    spmm,
    spmm_xla,
    sddmm,
    segment_sum_edges,
)
from gcn_maxcut.ops.ste import (
    pin_terminals,
    ste_argmax_onehot,
    ste_threshold,
)

__all__ = [
    "spmm",
    "spmm_xla",
    "sddmm",
    "segment_sum_edges",
    "pin_terminals",
    "ste_argmax_onehot",
    "ste_threshold",
]
