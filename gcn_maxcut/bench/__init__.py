from gcn_maxcut.bench.roofline import RooflineModel, device_specs
from gcn_maxcut.bench.microbench import (
    bench_spmm,
    bench_train_epoch,
    bench_post_processing,
)
from gcn_maxcut.bench.kway_sweep import kway_sweep

__all__ = [
    "RooflineModel",
    "device_specs",
    "bench_spmm",
    "bench_train_epoch",
    "bench_post_processing",
    "kway_sweep",
]
