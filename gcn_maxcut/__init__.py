"""gcn_maxcut — a JAX GNN framework for unsupervised k-way max-cut.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
research repo ``MJavaadAkhtar/GCN-max-cut`` (see SURVEY.md): seeded random
regular-graph generation with terminal nodes, terminal normalization,
dense-extended node embeddings, a 2-layer GCN with a differentiable
negative-cut loss and straight-through terminal pinning/argmax, probabilistic
post-processing, randomized/heuristic/exact baselines, and analysis reports —
all built for the accelerator (static shapes, padded CSR/COO sparse
adjacency, ELL-gather and banded SpMM, shard_map multi-device scaling).

Layout:
  core/        sparse graph containers (static-shape pytrees), padding
  ops/         SpMM/SDDMM (ELL gather, segment-sum, banded stream), STE ops
  models/      GCNConv (DGL GraphConv semantics), GCNSoftmax, GCNDev
  objectives/  differentiable cut losses, penalties, QUBO loss
  data/        graph generation (host + on-device), terminal normalization,
               dataset assembly/serialization
  train/       configs, optimizer, training loop, checkpointing
  eval/        decoders, vmapped post-processing sampler, analysis, reports
  baselines/   randomized k-way, SA, BLS, local search, exact solvers
  parallel/    mesh setup, edge partitioning, halo exchange, sharded SpMM
  bench/       roofline model, microbenchmarks
  viz/         publication charts (matplotlib, gated)
  utils/       timing, logging, profiling helpers
"""

__version__ = "0.1.0"
