"""At-scale workflow: giant-graph training, classical anchoring, refinement.

The reference tops out at n=500 (SURVEY.md §5.7); this example is the
framework's at-scale recipe (BASELINE configs[3..4]) in library-API form:

  1. build / partition a large graph (contiguous, BFS, or the native
     multilevel METIS-style partitioner);
  2. train the node-sharded GCN (ring halo-exchange SpMM inside one
     shard_map'd jit; optional hop-0 block-ELL routing when the graph has
     latent locality);
  3. decode an assignment and REFINE it with the native sweep search;
  4. anchor the result against the classical baseline (the same sweep
     from a random init) — the at-scale attribution ablation of
     PARITY §4-5.

Defaults are sized to run on CPU in ~a minute; scale `N` up on a GPU
(10M-node circulant graphs use `bench.giant_demo.train_banded_giant_packed`
instead).

Run:  python examples/giant_scale_pipeline.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gcn_maxcut.baselines import greedy_sweep_maxcut
from gcn_maxcut.parallel import partition_nodes_metis, partition_quality
from gcn_maxcut.parallel.giant import GiantConfig, train_giant_graph

N = 20_000
D_REG = 8
K = 3
SEED = 0


def build_graph():
    """A semi-local graph: banded neighbors + 2% random rewires — the
    class where locality-aware partitioning and block-ELL routing pay."""
    rng = np.random.default_rng(SEED)
    offs = rng.choice(np.arange(1, 257), D_REG // 2, replace=False)
    s = np.concatenate([np.arange(N)] * (D_REG // 2))
    r = np.concatenate([(np.arange(N) + o) % N for o in offs])
    rewire = rng.random(r.shape[0]) < 0.02
    r = np.where(rewire, rng.integers(0, N, r.shape[0]), r)
    keep = s != r
    s, r = s[keep], r[keep]
    return np.concatenate([s, r]), np.concatenate([r, s])


def main():
    senders, receivers = build_graph()
    e_und = senders.shape[0] // 2

    # -- 1. partitioning quality check (what the ring will pay) ----------
    owner = partition_nodes_metis(senders, receivers, N, 4)
    q = partition_quality(owner, senders, receivers)
    print(f"metis 4-way partition: {100 * q['cross_shard_edge_fraction']:.2f}% "
          f"cross-shard edges, imbalance {q['imbalance']:.3f}")

    # -- 2. sharded training (single-process mesh; same code on a slice) -
    cfg = GiantConfig(
        num_classes=K, dim_embedding=64, hidden_dim=32,
        number_epochs=40, epochs_per_call=10, log_every=10, seed=SEED,
        local_reorder="off",      # "rcm" bands each shard's local rows
    )
    out = train_giant_graph(
        senders, receivers, N, cfg, return_assignment=True
    )
    gcn_frac = out["final_cut"] / e_und
    print(f"GCN cut after {out['epochs']} epochs: "
          f"{out['final_cut']:.0f}/{e_und} ({100 * gcn_frac:.1f}%)")

    # -- 3. refine the decode with the native sweep search ---------------
    edges = np.stack([senders[: senders.shape[0] // 2],
                      receivers[: senders.shape[0] // 2]], axis=1)
    asn = np.asarray(out["assignment"], np.int64)
    _, refined_cut, sweeps = greedy_sweep_maxcut(edges, N, asn, k=K)
    print(f"GCN + sweep refine: {refined_cut:.0f} "
          f"({100 * refined_cut / e_und:.1f}%) in {sweeps} sweeps")

    # -- 4. classical anchor: the same sweep from a random init ----------
    rng = np.random.default_rng(123)
    rand_init = rng.integers(0, K, N)
    rand_init[:K] = np.arange(K)
    _, rand_cut, rsweeps = greedy_sweep_maxcut(edges, N, rand_init, k=K)
    print(f"random-init sweep baseline: {rand_cut:.0f} "
          f"({100 * rand_cut / e_und:.1f}%) in {rsweeps} sweeps")
    print(f"GCN warm-start margin: {refined_cut - rand_cut:+.0f} edges")


if __name__ == "__main__":
    main()
