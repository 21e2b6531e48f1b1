"""VERDICT r4 #6: measured edge-cut comparison of the partitioners at the
1M-node scale (host-only; the quality metric is partition_quality's
cross-shard edge fraction — the ring-traffic driver).

Graph classes:
  banded       circulant d=8 within +-63 (contiguous is provably optimal)
  semilocal    banded +-256 with 5% uniform endpoint rewires (latent
               locality, no contiguous structure guarantee after rewires)
  shuffled     the banded graph under a random node relabeling (locality
               exists but is hidden from contiguous ranges)
  expander     uniform random 8-regular (no partitioner can do well;
               the information-theoretic cut floor is ~(D-1)/D)

Run:  python experiments/partition_quality_r5.py [n]
Writes docs/partition_quality_r5.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
D_SHARDS = 8
SEED = 0


def graphs():
    rng = np.random.default_rng(SEED)
    n = N

    def banded(w, rewire):
        offs = rng.choice(np.arange(1, w + 1), 4, replace=False)
        s = np.concatenate([np.arange(n)] * 4)
        r = np.concatenate([(np.arange(n) + o) % n for o in offs])
        if rewire:
            rew = rng.random(r.shape[0]) < rewire
            r = np.where(rew, rng.integers(0, n, r.shape[0]), r)
        keep = s != r
        s, r = s[keep], r[keep]
        return np.concatenate([s, r]), np.concatenate([r, s])

    yield "banded", banded(63, 0.0)
    yield "semilocal", banded(256, 0.05)
    s, r = banded(63, 0.0)
    perm = rng.permutation(n)
    yield "shuffled", (perm[s], perm[r])
    from gcn_maxcut.data.generate import random_regular_edges

    e = random_regular_edges(n, 8, seed=SEED)
    yield "expander", (
        np.concatenate([e[:, 0], e[:, 1]]),
        np.concatenate([e[:, 1], e[:, 0]]),
    )


def main():
    from gcn_maxcut.parallel import (
        partition_nodes_bfs,
        partition_nodes_contiguous,
        partition_nodes_metis,
    )
    from gcn_maxcut.parallel.partition import partition_quality

    out = {}
    for name, (s, r) in graphs():
        row = {"n": N, "e_directed": int(s.shape[0])}
        for pname in ("contiguous", "bfs", "metis"):
            t0 = time.perf_counter()
            if pname == "contiguous":
                owner = partition_nodes_contiguous(N, D_SHARDS)
            elif pname == "bfs":
                owner = partition_nodes_bfs(s, r, N, D_SHARDS)
            else:
                owner = partition_nodes_metis(s, r, N, D_SHARDS)
            q = partition_quality(owner, s, r)
            row[pname] = {
                "cut_frac": q["cross_shard_edge_fraction"],
                "imbalance": q["imbalance"],
                "time_s": time.perf_counter() - t0,
            }
        out[name] = row
        print(name, json.dumps(row), flush=True)
    with open("/root/repo/docs/partition_quality_r5.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
