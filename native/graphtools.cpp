// graphtools — native host-side graph toolkit for gcn_maxcut.
//
// The reference relies on external native code for everything heavy (DGL's
// C++ kernels, the CPLEX binary; SURVEY.md §2).  Device compute here is
// JAX/XLA/Pallas; this library covers the *host* side of the pipeline where
// Python loops would dominate at the 10M-node scale of BASELINE.json
// configs[3..4]:
//
//   * gt_random_regular  — Steger–Wormald pairing-model sampler of simple
//                          d-regular graphs (replaces the NumPy sampler in
//                          data/generate.py for large n; ~100x faster).
//   * gt_sort_by_receiver— counting sort of a directed COO edge list
//                          (CSR assembly for core.graph construction).
//   * gt_bfs_partition   — BFS-grown balanced node blocks (METIS-style
//                          locality) for parallel.partition.
//   * gt_brute_force_maxcut — exhaustive small-n k-way max-cut with pinned
//                          terminals (host-side oracle / solver).
//   * gt_greedy_maxcut   — best-improvement flip local search (host
//                          baseline for verifying device local search).
//
// Exposed as a plain C ABI consumed via ctypes (gcn_maxcut/native/).
// Build: make -C native  (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

extern "C" {

// Sample a simple d-regular graph on n nodes. Writes n*d/2 undirected edges
// as (src[i], dst[i]) with src < dst. Returns edge count, or -1 on failure
// (n*d odd, d >= n, or restart budget exhausted).
int64_t gt_random_regular(int64_t n, int32_t d, uint64_t seed,
                          int32_t* src, int32_t* dst) {
  if (n <= 0 || d < 0 || d >= n || (n * (int64_t)d) % 2 != 0) return -1;
  if (d == 0) return 0;
  const int64_t m_target = n * (int64_t)d / 2;
  std::mt19937_64 rng(seed);

  // edge hash set keyed by packed (lo, hi)
  auto pack = [](int64_t a, int64_t b) { return (a << 32) | b; };

  std::vector<int64_t> stubs;
  stubs.reserve(n * (size_t)d);
  for (int restart = 0; restart < 256; ++restart) {
    stubs.clear();
    for (int64_t v = 0; v < n; ++v)
      for (int32_t j = 0; j < d; ++j) stubs.push_back(v);
    std::shuffle(stubs.begin(), stubs.end(), rng);

    std::unordered_set<int64_t> edges;
    edges.reserve(m_target * 2);
    bool stalled = false;
    std::vector<int64_t> retry;
    while (!stubs.empty()) {
      retry.clear();
      size_t fresh = 0;
      for (size_t i = 0; i + 1 < stubs.size(); i += 2) {
        int64_t a = stubs[i], b = stubs[i + 1];
        int64_t lo = std::min(a, b), hi = std::max(a, b);
        if (lo != hi && edges.insert(pack(lo, hi)).second) {
          ++fresh;
        } else {
          retry.push_back(a);
          retry.push_back(b);
        }
      }
      if (retry.empty()) { stubs.clear(); break; }
      if (fresh == 0 && retry.size() == stubs.size()) { stalled = true; break; }
      stubs.swap(retry);
      std::shuffle(stubs.begin(), stubs.end(), rng);
    }
    if (!stalled && (int64_t)edges.size() == m_target) {
      int64_t i = 0;
      for (int64_t key : edges) {
        src[i] = (int32_t)(key >> 32);
        dst[i] = (int32_t)(key & 0xffffffff);
        ++i;
      }
      return m_target;
    }
  }
  return -1;
}

// In-place counting sort of a directed COO list by receiver (stable).
// w may be null. n is the node-id upper bound.
void gt_sort_by_receiver(int64_t e, int64_t n, int32_t* src, int32_t* dst,
                         float* w) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) count[dst[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) count[v + 1] += count[v];
  std::vector<int32_t> s2(e), d2(e);
  std::vector<float> w2(w ? e : 0);
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    int64_t p = pos[dst[i]]++;
    s2[p] = src[i];
    d2[p] = dst[i];
    if (w) w2[p] = w[i];
  }
  std::memcpy(src, s2.data(), e * sizeof(int32_t));
  std::memcpy(dst, d2.data(), e * sizeof(int32_t));
  if (w) std::memcpy(w, w2.data(), e * sizeof(float));
}

// BFS-grown balanced partition into num_shards blocks. Directed COO input
// (both directions present). Writes owner[v] in [0, num_shards).
void gt_bfs_partition(int64_t n, int64_t e, const int32_t* src,
                      const int32_t* dst, int32_t num_shards,
                      int32_t* owner) {
  // CSR by src
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) indptr[src[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
  std::vector<int32_t> adj(e);
  std::vector<int64_t> pos(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) adj[pos[src[i]]++] = dst[i];

  const int64_t target = (n + num_shards - 1) / num_shards;
  std::fill(owner, owner + n, -1);
  int64_t next_seed = 0;
  std::queue<int32_t> q;
  for (int32_t shard = 0; shard < num_shards; ++shard) {
    int64_t cnt = 0;
    while (cnt < target) {
      if (q.empty()) {
        while (next_seed < n && owner[next_seed] != -1) ++next_seed;
        if (next_seed >= n) break;
        owner[next_seed] = shard;
        q.push((int32_t)next_seed);
        ++cnt;
      }
      int32_t v = q.front();
      q.pop();
      for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
        int32_t u = adj[j];
        if (owner[u] == -1 && cnt < target) {
          owner[u] = shard;
          ++cnt;
          q.push(u);
        }
      }
    }
    std::queue<int32_t>().swap(q);
  }
  for (int64_t v = 0; v < n; ++v)
    if (owner[v] == -1) owner[v] = num_shards - 1;
}

// Exhaustive k-way max-cut, terminals 0..num_fixed-1 pinned to their own
// classes. Undirected COO (src < dst). Writes the optimum into best_asn,
// returns its cut value (or -1 if k^(n-num_fixed) > 2^40).
double gt_brute_force_maxcut(int32_t n, int64_t e, const int32_t* src,
                             const int32_t* dst, const float* w, int32_t k,
                             int32_t num_fixed, int32_t* best_asn) {
  int32_t free_n = n - num_fixed;
  double total = 1;
  for (int32_t i = 0; i < free_n; ++i) {
    total *= k;
    if (total > 1099511627776.0) return -1;  // 2^40
  }
  std::vector<int32_t> asn(n), best(n);
  for (int32_t i = 0; i < num_fixed; ++i) asn[i] = i;
  double best_val = -1;
  uint64_t codes = (uint64_t)total;
  for (uint64_t code = 0; code < codes; ++code) {
    uint64_t c = code;
    for (int32_t i = 0; i < free_n; ++i) {
      asn[num_fixed + i] = (int32_t)(c % k);
      c /= k;
    }
    double val = 0;
    for (int64_t j = 0; j < e; ++j)
      if (asn[src[j]] != asn[dst[j]]) val += w ? w[j] : 1.0;
    if (val > best_val) {
      best_val = val;
      best = asn;
    }
  }
  std::copy(best.begin(), best.end(), best_asn);
  return best_val;
}

// Best-improvement flip local search from the given assignment.
// Terminals 0..num_fixed-1 never move. Returns the final cut value.
double gt_greedy_maxcut(int32_t n, int64_t e, const int32_t* src,
                        const int32_t* dst, const float* w, int32_t k,
                        int32_t num_fixed, int32_t* asn, int64_t max_steps) {
  // CSR over undirected edges (both directions)
  std::vector<int64_t> indptr(n + 1, 0);
  std::vector<int32_t> adj(2 * e);
  std::vector<float> wts(2 * e);
  for (int64_t i = 0; i < e; ++i) {
    indptr[src[i] + 1]++;
    indptr[dst[i] + 1]++;
  }
  for (int32_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
  {
    std::vector<int64_t> pos(indptr.begin(), indptr.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
      float ww = w ? w[i] : 1.0f;
      adj[pos[src[i]]] = dst[i];
      wts[pos[src[i]]++] = ww;
      adj[pos[dst[i]]] = src[i];
      wts[pos[dst[i]]++] = ww;
    }
  }
  auto cut_of = [&]() {
    double val = 0;
    for (int64_t i = 0; i < e; ++i)
      if (asn[src[i]] != asn[dst[i]]) val += w ? w[i] : 1.0;
    return val;
  };
  std::vector<double> cw(k);
  for (int64_t step = 0; step < max_steps; ++step) {
    double best_gain = 1e-9;
    int32_t best_v = -1, best_c = -1;
    for (int32_t v = num_fixed; v < n; ++v) {
      std::fill(cw.begin(), cw.end(), 0.0);
      for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j)
        cw[asn[adj[j]]] += wts[j];
      double cur = cw[asn[v]];
      for (int32_t c = 0; c < k; ++c) {
        double gain = cur - cw[c];
        if (c != asn[v] && gain > best_gain) {
          best_gain = gain;
          best_v = v;
          best_c = c;
        }
      }
    }
    if (best_v < 0) break;
    asn[best_v] = best_c;
  }
  return cut_of();
}

// ---- node-sharded COO assembly (parallel/partition.shard_graph hot path) --
//
// Phase 1 (gt_shard_counts): local node index within each shard, shard
// sizes, per-(receiver-shard, ring-hop) bucket sizes, and the
// per-(bucket, local-receiver) in-degree histogram; returns the max in-
// degree (the ELL width).  Phase 2 (gt_shard_fill) scatters the edges into
// the padded [D, D, e_group] group buffers — sorted stably by local
// receiver within each bucket via the phase-1 histogram turned into run
// offsets — and fills the ELL tables and degree vector in the same pass.
// The NumPy path does the same with an O(E log E) lexsort + several full-
// array gathers; this is O(E) with one read pass and one write pass.

// owner: [n] node -> shard.  Outputs: local[n], shard_sizes[D],
// counts[D*D], deg_group[D*D*n_shard] (caller-zeroed int32).
// Returns max ELL width, or -1 if any owner/id is out of range.
int64_t gt_shard_counts(int64_t e, int64_t n, int32_t num_shards,
                        const int32_t* src, const int32_t* dst,
                        const int32_t* owner, int64_t n_shard,
                        int32_t* local, int64_t* shard_sizes,
                        int64_t* counts, int32_t* deg_group) {
  const int32_t D = num_shards;
  std::fill(shard_sizes, shard_sizes + D, 0);
  for (int64_t v = 0; v < n; ++v) {
    int32_t o = owner[v];
    if (o < 0 || o >= D) return -1;
    local[v] = (int32_t)shard_sizes[o]++;
  }
  std::fill(counts, counts + (int64_t)D * D, 0);
  int64_t ell_w = 0;
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -1;
    int32_t d = owner[dst[i]];
    int32_t g = owner[src[i]] - d;
    if (g < 0) g += D;
    int64_t ds = (int64_t)d * D + g;
    counts[ds]++;
    int32_t c = ++deg_group[ds * n_shard + local[dst[i]]];
    if (c > ell_w) ell_w = c;
  }
  return ell_w;
}

// Scatter pass.  deg_group is the phase-1 histogram (consumed/overwritten).
// S/R/W/M: [D*D*e_group] (uninitialized; fully written incl. padding).
// degrees: [D*n_shard] (uninitialized).  ES/EW/EM: [D*D*n_shard*ell_w] or
// null when ell_w == 0.  w may be null (unit weights).
void gt_shard_fill(int64_t e, int64_t n, int32_t num_shards, int64_t n_shard,
                   int64_t e_group, int64_t ell_w, const int32_t* src,
                   const int32_t* dst, const float* w, const int32_t* owner,
                   const int32_t* local, int64_t* counts, int32_t* deg_group,
                   int32_t* S, int32_t* R, float* W, float* M, float* degrees,
                   int32_t* ES, float* EW, float* EM) {
  const int32_t D = num_shards;
  const int64_t DD = (int64_t)D * D;
  const int32_t pad_idx = (int32_t)(n_shard - 1);

  // degrees from the histogram before it is turned into offsets
  std::fill(degrees, degrees + (int64_t)D * n_shard, 0.0f);
  for (int32_t d = 0; d < D; ++d)
    for (int32_t g = 0; g < D; ++g) {
      const int32_t* row = deg_group + ((int64_t)d * D + g) * n_shard;
      float* out = degrees + (int64_t)d * n_shard;
      for (int64_t r = 0; r < n_shard; ++r) out[r] += (float)row[r];
    }

  // per-(bucket, local receiver) run offsets: exclusive prefix sum within
  // each bucket; run_start keeps the original value for ELL slot indices.
  std::vector<int32_t> run_start((size_t)DD * n_shard);
  for (int64_t ds = 0; ds < DD; ++ds) {
    int32_t* h = deg_group + ds * n_shard;
    int32_t* rs = run_start.data() + ds * n_shard;
    int32_t acc = 0;
    for (int64_t r = 0; r < n_shard; ++r) {
      int32_t c = h[r];
      rs[r] = acc;
      h[r] = acc;  // becomes the running cursor
      acc += c;
    }
  }

  // single scatter pass in original edge order (stable within runs)
  for (int64_t i = 0; i < e; ++i) {
    int32_t d = owner[dst[i]];
    int32_t g = owner[src[i]] - d;
    if (g < 0) g += D;
    int64_t ds = (int64_t)d * D + g;
    int32_t rl = local[dst[i]];
    int32_t pos = deg_group[ds * n_shard + rl]++;
    int64_t idx = ds * e_group + pos;
    int32_t sl = local[src[i]];
    float wi = w ? w[i] : 1.0f;
    S[idx] = sl;
    R[idx] = rl;
    W[idx] = wi;
    M[idx] = 1.0f;
    if (ell_w > 0) {
      int64_t slot = pos - run_start[(size_t)ds * n_shard + rl];
      int64_t eidx = (ds * n_shard + rl) * ell_w + slot;
      ES[eidx] = sl;
      EW[eidx] = wi;
      EM[eidx] = 1.0f;
    }
  }

  // pad the bucket tails (mask 0, indices point at the last local row)
  for (int64_t ds = 0; ds < DD; ++ds) {
    int64_t used = counts[ds];
    int64_t base = ds * e_group;
    for (int64_t p = used; p < e_group; ++p) {
      S[base + p] = pad_idx;
      R[base + p] = pad_idx;
      W[base + p] = 0.0f;
      M[base + p] = 0.0f;
    }
  }

  // pad the ELL slot tails (deg_group now holds the end cursor of each run)
  if (ell_w > 0) {
    for (int64_t dsr = 0; dsr < DD * n_shard; ++dsr) {
      int64_t used = deg_group[dsr] - run_start[(size_t)dsr];
      int64_t base = dsr * ell_w;
      for (int64_t s = used; s < ell_w; ++s) {
        ES[base + s] = pad_idx;
        EW[base + s] = 0.0f;
        EM[base + s] = 0.0f;
      }
    }
  }
}

// Order-independent 128-bit hash of the directed COO multiset {(a, b, w)}.
// gt_symmetry_check compares hash(s, r, w) with hash(r, s, w): equality
// certifies A^T = A up to negligible collision probability — O(E), no sort.
static inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

int32_t gt_symmetry_check(int64_t e, const int32_t* src, const int32_t* dst,
                          const float* w) {
  uint64_t add_f = 0, xor_f = 0, add_b = 0, xor_b = 0;
  for (int64_t i = 0; i < e; ++i) {
    uint32_t wb;
    float wf = w ? w[i] : 1.0f;
    std::memcpy(&wb, &wf, 4);
    // ((a << 32) | b) is injective in (a, b); fold w in after one mix
    uint64_t wk = 0x9e3779b97f4a7c15ULL * ((uint64_t)wb + 1);
    uint64_t hf = mix64(mix64(((uint64_t)(uint32_t)src[i] << 32) |
                              (uint32_t)dst[i]) ^ wk);
    uint64_t hb = mix64(mix64(((uint64_t)(uint32_t)dst[i] << 32) |
                              (uint32_t)src[i]) ^ wk);
    add_f += hf;
    xor_f ^= hf;
    add_b += hb;
    xor_b ^= hb;
  }
  return (add_f == add_b && xor_f == xor_b) ? 1 : 0;
}

}  // extern "C" (reopened below — the partitioner needs C++ internals)

// ---------------------------------------------------------------------------
// Multilevel (METIS-style) graph partitioner: heavy-edge-matching
// coarsening -> BFS-grown initial partition on the coarsest graph ->
// greedy boundary (KL/FM-style) refinement at every uncoarsening level.
// Balance: each part's VERTEX WEIGHT (contained fine-vertex count) stays
// under ceil(n / parts) * (1 + imbalance).
//
// This is the "METIS-style edge partitioning" of the north star
// (BASELINE.json): not a binding to the METIS library (no external deps)
// but the same algorithmic skeleton (Karypis & Kumar '98).  Quality is
// measured against the single-level BFS partitioner in
// experiments/partition_quality_r5.py -> docs/ + DESIGN.md.

namespace {

struct CsrW {
  std::vector<int64_t> indptr;
  std::vector<int32_t> adj;
  std::vector<float> wts;
};

// build CSR over undirected edges given directed COO (both directions in)
CsrW build_csr(int64_t n, int64_t e, const int32_t* src, const int32_t* dst,
               const float* w) {
  CsrW g;
  g.indptr.assign(n + 1, 0);
  g.adj.resize(e);
  g.wts.resize(e);
  for (int64_t i = 0; i < e; ++i) g.indptr[src[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) g.indptr[v + 1] += g.indptr[v];
  std::vector<int64_t> pos(g.indptr.begin(), g.indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    g.adj[pos[src[i]]] = dst[i];
    g.wts[pos[src[i]]++] = w ? w[i] : 1.0f;
  }
  return g;
}

struct Level {
  CsrW g;
  std::vector<float> vwgt;     // vertex weights (fine-vertex counts)
  std::vector<int32_t> map;    // fine vertex -> coarse vertex (next level)
};

// one heavy-edge-matching coarsening step; returns coarse vertex count
int64_t hem_coarsen(const CsrW& g, const std::vector<float>& vwgt, int64_t n,
                    uint64_t seed, std::vector<int32_t>& cmap) {
  std::vector<int32_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = (int32_t)v;
  std::mt19937_64 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  cmap.assign(n, -1);
  int64_t nc = 0;
  for (int64_t ii = 0; ii < n; ++ii) {
    int32_t v = order[ii];
    if (cmap[v] != -1) continue;
    // pick the unmatched neighbor with the heaviest total edge weight
    // (parallel edges accumulate naturally as we scan)
    int32_t best_u = -1;
    float best_w = 0.0f;
    for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
      int32_t u = g.adj[j];
      if (u == v || cmap[u] != -1) continue;
      if (g.wts[j] > best_w) {
        best_w = g.wts[j];
        best_u = u;
      }
    }
    cmap[v] = (int32_t)nc;
    if (best_u != -1) cmap[best_u] = (int32_t)nc;
    ++nc;
  }
  return nc;
}

// contract g by cmap into gc (aggregating parallel edge weights)
void contract(const CsrW& g, const std::vector<float>& vwgt, int64_t n,
              const std::vector<int32_t>& cmap, int64_t nc, CsrW& gc,
              std::vector<float>& cvwgt) {
  cvwgt.assign(nc, 0.0f);
  for (int64_t v = 0; v < n; ++v) cvwgt[cmap[v]] += vwgt[v];
  // collect coarse edges via per-coarse-node hashing against a stamp array
  std::vector<int64_t> head(nc + 1, 0);
  std::vector<std::pair<int32_t, float>> buf;  // (neighbor, weight) runs
  std::vector<int64_t> stamp(nc, -1);
  std::vector<int64_t> slot(nc, 0);
  std::vector<std::vector<int32_t>> members(nc);
  for (int64_t v = 0; v < n; ++v) members[cmap[v]].push_back((int32_t)v);
  gc.indptr.assign(nc + 1, 0);
  std::vector<int32_t> tmp_adj;
  std::vector<float> tmp_w;
  for (int64_t c = 0; c < nc; ++c) {
    int64_t start = (int64_t)tmp_adj.size();
    for (int32_t v : members[c]) {
      for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
        int32_t uc = cmap[g.adj[j]];
        if (uc == c) continue;  // internal edge vanishes
        if (stamp[uc] != c) {
          stamp[uc] = c;
          slot[uc] = (int64_t)tmp_adj.size();
          tmp_adj.push_back(uc);
          tmp_w.push_back(g.wts[j]);
        } else {
          tmp_w[slot[uc]] += g.wts[j];
        }
      }
    }
    gc.indptr[c + 1] = (int64_t)tmp_adj.size() - start;
  }
  for (int64_t c = 0; c < nc; ++c) gc.indptr[c + 1] += gc.indptr[c];
  gc.adj = std::move(tmp_adj);
  gc.wts = std::move(tmp_w);
  (void)head;
  (void)buf;
}

// BFS-grown initial partition on the coarsest graph, balanced by vwgt
void initial_partition(const CsrW& g, const std::vector<float>& vwgt,
                       int64_t n, int32_t parts, float target,
                       std::vector<int32_t>& part) {
  part.assign(n, -1);
  int64_t seedv = 0;
  std::vector<int64_t> queue;
  for (int32_t p = 0; p < parts; ++p) {
    float wsum = 0.0f;
    queue.clear();
    size_t qh = 0;
    while (wsum < target) {
      if (qh >= queue.size()) {
        while (seedv < n && part[seedv] != -1) ++seedv;
        if (seedv >= n) break;
        queue.push_back(seedv);
        part[seedv] = p;
        wsum += vwgt[seedv];
      }
      if (qh >= queue.size()) break;
      int64_t v = queue[qh++];
      for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
        int32_t u = g.adj[j];
        if (part[u] == -1 && wsum + vwgt[u] <= target * 1.02f) {
          part[u] = p;
          wsum += vwgt[u];
          queue.push_back(u);
        }
      }
    }
  }
  for (int64_t v = 0; v < n; ++v)
    if (part[v] == -1) part[v] = parts - 1;
}

// greedy boundary refinement: a few sweeps of single-vertex moves with
// positive edge-cut gain, subject to the balance cap
void refine(const CsrW& g, const std::vector<float>& vwgt, int64_t n,
            int32_t parts, float cap, std::vector<int32_t>& part,
            int sweeps) {
  std::vector<float> pw(parts, 0.0f);
  for (int64_t v = 0; v < n; ++v) pw[part[v]] += vwgt[v];
  std::vector<float> conn(parts, 0.0f);
  std::vector<int32_t> touched;
  for (int s = 0; s < sweeps; ++s) {
    int64_t moves = 0;
    for (int64_t v = 0; v < n; ++v) {
      int32_t pv = part[v];
      touched.clear();
      bool boundary = false;
      for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
        int32_t pu = part[g.adj[j]];
        if (conn[pu] == 0.0f) touched.push_back(pu);
        conn[pu] += g.wts[j];
        if (pu != pv) boundary = true;
      }
      if (boundary) {
        float internal = conn[pv];
        int32_t best_p = pv;
        float best_gain = 1e-6f;
        for (int32_t pu : touched) {
          if (pu == pv) continue;
          float gain = conn[pu] - internal;
          if (gain > best_gain && pw[pu] + vwgt[v] <= cap) {
            best_gain = gain;
            best_p = pu;
          }
        }
        if (best_p != pv) {
          pw[pv] -= vwgt[v];
          pw[best_p] += vwgt[v];
          part[v] = best_p;
          ++moves;
        }
      }
      for (int32_t pu : touched) conn[pu] = 0.0f;
    }
    if (moves == 0) break;
  }
}

}  // namespace

extern "C" void gt_metis_partition(int64_t n, int64_t e, const int32_t* src,
                                   const int32_t* dst, const float* w,
                                   int32_t parts, float imbalance,
                                   uint64_t seed, int32_t* owner) {
  std::vector<Level> levels;
  levels.emplace_back();
  levels.back().g = build_csr(n, e, src, dst, w);
  levels.back().vwgt.assign(n, 1.0f);
  int64_t cur_n = n;
  const int64_t floor_n = std::max<int64_t>(128, 32 * parts);
  // coarsen until small or the matching stalls (<10% reduction)
  while (cur_n > floor_n) {
    Level& top = levels.back();
    std::vector<int32_t> cmap;
    int64_t nc =
        hem_coarsen(top.g, top.vwgt, cur_n, seed + levels.size(), cmap);
    if (nc > cur_n * 9 / 10) break;
    top.map = cmap;
    Level next;
    contract(top.g, top.vwgt, cur_n, cmap, nc, next.g, next.vwgt);
    levels.push_back(std::move(next));
    cur_n = nc;
  }
  float target = (float)n / parts;
  float cap = target * (1.0f + imbalance);
  // initial partition at the coarsest level
  std::vector<int32_t> part;
  initial_partition(levels.back().g, levels.back().vwgt, cur_n, parts,
                    target, part);
  refine(levels.back().g, levels.back().vwgt, cur_n, parts, cap, part, 8);
  // uncoarsen with refinement at each level
  for (int64_t li = (int64_t)levels.size() - 2; li >= 0; --li) {
    Level& lv = levels[li];
    int64_t ln = (int64_t)lv.vwgt.size();
    std::vector<int32_t> fine(ln);
    for (int64_t v = 0; v < ln; ++v) fine[v] = part[lv.map[v]];
    part = std::move(fine);
    refine(lv.g, lv.vwgt, ln, parts, cap, part, li == 0 ? 4 : 2);
  }
  std::copy(part.begin(), part.end(), owner);
}

extern "C" {

// First-improvement sweep local search: repeatedly sweep all nodes in
// index order, moving each to its best class immediately (gains of later
// nodes see earlier moves — Gauss-Seidel style), until a full sweep makes
// no move or max_sweeps is hit.  O(E) per sweep, converges in tens of
// sweeps — THE scalable greedy (gt_greedy_maxcut above is best-improvement
// with one flip per O(n·d) scan: right for n<=1k exactness comparisons,
// infeasible at the 100k/10M-node scales the at-scale quality tables
// need).  Terminals 0..num_fixed-1 never move.  Returns the final cut;
// sweeps_used reports convergence.
double gt_greedy_sweep(int32_t n, int64_t e, const int32_t* src,
                       const int32_t* dst, const float* w, int32_t k,
                       int32_t num_fixed, int32_t* asn, int32_t max_sweeps,
                       int32_t* sweeps_used) {
  std::vector<int64_t> indptr(n + 1, 0);
  std::vector<int32_t> adj(2 * e);
  std::vector<float> wts(2 * e);
  for (int64_t i = 0; i < e; ++i) {
    indptr[src[i] + 1]++;
    indptr[dst[i] + 1]++;
  }
  for (int32_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
  {
    std::vector<int64_t> pos(indptr.begin(), indptr.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
      float ww = w ? w[i] : 1.0f;
      adj[pos[src[i]]] = dst[i];
      wts[pos[src[i]]++] = ww;
      adj[pos[dst[i]]] = src[i];
      wts[pos[dst[i]]++] = ww;
    }
  }
  std::vector<double> cw(k);
  int32_t sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    int64_t moves = 0;
    for (int32_t v = num_fixed; v < n; ++v) {
      std::fill(cw.begin(), cw.end(), 0.0);
      for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j)
        cw[asn[adj[j]]] += wts[j];
      int32_t best_c = asn[v];
      double best_w = cw[best_c];
      for (int32_t c = 0; c < k; ++c)
        if (cw[c] < best_w - 1e-9) {
          best_w = cw[c];
          best_c = c;
        }
      if (best_c != asn[v]) {
        asn[v] = best_c;
        ++moves;
      }
    }
    if (moves == 0) break;
  }
  if (sweeps_used) *sweeps_used = sweep;
  double val = 0;
  for (int64_t i = 0; i < e; ++i)
    if (asn[src[i]] != asn[dst[i]]) val += w ? w[i] : 1.0;
  return val;
}

}  // extern "C"
