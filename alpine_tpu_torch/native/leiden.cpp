// Leiden community detection (Traag, Waltman & van Eck, 2019) in C++.
//
// Native replacement for the reference's scanpy -> igraph/leidenalg call
// chain (the reference's alpine/optimization.py:271-272:
// `sc.tl.leiden(flavor="igraph", resolution=1)`), used by the
// ComponentOptimizer's CV scoring to cluster the unguided embedding.
// The port's copy of alpine_tpu/native/leiden.cpp: the algorithm is
// implemented here and exposed through a C ABI consumed via ctypes (see
// alpine_tpu_torch/native/__init__.py), with a pure-Python fallback.
//
// Quality function: RB-configuration modularity with resolution gamma
// (leidenalg's RBConfigurationVertexPartition, scanpy's default):
//   Q = sum_c [ e_c - gamma * K_c^2 / (2m) ] / (2m)
//
// Phases per level: (1) queue-based fast local move, (2) refinement inside
// each community with the well-connectedness constraint, (3) aggregation on
// the refined partition constrained by the local-move partition.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Graph {
  int64_t n;
  std::vector<int64_t> offs;   // CSR offsets, size n+1
  std::vector<int64_t> nbr;    // neighbor ids
  std::vector<double> w;       // edge weights (self-loops excluded; tracked apart)
  std::vector<double> self_w;  // self-loop weight per node
  std::vector<double> strength;  // sum_u w_vu + 2*self_w (degree incl. self-loop)
  double total_w2;               // 2m = sum of strengths
};

// Community bookkeeping for one level.
struct Partition {
  std::vector<int64_t> comm;    // node -> community id
  std::vector<double> K;        // community total strength
  std::vector<int64_t> size;    // community node count
};

Partition singleton_partition(const Graph& g) {
  Partition p;
  p.comm.resize(g.n);
  p.K = g.strength;
  p.size.assign(g.n, 1);
  for (int64_t v = 0; v < g.n; ++v) p.comm[v] = v;
  return p;
}

// Partition seeded from compacted labels (ids in [0, g.n)).  Canonical
// Leiden initializes each aggregate level from the PREVIOUS level's
// partition and keeps moving — restarting from singletons would discard
// merges whose pairwise block-merge gain is non-positive.
Partition partition_from_labels(const Graph& g,
                                const std::vector<int64_t>& labels) {
  Partition p;
  p.comm = labels;
  p.K.assign(g.n, 0.0);
  p.size.assign(g.n, 0);
  for (int64_t v = 0; v < g.n; ++v) {
    p.K[labels[v]] += g.strength[v];
    p.size[labels[v]] += 1;
  }
  return p;
}

// Queue-based fast local move. Returns true if anything moved.
bool local_move(const Graph& g, Partition& p, std::mt19937_64& rng,
                double gamma) {
  std::vector<int64_t> order(g.n);
  for (int64_t v = 0; v < g.n; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);

  std::vector<char> in_queue(g.n, 1);
  std::queue<int64_t> q;
  for (int64_t v : order) q.push(v);

  // scratch: community -> edge weight from current node
  std::vector<double> k_to(p.K.size(), 0.0);
  std::vector<int64_t> touched;
  touched.reserve(64);

  bool moved_any = false;
  double inv_2m = 1.0 / g.total_w2;

  while (!q.empty()) {
    int64_t v = q.front();
    q.pop();
    in_queue[v] = 0;

    int64_t c_old = p.comm[v];
    double kv = g.strength[v];

    touched.clear();
    for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e) {
      int64_t c = p.comm[g.nbr[e]];
      if (k_to[c] == 0.0) touched.push_back(c);
      k_to[c] += g.w[e];
    }
    if (k_to[c_old] == 0.0) touched.push_back(c_old);  // ensure present

    // gain of leaving c_old (relative): -(k_{v,old\v} - gamma*kv*(K_old-kv)/2m)
    double base = k_to[c_old] - gamma * kv * (p.K[c_old] - kv) * inv_2m;
    int64_t c_best = c_old;
    double best_gain = 0.0;
    for (int64_t c : touched) {
      if (c == c_old) continue;
      double gain = (k_to[c] - gamma * kv * p.K[c] * inv_2m) - base;
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        c_best = c;
      }
    }

    if (c_best != c_old) {
      p.K[c_old] -= kv;
      p.size[c_old] -= 1;
      p.K[c_best] += kv;
      p.size[c_best] += 1;
      p.comm[v] = c_best;
      moved_any = true;
      // re-queue neighbors not in the new community
      for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e) {
        int64_t u = g.nbr[e];
        if (p.comm[u] != c_best && !in_queue[u]) {
          in_queue[u] = 1;
          q.push(u);
        }
      }
    }
    for (int64_t c : touched) k_to[c] = 0.0;
  }
  return moved_any;
}

// Refinement: within each local-move community, re-cluster from singletons,
// merging only well-connected nodes into well-connected sub-communities.
// Returns the refined partition (ids are compacted by caller).
Partition refine(const Graph& g, const Partition& p, std::mt19937_64& rng,
                 double gamma) {
  Partition r = singleton_partition(g);
  double inv_2m = 1.0 / g.total_w2;

  // K of each local-move community (for well-connectedness tests)
  // k of node within its P-community
  std::vector<double> k_in_P(g.n, 0.0);
  for (int64_t v = 0; v < g.n; ++v)
    for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e)
      if (p.comm[g.nbr[e]] == p.comm[v]) k_in_P[v] += g.w[e];

  // edge weight from refined community to rest of its P-community
  std::vector<double> r_ext(g.n);
  for (int64_t v = 0; v < g.n; ++v) r_ext[v] = k_in_P[v];

  std::vector<int64_t> order(g.n);
  for (int64_t v = 0; v < g.n; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);

  std::vector<double> k_to(g.n, 0.0);
  std::vector<int64_t> touched;

  for (int64_t v : order) {
    if (r.size[r.comm[v]] != 1) continue;  // only merge singletons
    double kv = g.strength[v];
    int64_t P_c = p.comm[v];
    // node well-connected within its P-community?
    if (k_in_P[v] < gamma * kv * (p.K[P_c] - kv) * inv_2m) continue;

    touched.clear();
    for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e) {
      int64_t u = g.nbr[e];
      if (p.comm[u] != P_c) continue;  // constrained to own P-community
      int64_t rc = r.comm[u];
      if (k_to[rc] == 0.0) touched.push_back(rc);
      k_to[rc] += g.w[e];
    }

    int64_t rc_old = r.comm[v];
    int64_t rc_best = rc_old;
    double best_gain = 0.0;
    for (int64_t rc : touched) {
      if (rc == rc_old) continue;
      // target sub-community must itself be well-connected in P
      if (r_ext[rc] < gamma * r.K[rc] * (p.K[P_c] - r.K[rc]) * inv_2m) continue;
      double gain = k_to[rc] - gamma * kv * r.K[rc] * inv_2m;
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        rc_best = rc;
      }
    }

    if (rc_best != rc_old) {
      r.K[rc_old] -= kv;
      r.size[rc_old] -= 1;
      r.K[rc_best] += kv;
      r.size[rc_best] += 1;
      r_ext[rc_best] += k_in_P[v] - 2.0 * k_to[rc_best];
      r.comm[v] = rc_best;
    }
    for (int64_t rc : touched) k_to[rc] = 0.0;
  }
  return r;
}

// Aggregate g by refined partition r; map partition p onto aggregate nodes.
void aggregate(const Graph& g, const Partition& r, const Partition& p,
               Graph& ag, std::vector<int64_t>& node_of,  // old node -> new node
               std::vector<int64_t>& agg_comm /* new node -> p community */) {
  // compact refined community ids
  std::vector<int64_t> remap(g.n, -1);
  int64_t n_new = 0;
  node_of.resize(g.n);
  for (int64_t v = 0; v < g.n; ++v) {
    int64_t rc = r.comm[v];
    if (remap[rc] < 0) remap[rc] = n_new++;
    node_of[v] = remap[rc];
  }

  agg_comm.assign(n_new, -1);
  for (int64_t v = 0; v < g.n; ++v) agg_comm[node_of[v]] = p.comm[v];

  // accumulate edges between aggregated nodes (hash-free two-pass)
  std::vector<std::vector<std::pair<int64_t, double>>> adj(n_new);
  std::vector<double> self_w(n_new, 0.0);
  for (int64_t v = 0; v < g.n; ++v) {
    int64_t a = node_of[v];
    self_w[a] += g.self_w[v];
    for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e) {
      int64_t b = node_of[g.nbr[e]];
      if (a == b) {
        self_w[a] += 0.5 * g.w[e];  // each internal edge visited twice
      } else {
        adj[a].push_back({b, g.w[e]});
      }
    }
  }
  // merge duplicate neighbor entries
  ag.n = n_new;
  ag.offs.assign(n_new + 1, 0);
  ag.nbr.clear();
  ag.w.clear();
  ag.self_w = self_w;
  std::vector<double> acc(n_new, 0.0);
  std::vector<int64_t> seen;
  for (int64_t a = 0; a < n_new; ++a) {
    seen.clear();
    for (auto& pr : adj[a]) {
      if (acc[pr.first] == 0.0) seen.push_back(pr.first);
      acc[pr.first] += pr.second;
    }
    for (int64_t b : seen) {
      ag.nbr.push_back(b);
      ag.w.push_back(acc[b]);
      acc[b] = 0.0;
    }
    ag.offs[a + 1] = (int64_t)ag.nbr.size();
  }
  ag.strength.assign(n_new, 0.0);
  for (int64_t a = 0; a < n_new; ++a) {
    double s = 2.0 * ag.self_w[a];
    for (int64_t e = ag.offs[a]; e < ag.offs[a + 1]; ++e) s += ag.w[e];
    ag.strength[a] = s;
  }
  ag.total_w2 = g.total_w2;  // invariant under aggregation
}

}  // namespace

extern "C" {

// Cluster an undirected weighted graph given as an edge list (each edge
// once; src[i] < dst[i] or arbitrary, self-loops allowed).  Writes one
// community label per node into out_labels.  Returns the number of
// communities, or -1 on error.
int64_t alpine_leiden(int64_t n_nodes, int64_t n_edges, const int64_t* src,
                      const int64_t* dst, const double* weight,
                      double resolution, int64_t max_levels, uint64_t seed,
                      int64_t* out_labels) {
  if (n_nodes <= 0) return -1;

  // build CSR
  Graph g;
  g.n = n_nodes;
  g.self_w.assign(n_nodes, 0.0);
  std::vector<int64_t> deg(n_nodes, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    if (src[i] < 0 || src[i] >= n_nodes || dst[i] < 0 || dst[i] >= n_nodes)
      return -1;
    if (src[i] == dst[i]) {
      g.self_w[src[i]] += weight ? weight[i] : 1.0;
    } else {
      deg[src[i]]++;
      deg[dst[i]]++;
    }
  }
  g.offs.assign(n_nodes + 1, 0);
  for (int64_t v = 0; v < n_nodes; ++v) g.offs[v + 1] = g.offs[v] + deg[v];
  g.nbr.resize(g.offs[n_nodes]);
  g.w.resize(g.offs[n_nodes]);
  std::vector<int64_t> fill(g.offs.begin(), g.offs.end() - 1);
  for (int64_t i = 0; i < n_edges; ++i) {
    if (src[i] == dst[i]) continue;
    double wt = weight ? weight[i] : 1.0;
    g.nbr[fill[src[i]]] = dst[i];
    g.w[fill[src[i]]++] = wt;
    g.nbr[fill[dst[i]]] = src[i];
    g.w[fill[dst[i]]++] = wt;
  }
  g.strength.assign(n_nodes, 0.0);
  double tw = 0.0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    double s = 2.0 * g.self_w[v];
    for (int64_t e = g.offs[v]; e < g.offs[v + 1]; ++e) s += g.w[e];
    g.strength[v] = s;
    tw += s;
  }
  if (tw <= 0.0) {  // empty graph: all singletons
    for (int64_t v = 0; v < n_nodes; ++v) out_labels[v] = v;
    return n_nodes;
  }
  g.total_w2 = tw;

  std::mt19937_64 rng(seed);

  // labels[v] tracks the flat community of original node v across levels
  std::vector<int64_t> node_map(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v) node_map[v] = v;

  Graph cur = std::move(g);
  std::vector<int64_t> final_comm;
  // compacted previous-level partition of the current (aggregate) nodes;
  // empty only at level 0
  std::vector<int64_t> init_comm;

  for (int64_t level = 0; level < max_levels; ++level) {
    Partition p = init_comm.empty() ? singleton_partition(cur)
                                    : partition_from_labels(cur, init_comm);
    bool moved = local_move(cur, p, rng, resolution);

    // count communities
    std::vector<int64_t> remap(cur.n, -1);
    int64_t n_comm = 0;
    for (int64_t v = 0; v < cur.n; ++v)
      if (remap[p.comm[v]] < 0) remap[p.comm[v]] = n_comm++;

    if (!moved || n_comm == cur.n) {
      final_comm.resize(cur.n);
      for (int64_t v = 0; v < cur.n; ++v) final_comm[v] = remap[p.comm[v]];
      break;
    }

    Partition r = refine(cur, p, rng, resolution);
    Graph next;
    std::vector<int64_t> node_of, agg_comm;
    aggregate(cur, r, p, next, node_of, agg_comm);

    if (next.n == cur.n) {  // refinement couldn't shrink: accept local move
      final_comm.resize(cur.n);
      for (int64_t v = 0; v < cur.n; ++v) final_comm[v] = remap[p.comm[v]];
      break;
    }

    int64_t old_n = cur.n;  // agg_comm ids live in the old node-id domain
    for (int64_t v = 0; v < n_nodes; ++v) node_map[v] = node_of[node_map[v]];
    cur = std::move(next);

    // compact the carried p-communities of the aggregate nodes; they SEED
    // the next level's local move (canonical Leiden), and double as the
    // final labels if max_levels is exhausted
    std::vector<int64_t> remap2(old_n, -1);
    int64_t nc = 0;
    init_comm.assign(cur.n, 0);
    for (int64_t a = 0; a < cur.n; ++a) {
      if (remap2[agg_comm[a]] < 0) remap2[agg_comm[a]] = nc++;
      init_comm[a] = remap2[agg_comm[a]];
    }
    if (level == max_levels - 1) final_comm = init_comm;
  }

  if (final_comm.empty()) {
    final_comm.resize(cur.n);
    for (int64_t v = 0; v < cur.n; ++v) final_comm[v] = v;
  }

  int64_t n_comm = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    out_labels[v] = final_comm[node_map[v]];
    if (out_labels[v] + 1 > n_comm) n_comm = out_labels[v] + 1;
  }
  return n_comm;
}

}  // extern "C"
