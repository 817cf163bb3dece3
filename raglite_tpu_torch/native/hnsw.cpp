// First-party HNSW (Malkov & Yashunin 2016): the recall baseline of the
// exact dense index.
//
// The PyTorch port's own copy of raglite_tpu/native/hnsw.cpp (host code; the
// code below is unchanged, so the same vectors with the same seed give the
// same graph, ids and scores bit for bit). It plays the role of the engine
// the upstream RAGLite serves from (DuckDB VSS `USING HNSW`, searched with
// ef_search = 160 at its defaults): irbench.py builds this graph over the
// same embeddings as the dense index and reports both recalls side by side.
// It is the baseline, not the serving path: the dense index is an exact scan
// on the card (index/dense.py).
//
// Single-threaded, inner-product / cosine (vectors assumed normalized for
// cosine) and L2 metrics, float32 storage. Exposed as a C API consumed via
// ctypes (raglite_tpu_torch/native/__init__.py:HnswIndex).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

struct Hnsw {
  int dim;
  int M;               // max degree (level > 0); level 0 uses 2M
  int ef_construction;
  int metric;          // 0 = inner product (negated distance), 1 = l2
  double level_mult;
  std::mt19937_64 rng{42};

  std::vector<float> data;                      // [n, dim]
  std::vector<int> levels;                      // node -> top level
  std::vector<std::vector<std::vector<int>>> links;  // node -> level -> neighbors
  int entry = -1;
  int max_level = -1;

  int n() const { return static_cast<int>(levels.size()); }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (metric == 0) {
      for (int i = 0; i < dim; ++i) acc += a[i] * b[i];
      return -acc;  // smaller is better
    }
    for (int i = 0; i < dim; ++i) {
      float d = a[i] - b[i];
      acc += d * d;
    }
    return acc;
  }

  const float* vec(int id) const { return data.data() + static_cast<size_t>(id) * dim; }

  // Greedy descent to the closest node at `level`.
  int greedy(const float* q, int start, int level) const {
    int cur = start;
    float cur_d = dist(q, vec(cur));
    bool improved = true;
    while (improved) {
      improved = false;
      for (int nb : links[cur][level]) {
        float d = dist(q, vec(nb));
        if (d < cur_d) {
          cur_d = d;
          cur = nb;
          improved = true;
        }
      }
    }
    return cur;
  }

  // Beam search of width ef at `level`; returns (dist, id) sorted ascending.
  std::vector<std::pair<float, int>> search_layer(
      const float* q, int start, int ef, int level) const {
    std::priority_queue<std::pair<float, int>> best;                       // max-heap (worst on top)
    std::priority_queue<std::pair<float, int>,
                        std::vector<std::pair<float, int>>,
                        std::greater<>> cand;                              // min-heap
    std::unordered_set<int> visited;
    float d0 = dist(q, vec(start));
    best.emplace(d0, start);
    cand.emplace(d0, start);
    visited.insert(start);
    while (!cand.empty()) {
      auto [d, c] = cand.top();
      if (d > best.top().first && static_cast<int>(best.size()) >= ef) break;
      cand.pop();
      for (int nb : links[c][level]) {
        if (!visited.insert(nb).second) continue;
        float dn = dist(q, vec(nb));
        if (static_cast<int>(best.size()) < ef || dn < best.top().first) {
          best.emplace(dn, nb);
          cand.emplace(dn, nb);
          if (static_cast<int>(best.size()) > ef) best.pop();
        }
      }
    }
    std::vector<std::pair<float, int>> out;
    out.reserve(best.size());
    while (!best.empty()) { out.push_back(best.top()); best.pop(); }
    std::sort(out.begin(), out.end());
    return out;
  }

  // Heuristic neighbor selection (alg. 4 of the paper): keep candidates
  // closer to the query than to any already-selected neighbor.
  std::vector<int> select_neighbors(
      const std::vector<std::pair<float, int>>& cands, int m) const {
    std::vector<int> out;
    for (const auto& [d, id] : cands) {
      if (static_cast<int>(out.size()) >= m) break;
      bool ok = true;
      for (int sel : out) {
        if (dist(vec(id), vec(sel)) < d) { ok = false; break; }
      }
      if (ok) out.push_back(id);
    }
    // Backfill with nearest skipped candidates if the heuristic was strict.
    for (const auto& [d, id] : cands) {
      if (static_cast<int>(out.size()) >= m) break;
      if (std::find(out.begin(), out.end(), id) == out.end()) out.push_back(id);
    }
    return out;
  }

  void add(const float* v) {
    int id = n();
    data.insert(data.end(), v, v + dim);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    int level = static_cast<int>(-std::log(std::max(unif(rng), 1e-12)) * level_mult);
    levels.push_back(level);
    links.emplace_back(level + 1);
    if (entry < 0) { entry = id; max_level = level; return; }

    int cur = entry;
    for (int l = max_level; l > level; --l) cur = greedy(v, cur, l);
    for (int l = std::min(level, max_level); l >= 0; --l) {
      auto cands = search_layer(v, cur, ef_construction, l);
      int m = (l == 0) ? 2 * M : M;
      auto neigh = select_neighbors(cands, m);
      links[id][l] = neigh;
      for (int nb : neigh) {
        auto& nl = links[nb][l];
        nl.push_back(id);
        if (static_cast<int>(nl.size()) > m) {
          // Re-select the neighbor's links with the same heuristic.
          std::vector<std::pair<float, int>> nc;
          nc.reserve(nl.size());
          for (int x : nl) nc.emplace_back(dist(vec(nb), vec(x)), x);
          std::sort(nc.begin(), nc.end());
          nl = select_neighbors(nc, m);
        }
      }
      cur = cands.front().second;
    }
    if (level > max_level) { max_level = level; entry = id; }
  }

  void search(const float* q, int k, int ef, int* out_ids, float* out_scores) const {
    if (entry < 0) {
      for (int i = 0; i < k; ++i) { out_ids[i] = -1; out_scores[i] = 0.f; }
      return;
    }
    int cur = entry;
    for (int l = max_level; l > 0; --l) cur = greedy(q, cur, l);
    auto res = search_layer(q, cur, std::max(ef, k), 0);
    for (int i = 0; i < k; ++i) {
      if (i < static_cast<int>(res.size())) {
        out_ids[i] = res[i].second;
        out_scores[i] = metric == 0 ? -res[i].first : res[i].first;
      } else {
        out_ids[i] = -1;
        out_scores[i] = 0.f;
      }
    }
  }
};

}  // namespace

extern "C" {

void* rlt_hnsw_new(int dim, int M, int ef_construction, int metric, uint64_t seed) {
  auto* h = new Hnsw();
  h->dim = dim;
  h->M = M;
  h->ef_construction = ef_construction;
  h->metric = metric;
  h->level_mult = 1.0 / std::log(std::max(2.0, static_cast<double>(M)));
  h->rng.seed(seed);
  return h;
}

void rlt_hnsw_free(void* h) { delete static_cast<Hnsw*>(h); }

void rlt_hnsw_add(void* h, const float* vecs, int64_t count) {
  auto& g = *static_cast<Hnsw*>(h);
  for (int64_t i = 0; i < count; ++i) g.add(vecs + i * g.dim);
}

int rlt_hnsw_size(void* h) { return static_cast<Hnsw*>(h)->n(); }

// Bytes of graph + vector storage (the "equal memory" axis of the claim).
int64_t rlt_hnsw_memory_bytes(void* h) {
  auto& g = *static_cast<Hnsw*>(h);
  int64_t bytes = static_cast<int64_t>(g.data.size()) * sizeof(float);
  for (const auto& node : g.links) {
    for (const auto& lvl : node) bytes += static_cast<int64_t>(lvl.size()) * sizeof(int);
  }
  return bytes;
}

void rlt_hnsw_search(void* h, const float* queries, int64_t num_queries, int k,
                     int ef_search, int* out_ids, float* out_scores) {
  auto& g = *static_cast<Hnsw*>(h);
  for (int64_t i = 0; i < num_queries; ++i) {
    g.search(queries + i * g.dim, k, ef_search, out_ids + i * k, out_scores + i * k);
  }
}

}  // extern "C"
