// graphprep: host-side graph preparation of the mini-batch trainer, in C++
// for speed, loaded with ctypes (native/__init__.py). The port's own copy of
// difformer_tpu/native/graphprep.cpp's sort_edges_by_receiver,
// gcn_norm_values and induced_subgraph, with the same arithmetic, and
// entries of its own for the trainer's chunk plans:
//
// - chunk_subgraphs: the induced subgraphs of every node chunk of an epoch
//   in one pass over the edges (a pass per chunk walks all E edges once per
//   chunk: 17 times at Pokec's size, 14 at ogbn-proteins'). Each chunk's
//   edges come out in their order in the input, relabelled to positions in
//   the chunk, exactly as induced_subgraph gives them one chunk at a time.
// - chunk_csr: a chunk's two CSRs (by receiver, and the transposed one by
//   sender) with their GCN values, by two stable counting sorts: the arrays
//   that sort_edges_by_receiver and gcn_norm_values give, in one call.
// - chunk_norm_csr: a chunk's two CSRs with the baseline zoo's gcn_norm
//   values (ops/graph_ops.py:gcn_norm's float32 arithmetic), with a
//   self-loop on every node or without, as nn/gnns.py:norm_plan builds
//   them.
// - chunk_gat_csr: a chunk's GAT plan (nn/gnns.py:gat_plan): the edges and
//   a self-loop on every node in receiver order, each position's receiver,
//   and the transposed CSR with the receiver-order position of its entries.
//
// - ell_fill: one degree bucket of the ELL layout (ops/ell.py), as
//   difformer_tpu/native/graphprep.cpp's.
// - label_propagation: the communities behind locality_reorder's
//   "community" order and parallel/partition.py's locality_layout, as
//   difformer_tpu/native/graphprep.cpp's, with the thread count an
//   argument (the labels do not depend on it).
// - knn_graph: brute-force k nearest neighbours of every row, as
//   difformer_tpu/native/graphprep.cpp's (f64 distances as
//   |a|^2 - 2 a.b + |b|^2, ties to the lower index, self at 1e300 when
//   excluded), its rows shared by every hardware thread.
//
// The reference delegates this work to PyG's subgraph and torch_sparse
// (node classification/main-batch.py:131, data_utils.py:183-200).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 graphprep.cpp -o libgraphprep.so -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Counting sort of edges by receiver; fills order (positions into the
// original arrays) and indptr (receiver CSR offsets, length n+1).
void sort_edges_by_receiver(const int32_t* receivers, int64_t e, int64_t n,
                            int64_t* order, int64_t* indptr) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) count[receivers[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) count[i + 1] += count[i];
  std::memcpy(indptr, count.data(), sizeof(int64_t) * (n + 1));
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < e; ++i) order[cursor[receivers[i]]++] = i;
}

// 1 / sqrt(in-degree) of every node in float32 (0 for no in-edges), the
// degrees counted in double.
static std::vector<float> inv_sqrt_degrees(const int32_t* receivers,
                                           int64_t e, int64_t n) {
  std::vector<double> deg(n, 0.0);
  for (int64_t i = 0; i < e; ++i) deg[receivers[i]] += 1.0;
  std::vector<float> inv(n);
  for (int64_t i = 0; i < n; ++i)
    inv[i] = deg[i] > 0.0 ? (float)(1.0 / std::sqrt(deg[i])) : 0.0f;
  return inv;
}

static inline float gcn_value(float w, float inv_r, float inv_s) {
  float v = w * inv_r * inv_s;
  return std::isfinite(v) ? v : 0.0f;
}

// The reference's normalised GCN edge values:
// val = w * rsqrt(deg[recv]) * rsqrt(deg[send]); non-finite -> 0
void gcn_norm_values(const int32_t* senders, const int32_t* receivers,
                     const float* edge_weight, int64_t e, int64_t n,
                     float* out) {
  const std::vector<float> inv = inv_sqrt_degrees(receivers, e, n);
  for (int64_t i = 0; i < e; ++i)
    out[i] = gcn_value(edge_weight ? edge_weight[i] : 1.0f, inv[receivers[i]],
                       inv[senders[i]]);
}

// Induced subgraph: keep edges with both endpoints selected; relabel via
// remap (remap[node] = position in chunk, -1 otherwise). Returns kept count.
int64_t induced_subgraph(const int32_t* senders, const int32_t* receivers,
                         int64_t e, const int64_t* remap, int32_t* out_s,
                         int32_t* out_r) {
  int64_t kept = 0;
  for (int64_t i = 0; i < e; ++i) {
    int64_t rs = remap[senders[i]];
    int64_t rr = remap[receivers[i]];
    if (rs >= 0 && rr >= 0) {
      out_s[kept] = (int32_t)rs;
      out_r[kept] = (int32_t)rr;
      ++kept;
    }
  }
  return kept;
}

// The induced subgraph of every chunk of perm (chunk c holds the nodes
// perm[c * batch .. (c + 1) * batch - 1], n nodes in all), in one pass:
// chunk c's edges, relabelled to positions in the chunk and in input order,
// land in out_s/out_r [offsets[c], offsets[c + 1]). offsets has
// n_chunks + 1 entries; out_s and out_r room for every kept edge (at most
// e). Each of `threads` threads takes a contiguous range of edges; their
// outputs are placed in range order, so the result does not depend on the
// thread count. Returns the number of kept edges.
int64_t chunk_subgraphs(const int32_t* senders, const int32_t* receivers,
                        int64_t e, const int64_t* perm, int64_t n,
                        int64_t batch, int64_t n_chunks, int threads,
                        int64_t* offsets, int32_t* out_s, int32_t* out_r) {
  std::vector<int32_t> chunk_of(n), local(n);
  for (int64_t i = 0; i < n; ++i) {
    chunk_of[perm[i]] = (int32_t)(i / batch);
    local[perm[i]] = (int32_t)(i % batch);
  }
  const int t_count = std::max(1, threads);
  std::vector<int64_t> count(int64_t(t_count) * n_chunks, 0);
  auto range = [&](int t, int64_t* lo, int64_t* hi) {
    *lo = e * t / t_count;
    *hi = e * (t + 1) / t_count;
  };
  auto run = [&](auto&& body) {
    std::vector<std::thread> pool;
    for (int t = 1; t < t_count; ++t) pool.emplace_back(body, t);
    body(0);
    for (auto& th : pool) th.join();
  };
  run([&](int t) {
    int64_t lo, hi;
    range(t, &lo, &hi);
    std::vector<int64_t> mine(n_chunks, 0);  // a thread's own cache lines
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t c = chunk_of[senders[i]];
      if (c == chunk_of[receivers[i]]) mine[c]++;
    }
    std::copy(mine.begin(), mine.end(),
              count.begin() + int64_t(t) * n_chunks);
  });
  // place each thread's edges of a chunk after the earlier threads'
  int64_t total = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    offsets[c] = total;
    for (int t = 0; t < t_count; ++t) {
      const int64_t k = count[int64_t(t) * n_chunks + c];
      count[int64_t(t) * n_chunks + c] = total;
      total += k;
    }
  }
  offsets[n_chunks] = total;
  run([&](int t) {
    int64_t lo, hi;
    range(t, &lo, &hi);
    std::vector<int64_t> cursor(count.begin() + int64_t(t) * n_chunks,
                                count.begin() + int64_t(t + 1) * n_chunks);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t c = chunk_of[senders[i]];
      if (c != chunk_of[receivers[i]]) continue;
      const int64_t p = cursor[c]++;
      out_s[p] = local[senders[i]];
      out_r[p] = local[receivers[i]];
    }
  });
  return total;
}

// Stable counting sort of the edges by key: ptr [n + 1] the CSR offsets,
// and in CSR order other[i] into col and value[i] into val.
static void csr_by(const int32_t* key, const int32_t* other,
                   const float* value, int64_t e, int64_t n, int32_t* ptr,
                   int32_t* col, float* val) {
  std::vector<int32_t> cursor(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cursor[key[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cursor[i + 1] += cursor[i];
  std::memcpy(ptr, cursor.data(), sizeof(int32_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) {
    const int32_t p = cursor[key[i]]++;
    col[p] = other[i];
    val[p] = value[i];
  }
}

// A chunk's CSR plan (e < 2^31 edges among n nodes): the receivers' CSR
// (row_ptr [n + 1], col = senders, val) and the senders' (t_row_ptr,
// t_col = receivers, t_val), both stable, with the GCN values of
// gcn_norm_values (unit weights).
void chunk_csr(const int32_t* senders, const int32_t* receivers, int64_t e,
               int64_t n, int32_t* row_ptr, int32_t* col, float* val,
               int32_t* t_row_ptr, int32_t* t_col, float* t_val) {
  const std::vector<float> inv = inv_sqrt_degrees(receivers, e, n);
  std::vector<float> value(e);
  for (int64_t i = 0; i < e; ++i)
    value[i] = gcn_value(1.0f, inv[receivers[i]], inv[senders[i]]);
  csr_by(receivers, senders, value.data(), e, n, row_ptr, col, val);
  csr_by(senders, receivers, value.data(), e, n, t_row_ptr, t_col, t_val);
}

// 1 / sqrt of every node's in-degree, plus one for its self-loop with
// self_loops, as gcn_norm computes it: the degree summed in double and
// rounded to float, then a float square root and a float quotient (two
// roundings, not the double ones of inv_sqrt_degrees); 0 for a node
// without in-edges.
static std::vector<float> rsqrt_degrees(const int32_t* receivers, int64_t e,
                                        int64_t n, int self_loops) {
  std::vector<double> deg(n, self_loops ? 1.0 : 0.0);
  for (int64_t i = 0; i < e; ++i) deg[receivers[i]] += 1.0;
  std::vector<float> inv(n);
  for (int64_t i = 0; i < n; ++i) {
    const float d = (float)deg[i];
    inv[i] = d > 0.0f ? 1.0f / std::sqrt(d) : 0.0f;
  }
  return inv;
}

// Stable counting sort of the edges by key, each row followed by its node's
// self-loop with self_loops (the loops appended after every edge, as
// gcn_norm and gat_plan append them): ptr [n + 1], and in CSR order other[i]
// into col, value[i] into val (when val is given) and key[i] into rows (when
// given); a loop's value is loop_val[v].
static void csr_by_with_loops(const int32_t* key, const int32_t* other,
                              const float* value, const float* loop_val,
                              int64_t e, int64_t n, int self_loops,
                              int32_t* ptr, int32_t* col, float* val,
                              int32_t* rows) {
  std::vector<int64_t> cursor(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cursor[key[i] + 1]++;
  if (self_loops)
    for (int64_t v = 0; v < n; ++v) cursor[v + 1]++;
  for (int64_t i = 0; i < n; ++i) cursor[i + 1] += cursor[i];
  for (int64_t i = 0; i <= n; ++i) ptr[i] = (int32_t)cursor[i];
  for (int64_t i = 0; i < e; ++i) {
    const int64_t p = cursor[key[i]]++;
    col[p] = other[i];
    if (val) val[p] = value[i];
    if (rows) rows[p] = key[i];
  }
  if (!self_loops) return;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t p = cursor[v]++;
    col[p] = (int32_t)v;
    if (val) val[p] = loop_val[v];
    if (rows) rows[p] = (int32_t)v;
  }
}

// A chunk's plan of the gcn_norm adjacency (e edges among n nodes, plus a
// self-loop on every node with self_loops; fewer than 2^31 in all): the
// receivers' CSR (row_ptr [n + 1], col = senders, val) and the senders'
// (t_row_ptr, t_col = receivers, t_val), both stable, each row's loop after
// its edges, with val = inv[s] * w * inv[r] (w = 1) of rsqrt_degrees.
void chunk_norm_csr(const int32_t* senders, const int32_t* receivers,
                    int64_t e, int64_t n, int self_loops, int32_t* row_ptr,
                    int32_t* col, float* val, int32_t* t_row_ptr,
                    int32_t* t_col, float* t_val) {
  const std::vector<float> inv = rsqrt_degrees(receivers, e, n, self_loops);
  std::vector<float> value(e), loop(self_loops ? n : 0);
  for (int64_t i = 0; i < e; ++i)
    value[i] = inv[senders[i]] * 1.0f * inv[receivers[i]];
  for (int64_t v = 0; v < (int64_t)loop.size(); ++v)
    loop[v] = inv[v] * 1.0f * inv[v];
  csr_by_with_loops(receivers, senders, value.data(), loop.data(), e, n,
                    self_loops, row_ptr, col, val, nullptr);
  csr_by_with_loops(senders, receivers, value.data(), loop.data(), e, n,
                    self_loops, t_row_ptr, t_col, t_val, nullptr);
}

// A chunk's GAT plan (e edges among n nodes and a self-loop on every node,
// e + n < 2^31): the receivers' CSR of the edges and loops, stable, each
// row's loop after its edges (row_ptr [n + 1], col = senders, rows = each
// position's receiver, [e + n]), and the transposed CSR of those positions
// by sender, stable (t_row_ptr [n + 1], t_col = receivers, t_pos = the
// receiver-order position of each entry).
void chunk_gat_csr(const int32_t* senders, const int32_t* receivers,
                   int64_t e, int64_t n, int32_t* row_ptr, int32_t* col,
                   int32_t* rows, int32_t* t_row_ptr, int32_t* t_col,
                   int32_t* t_pos) {
  csr_by_with_loops(receivers, senders, nullptr, nullptr, e, n, 1, row_ptr,
                    col, nullptr, rows);
  const int64_t total = e + n;
  std::vector<int64_t> cursor(n + 1, 0);
  for (int64_t p = 0; p < total; ++p) cursor[col[p] + 1]++;
  for (int64_t i = 0; i < n; ++i) cursor[i + 1] += cursor[i];
  for (int64_t i = 0; i <= n; ++i) t_row_ptr[i] = (int32_t)cursor[i];
  for (int64_t p = 0; p < total; ++p) {
    const int64_t q = cursor[col[p]]++;
    t_col[q] = rows[p];
    t_pos[q] = (int32_t)p;
  }
}

// One bucket of the ELL layout (ops/ell.py): for each of its nb rows, the
// node nodes[row], the first k entries of the node's CSR range
// indptr[node] .. indptr[node + 1] of point_s and val_s, zero-padded to k.
void ell_fill(const int64_t* nodes, int64_t nb, int64_t k,
              const int64_t* indptr, const int32_t* point_s,
              const float* val_s, int32_t* idx_out, float* w_out) {
  for (int64_t row = 0; row < nb; ++row) {
    const int64_t node = nodes[row];
    const int64_t a = indptr[node];
    const int64_t len = std::min<int64_t>(indptr[node + 1] - a, k);
    int32_t* ir = idx_out + row * k;
    float* wr = w_out + row * k;
    for (int64_t j = 0; j < len; ++j) {
      ir[j] = point_s[a + j];
      wr[j] = val_s[a + j];
    }
    for (int64_t j = len; j < k; ++j) {
      ir[j] = 0;
      wr[j] = 0.0f;
    }
  }
}

// Synchronous label propagation over the symmetrised adjacency (self loops
// dropped). Each pass gives every node the neighbour label of the highest
// score, count + 0.5 * prio(label), where prio is a splitmix64 hash in
// [0, 1) that breaks the symmetric ties plain synchronous propagation
// oscillates on; among equal scores the smallest label wins (labels are
// visited in increasing order and only a larger score replaces the best).
// A pass reads only the previous pass's labels, so `threads` threads, each
// taking chunks of 4096 nodes, give the same labels as one. Stops early when
// a pass changes nothing. labels_out holds the labels compacted to
// [0, n_communities) in order of first appearance.
static inline double prio_hash(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  x = x ^ (x >> 31);
  return (double)(x >> 11) * (1.0 / 9007199254740992.0);  // [0, 1)
}

void label_propagation(const int32_t* senders, const int32_t* receivers,
                       int64_t e, int64_t n, int32_t iters, int threads,
                       int64_t* labels_out) {
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (senders[i] == receivers[i]) continue;
    indptr[senders[i] + 1]++;
    indptr[receivers[i] + 1]++;
  }
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  std::vector<int32_t> nbr(indptr[n]);
  {
    std::vector<int64_t> cur(indptr.begin(), indptr.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
      if (senders[i] == receivers[i]) continue;
      nbr[cur[senders[i]]++] = receivers[i];
      nbr[cur[receivers[i]]++] = senders[i];
    }
  }

  std::vector<int64_t> labels(n), next_labels(n);
  for (int64_t i = 0; i < n; ++i) labels[i] = i;
  const int t_count = std::max(1, threads);

  for (int32_t it = 0; it < iters; ++it) {
    std::atomic<int64_t> chunk(0);
    std::atomic<bool> changed(false);
    auto worker = [&]() {
      std::vector<int64_t> ls;
      for (;;) {
        const int64_t lo = chunk.fetch_add(1) * 4096;
        if (lo >= n) break;
        const int64_t hi = std::min<int64_t>(lo + 4096, n);
        for (int64_t v = lo; v < hi; ++v) {
          const int64_t a = indptr[v], b = indptr[v + 1];
          if (a == b) {
            next_labels[v] = labels[v];
            continue;
          }
          ls.clear();
          for (int64_t j = a; j < b; ++j) ls.push_back(labels[nbr[j]]);
          std::sort(ls.begin(), ls.end());
          double best_score = -1.0;
          int64_t best_lab = labels[v];
          for (size_t j = 0; j < ls.size();) {
            size_t j2 = j;
            while (j2 < ls.size() && ls[j2] == ls[j]) ++j2;
            const double score =
                (double)(j2 - j) + 0.5 * prio_hash((uint64_t)ls[j]);
            if (score > best_score) {
              best_score = score;
              best_lab = ls[j];
            }
            j = j2;
          }
          next_labels[v] = best_lab;
          if (best_lab != labels[v])
            changed.store(true, std::memory_order_relaxed);
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < t_count; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    labels.swap(next_labels);
    if (!changed.load()) break;
  }

  std::vector<int64_t> remap(n, -1);
  int64_t next_id = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (remap[labels[i]] < 0) remap[labels[i]] = next_id++;
    labels_out[i] = remap[labels[i]];
  }
}


// Brute-force kNN over the rows of x [n, d]: nbr [n, k'] (k' = min(k, n))
// sorted by distance, (distance, index) pairs ordered so that ties go to
// the lower index. include_self = 0 gives the point itself the distance
// 1e300 (so it comes last, and is kept when k >= n). Rows are shared by
// every hardware thread.
void knn_graph(const float* x, int64_t n, int64_t d, int64_t k,
               int include_self, int64_t* nbr) {
  const int64_t kk = std::min<int64_t>(k, n);
  std::vector<double> sq(n);
  for (int64_t i = 0; i < n; ++i) {
    double s = 0;
    for (int64_t j = 0; j < d; ++j) s += (double)x[i * d + j] * x[i * d + j];
    sq[i] = s;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<std::pair<double, int64_t>> dist(n);
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) break;
      for (int64_t j = 0; j < n; ++j) {
        double dot = 0;
        for (int64_t c = 0; c < d; ++c)
          dot += (double)x[i * d + c] * x[j * d + c];
        double dd = sq[i] - 2.0 * dot + sq[j];
        if (!include_self && j == i) dd = 1e300;
        dist[j] = {dd, j};
      }
      std::partial_sort(dist.begin(), dist.begin() + kk, dist.end());
      for (int64_t j = 0; j < kk; ++j) nbr[i * kk + j] = dist[j].second;
    }
  };
  const unsigned threads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
