// ELL SpMM (K6), hand-written for Hopper (sm_90a).
//
// Replaces the XLA gathers and sums of the JAX package's ELL product,
// _ell_matvec in difformer_tpu/ops/ell.py:180-225: for every degree bucket
// of one direction of the GCN adjacency, a gather of the bucket's
// [rows, k, F] neighbour rows, a weighted sum over k, the buckets'
// concatenation, and a gather of the result back to node order by inv_perm.
// Here one launch computes every bucket:
//
//   out[rows[r], :] = sum over j < k of val[s_r + j] * x[idx[s_r + j], :]
//
// where row r of bucket b has width k = width[b] and its first slot
// s_r = slot0[b] + (r - row0[b]) * k. Each row writes straight to its node
// (rows[] is the inverse of inv_perm), so the inverse-permutation gather is
// fused away; every node is the row of exactly one bucket, so there are no
// atomics and two calls give bit-equal results. Nodes without edges sit in
// bucket 0 and write 0. With accumulate, the row's sum is added to what out
// holds (the block-sparse hybrid's residual, bsr.cu).
//
// What bounds it on this card: bytes, as K1 (spmm.cu). It does 2 E W flops
// on E edges and moves x and out once plus 8 bytes an edge; the gathered
// rows, E W elements, set its time: they stay in the 50 MB L2 only while x
// is small (bench.py's graphs: 33.5 MB at W = 64).
//
// The design.
// - A group of lanes (the power of two >= the row's vectors, up to a warp)
//   sums one row, or one chunk of a split row, striding its W columns in
//   16-byte packs where W and the pointers allow (float4; 8 bf16), f32 sums
//   in registers, in slot order, kUnroll slots' rows of x gathered at once
//   (at 8, or with the last few slots of a run gathered at once too, the
//   registers a thread rose from 40 to 60-100 and the card held fewer
//   groups; PERF.md section 6). Slot, row and block offsets are 32-bit.
// - Padded slots are skipped. Each row is sorted by neighbour index, so its
//   pads (index 0, weight 0) form one run that starts after the row's real
//   edges to node 0; pads[r] = (first pad slot, pads) of row r, built on
//   the host with the layout (ops/ell.py). A row sums its real slots
//   [0, first) and [first + pads, k) and reads neither the pads' index and
//   value words nor x[0] for them. For finite x no sum changes (a pad adds
//   +-0); a NaN or Inf in x[0] no longer reaches rows that only pad with 0.
//   The price is one load (pads[r]) before a row's first index load.
// - Hub rows are split across thread blocks by a host plan
//   (kernels/ell.py split_plan): a bucket wider than T slots is cut into
//   chunks = ceil(k / T) runs of ceil(k / chunks) slots, in slot order; each
//   chunk is summed by a group into its row of an f32 workspace (part),
//   rows of one node consecutive. K1's csr_spmm_combine (spmm.cu) then sums
//   each split row's chunks in chunk order, adds out's value under
//   accumulate, rounds once and writes the row to its node. Without a split
//   bucket K6 is one launch.
// - Launch order: the chunks take the first blocks of the grid, then the
//   unsplit buckets from the widest to the narrowest, so the longest runs
//   start first and end under the short ones instead of trailing them.
//
// The table of buckets (first row, width, first slot, chunks, first
// partial row) is built on the host at each call from the layout's host
// table and the plan, and passed by value, so a call reads nothing back and
// can be captured in a CUDA graph. The JAX package's gather budget
// (k-chunks under lax.scan) has no counterpart: the gathered rows never
// leave registers.
//
// Element types: x and out float32 or bfloat16, f32 sums and partials, one
// rounding to the output type at the store (K1's rule); idx and rows int32,
// val float32, pads int32 pairs.
//
// C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "pack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // slots whose rows of x are gathered at once
constexpr int kMaxBuckets = 48;  // kernels/ell.py MAX_BUCKETS

// The buckets in launch order: the split ones first, then the rest from the
// widest down.
struct Table {
  int count;
  int block0[kMaxBuckets + 1];  // first block of each; all blocks
  int row0[kMaxBuckets];        // the bucket's first row
  int slot0[kMaxBuckets];       // its first slot
  int part0[kMaxBuckets];       // its first partial row (split only)
  int items[kMaxBuckets];       // rows x chunks
  int width[kMaxBuckets];           // k
  int chunks[kMaxBuckets];          // 1: not split
  int chunk[kMaxBuckets];           // slots a chunk, ceil(k / chunks)
};

// acc[v] += the sum over slots begin .. end - 1, in order, of val * x[idx]
// at the pack c of a row of vecs packs: kUnroll slots' gathers in flight,
// then the last end - begin mod kUnroll one by one. Slot offsets are 32-bit
// (the entry checks that every slot's is).
template <typename T, int V>
__device__ __forceinline__ void sum_slots(const int* __restrict__ idx,
                                          const float* __restrict__ val,
                                          const T* __restrict__ x, int begin,
                                          int end, int64_t vecs, int64_t c,
                                          float (&acc)[V]) {
  int j = begin;
  for (; j + kUnroll <= end; j += kUnroll) {
    int s[kUnroll];
    float w[kUnroll];
    float xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = __ldg(idx + j + u);
      w[u] = __ldg(val + j + u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      Pack<T, V>::load(x + (int64_t(s[u]) * vecs + c) * V, xs[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(w[u], xs[u][v], acc[v]);
  }
  for (; j < end; ++j) {
    float xe[V];
    const float we = __ldg(val + j);
    Pack<T, V>::load(x + (int64_t(__ldg(idx + j)) * vecs + c) * V, xe);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(we, xe[v], acc[v]);
  }
}

// A group of 2^group_log2 lanes an item: a row of an unsplit bucket into
// out[rows[r]], or a chunk of a split row into part. The item's slots
// [lo, hi) of its row minus the pad run [first, first + pads): the real
// slots in front of the run (edges to node 0), then those behind it.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const Table tab, const int* __restrict__ idx,
                    const float* __restrict__ val,
                    const int* __restrict__ rows,
                    const int2* __restrict__ pads, const T* __restrict__ x,
                    T* __restrict__ out, float* __restrict__ part,
                    int64_t vecs, int group_log2, int accumulate) {
  int b = 0;
  while (b + 1 < tab.count && int(blockIdx.x) >= tab.block0[b + 1]) ++b;
  const int item = static_cast<int>(
      (int64_t(int(blockIdx.x) - tab.block0[b]) * kThreads + threadIdx.x) >>
      group_log2);
  if (item >= tab.items[b]) return;
  const int chunks = tab.chunks[b];
  const int r = chunks == 1 ? item : item / chunks;
  const int k = tab.width[b];
  const int lo = (item - r * chunks) * tab.chunk[b];
  const int hi = min(k, lo + tab.chunk[b]);
  const int s = tab.slot0[b] + r * k;
  const int2 pad = __ldg(pads + tab.row0[b] + r);  // (first pad slot, pads)
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  for (int64_t c = lane; c < vecs; c += group) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    sum_slots<T, V>(idx, val, x, s + lo, s + min(hi, pad.x), vecs, c,
                       acc);
    sum_slots<T, V>(idx, val, x, s + max(lo, pad.x + pad.y), s + hi, vecs,
                       c, acc);
    if (chunks > 1) {
      Pack<float, V>::store(
          part + ((int64_t(tab.part0[b]) + item) * vecs + c) * V, acc);
      continue;
    }
    T* dst = out + (int64_t(__ldg(rows + tab.row0[b] + r)) * vecs + c) * V;
    if (accumulate) {
      float old[V];
      Pack<T, V>::load(dst, old);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = old[v] + acc[v];
    }
    Pack<T, V>::store(dst, acc);
  }
}

template <typename T, int V>
int launch(const Table& tab, const int* idx, const float* val,
           const int* rows, const int2* pads, const void* x, void* out,
           float* part, int64_t vecs, int group_log2, int accumulate,
           cudaStream_t stream) {
  ell_spmm_kernel<T, V>
      <<<static_cast<unsigned>(tab.block0[tab.count]), kThreads, 0,
         stream>>>(tab, idx, val, rows, pads, static_cast<const T*>(x),
                   static_cast<T*>(out), part, vecs, group_log2, accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [N, width] = the ELL product over the buckets of table (host, int64
// [buckets, 5]: first row, width, first slot, chunks and first partial row
// of each; total_rows rows in all) of x [N, width], x and out float32
// (bf16 == 0) or bfloat16 (bf16 == 1), contiguous; idx int32 and val
// float32 [slots], rows int32 [total_rows] (the node of each row), pads
// int32 [total_rows, 2] (the first pad slot and the pads of each row). The
// rows of a bucket of more than one chunk are not written: their chunks'
// f32 sums go to part [partial rows, width] (null when nothing is split).
// With accumulate == 1 each written row's sum is added to out's.
int ell_spmm(const void* idx, const void* val, const void* rows,
             const void* pads, const void* x, void* out, void* part,
             const int64_t* table, int buckets, int64_t total_rows,
             int64_t width, int bf16, int accumulate, void* stream) {
  if (buckets < 1 || buckets > kMaxBuckets || width <= 0 || total_rows < 0 ||
      (bf16 != 0 && bf16 != 1) || (accumulate != 0 && accumulate != 1))
    return cudaErrorInvalidValue;
  const bool aligned =
      aligned16(x) && aligned16(out) && (part == nullptr || aligned16(part));
  const int V = bf16 ? (width % 8 == 0 && aligned ? 8 : 1)
                     : (width % 4 == 0 && aligned ? 4 : 1);
  const int64_t vecs = width / V;
  int group_log2 = 0;  // lanes an item: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  // the launch order: split buckets in table order, then the others from
  // the widest down (ties in table order)
  int order[kMaxBuckets];
  int n = 0;
  for (int b = 0; b < buckets; ++b)
    if (table[5 * b + 3] > 1) order[n++] = b;
  const int split = n;
  for (int b = 0; b < buckets; ++b) {
    if (table[5 * b + 3] > 1) continue;
    int at = n++;
    while (at > split && table[5 * order[at - 1] + 1] < table[5 * b + 1]) {
      order[at] = order[at - 1];
      --at;
    }
    order[at] = b;
  }
  Table tab = {};
  tab.count = buckets;
  int64_t blocks = 0;
  for (int e = 0; e < buckets; ++e) {
    const int b = order[e];
    const int64_t* t = table + 5 * b;
    const int64_t next = b + 1 < buckets ? table[5 * (b + 1)] : total_rows;
    const int64_t k = t[1], chunks = t[3];
    const int64_t items = (next - t[0]) * chunks;
    // every row, slot, partial row and block is indexed in 32 bits
    if (k < 1 || k > INT_MAX || chunks < 1 || chunks > k || items < 0 ||
        items > INT_MAX || next > INT_MAX ||
        t[2] + (next - t[0]) * k > INT_MAX ||
        (chunks > 1 && (part == nullptr || t[4] < 0 ||
                        t[4] + items > INT_MAX)))
      return cudaErrorInvalidValue;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    tab.block0[e] = static_cast<int>(blocks);
    tab.row0[e] = static_cast<int>(t[0]);
    tab.slot0[e] = static_cast<int>(t[2]);
    tab.part0[e] = static_cast<int>(t[4]);
    tab.items[e] = static_cast<int>(items);
    tab.width[e] = static_cast<int>(k);
    tab.chunks[e] = static_cast<int>(chunks);
    tab.chunk[e] = static_cast<int>((k + chunks - 1) / chunks);
    blocks += ((items << group_log2) + kThreads - 1) / kThreads;
  }
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  tab.block0[buckets] = static_cast<int>(blocks);
  if (blocks == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  const auto* vl = static_cast<const float*>(val);
  const auto* rw = static_cast<const int*>(rows);
  const auto* pd = static_cast<const int2*>(pads);
  auto* pt = static_cast<float*>(part);
  if (bf16) {
    if (V == 8)
      return launch<__nv_bfloat16, 8>(tab, ix, vl, rw, pd, x, out, pt, vecs,
                                      group_log2, accumulate, st);
    return launch<__nv_bfloat16, 1>(tab, ix, vl, rw, pd, x, out, pt, vecs,
                                    group_log2, accumulate, st);
  }
  if (V == 4)
    return launch<float, 4>(tab, ix, vl, rw, pd, x, out, pt, vecs,
                            group_log2, accumulate, st);
  return launch<float, 1>(tab, ix, vl, rw, pd, x, out, pt, vecs, group_log2,
                          accumulate, st);
}

}  // extern "C"
