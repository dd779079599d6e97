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
// bucket 0 with zero weights and write 0. With accumulate, the row's sum is
// added to what out holds (the block-sparse hybrid's residual, bsr.cu).
//
// What bounds it on this card: bytes, as K1 (spmm.cu). It does 2 S W flops
// on S slots (at most twice the edges) and moves x and out once plus 8 bytes
// a slot; the gathered rows, S W elements, set its time once x outgrows the
// 50 MB L2.
//
// The design. A bucket no wider than kHeavyWidth slots: a group of lanes (the
// power of two >= the row's vectors, up to a warp) sums one row, striding its
// W columns in 16-byte packs where W and the pointers allow (float4; 8 bf16),
// four slots' gathers in flight, f32 sums in registers, in slot order. A
// wider bucket (the hubs of a power-law graph, whose rows reach thousands of
// slots) takes a block a row: its 256 / group groups each sum a contiguous
// run of the row's slots into shared memory, and the block then adds the
// runs in order and writes the row once (K1 reaches the same balance with
// segments and a second launch, spmm.cu; a block a row keeps K6 one launch).
// The table of buckets (first row, width, first slot, first block) is built
// on the host from the layout's host table at each call and passed by value,
// so a call reads nothing back and can be captured in a CUDA graph. The JAX
// package's gather budget (k-chunks under lax.scan) has no counterpart: the
// gathered rows never leave registers.
//
// Element types: x and out float32 or bfloat16, f32 sums, one rounding to
// the output type at the store (K1's rule); idx and rows int32, val float32,
// slot offsets int64 (the padding can reach twice the edges).
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
constexpr int kUnroll = 4;
constexpr int kMaxBuckets = 48;     // kernels/ell.py MAX_BUCKETS
constexpr int kHeavyWidth = 128;    // kernels/ell.py HEAVY_WIDTH

struct Buckets {
  int count;
  int heavy_any;
  int64_t row0[kMaxBuckets + 1];    // first row of each bucket; total rows
  int64_t slot0[kMaxBuckets];       // first slot of each bucket
  int64_t block0[kMaxBuckets + 1];  // first block of each bucket; all blocks
  int width[kMaxBuckets];
};

// acc[v] += sum over slots begin .. end - 1, in order, of val * x[idx] at
// the pack c of a row of vecs packs.
template <typename T, int V>
__device__ __forceinline__ void sum_slots(const int* __restrict__ idx,
                                          const float* __restrict__ val,
                                          const T* __restrict__ x,
                                          int64_t begin, int64_t end,
                                          int64_t vecs, int64_t c,
                                          float (&acc)[V]) {
  int64_t j = begin;
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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const Buckets tab, const int* __restrict__ idx,
                    const float* __restrict__ val,
                    const int* __restrict__ rows, const T* __restrict__ x,
                    T* __restrict__ out, int64_t vecs, int group_log2,
                    int accumulate) {
  extern __shared__ float runs[];  // heavy rows: [groups][vecs * V]
  int b = 0;
  while (b + 1 < tab.count && int64_t(blockIdx.x) >= tab.block0[b + 1]) ++b;
  const int64_t blk = int64_t(blockIdx.x) - tab.block0[b];
  const int64_t k = tab.width[b];
  const int64_t nrows = tab.row0[b + 1] - tab.row0[b];
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  if (k <= kHeavyWidth) {
    const int64_t r = (blk * kThreads + threadIdx.x) >> group_log2;
    if (r >= nrows) return;
    const int64_t slot = tab.slot0[b] + r * k;
    T* dst = out + int64_t(__ldg(rows + tab.row0[b] + r)) * vecs * V;
    for (int64_t c = lane; c < vecs; c += group) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      sum_slots<T, V>(idx, val, x, slot, slot + k, vecs, c, acc);
      if (accumulate) {
        float old[V];
        Pack<T, V>::load(dst + c * V, old);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = old[v] + acc[v];
      }
      Pack<T, V>::store(dst + c * V, acc);
    }
    return;
  }
  // a block a row: group g sums the slots [g * run, (g + 1) * run) of the
  // row into runs[g], then the block adds the runs in order
  const int groups = kThreads >> group_log2;
  const int g = threadIdx.x >> group_log2;
  const int64_t run = (k + groups - 1) / groups;
  const int64_t slot = tab.slot0[b] + blk * k;
  const int64_t begin = slot + min(k, g * run);
  const int64_t end = slot + min(k, (g + 1) * run);
  const int64_t width = vecs * V;
  for (int64_t c = lane; c < vecs; c += group) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    sum_slots<T, V>(idx, val, x, begin, end, vecs, c, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) runs[g * width + c * V + v] = acc[v];
  }
  __syncthreads();
  T* dst = out + int64_t(__ldg(rows + tab.row0[b] + blk)) * width;
  for (int64_t col = threadIdx.x; col < width; col += kThreads) {
    float acc[1] = {0.0f};
    for (int h = 0; h < groups; ++h) acc[0] += runs[h * width + col];
    if (accumulate) {
      float old[1];
      Pack<T, 1>::load(dst + col, old);
      acc[0] = old[0] + acc[0];
    }
    Pack<T, 1>::store(dst + col, acc);
  }
}

template <typename T, int V>
int launch(Buckets tab, const int* idx, const float* val, const int* rows,
           const void* x, void* out, int64_t vecs, int accumulate,
           cudaStream_t stream) {
  int group_log2 = 0;  // lanes a row: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  int64_t blocks = 0;
  tab.heavy_any = 0;
  for (int b = 0; b < tab.count; ++b) {
    tab.block0[b] = blocks;
    const int64_t nrows = tab.row0[b + 1] - tab.row0[b];
    if (tab.width[b] > kHeavyWidth) {
      blocks += nrows;
      tab.heavy_any |= nrows > 0;
    } else {
      blocks += ((nrows << group_log2) + kThreads - 1) / kThreads;
    }
  }
  tab.block0[tab.count] = blocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const size_t smem =
      tab.heavy_any
          ? sizeof(float) * size_t(kThreads >> group_log2) * vecs * V
          : 0;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(
        ell_spmm_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  ell_spmm_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(tab, idx, val, rows,
                                    static_cast<const T*>(x),
                                    static_cast<T*>(out), vecs, group_log2,
                                    accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [N, width] = the ELL product over the buckets of table (host, int64
// [buckets, 3]: first row, width, first slot of each; total_rows rows in
// all) of x [N, width], x and out float32 (bf16 == 0) or bfloat16
// (bf16 == 1), contiguous; idx int32 and val float32 [slots], rows int32
// [total_rows] (the node of each row). With accumulate == 1 each row's sum
// is added to out's.
int ell_spmm(const void* idx, const void* val, const void* rows,
             const void* x, void* out, const int64_t* table, int buckets,
             int64_t total_rows, int64_t width, int bf16, int accumulate,
             void* stream) {
  if (buckets < 1 || buckets > kMaxBuckets || width <= 0 || total_rows < 0 ||
      (bf16 != 0 && bf16 != 1) || (accumulate != 0 && accumulate != 1))
    return cudaErrorInvalidValue;
  Buckets tab = {};
  tab.count = buckets;
  for (int b = 0; b < buckets; ++b) {
    tab.row0[b] = table[3 * b];
    tab.width[b] = static_cast<int>(table[3 * b + 1]);
    tab.slot0[b] = table[3 * b + 2];
    if (table[3 * b + 1] < 1 || table[3 * b + 1] > INT_MAX)
      return cudaErrorInvalidValue;
  }
  tab.row0[buckets] = total_rows;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  const auto* vl = static_cast<const float*>(val);
  const auto* rw = static_cast<const int*>(rows);
  const bool aligned = aligned16(x) && aligned16(out);
  if (bf16) {
    if (width % 8 == 0 && aligned)
      return launch<__nv_bfloat16, 8>(tab, ix, vl, rw, x, out, width / 8,
                                      accumulate, st);
    return launch<__nv_bfloat16, 1>(tab, ix, vl, rw, x, out, width,
                                    accumulate, st);
  }
  if (width % 4 == 0 && aligned)
    return launch<float, 4>(tab, ix, vl, rw, x, out, width / 4, accumulate,
                            st);
  return launch<float, 1>(tab, ix, vl, rw, x, out, width, accumulate, st);
}

}  // extern "C"
