// CSR SpMM for the GCN branch (K1), hand-written for Hopper (sm_90a).
//
// Replaces the XLA gather plus segment_sum of gcn_conv and spmm in
// difformer_tpu/ops/graph_ops.py (:107-112 and :233-236), which the JAX
// package runs over edges sorted by receiver:
//
//   out[r, :] = sum over the edges e of row r of val[e] * x[col[e], :]
//
// The forward runs it over the receivers' CSR (col = senders) and the
// backward over the transposed CSR (rows = senders, col = receivers, the
// same values permuted), dx[s] = sum over out-edges of val[e] * dout[r];
// both are built once per graph on the host side (ops/graph_ops.py,
// build_csr_plan), each with its split schedule (below).
//
// What bounds it on this card: bytes. It does 2 E W flops on
// (2 N W + 2 E + N + 1) * 4 compulsory bytes, well under the FP32 rate's
// 20 flops a byte. In practice the gathered rows x[col[e]], E W * 4 bytes,
// set its time once x outgrows the 50 MB L2 (Pokec's size): the gather
// floor, every gathered row read once from HBM, is about 9 times the
// compulsory bytes there, and only rows that L2 keeps (the hot senders of a
// power-law graph) let K1 go below it.
//
// The design. A group of lanes (the power of two >= the row's vectors, up
// to a warp) sums one run of edges and strides its W columns, 16-byte
// float4 loads where W and the pointers allow (a 128-wide row is one
// coalesced 512-byte read by 32 lanes), scalar loads otherwise (any W, e.g.
// the odd F + 1 = 65 of spmm_first). Each lane keeps its sums in f32
// registers, walks the edges four at a time so four gathers are in flight,
// and writes each output once. Rows of very different degree are balanced
// by a split schedule that the plan builds once (kernels/spmm.py,
// row_split): a row of more than T edges (a heavy row, a hub of a power-law
// graph) is cut into contiguous segments of at most T edges, in CSR order.
// One launch of csr_spmm_kernel takes the segments in its first blocks,
// each summed by one group into a row of a workspace, and the light rows
// (degree <= T) in the rest, each summed straight into out; heavy rows are
// skipped there. The segments go first so that they start at once and end
// under the bulk of light rows, instead of running as a tail after it.
// Then, only when the schedule has heavy rows, csr_spmm_combine sums each
// heavy row's segments in segment order and writes the row once. So a row's
// sum is taken in CSR order within each segment, then over its segments in
// order: no atomics, and two calls give bit-equal results. Without heavy
// rows (every citation graph at the package's T) it is one launch, as
// before the split. Empty rows write 0.
//
// Layouts: row_ptr int32 [rows + 1], col int32 [E], val float32 [E],
// x float32 [*, W] and out float32 [rows, W], all contiguous; the schedule's
// heavy_rows int32 [H], seg_ptr int32 [H + 1] (the segments of heavy row h
// are seg_ptr[h] .. seg_ptr[h + 1] - 1), seg_begin and seg_end int32 [S]
// (edge offsets) and the workspace ws float32 [S, W]. Offsets into x, out
// and ws are 64-bit.
//
// C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after its launches, so a refused launch is reported to the caller.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads of every block
constexpr int kUnroll = 4;     // edges whose gathers are in flight at once

__device__ __forceinline__ float zero(float*) { return 0.0f; }
__device__ __forceinline__ float4 zero(float4*) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void fma_into(float& acc, float w, float x) {
  acc = fmaf(w, x, acc);
}
__device__ __forceinline__ void fma_into(float4& acc, float w, float4 x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ void add_into(float& acc, float x) { acc += x; }
__device__ __forceinline__ void add_into(float4& acc, float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// dst[c] = sum over edges begin .. end - 1, in order, of val[e] *
// x[col[e] * vecs + c], for the columns c = lane, lane + group, ... of a
// row of vecs values of T (float or float4).
template <typename T>
__device__ __forceinline__ void sum_edges(const int* __restrict__ col,
                                          const float* __restrict__ val,
                                          const T* __restrict__ x,
                                          T* __restrict__ dst, int begin,
                                          int end, int64_t vecs, int lane,
                                          int group) {
  for (int64_t c = lane; c < vecs; c += group) {
    T acc = zero(static_cast<T*>(nullptr));
    int e = begin;
    for (; e + kUnroll <= end; e += kUnroll) {
      int s[kUnroll];
      float w[kUnroll];
      T xs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = __ldg(col + e + u);
        w[u] = __ldg(val + e + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) xs[u] = __ldg(x + s[u] * vecs + c);
      // in CSR order, one edge after the other
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma_into(acc, w[u], xs[u]);
    }
    for (; e < end; ++e)
      fma_into(acc, __ldg(val + e), __ldg(x + __ldg(col + e) * vecs + c));
    dst[c] = acc;
  }
}

// A group of 2^group_log2 lanes per segment (blocks below seg_blocks) or
// per row (the rest): segment s into ws[s], a light row into out[row].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col,
                    const float* __restrict__ val, const T* __restrict__ x,
                    T* __restrict__ out, int64_t rows, int64_t vecs,
                    int group_log2, int threshold,
                    const int* __restrict__ seg_begin,
                    const int* __restrict__ seg_end, T* __restrict__ ws,
                    int64_t segments, int seg_blocks) {
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  if (int(blockIdx.x) < seg_blocks) {
    const int64_t seg =
        (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> group_log2;
    if (seg >= segments) return;
    sum_edges(col, val, x, ws + seg * vecs, __ldg(seg_begin + seg),
              __ldg(seg_end + seg), vecs, lane, group);
    return;
  }
  const int64_t row =
      (int64_t(blockIdx.x - seg_blocks) * kThreads + threadIdx.x) >>
      group_log2;
  if (row >= rows) return;
  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  if (end - begin > threshold) return;  // heavy: csr_spmm_combine writes it
  sum_edges(col, val, x, out + row * vecs, begin, end, vecs, lane, group);
}

// out[heavy_rows[h]] = the sum of ws[seg_ptr[h]] .. ws[seg_ptr[h + 1] - 1],
// in segment order; a group of 2^group_log2 lanes per heavy row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_combine(const int* __restrict__ heavy_rows,
                     const int* __restrict__ seg_ptr,
                     const T* __restrict__ ws, T* __restrict__ out,
                     int64_t heavy, int64_t vecs, int group_log2) {
  const int64_t h =
      (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> group_log2;
  if (h >= heavy) return;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int first = __ldg(seg_ptr + h);
  const int last = __ldg(seg_ptr + h + 1);
  T* dst = out + int64_t(__ldg(heavy_rows + h)) * vecs;
  for (int64_t c = lane; c < vecs; c += group) {
    T acc = zero(static_cast<T*>(nullptr));
    for (int s = first; s < last; ++s) add_into(acc, ws[s * vecs + c]);
    dst[c] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int64_t blocks_for(int64_t items, int group_log2) {
  return ((items << group_log2) + kThreads - 1) / kThreads;
}

template <typename T>
int launch(const int* row_ptr, const int* col, const float* val,
           const void* x, void* out, int64_t rows, int64_t vecs,
           int threshold, const int* heavy_rows, const int* seg_ptr,
           const int* seg_begin, const int* seg_end, int64_t heavy,
           int64_t segments, void* ws, cudaStream_t stream) {
  int group_log2 = 0;  // lanes per row: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const int64_t seg_blocks = blocks_for(segments, group_log2);
  const int64_t blocks = seg_blocks + blocks_for(rows, group_log2);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  csr_spmm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      row_ptr, col, val, static_cast<const T*>(x), static_cast<T*>(out), rows,
      vecs, group_log2, threshold, seg_begin, seg_end, static_cast<T*>(ws),
      segments, static_cast<int>(seg_blocks));
  if (heavy == 0) return cudaGetLastError();
  const int rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  csr_spmm_combine<T><<<static_cast<unsigned>(blocks_for(heavy, group_log2)),
                        kThreads, 0, stream>>>(
      heavy_rows, seg_ptr, static_cast<const T*>(ws), static_cast<T*>(out),
      heavy, vecs, group_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [rows, width] = CSR(row_ptr, col, val) @ x [*, width]. The rows of
// more than threshold edges (heavy_rows, heavy of them) are summed by
// segments (seg_ptr, seg_begin, seg_end; segments in all) into ws
// [segments, width], then combined. Nothing is launched for rows == 0 (the
// caller returns zeros for an empty graph).
int csr_spmm(const void* row_ptr, const void* col, const void* val,
             const void* x, void* out, int64_t rows, int64_t width,
             int threshold, const void* heavy_rows, const void* seg_ptr,
             const void* seg_begin, const void* seg_end, int64_t heavy,
             int64_t segments, void* ws, void* stream) {
  if (rows < 0 || width <= 0 || rows > (int64_t(1) << 40) || threshold < 1 ||
      heavy < 0 || segments < heavy || segments > (int64_t(1) << 40))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cl = static_cast<const int*>(col);
  const auto* vl = static_cast<const float*>(val);
  const auto* hr = static_cast<const int*>(heavy_rows);
  const auto* sp = static_cast<const int*>(seg_ptr);
  const auto* sb = static_cast<const int*>(seg_begin);
  const auto* se = static_cast<const int*>(seg_end);
  if (width % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(ws))
    return launch<float4>(rp, cl, vl, x, out, rows, width / 4, threshold, hr,
                          sp, sb, se, heavy, segments, ws, st);
  return launch<float>(rp, cl, vl, x, out, rows, width, threshold, hr, sp, sb,
                       se, heavy, segments, ws, st);
}

}  // extern "C"
