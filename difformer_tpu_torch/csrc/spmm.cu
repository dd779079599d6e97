// CSR SpMM for the GCN branch (K1), hand-written for Hopper (sm_90a).
//
// Replaces the XLA gather plus segment_sum of gcn_conv and spmm in
// difformer_tpu/ops/graph_ops.py (:107-112 and :233-236), which the JAX
// package runs over edges sorted by receiver:
//
//   csr_spmm_kernel  out[r, :] = sum over the edges e of row r, in CSR
//                    order, of val[e] * x[col[e], :]
//
// The forward runs it over the receivers' CSR (col = senders) and the
// backward over the transposed CSR (rows = senders, col = receivers, the
// same values permuted), dx[s] = sum over out-edges of val[e] * dout[r];
// both are built once per graph on the host side (ops/graph_ops.py,
// build_csr_plan). So no output row is written by two threads: there are no
// atomics, and two calls give bit-equal results.
//
// What bounds it on this card: bytes. It does 2 E W flops on
// (2 N W + 2 E + N + 1) * 4 compulsory bytes, well under the FP32 rate's
// 20 flops a byte; and the gathered rows x[col[e]] are E W * 4 bytes, which
// the 50 MB L2 holds only while x is small (Cora, PubMed), not at Pokec's
// size. The design is the simple one: a group of lanes owns one row and
// strides its W columns, 16-byte float4 loads where W and the pointers
// allow (a 64-wide row is one coalesced 256-byte read by 16 lanes), scalar
// loads otherwise (any W, e.g. the odd F + 1 = 65 of spmm_first). Each lane
// keeps its sums in f32 registers, walks the row's edges four at a time so
// four gathers are in flight, and writes each output once. Empty rows
// write 0. Load balancing across rows of very different degree, shared
// memory staging of col and val, and gathers through the TMA are later
// work.
//
// Layouts: row_ptr int32 [rows + 1], col int32 [E], val float32 [E],
// x float32 [*, W] and out float32 [rows, W], all contiguous. Offsets into
// x and out are 64-bit.
//
// C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after its launch, so a refused launch is reported to the caller.

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

// T is float or float4; a row holds vecs values of T. A group of
// 2^group_log2 lanes owns a row, lane j its vectors j, j + group, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col,
                    const float* __restrict__ val, const T* __restrict__ x,
                    T* __restrict__ out, int64_t rows, int64_t vecs,
                    int group_log2) {
  const int64_t thread = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = thread >> group_log2;
  if (row >= rows) return;
  const int group = 1 << group_log2;
  const int lane = int(thread & (group - 1));
  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  T* dst = out + row * vecs;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const int* row_ptr, const int* col, const float* val,
           const void* x, void* out, int64_t rows, int64_t vecs,
           cudaStream_t stream) {
  int group_log2 = 0;  // lanes per row: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const int64_t blocks = ((rows << group_log2) + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  csr_spmm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      row_ptr, col, val, static_cast<const T*>(x), static_cast<T*>(out), rows,
      vecs, group_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [rows, width] = CSR(row_ptr, col, val) @ x [*, width]; nothing is
// launched for rows == 0 (the caller returns zeros for an empty graph).
int csr_spmm(const void* row_ptr, const void* col, const void* val,
             const void* x, void* out, int64_t rows, int64_t width,
             void* stream) {
  if (rows < 0 || width <= 0 || rows > (int64_t(1) << 40))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cl = static_cast<const int*>(col);
  const auto* vl = static_cast<const float*>(val);
  if (width % 4 == 0 && aligned16(x) && aligned16(out))
    return launch<float4>(rp, cl, vl, x, out, rows, width / 4, st);
  return launch<float>(rp, cl, vl, x, out, rows, width, st);
}

}  // extern "C"
