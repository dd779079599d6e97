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
// coalesced 512-byte read by 32 lanes; at bf16, 8 values a lane), scalar
// loads otherwise (any W, e.g. the odd F + 1 = 65 of spmm_first). Each
// lane keeps its sums in f32 registers, walks the edges four at a time so
// four gathers are in flight,
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
// Capture in a CUDA graph for a changing graph (the mini-batch trainer
// replays one graph of a chunk's train step for every chunk of an epoch,
// each with its own CSRs): the grids must not depend on the data. Such a
// caller gives the schedule at a fixed capacity, H_cap heavy rows and S_cap
// segments, sizes the grids from those, and passes counts, a device array
// holding the real heavy-row and segment counts; blocks past them exit at
// once. Light rows need no count: a row is heavy by its degree, which the
// kernel reads. Without counts (the graph of a whole run, whose schedule is
// known when the plan is built) the counts are the host's and the launch is
// the exact one.
//
// Element types: x and out are float32, or bfloat16 (the model at
// compute_dtype="bfloat16"). At bf16 each lane loads 8 values (16 bytes) a
// gather where W is a multiple of 8 and the pointers allow, sums in f32
// registers as at f32, and rounds each output to bf16 once, at its store:
// a row's result is its f32 sum rounded once. (The JAX package rounds each
// message to bf16 and sums in bf16, graph_ops.py:107-112; the single
// rounding here is the more accurate of the two.) The heavy rows'
// workspace stays f32 at either type, so a row summed in segments is
// rounded once too, by the combine; the values val stay f32.
//
// Layouts: row_ptr int32 [rows + 1], col int32 [E], val float32 [E],
// x [*, W] and out [rows, W] of one element type, all contiguous; the
// schedule's heavy_rows int32 [H], seg_ptr int32 [H + 1] (the segments of
// heavy row h are seg_ptr[h] .. seg_ptr[h + 1] - 1), seg_begin and seg_end
// int32 [S] (edge offsets) and the workspace ws float32 [S, W]; counts, when
// given,
// int32 [2] on the device: the heavy rows and segments in use, at most H
// and S. Offsets into x, out and ws are 64-bit.
//
// The value gradient (K1-dval, csr_spmm_dval_kernel). Where the edge values
// are learned (GAT's attention, difformer_tpu/nn/gnns.py:183-184; spmm's
// values, graph_ops.py:233-236, which XLA differentiates), the backward
// also needs dval[e, h] = <dout[row(e), h], x[col[e], h]> for every head h,
// a sampled dense-dense product over the forward CSR. It is bound by bytes
// as K1 is (2 E H D flops on (2 N H D + E H + E + N) * 4 compulsory bytes).
// The design is K1's, row by row: one work item is a light row, or a
// segment of a heavy row, for one head, and a group of lanes (the power of
// two >= the row's packs, up to a warp) takes it. The schedule is a split
// like K1's, at a smaller T (kernels/spmm.py DVAL_SPLIT_THRESHOLD, built
// with the plan): every edge ends in a reduction across the group, so a
// light row of a few hundred edges (a popular neighbour in a kNN graph)
// walked by one group would set the call's time. The group loads
// dout[r, h] once into registers, then walks the item's edges in CSR
// order, a batch of group edges at a time: each lane loads one
// column index of the batch (one coalesced read), the edges' indices come
// to every lane by shuffles, and the gathers of x[col[e], h] (16-byte packs
// where D and the strides allow, single floats otherwise, e.g. GAT's D = 7)
// of several edges are in flight before their sums. Each edge's products
// are summed in f32 per lane, then across the group by a butterfly of
// shuffles; lane k of the group keeps edge base + k's value and the batch
// is stored at once. A lane holds at most kDvalPacks packs of dout; a wider
// row walks its edges once for each slice of that many packs a lane, adding
// the slices in order before the one store. Every value is written once, by
// one group: no atomics, and two calls are bit-equal. dout and x are read
// in place as [rows, H, D] views at their row and head strides, so every
// head of GAT's layer is one launch, with no copies of strided head slices.
// The heads of a row are neighbouring items, so their loads and stores are
// neighbours too. Only float32 is taken (the baseline models train at f32).
// In practice its x gathers, E H D * 4 bytes, set its time: from L2 where x
// fits there (cifar10's kNN graph), from HBM beyond (Pokec's size).
//
// C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after its launches, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "pack.cuh"

namespace {

constexpr int kThreads = 256;  // threads of every block
constexpr int kUnroll = 4;     // edges whose gathers are in flight at once

// dst[c] = sum over edges begin .. end - 1, in order, of val[e] *
// x[col[e]][c], in f32, for the packs c = lane, lane + group, ... of a row
// of vecs packs of V values; stored as Out (the output's type, or f32 into
// the workspace).
template <typename In, typename Out, int V>
__device__ __forceinline__ void sum_edges(const int* __restrict__ col,
                                          const float* __restrict__ val,
                                          const In* __restrict__ x,
                                          Out* __restrict__ dst, int begin,
                                          int end, int64_t vecs, int lane,
                                          int group) {
  for (int64_t c = lane; c < vecs; c += group) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    int e = begin;
    for (; e + kUnroll <= end; e += kUnroll) {
      int s[kUnroll];
      float w[kUnroll];
      float xs[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = __ldg(col + e + u);
        w[u] = __ldg(val + e + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Pack<In, V>::load(x + (s[u] * vecs + c) * V, xs[u]);
      // in CSR order, one edge after the other
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(w[u], xs[u][v], acc[v]);
    }
    for (; e < end; ++e) {
      float xe[V];
      const float we = __ldg(val + e);
      Pack<In, V>::load(x + (__ldg(col + e) * vecs + c) * V, xe);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(we, xe[v], acc[v]);
    }
    Pack<Out, V>::store(dst + c * V, acc);
  }
}

// A group of 2^group_log2 lanes per segment (blocks below seg_blocks) or
// per row (the rest): segment s into ws[s] (f32), a light row into out[row].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col,
                    const float* __restrict__ val, const T* __restrict__ x,
                    T* __restrict__ out, int64_t rows, int64_t vecs,
                    int group_log2, int threshold,
                    const int* __restrict__ seg_begin,
                    const int* __restrict__ seg_end, float* __restrict__ ws,
                    int64_t segments, int seg_blocks,
                    const int* __restrict__ counts) {
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  if (int(blockIdx.x) < seg_blocks) {
    const int64_t seg =
        (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> group_log2;
    if (seg >= (counts ? int64_t(__ldg(counts + 1)) : segments)) return;
    sum_edges<T, float, V>(col, val, x, ws + seg * vecs * V,
                           __ldg(seg_begin + seg), __ldg(seg_end + seg), vecs,
                           lane, group);
    return;
  }
  const int64_t row =
      (int64_t(blockIdx.x - seg_blocks) * kThreads + threadIdx.x) >>
      group_log2;
  if (row >= rows) return;
  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  if (end - begin > threshold) return;  // heavy: csr_spmm_combine writes it
  sum_edges<T, T, V>(col, val, x, out + row * vecs * V, begin, end, vecs,
                     lane, group);
}

// out[heavy_rows[h]] = the sum of ws[seg_ptr[h]] .. ws[seg_ptr[h + 1] - 1],
// in segment order, in f32, added to out's value under accumulate, stored
// as T; a group of 2^group_log2 lanes per heavy row, for the first
// counts[0] heavy rows when counts is given, else the first heavy. K6
// (ell.cu) sums its split rows' chunks with it too.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_combine(const int* __restrict__ heavy_rows,
                     const int* __restrict__ seg_ptr,
                     const float* __restrict__ ws, T* __restrict__ out,
                     int64_t heavy, int64_t vecs, int group_log2,
                     const int* __restrict__ counts, int accumulate) {
  const int64_t h =
      (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> group_log2;
  if (h >= (counts ? int64_t(__ldg(counts)) : heavy)) return;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int first = __ldg(seg_ptr + h);
  const int last = __ldg(seg_ptr + h + 1);
  T* dst = out + int64_t(__ldg(heavy_rows + h)) * vecs * V;
  for (int64_t c = lane; c < vecs; c += group) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int s = first; s < last; ++s) {
      float part[V];
      Pack<float, V>::load(ws + (s * vecs + c) * V, part);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += part[v];
    }
    if (accumulate) {
      float old[V];
      Pack<T, V>::load(dst + c * V, old);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = old[v] + acc[v];
    }
    Pack<T, V>::store(dst + c * V, acc);
  }
}

constexpr int kDvalPacks = 4;  // packs of dout a lane holds (K1-dval)

// The lanes of this thread's group of group (a power of two <= 32) lanes,
// as a shuffle mask: groups of one warp walk items of different lengths,
// so a group's shuffles name only its own lanes.
__device__ __forceinline__ unsigned group_mask(int group) {
  if (group == 32) return 0xffffffffu;
  return ((1u << group) - 1u) << (threadIdx.x & 31 & ~(group - 1));
}

// dst[e * heads] = <g, x[col[e]]> for the edges begin .. end - 1 of one
// item, g and x's rows at one head (x at row stride ld_x), vecs packs of V
// floats a row, in f32: the group's lanes hold g's packs c = lane + k group
// (k < P) of each slice of group P packs; U edges' gathers are issued
// before their sums.
template <int V, int P, int U>
__device__ __forceinline__ void dval_item(const float* __restrict__ g,
                                          const float* __restrict__ xh,
                                          int64_t ld_x,
                                          const int* __restrict__ col,
                                          float* __restrict__ dst,
                                          int64_t heads, int begin, int end,
                                          int vecs, int lane, int group,
                                          unsigned mask) {
  const int span = group * P;  // packs of a slice
  const int slices = (vecs + span - 1) / span;
  float gv[P][V];
  for (int base = begin; base < end; base += group) {
    const int count = min(group, end - base);
    const int my_col = lane < count ? __ldg(col + base + lane) : 0;
    float mine = 0.0f;  // the value of edge base + lane
    for (int s = 0; s < slices; ++s) {
      const int c0 = s * span + lane;
      if (slices > 1 || base == begin) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (c0 + p * group < vecs) {
            Pack<float, V>::load(g + (c0 + p * group) * V, gv[p]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) gv[p][v] = 0.0f;
          }
        }
      }
      for (int k = 0; k < count; k += U) {
        float xv[U][P][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool live = k + u < count;
          const int c = __shfl_sync(mask, my_col, live ? k + u : 0, group);
          const float* b = xh + int64_t(c) * ld_x;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (live && c0 + p * group < vecs) {
              Pack<float, V>::load(b + (c0 + p * group) * V, xv[u][p]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) xv[u][p][v] = 0.0f;
            }
          }
        }
        float acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u] = 0.0f;
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[u] = fmaf(gv[p][v], xv[u][p][v], acc[u]);
        }
        for (int offset = group >> 1; offset > 0; offset >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
            acc[u] += __shfl_xor_sync(mask, acc[u], offset);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (lane == k + u) mine = s == 0 ? acc[u] : mine + acc[u];
      }
    }
    if (lane < count) dst[int64_t(base + lane) * heads] = mine;
  }
}

// dval[e * heads + h] = sum over c of dout[r][h][c] * x[col[e]][h][c], in
// f32, for the edges e of row r of the forward CSR: the gradient of K1's
// output with respect to its values, every head at once. Items are (row or
// segment, head), the head the fastest: blocks below seg_blocks take the
// segments of the heavy rows (the first counts[1] when counts is given),
// the rest the light rows (degree <= threshold; a heavy row is skipped
// there). A group of 2^group_log2 lanes takes an item (dval_item).
template <int V, int P, int U>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_dval_kernel(const int* __restrict__ row_ptr,
                         const int* __restrict__ rows,
                         const int* __restrict__ col,
                         const float* __restrict__ dout,
                         const float* __restrict__ x,
                         float* __restrict__ dval, int64_t nrows,
                         int64_t heads, int vecs, int64_t ld_g, int64_t hs_g,
                         int64_t ld_x, int64_t hs_x, int group_log2,
                         int threshold, const int* __restrict__ seg_begin,
                         const int* __restrict__ seg_end, int64_t segments,
                         int seg_blocks, const int* __restrict__ counts) {
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const bool seg_item = int(blockIdx.x) < seg_blocks;
  const int64_t item =
      (int64_t(seg_item ? blockIdx.x : blockIdx.x - seg_blocks) * kThreads +
       threadIdx.x) >>
      group_log2;
  const int64_t unit = item / heads;  // the segment or the row
  const int64_t h = item - unit * heads;
  int64_t r;
  int begin, end;
  if (seg_item) {
    if (unit >= (counts ? int64_t(__ldg(counts + 1)) : segments)) return;
    begin = __ldg(seg_begin + unit);
    end = __ldg(seg_end + unit);
    r = __ldg(rows + begin);
  } else {
    if (unit >= nrows) return;
    r = unit;
    begin = __ldg(row_ptr + r);
    end = __ldg(row_ptr + r + 1);
    if (end - begin > threshold) return;  // heavy: its segments cover it
  }
  dval_item<V, P, U>(dout + r * ld_g + h * hs_g, x + h * hs_x, ld_x, col,
                     dval + h, heads, begin, end, vecs, lane, group,
                     group_mask(group));
}

int64_t blocks_for(int64_t items, int group_log2) {
  return ((items << group_log2) + kThreads - 1) / kThreads;
}

// csr_spmm_combine over heavy rows (counts: see the kernel) of vecs packs
template <typename T, int V>
int launch_combine(const int* heavy_rows, const int* seg_ptr,
                   const float* ws, void* out, int64_t heavy, int64_t vecs,
                   const int* counts, int accumulate, cudaStream_t stream) {
  int group_log2 = 0;  // lanes per row: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const int64_t blocks = blocks_for(heavy, group_log2);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  csr_spmm_combine<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(heavy_rows, seg_ptr, ws,
                                     static_cast<T*>(out), heavy, vecs,
                                     group_log2, counts, accumulate);
  return cudaGetLastError();
}

// vecs packs of V values of T a row
template <typename T, int V>
int launch(const int* row_ptr, const int* col, const float* val,
           const void* x, void* out, int64_t rows, int64_t vecs,
           int threshold, const int* heavy_rows, const int* seg_ptr,
           const int* seg_begin, const int* seg_end, int64_t heavy,
           int64_t segments, const int* counts, float* ws,
           cudaStream_t stream) {
  int group_log2 = 0;  // lanes per row: the power of two >= vecs, up to 32
  while ((int64_t(1) << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const int64_t seg_blocks = blocks_for(segments, group_log2);
  const int64_t blocks = seg_blocks + blocks_for(rows, group_log2);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  csr_spmm_kernel<T, V>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          row_ptr, col, val, static_cast<const T*>(x), static_cast<T*>(out),
          rows, vecs, group_log2, threshold, seg_begin, seg_end, ws, segments,
          static_cast<int>(seg_blocks), counts);
  if (heavy == 0) return cudaGetLastError();
  const int rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  return launch_combine<T, V>(heavy_rows, seg_ptr, ws, out, heavy, vecs,
                              counts, 0, stream);
}

// K1-dval with P packs of dout a lane; U edges in flight where P is small
template <int V, int P>
int launch_dval(const int* row_ptr, const int* rows, const int* col,
                const float* dout, const float* x, float* dval,
                int64_t nrows, int64_t heads, int vecs, int64_t ld_g,
                int64_t hs_g, int64_t ld_x, int64_t hs_x, int group_log2,
                int threshold, const int* seg_begin, const int* seg_end,
                int64_t segments, const int* counts, cudaStream_t stream) {
  constexpr int U = P <= 2 ? 4 : 2;
  const int64_t seg_blocks = blocks_for(segments * heads, group_log2);
  const int64_t blocks = seg_blocks + blocks_for(nrows * heads, group_log2);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  csr_spmm_dval_kernel<V, P, U>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          row_ptr, rows, col, dout, x, dval, nrows, heads, vecs, ld_g, hs_g,
          ld_x, hs_x, group_log2, threshold, seg_begin, seg_end, segments,
          static_cast<int>(seg_blocks), counts);
  return cudaGetLastError();
}

template <int V>
int launch_dval_p(int packs, const int* row_ptr, const int* rows,
                  const int* col, const float* dout, const float* x,
                  float* dval, int64_t nrows, int64_t heads, int vecs,
                  int64_t ld_g, int64_t hs_g, int64_t ld_x, int64_t hs_x,
                  int group_log2, int threshold, const int* seg_begin,
                  const int* seg_end, int64_t segments, const int* counts,
                  cudaStream_t stream) {
  switch (packs) {
    case 1:
      return launch_dval<V, 1>(row_ptr, rows, col, dout, x, dval, nrows,
                               heads, vecs, ld_g, hs_g, ld_x, hs_x,
                               group_log2, threshold, seg_begin, seg_end,
                               segments, counts, stream);
    case 2:
      return launch_dval<V, 2>(row_ptr, rows, col, dout, x, dval, nrows,
                               heads, vecs, ld_g, hs_g, ld_x, hs_x,
                               group_log2, threshold, seg_begin, seg_end,
                               segments, counts, stream);
    case 3:
      return launch_dval<V, 3>(row_ptr, rows, col, dout, x, dval, nrows,
                               heads, vecs, ld_g, hs_g, ld_x, hs_x,
                               group_log2, threshold, seg_begin, seg_end,
                               segments, counts, stream);
    default:
      return launch_dval<V, kDvalPacks>(row_ptr, rows, col, dout, x, dval,
                                        nrows, heads, vecs, ld_g, hs_g,
                                        ld_x, hs_x, group_log2, threshold,
                                        seg_begin, seg_end, segments, counts,
                                        stream);
  }
}

}  // namespace

extern "C" {

// out [rows, width] = CSR(row_ptr, col, val) @ x [*, width], x and out
// float32 (bf16 == 0) or bfloat16 (bf16 == 1). The rows of more than
// threshold edges (heavy_rows, heavy of them) are summed by segments
// (seg_ptr, seg_begin, seg_end; segments in all) into the float32
// workspace ws [segments, width], then combined. With counts (int32 [2] on
// the device) heavy and segments are capacities, and the first counts[0]
// heavy rows and counts[1] segments are used. Nothing is launched for
// rows == 0 (the caller returns zeros for an empty graph).
int csr_spmm(const void* row_ptr, const void* col, const void* val,
             const void* x, void* out, int64_t rows, int64_t width, int bf16,
             int threshold, const void* heavy_rows, const void* seg_ptr,
             const void* seg_begin, const void* seg_end, int64_t heavy,
             int64_t segments, const void* counts, void* ws, void* stream) {
  if (rows < 0 || width <= 0 || rows > (int64_t(1) << 40) || threshold < 1 ||
      heavy < 0 || segments < heavy || segments > (int64_t(1) << 40) ||
      (bf16 != 0 && bf16 != 1))
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
  const auto* ct = static_cast<const int*>(counts);
  auto* w = static_cast<float*>(ws);
  const bool aligned = aligned16(x) && aligned16(out) && aligned16(ws);
  if (bf16) {
    if (width % 8 == 0 && aligned)
      return launch<__nv_bfloat16, 8>(rp, cl, vl, x, out, rows, width / 8,
                                      threshold, hr, sp, sb, se, heavy,
                                      segments, ct, w, st);
    return launch<__nv_bfloat16, 1>(rp, cl, vl, x, out, rows, width,
                                    threshold, hr, sp, sb, se, heavy,
                                    segments, ct, w, st);
  }
  if (width % 4 == 0 && aligned)
    return launch<float, 4>(rp, cl, vl, x, out, rows, width / 4, threshold,
                            hr, sp, sb, se, heavy, segments, ct, w, st);
  return launch<float, 1>(rp, cl, vl, x, out, rows, width, threshold, hr, sp,
                          sb, se, heavy, segments, ct, w, st);
}

// The combine alone: out[heavy_rows[h]] (+)= the sum, in order, of the
// float32 rows ws[seg_ptr[h]] .. ws[seg_ptr[h + 1] - 1] of ws [*, width],
// for h < heavy, rounded once to out's type (float32, bf16 == 0, or
// bfloat16, bf16 == 1); with accumulate == 1 added to out's value. K6's
// split rows (ell.cu) are finished by it. Nothing is launched for
// heavy == 0.
int csr_spmm_combine_rows(const void* heavy_rows, const void* seg_ptr,
                          const void* ws, void* out, int64_t heavy,
                          int64_t width, int bf16, int accumulate,
                          void* stream) {
  if (heavy < 0 || width <= 0 || heavy > (int64_t(1) << 40) ||
      (bf16 != 0 && bf16 != 1) || (accumulate != 0 && accumulate != 1))
    return cudaErrorInvalidValue;
  if (heavy == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* hr = static_cast<const int*>(heavy_rows);
  const auto* sp = static_cast<const int*>(seg_ptr);
  const auto* w = static_cast<const float*>(ws);
  const bool aligned = aligned16(ws) && aligned16(out);
  if (bf16) {
    if (width % 8 == 0 && aligned)
      return launch_combine<__nv_bfloat16, 8>(hr, sp, w, out, heavy,
                                              width / 8, nullptr, accumulate,
                                              st);
    return launch_combine<__nv_bfloat16, 1>(hr, sp, w, out, heavy, width,
                                            nullptr, accumulate, st);
  }
  if (width % 4 == 0 && aligned)
    return launch_combine<float, 4>(hr, sp, w, out, heavy, width / 4,
                                    nullptr, accumulate, st);
  return launch_combine<float, 1>(hr, sp, w, out, heavy, width, nullptr,
                                  accumulate, st);
}

// dval [E, heads] = the gradient of K1's output with respect to its values,
// for the forward CSR (row_ptr [nrows + 1], col [E], rows [E] each edge's
// row, int32): dval[e * heads + h] = <dout[r][h], x[col[e]][h]> for edge e
// of row r, dout and x float32 [*, heads, width] with the row strides ld_*
// and head strides hs_* (elements; the columns contiguous), read in place.
// The rows of more than threshold edges are taken by their segments
// (seg_begin, seg_end; segments in all, the first counts[1] with counts,
// int32 [2] on the device), as K1's schedule cuts them. Each value is
// written once (no atomics). Nothing is launched for nrows == 0.
int csr_spmm_dval(const void* row_ptr, const void* rows, const void* col,
                  const void* dout, const void* x, void* dval, int64_t nrows,
                  int64_t heads, int64_t width, int64_t ld_dout,
                  int64_t hs_dout, int64_t ld_x, int64_t hs_x, int threshold,
                  const void* seg_begin, const void* seg_end,
                  int64_t segments, const void* counts, void* stream) {
  if (nrows < 0 || nrows > (int64_t(1) << 40) || heads < 1 ||
      heads > (int64_t(1) << 20) || width <= 0 || width > (1 << 24) ||
      threshold < 1 || segments < 0 || segments > (int64_t(1) << 40) ||
      ld_dout < 0 || hs_dout < 0 || ld_x < 0 || hs_x < 0)
    return cudaErrorInvalidValue;
  if (nrows == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec4 = width % 4 == 0 && ld_dout % 4 == 0 && hs_dout % 4 == 0 &&
                    ld_x % 4 == 0 && hs_x % 4 == 0 && aligned16(dout) &&
                    aligned16(x);
  const int vecs = static_cast<int>(vec4 ? width / 4 : width);
  int group_log2 = 0;  // lanes per item: the power of two >= vecs, up to 32
  while ((1 << group_log2) < vecs && group_log2 < 5) ++group_log2;
  const int per_lane = (vecs + (1 << group_log2) - 1) >> group_log2;
  const int packs = per_lane < kDvalPacks ? per_lane : kDvalPacks;
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* rw = static_cast<const int*>(rows);
  const auto* cl = static_cast<const int*>(col);
  const auto* g = static_cast<const float*>(dout);
  const auto* xs = static_cast<const float*>(x);
  auto* out = static_cast<float*>(dval);
  const auto* sb = static_cast<const int*>(seg_begin);
  const auto* se = static_cast<const int*>(seg_end);
  const auto* ct = static_cast<const int*>(counts);
  if (vec4)
    return launch_dval_p<4>(packs, rp, rw, cl, g, xs, out, nrows, heads,
                            vecs, ld_dout, hs_dout, ld_x, hs_x, group_log2,
                            threshold, sb, se, segments, ct, st);
  return launch_dval_p<1>(packs, rp, rw, cl, g, xs, out, nrows, heads, vecs,
                          ld_dout, hs_dout, ld_x, hs_x, group_log2,
                          threshold, sb, se, segments, ct, st);
}

}  // extern "C"
