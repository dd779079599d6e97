// Block-sparse (BSR) SpMM (K7), hand-written for Hopper (sm_90a).
//
// Replaces the XLA gather and einsum of the JAX package's block-sparse
// hybrid, _bsr_matvec and _bsr_bucketed_matvec in difformer_tpu/ops/bsr.py
// (:252-264 and :568-627): for every row tile n that holds dense blocks,
//
//   out[n T + r, :] = sum over k, c of blocks[n, k, r, c] * x[bcol[n, k] T + c, :]
//
// over its blocks k (their column tiles bcol), for the padded layout
// ([Ntr, Kb, T, T], every row tile in order) and for every bucket of the
// bucketed layout ([m, kb, T, T] with its row tiles rows[m]) in one launch.
// A group of row tiles without blocks (the bucketed layout's tiles with no
// dense block) is written 0, so every row tile is written exactly once, by
// one thread an element: no atomics, deterministic. The sparse tiles' edges
// (the residual) are then added by the ELL kernel K6 (ell.cu), on the raw x.
//
// Blocks are float32, bfloat16 or int8 edge counts. For counts the rank-1
// GCN scaling of BsrBuckets.inv_scale is fused into the loads and stores:
// x rows are multiplied by scale[row] as they are staged, and each output
// element by scale[node] as it is stored; the JAX package does the same
// with two elementwise passes. x and out are float32 or bfloat16; every
// product and sum is f32, and the output is rounded once at the store.
//
// What bounds it on this card: operations. A T x T block against a [T, W]
// slice of x is 2 T^2 W flops for T^2 block elements: at T = 256, W = 64
// and f32 blocks 8.4 MFLOP a 256 KB block, 32 flops a byte, above the FP32
// units' 20 flops a byte of HBM (int8 blocks 128). The compulsory bytes are
// the blocks once, x once and out once.
//
// The design: the products on the tensor cores, mma.sync.m16n8k8 in TF32
// with f32 sums. TF32 keeps 10 mantissa bits: an f32 operand is split into
// hi + lo TF32 values and a b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b
// (3 passes, as the wide K2-K4 of sigmoid_attention.cu), f32's order of
// error; bf16 block values and edge counts (at most 127) are TF32 values
// already, so with them only x is split (2 passes), and at bf16 x without a
// scale nothing is (1 pass). The passes set the pace at f32 (PERF.md §6).
//
// Two ways to stage the operands. Where T is a multiple of 32, a row of x a
// multiple of 16 bytes and the pointers 16-byte aligned (every layout at
// the model's widths but spmm_first's F + 1), bsr_spmm_async_kernel: a
// block of 8 warps computes a 128 x 64 tile of one row tile's output (128
// rows, 64 of the W columns; each warp 32 x 32, 2 x 4 m16n8 accumulators,
// so a fragment of x serves two products and one of the block four), and a
// ring of 3 shared-memory stages, each the [128, 32] slice of a block and
// the [32, 64] slice of x (the column tile's rows; 0 past the last node and
// column) in their own element types, is filled by 16-byte cp.async copies
// two slices ahead of the products, which convert (and scale, for counts)
// as they load their fragments: enough bytes in flight to stream the
// blocks. Otherwise bsr_spmm_kernel stages through registers: 64 x 64 a
// block, the slices converted to f32 and scaled as they are stored, the
// next slice loaded while the tensor cores work on this one. Slices of 32
// columns keep any T (128 and 256 here; a 256 x 256 f32 block, 256 KB, does
// not fit in a block's 227 KB) and any W. Padded slots, zero blocks
// pointing at column tile 0, are multiplied like any other. A row tile's
// blocks are walked by one block of threads, so a hub row tile of hundreds
// of blocks (the bucketed layout of a degree-sorted power-law graph) sets
// the tail; splitting it is queue B's. The table of groups (blocks, column
// tiles, row tiles, m, kb; the first block of each is set at launch) is
// passed by value, so a call reads nothing back and can be captured in a
// CUDA graph.
//
// C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 8 warps: 4 along the rows, 2 along W
constexpr int kRows = 64;       // output rows of a block
constexpr int kCols = 64;       // output columns of a block
constexpr int kDepth = 32;      // block columns staged at once
constexpr int kLdA = kDepth + 4;  // 4 mod 32: ldmatrix hits 32 banks
constexpr int kLdX = kCols + 8;   // 8 mod 32: the k-major B reads too
constexpr int kMaxGroups = 32;    // kernels/bsr.py MAX_GROUPS
constexpr int kPerThread = kRows * kDepth / kThreads;  // 8 of A, 8 of x

struct Groups {
  int count;
  int64_t block0[kMaxGroups + 1];  // first block of each group; all blocks
  const void* blocks[kMaxGroups];  // [m, kb, T, T], or null: tiles written 0
  const int* bcol[kMaxGroups];     // [m, kb] column tiles
  const int* tiles[kMaxGroups];    // [m] row tiles, or null: tile i is i
  int64_t m[kMaxGroups];
  int kb[kMaxGroups];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four 8 x 4 tiles of f32 from shared memory in one instruction: lane
// 8 j + r gives the address of row r of tile j (16 bytes, 16-byte aligned),
// and lane 4 g + t receives word t of row g of tile j in x[j] (as in
// sigmoid_attention.cu).
__device__ __forceinline__ void ldsm_x4(float (&x)[4], const float* row) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
}

// x = hi + lo in TF32 values; without Split, x is one TF32 value already
// (a bf16 value or an edge count) and only hi is kept.
template <bool Split, int K>
struct Tf32 {
  uint32_t hi[K], lo[K];
  Tf32() = default;
  __device__ __forceinline__ explicit Tf32(const float (&x)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
      if (Split)
        lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i])) & 0xffffe000u;
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block values as staged: T elements in, f32 in shared memory.
template <typename TB>
__device__ __forceinline__ void load_a(float (&v)[kPerThread], const TB* a,
                                       int tile, int r_base, int c0) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int r = e / kDepth, c = e % kDepth;
    const int row = r_base + r, col = c0 + c;
    v[it] = (row < tile && col < tile)
                ? to_f32(a[int64_t(row) * tile + col])
                : 0.0f;
  }
}

// The x rows of a column tile's slice, scaled (counts), 0 past the last
// node and the last column.
template <typename TX>
__device__ __forceinline__ void load_x(float (&v)[kPerThread],
                                       const TX* __restrict__ x,
                                       const float* __restrict__ scale,
                                       int64_t x_row0, int c0, int tile,
                                       int64_t n, int64_t c_base,
                                       int64_t width) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int c = e / kCols, j = e % kCols;
    const int64_t xr = x_row0 + c0 + c;
    const int64_t col = c_base + j;
    float val = 0.0f;
    if (c0 + c < tile && xr < n && col < width) {
      val = to_f32(x[xr * width + col]);
      if (scale) val *= __ldg(scale + xr);
    }
    v[it] = val;
  }
}

template <typename TB, typename TX, bool SplitA, bool SplitB>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_spmm_kernel(const Groups grp, const TX* __restrict__ x,
                    TX* __restrict__ out, const float* __restrict__ scale,
                    int64_t n, int tile, int64_t width, int row_blocks,
                    int col_blocks) {
  __shared__ __align__(16) float as[kRows * kLdA];   // block slice [r][c]
  __shared__ __align__(16) float xs[kDepth * kLdX];  // x slice [c][j]
  int g = 0;
  while (g + 1 < grp.count && int64_t(blockIdx.x) >= grp.block0[g + 1]) ++g;
  const int64_t blk = int64_t(blockIdx.x) - grp.block0[g];
  const int per_tile = row_blocks * col_blocks;
  const int64_t mi = blk / per_tile;
  const int rem = static_cast<int>(blk - mi * per_tile);
  const int r_base = (rem / col_blocks) * kRows;  // rows within the tile
  const int64_t c_base = int64_t(rem % col_blocks) * kCols;  // of W
  const int64_t row_tile = grp.tiles[g] ? __ldg(grp.tiles[g] + mi) : mi;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const TB* blocks = static_cast<const TB*>(grp.blocks[g]);
  const int kb = blocks ? grp.kb[g] : 0;
  const int steps = (tile + kDepth - 1) / kDepth;  // slices of a block
  const int chunks = kb * steps;
  float va[kPerThread], vx[kPerThread];
  // the chunk after the one in shared memory is loaded into registers
  // before the products of the current one
  auto fetch = [&](int chunk) {
    const int k = chunk / steps, c0 = (chunk % steps) * kDepth;
    const int64_t slot = mi * kb + k;
    load_a<TB>(va, blocks + slot * tile * tile, tile, r_base, c0);
    load_x<TX>(vx, x, scale, int64_t(__ldg(grp.bcol[g] + slot)) * tile, c0,
               tile, n, c_base, width);
  };
  if (chunks > 0) fetch(0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
#pragma unroll
    for (int it = 0; it < kPerThread; ++it) {
      const int e = it * kThreads + threadIdx.x;
      as[(e / kDepth) * kLdA + e % kDepth] = va[it];
      xs[(e / kCols) * kLdX + e % kCols] = vx[it];
    }
    __syncthreads();
    if (chunk + 1 < chunks) fetch(chunk + 1);
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      float af[4];
      {
        const int j = lane / 8, r = lane % 8;
        ldsm_x4(af, as + (wr + r + 8 * (j % 2)) * kLdA + 8 * ks +
                        4 * (j / 2));
      }
      const Tf32<SplitA, 4> a(af);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* xb = xs + (8 * ks) * kLdX + wc + 8 * nt;
        const float bf[2] = {xb[tq * kLdX + gq], xb[(tq + 4) * kLdX + gq]};
        const Tf32<SplitB, 2> b(bf);
        // the small products first, then hi hi
        if (SplitA) mma_tf32(acc[nt], a.lo, b.hi);
        if (SplitB) mma_tf32(acc[nt], a.hi, b.lo);
        mma_tf32(acc[nt], a.hi, b.hi);
      }
    }
    __syncthreads();
  }
  // acc[nt]: rows wr + gq (+ 8), columns wc + 8 nt + 2 tq (+ 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_base + wr + gq + 8 * h;
    const int64_t node = row_tile * tile + row;
    if (row >= tile || node >= n) continue;
    const float s = scale ? __ldg(scale + node) : 1.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int64_t col = c_base + wc + 8 * nt + 2 * tq + q;
        if (col < width)
          store_as(out + node * width + col, acc[nt][2 * h + q] * s);
      }
  }
}

// ---- the cp.async path: T a multiple of 32, W of 16 bytes of x ----------

constexpr int kAsyncRows = 128;  // output rows of a block (16 a warp)
constexpr int kStages = 3;       // ring of staged slices
constexpr int kLdXs = kCols + 8;  // x slice row, elements: 8 mod 32 in f32

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One stage of the ring, in raw element types: the [128, 32] slice of a
// block (row stride kDepth + 16 bytes), the [32, 64] slice of x (row stride
// kLdXs) and, for counts, the 32 scales of the slice's x rows.
template <typename TB, typename TX>
struct alignas(16) Stage {
  static constexpr int kLdA = kDepth + 16 / static_cast<int>(sizeof(TB));
  TB a[kAsyncRows * kLdA];
  TX x[kDepth * kLdXs];
  float scale[kDepth];
};

template <typename TB, typename TX>
__device__ __forceinline__ void issue_stage(Stage<TB, TX>& st,
                                            const TB* block,
                                            const TX* __restrict__ x,
                                            const float* __restrict__ scale,
                                            int64_t x_row0, int c0, int tile,
                                            int r_base, int64_t n,
                                            int64_t c_base, int64_t width) {
  constexpr int kVa = 16 / sizeof(TB);  // elements of a 16-byte copy
  constexpr int kVx = 16 / sizeof(TX);
  for (int e = threadIdx.x; e < kAsyncRows * kDepth / kVa; e += kThreads) {
    const int r = e / (kDepth / kVa), c = (e % (kDepth / kVa)) * kVa;
    const bool ok = r_base + r < tile;
    cp_async16(st.a + r * Stage<TB, TX>::kLdA + c,
               ok ? block + int64_t(r_base + r) * tile + c0 + c : block,
               ok ? 16 : 0);
  }
  for (int e = threadIdx.x; e < kDepth * kCols / kVx; e += kThreads) {
    const int c = e / (kCols / kVx), j = (e % (kCols / kVx)) * kVx;
    const int64_t xr = x_row0 + c0 + c, col = c_base + j;
    const bool ok = xr < n && col < width;
    cp_async16(st.x + c * kLdXs + j, ok ? x + xr * width + col : x,
               ok ? 16 : 0);
  }
  if (scale && threadIdx.x < kDepth / 4) {
    const int64_t xr = x_row0 + c0 + 4 * threadIdx.x;
    const bool ok = xr < n;  // past the last node: zeros
    cp_async16(st.scale + 4 * threadIdx.x, ok ? scale + xr : scale,
               ok ? 4 * static_cast<int>(min(int64_t(4), n - xr)) : 0);
  }
}

template <typename TB, typename TX, bool SplitA, bool SplitB>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_spmm_async_kernel(const Groups grp, const TX* __restrict__ x,
                          TX* __restrict__ out,
                          const float* __restrict__ scale, int64_t n,
                          int tile, int64_t width, int row_blocks,
                          int col_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<Stage<TB, TX>*>(smem);
  constexpr int kLdA = Stage<TB, TX>::kLdA;
  int g = 0;
  while (g + 1 < grp.count && int64_t(blockIdx.x) >= grp.block0[g + 1]) ++g;
  const int64_t blk = int64_t(blockIdx.x) - grp.block0[g];
  const int per_tile = row_blocks * col_blocks;
  const int64_t mi = blk / per_tile;
  const int rem = static_cast<int>(blk - mi * per_tile);
  const int r_base = (rem / col_blocks) * kAsyncRows;
  const int64_t c_base = int64_t(rem % col_blocks) * kCols;
  const int64_t row_tile = grp.tiles[g] ? __ldg(grp.tiles[g] + mi) : mi;
  // warp w: rows 32 (w % 4) .. + 31, columns 32 (w / 4) .. + 31, as 2 x 4
  // m16n8 tiles
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 32, wc = (warp / 4) * 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;

  const TB* blocks = static_cast<const TB*>(grp.blocks[g]);
  const int kb = blocks ? grp.kb[g] : 0;
  const int steps = tile / kDepth;
  const int chunks = kb * steps;
  auto issue = [&](int chunk) {
    const int k = chunk / steps, c0 = (chunk % steps) * kDepth;
    const int64_t slot = mi * kb + k;
    issue_stage<TB, TX>(ring[chunk % kStages], blocks + slot * tile * tile,
                        x, scale,
                        int64_t(__ldg(grp.bcol[g] + slot)) * tile, c0, tile,
                        r_base, n, c_base, width);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) issue(s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (chunk + kStages - 1 < chunks) issue(chunk + kStages - 1);
    cp_async_commit();
    const Stage<TB, TX>& st = ring[chunk % kStages];
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      const float s0 = scale ? st.scale[8 * ks + tq] : 1.0f;
      const float s1 = scale ? st.scale[8 * ks + tq + 4] : 1.0f;
      Tf32<SplitB, 2> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const TX* xb = st.x + (8 * ks) * kLdXs + wc + 8 * nt + gq;
        const float bf[2] = {to_f32(xb[tq * kLdXs]) * s0,
                             to_f32(xb[(tq + 4) * kLdXs]) * s1};
        b[nt] = Tf32<SplitB, 2>(bf);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[i] = to_f32(st.a[(wr + 16 * mt + gq + 8 * (i & 1)) * kLdA +
                              8 * ks + tq + 4 * (i >> 1)]);
        const Tf32<SplitA, 4> a(af);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (SplitA) mma_tf32(acc[mt][nt], a.lo, b[nt].hi);
          if (SplitB) mma_tf32(acc[mt][nt], a.hi, b[nt].lo);
          mma_tf32(acc[mt][nt], a.hi, b[nt].hi);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_base + wr + 16 * mt + gq + 8 * h;
      const int64_t node = row_tile * tile + row;
      if (row >= tile || node >= n) continue;
      const float sc = scale ? __ldg(scale + node) : 1.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int64_t col = c_base + wc + 8 * nt + 2 * tq + q;
          if (col < width)
            store_as(out + node * width + col,
                     acc[mt][nt][2 * h + q] * sc);
        }
    }
}

// One launch of the async kernel. Its dynamic shared memory (above the 48 KB
// default) is allowed once a process, at the first call: a warm-up, outside
// any CUDA graph capture.
template <typename TB, typename TX, bool SplitA, bool SplitB>
int launch_async(const Groups& g, const TX* x, TX* out, const float* scale,
                 int64_t n, int tile, int64_t width, int row_blocks,
                 int col_blocks, unsigned grid, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Stage<TB, TX>) * kStages;
  static const int rc = cudaFuncSetAttribute(
      bsr_spmm_async_kernel<TB, TX, SplitA, SplitB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  bsr_spmm_async_kernel<TB, TX, SplitA, SplitB>
      <<<grid, kThreads, smem, stream>>>(g, x, out, scale, n, tile, width,
                                         row_blocks, col_blocks);
  return cudaGetLastError();
}

template <typename TB, typename TX>
int launch(const Groups& grp, const void* x, void* out, const float* scale,
           int64_t n, int tile, int64_t width, bool aligned,
           cudaStream_t stream) {
  // f32 block values need two TF32 parts; bf16 values and counts are TF32
  // values. x needs two parts at f32, and at bf16 too when it is scaled.
  constexpr bool kSplitA = std::is_same<TB, float>::value;
  const bool split_b = std::is_same<TX, float>::value || scale != nullptr;
  const auto* xt = static_cast<const TX*>(x);
  auto* ot = static_cast<TX*>(out);
  const bool async = aligned && tile % kDepth == 0 &&
                     width % (16 / sizeof(TX)) == 0;
  const int rows = async ? kAsyncRows : kRows;
  const int row_blocks = (tile + rows - 1) / rows;
  const int col_blocks = static_cast<int>((width + kCols - 1) / kCols);
  Groups g = grp;
  int64_t total = 0;
  for (int i = 0; i < g.count; ++i) {
    g.block0[i] = total;
    total += g.m[i] * row_blocks * col_blocks;
  }
  g.block0[g.count] = total;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(total);
  if (async)
    return split_b
               ? launch_async<TB, TX, kSplitA, true>(
                     g, xt, ot, scale, n, tile, width, row_blocks,
                     col_blocks, grid, stream)
               : launch_async<TB, TX, kSplitA, false>(
                     g, xt, ot, scale, n, tile, width, row_blocks,
                     col_blocks, grid, stream);
  if (split_b)
    bsr_spmm_kernel<TB, TX, kSplitA, true><<<grid, kThreads, 0, stream>>>(
        g, xt, ot, scale, n, tile, width, row_blocks, col_blocks);
  else
    bsr_spmm_kernel<TB, TX, kSplitA, false><<<grid, kThreads, 0, stream>>>(
        g, xt, ot, scale, n, tile, width, row_blocks, col_blocks);
  return cudaGetLastError();
}

template <typename TX>
int launch_x(int block_type, const Groups& grp, const void* x, void* out,
             const float* scale, int64_t n, int tile, int64_t width,
             bool aligned, cudaStream_t stream) {
  if (block_type == 0)
    return launch<float, TX>(grp, x, out, scale, n, tile, width, aligned,
                             stream);
  if (block_type == 1)
    return launch<__nv_bfloat16, TX>(grp, x, out, scale, n, tile, width,
                                     aligned, stream);
  return launch<int8_t, TX>(grp, x, out, scale, n, tile, width, aligned,
                            stream);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// out [n, width] = the dense blocks of the groups of table (host, int64
// [groups, 5]: blocks pointer or 0, column tiles pointer, row tiles pointer
// or 0, m, kb of each) times x [n, width], both float32 (bf16_x == 0) or
// bfloat16 (1), contiguous; blocks float32 (block_type 0), bfloat16 (1) or
// int8 counts (2), each group's [m, kb, tile, tile] contiguous; scale
// float32 [n] or null (counts: x's rows and out's rows multiplied by it).
// Every row tile of out must be in exactly one group. Where tile is a
// multiple of 32, a row of x a multiple of 16 bytes and the pointers 16-byte
// aligned, the slices are staged by the cp.async ring (128 rows a block);
// otherwise through registers (64 rows a block).
int bsr_spmm(const void* x, void* out, const void* scale, int64_t n,
             int64_t width, int tile, int block_type, int bf16_x,
             const int64_t* table, int groups, void* stream) {
  if (n < 0 || width <= 0 || tile < 1 || groups < 1 || groups > kMaxGroups ||
      block_type < 0 || block_type > 2 || (bf16_x != 0 && bf16_x != 1) ||
      (width + kCols - 1) / kCols > INT_MAX / tile)
    return cudaErrorInvalidValue;
  Groups grp = {};
  grp.count = groups;
  bool aligned = aligned16(x) && aligned16(out) && aligned16(scale);
  for (int g = 0; g < groups; ++g) {
    const int64_t* row = table + 5 * g;
    grp.blocks[g] = reinterpret_cast<const void*>(row[0]);
    grp.bcol[g] = reinterpret_cast<const int*>(row[1]);
    grp.tiles[g] = reinterpret_cast<const int*>(row[2]);
    grp.m[g] = row[3];
    if (row[3] < 0 || row[4] < 0 || row[4] > INT_MAX ||
        (row[0] != 0 && row[4] > 0 && row[1] == 0))
      return cudaErrorInvalidValue;
    grp.kb[g] = static_cast<int>(row[4]);
    aligned = aligned && aligned16(grp.blocks[g]);
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  if (bf16_x)
    return launch_x<__nv_bfloat16>(block_type, grp, x, out, sc, n, tile,
                                   width, aligned, st);
  return launch_x<float>(block_type, grp, x, out, sc, n, tile, width,
                         aligned, st);
}

}  // extern "C"
