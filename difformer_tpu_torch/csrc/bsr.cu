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
// dense block) is written 0, so every row tile is written exactly once: no
// atomics, deterministic. The sparse tiles' edges (the residual) are then
// added by the ELL kernel K6 (ell.cu), on the raw x.
//
// Blocks are float32, bfloat16 or int8 edge counts. For counts the rank-1
// GCN scaling of BsrBuckets.inv_scale is fused into the loads and stores:
// x rows are multiplied by xscale[row] as they are loaded into fragments,
// and each output element by oscale[node] as it is stored; the JAX package
// does the same with two elementwise passes. The square call passes one
// scale as both. A rank's shard of the node-sharded hybrid (BsrShard,
// _bsr_shard_apply in difformer_tpu/ops/bsr.py:781-811) is rectangular:
// out has its n rows (rows_per), x the nx rows of the gathered operand
// (pad_n), xscale the pad_n inverse square-root degrees of the columns and
// oscale the rank's rows'; a group's row tiles are out's, its column tiles
// x's. x and out are float32 or bfloat16; every product and sum is f32,
// and the output is rounded once.
//
// What bounds it on this card. The compulsory bytes are the blocks once, x
// once and out once; the blocks dominate (a 256 x 256 f32 block is 256 KB
// against 64 KB of its x slice at W = 64). The products are 2 T^2 W flops a
// block, on the tensor cores as mma.sync.m16n8k8 in TF32 with f32 sums:
// TF32 keeps 10 mantissa bits, so an f32 operand is split into hi + lo
// TF32 values and a b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (3 passes,
// as the wide K2-K4 of sigmoid_attention.cu), f32's order of error; bf16
// block values and edge counts (at most 127) are TF32 values already, so
// with them only x is split (2 passes), and at bf16 x without a scale
// nothing is (1 pass). At f32 the three passes set the pace (PERF.md §6).
//
// The design, one kernel for every width, tile and row-tile shape:
//
// * A ring of 3 shared-memory stages filled by cp.async two slices ahead
//   of the products. A thread block of 8 warps computes a 128-row tile of
//   one row tile's output (warps 4 along the rows, 32 rows each as two m16
//   tiles; 2 along the columns) over the row tile's blocks, 32 block
//   columns a stage: the [128, 32] slice of the block and the [32, cols]
//   slice of x (the column tile's rows; 0 past the last node, the tile and
//   the width), each in its own element type, converted (and scaled, for
//   counts) as the fragments are loaded. Blocks come by 16-byte copies
//   where a block row is a multiple of 16 bytes and every block pointer is
//   16-byte aligned; otherwise (an odd --bsr_tile) by plain loads into the
//   same ring. x comes by 16-byte copies: the wrapper (kernels/bsr.py)
//   hands over a row stride ldx of a multiple of 16 bytes, staging x into a
//   [N, ldx] buffer where its rows are not (W = 65, spmm_first's F + 1, or
//   a misaligned view). Warps whose rows lie past the tile skip the
//   products (T = 64: half the warps).
// * Each block read from device memory once a call. A thread block's
//   column tile is W rounded up to 8 columns (an n8 tile of mma), up to 80
//   columns: W = 65 takes one pass of 72, not two of 64. Each warp runs
//   the loop for its own count of n-tiles (W = 65: 5 in one column of
//   warps, 4 in the other), a compile-time constant there, so nothing
//   branches between its products; the warps meet at a barrier without
//   .aligned. Up to 64 columns the stage holds 64 (4 n-tiles a warp at
//   most: W = 64 is the tile of earlier versions), else 80: 5 n-tiles a
//   warp fit the 128 registers of 2 blocks an SM. Wider W (128,
//   300) is cut into equal column tiles (2 of 64, 4 of 80), and the grid
//   puts the column tiles of one row tile next to each other, so their
//   repeated block reads come from the 50 MB L2. What bounds a call is
//   then what bounds its work: the blocks' bytes at W = 64 and 65, the
//   TF32 passes at W = 300.
// * Hub row tiles split across thread blocks. A group whose row tiles hold
//   more blocks (kb) than kernels/bsr.py's SPLIT_BLOCKS, and whose thread
//   blocks fill less than a wave of the card (2 an SM), is cut along kb
//   into chunks of equal size (split_plan, from shapes and the SM count
//   alone); each chunk's thread blocks write f32 partial sums into scratch
//   [chunks, m, T, W] (the wrapper's torch.empty), and bsr_combine_kernel
//   sums a group's chunks in their order, scales (counts) and rounds once,
//   as K1's csr_spmm_combine (spmm.cu). Without the split a row tile of
//   hundreds of blocks (the bucketed layout of a degree-sorted power-law
//   graph) ran on one or two SMs while the rest of the card idled. The
//   partials are written once and read once (bench.py's power-law hub
//   layout: 11 MB against the call's 114 MB of compulsory bytes); they
//   bound the combine, bytes only.
// * The combine's work: the host (kernels/bsr.py, combine_plan) numbers
//   the split groups' row bands (combine_rows(W) rows of a row tile) one
//   after another, a prefix a group, and each thread block of
//   kCombineThreads takes one band: its group is found once, uniformly,
//   and every index inside the band is 32-bit (a row tile's T W partials
//   fit in an int). A band rather than a whole row tile a block: the hub
//   tile's 86 chunks are the bulk of the partials, and one block could not
//   read them at the rate of more than one SM. A band is 8 rows where a
//   row is 16-byte packs (W % 4 == 0 and the bases aligned), a group of
//   lanes a row (the power of two >= its packs, up to a warp): one pack a
//   thread at W = 64, 6 at 300. Otherwise (W = 65) single floats, the
//   band as many rows as the block holds at a thread a value, the power of
//   two >= W threads a row (one row of 128 threads at W = 65). Each row's
//   scale is read once by its lanes, ahead of its chunks; rows at or past n
//   are skipped. A pack's loads of kCombineDepth chunks are issued before
//   its adds, which stay in chunk order (bit-equal to
//   bsr_spmm_combine_plain), and each result is rounded once (bf16 stored
//   4 values in 8 bytes).
//
// The table of groups (blocks, column tiles, row tiles, m, kb, chunks and
// the first partial of each) is passed by value, so a call reads nothing
// back and can be captured in a CUDA graph.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "pack.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps: 4 along the rows, 2 along W
constexpr int kRows = 128;        // output rows of a thread block
constexpr int kDepth = 32;        // block columns staged at once
constexpr int kStages = 3;        // ring of staged slices
constexpr int kMaxCols = 80;      // columns of a thread block
constexpr int kMaxTile = 1 << 16;  // rows of a block, so r * tile is an int
constexpr int kMaxGroups = 32;    // kernels/bsr.py MAX_GROUPS
constexpr int kTableCols = 7;     // kernels/bsr.py's table

struct Groups {
  int count;
  int64_t block0[kMaxGroups + 1];  // first thread block
  const void* blocks[kMaxGroups];  // [m, kb, T, T], or null: tiles written 0
  const int* bcol[kMaxGroups];     // [m, kb] column tiles
  const int* tiles[kMaxGroups];    // [m] row tiles, or null: tile i is i
  int64_t m[kMaxGroups];
  int kb[kMaxGroups];
  int chunks[kMaxGroups];          // thread blocks along kb; 1: unsplit
  int64_t part0[kMaxGroups];       // first partial of a split group
};

struct Shape {
  int64_t n;   // rows of out
  int64_t nx;  // rows of x
  int width;   // columns of x and out
  int ldx;     // row stride of x in elements, a multiple of 16 bytes
  int tile;
  int row_blocks;  // thread blocks along a row tile
  int col_blocks;  // thread blocks along W
  int cols;        // columns of a thread block, a multiple of 8
  int vec_a;       // blocks staged by 16-byte copies
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
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
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
// block (row stride kDepth + 16 bytes), the [32, cols] slice of x (row
// stride kLdX: 8 mod 32 words at f32, 4 at bf16, so a fragment's reads hit
// 32 banks) and, for counts, the 32 scales of the slice's x rows. NW: the
// most n-tiles a warp holds (4: up to 64 columns, 5: up to 80).
template <typename TB, typename TX, int NW>
struct alignas(16) Stage {
  static constexpr int kLdA = kDepth + 16 / static_cast<int>(sizeof(TB));
  static constexpr int kLdX = 16 * NW + 8;
  TB a[kRows * kLdA];
  TX x[kDepth * kLdX];
  float scale[kDepth];
};

// Issue the copies of one stage. block: the block's row r_base at column
// c0 (rows of tile elements); xs: x's row of the slice's first block column
// at column c_base (rows of ldx elements); sc: that row's scale, or null.
// Block rows and columns from rows_a, cols_a and x rows from rows_x are
// zero (x0, scale0: valid addresses for the copies that read nothing);
// x's granules from cols_x are left unwritten: they feed only columns that
// are never stored.
template <typename TB, typename TX, int NW>
__device__ __forceinline__ void issue_stage(
    Stage<TB, TX, NW>& st, const TB* __restrict__ block,
    const TX* __restrict__ xs, const TX* __restrict__ x0,
    const float* __restrict__ sc, const float* __restrict__ scale0,
    int rows_a, int cols_a, int rows_x, int cols_x, int tile, int ldx,
    bool vec_a) {
  using S = Stage<TB, TX, NW>;
  constexpr int kVa = 16 / sizeof(TB);  // elements of a 16-byte copy
  constexpr int kVx = 16 / sizeof(TX);
  constexpr int kGx = 16 * NW / kVx;    // 16-byte granules of a row of x
  static_assert(kRows * kDepth / kVa % kThreads == 0, "copies a thread");
  if (vec_a) {
#pragma unroll
    for (int i = 0; i < kRows * kDepth / kVa / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / (kDepth / kVa), c = (e % (kDepth / kVa)) * kVa;
      const bool ok = r < rows_a && c < cols_a;
      cp_async16(st.a + r * S::kLdA + c, ok ? block + r * tile + c : block,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, c = e % kDepth;
      st.a[r * S::kLdA + c] =
          r < rows_a && c < cols_a ? block[r * tile + c] : zero<TB>();
    }
  }
#pragma unroll
  for (int i = 0; i < (kDepth * kGx + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int c = e / kGx, j = (e % kGx) * kVx;
    if (e < kDepth * kGx && j < cols_x)
      cp_async16(st.x + c * S::kLdX + j, c < rows_x ? xs + c * ldx + j : x0,
                 c < rows_x ? 16 : 0);
  }
  if (sc && threadIdx.x < kDepth) {
    const bool ok = static_cast<int>(threadIdx.x) < rows_x;
    cp_async4(st.scale + threadIdx.x, ok ? sc + threadIdx.x : scale0,
              ok ? 4 : 0);
  }
}

// The products of one stage for a warp of N n-tiles, N known at compile
// time, so the chains of mma on the accumulators interleave: rows
// wr .. + 31, columns wc .. + 8 N. The x fragments of the n-tiles first,
// then each row tile's block fragment against them.
template <int N, bool SplitA, bool SplitB, typename TB, typename TX, int NW>
__device__ __forceinline__ void stage_products(
    float (&acc)[2][NW][4], const Stage<TB, TX, NW>& st, bool scaled,
    int wr, int wc, int gq, int tq) {
  using S = Stage<TB, TX, NW>;
  if constexpr (N > 0) {
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      const float s0 = scaled ? st.scale[8 * ks + tq] : 1.0f;
      const float s1 = scaled ? st.scale[8 * ks + tq + 4] : 1.0f;
      Tf32<SplitB, 2> b[N];
#pragma unroll
      for (int nt = 0; nt < N; ++nt) {
        const TX* xb = st.x + (8 * ks) * S::kLdX + wc + 8 * nt + gq;
        const float bf[2] = {to_f32(xb[tq * S::kLdX]) * s0,
                             to_f32(xb[(tq + 4) * S::kLdX]) * s1};
        b[nt] = Tf32<SplitB, 2>(bf);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[i] = to_f32(st.a[(wr + 16 * mt + gq + 8 * (i & 1)) * S::kLdA +
                              8 * ks + tq + 4 * (i >> 1)]);
        const Tf32<SplitA, 4> a(af);
#pragma unroll
        for (int nt = 0; nt < N; ++nt) {
          // the small products first, then hi hi
          if (SplitA) mma_tf32(acc[mt][nt], a.lo, b[nt].hi);
          if (SplitB) mma_tf32(acc[mt][nt], a.hi, b[nt].lo);
          mma_tf32(acc[mt][nt], a.hi, b[nt].hi);
        }
      }
    }
  }
}

// f(std::integral_constant<int, N>) for N = n, one of 0 .. NW.
template <int N, int NW, typename F>
__device__ __forceinline__ void with_n(int n, F&& f) {
  if constexpr (N < NW) {
    if (n == N) {
      f(std::integral_constant<int, N>());
      return;
    }
    with_n<N + 1, NW>(n, f);
  } else {
    f(std::integral_constant<int, N>());
  }
}

// A barrier of the thread block that its warps reach from different code
// (their n-tile counts differ): barrier.sync, without .aligned.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

template <typename TB, typename TX, bool SplitA, bool SplitB, int NW>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_spmm_kernel(const Groups grp, const Shape sh,
                    const TX* __restrict__ x, TX* __restrict__ out,
                    float* __restrict__ partial,
                    const float* __restrict__ xscale,
                    const float* __restrict__ oscale) {
  using S = Stage<TB, TX, NW>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<S*>(smem);
  const int tile = sh.tile;
  int g = 0;
  while (g + 1 < grp.count && int64_t(blockIdx.x) >= grp.block0[g + 1]) ++g;
  // thread blocks of a group: row tile, then chunk, then 128-row tile,
  // then column tile (adjacent: they read the same blocks)
  const int64_t blk = int64_t(blockIdx.x) - grp.block0[g];
  const int chunks = grp.chunks[g];
  const int per_chunk = sh.row_blocks * sh.col_blocks;
  const int64_t per_tile = int64_t(chunks) * per_chunk;
  const int64_t mi = blk / per_tile;
  int rem = static_cast<int>(blk - mi * per_tile);
  const int ch = rem / per_chunk;
  rem -= ch * per_chunk;
  const int r_base = (rem / sh.col_blocks) * kRows;
  const int c_base = (rem % sh.col_blocks) * sh.cols;
  // this thread block's n-tiles (8 columns each): the first half to the
  // warps of column 0, the rest to column 1; warp w holds rows
  // 32 (w % 4) .. + 31 as two m16 tiles, and none where they lie past the
  // tile
  const int cols_x = min(sh.cols, sh.width - c_base);
  const int nt_blk = (cols_x + 7) / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = (nt_blk + 1) / 2;
  const int n0 = (warp / 4) * half;
  const int wr = (warp % 4) * 32, wc = 8 * n0;
  const int nw = r_base + wr < tile ? max(0, min(half, nt_blk - n0)) : 0;
  const int gq = lane / 4, tq = lane % 4;

  const TB* blocks = static_cast<const TB*>(grp.blocks[g]);
  const int* bcol = grp.bcol[g];
  const int kb = blocks ? grp.kb[g] : 0;
  const int kc = (kb + chunks - 1) / chunks;  // blocks of a chunk
  const int k0 = min(kb, ch * kc), k1 = min(kb, k0 + kc);
  const int steps = (tile + kDepth - 1) / kDepth;  // slices of a block
  const int slices = (k1 - k0) * steps;
  const int64_t slot0 = mi * kb + k0;
  const TB* block0 = blocks + (slot0 * tile + r_base) * tile;
  const bool vec_a = sh.vec_a;
  auto issue = [&](int s) {
    const int k = s / steps, c0 = (s % steps) * kDepth;
    const int64_t xr = int64_t(__ldg(bcol + slot0 + k)) * tile + c0;
    issue_stage<TB, TX, NW>(
        ring[s % kStages], block0 + int64_t(k) * tile * tile + c0,
        x + xr * sh.ldx + c_base, x, xscale ? xscale + xr : nullptr, xscale,
        tile - r_base, tile - c0,
        static_cast<int>(min(int64_t(tile - c0), sh.nx - xr)), cols_x, tile,
        sh.ldx, vec_a);
  };
  // each warp runs the loop for its own count of n-tiles, known at
  // compile time there; the copies and barriers are the same in all
  with_n<0, NW>(nw, [&](auto n_tiles) {
    constexpr int N = decltype(n_tiles)::value;
    float acc[2][NW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < slices) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < slices; ++s) {
      cp_async_wait<kStages - 2>();
      block_sync();
      if (s + kStages - 1 < slices) issue(s + kStages - 1);
      cp_async_commit();
      stage_products<N, SplitA, SplitB>(acc, ring[s % kStages],
                                        xscale != nullptr, wr, wc, gq, tq);
    }
    cp_async_wait<0>();
    // acc[mt][nt]: rows wr + 16 mt + gq (+ 8), columns wc + 8 nt + 2 tq
    // (+ 1); a split group's chunk writes its f32 sums to its partial,
    // unscaled
    const bool split = chunks > 1;
    const int64_t row_tile = grp.tiles[g] ? __ldg(grp.tiles[g] + mi) : mi;
    float* part = split ? partial + grp.part0[g] +
                              (int64_t(ch) * grp.m[g] + mi) * tile * sh.width
                        : nullptr;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r_base + wr + 16 * mt + gq + 8 * h;
        const int64_t node = row_tile * tile + row;
        if (row >= tile || node >= sh.n) continue;
        const float sc = oscale && !split ? __ldg(oscale + node) : 1.0f;
#pragma unroll
        for (int nt = 0; nt < N; ++nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = c_base + wc + 8 * nt + 2 * tq + q;
            if (col >= sh.width) continue;
            if (split)
              part[int64_t(row) * sh.width + col] = acc[mt][nt][2 * h + q];
            else
              store_as(out + node * sh.width + col,
                       acc[mt][nt][2 * h + q] * sc);
          }
        }
      }
  });
}

constexpr int kCombineThreads = 128;  // kernels/bsr.py COMBINE_THREADS
constexpr int kCombineDepth = 16;  // chunks whose loads are in flight
constexpr int kCombineCols = 5;    // kernels/bsr.py's combine table

// Rows of a band at width W (kernels/bsr.py combine_rows): 8 where a row is
// 16-byte packs, else the rows of the block at a thread a value (W rounded
// up to a power of two threads a row), one at least.
inline int combine_rows(int64_t width) {
  if (width % 4 == 0) return 8;
  int threads = 1;
  while (threads < width && threads < kCombineThreads) threads <<= 1;
  return kCombineThreads / threads;
}

// The split groups of a combine: each group's first band (of m row tiles
// of bands bands each), row tiles, chunks and first partial.
struct CombineGroups {
  int count;
  int bands;                       // bands of a row tile
  int64_t band0[kMaxGroups + 1];   // first thread block; the total last
  const int* tiles[kMaxGroups];    // [m] row tiles, or null: tile i is i
  int64_t m[kMaxGroups];
  int chunks[kMaxGroups];
  int64_t part0[kMaxGroups];       // first partial: [chunks, m, T, W]
};

// The split groups' rows: for each (row, column) of a band the sum of its
// chunks' partials in chunk order, times the node's scale (counts), rounded
// once to TX; 2^group_log2 threads a row (at most a warp for 16-byte
// packs, the block for single floats), packs of V values.
template <typename TX, int V>
__global__ void __launch_bounds__(kCombineThreads)
    bsr_combine_kernel(const CombineGroups grp, int64_t n, int width,
                       int tile, int rows, int group_log2,
                       const float* __restrict__ partial,
                       const float* __restrict__ scale,
                       TX* __restrict__ out) {
  const int64_t b = blockIdx.x;
  int g = 0;
  while (g + 1 < grp.count && b >= grp.band0[g + 1]) ++g;
  const int64_t u = b - grp.band0[g];
  const int64_t mi = u / grp.bands;
  const int first = int(u - mi * grp.bands) * rows;
  const int64_t node0 =
      (grp.tiles[g] ? int64_t(__ldg(grp.tiles[g] + mi)) : mi) * tile;
  const int last =
      int(min(int64_t(min(first + rows, tile)), n - node0));  // rows < n
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int vecs = width / V;  // packs of a row
  const int chunks = grp.chunks[g];
  const int64_t stride = grp.m[g] * tile * width;  // from chunk to chunk
  const float* tile_part = partial + grp.part0[g] + mi * tile * width;
  TX* tile_out = out + node0 * width;
  for (int r = first + (threadIdx.x >> group_log2); r < last;
       r += kCombineThreads >> group_log2) {
    const float sc = scale ? __ldg(scale + node0 + r) : 1.0f;
    for (int c = lane; c < vecs; c += group) {
      const int off = r * width + c * V;
      const float* p = tile_part + off;
      float acc[V];
      for (int c0 = 0; c0 < chunks; c0 += kCombineDepth) {
        float part[kCombineDepth][V];
#pragma unroll
        for (int d = 0; d < kCombineDepth; ++d)
          if (c0 + d < chunks)
            Pack<float, V>::load(p + (c0 + d) * stride, part[d]);
#pragma unroll
        for (int d = 0; d < kCombineDepth; ++d)
          if (c0 + d < chunks)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = c0 + d == 0 ? part[d][v] : acc[v] + part[d][v];
      }
      if (scale)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] *= sc;
      Pack<TX, V>::store(tile_out + off, acc);
    }
  }
}

template <typename TX, int V>
int launch_combine(const CombineGroups& g, int64_t n, int width, int tile,
                   const float* partial, const float* scale, void* out,
                   cudaStream_t stream) {
  // threads a row: the power of two >= its packs, up to a warp for 16-byte
  // packs and up to the block for single floats
  const int cap = V == 1 ? 7 : 5;
  int group_log2 = 0;
  while ((1 << group_log2) < width / V && group_log2 < cap) ++group_log2;
  bsr_combine_kernel<TX, V>
      <<<static_cast<unsigned>(g.band0[g.count]), kCombineThreads, 0,
         stream>>>(g, n, width, tile, combine_rows(width), group_log2,
                   partial, scale, static_cast<TX*>(out));
  return cudaGetLastError();
}

// One launch of the main kernel. Its dynamic shared memory (above the 48 KB
// default) is allowed once a process, at the first call.
template <typename TB, typename TX, bool SplitA, bool SplitB, int NW>
int launch_blocks(const Groups& g, const Shape& sh, const TX* x, TX* out,
                  float* partial, const float* xscale, const float* oscale,
                  unsigned grid, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Stage<TB, TX, NW>) * kStages;
  static const int rc = cudaFuncSetAttribute(
      bsr_spmm_kernel<TB, TX, SplitA, SplitB, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  bsr_spmm_kernel<TB, TX, SplitA, SplitB, NW>
      <<<grid, kThreads, smem, stream>>>(g, sh, x, out, partial, xscale,
                                         oscale);
  return cudaGetLastError();
}

template <typename TB, typename TX, bool SplitB>
int launch_nw(const Groups& g, const Shape& sh, const void* x, void* out,
              float* partial, const float* xscale, const float* oscale,
              unsigned grid, cudaStream_t stream) {
  // f32 block values need two TF32 parts; bf16 values and counts are TF32
  // values
  constexpr bool kSplitA = std::is_same<TB, float>::value;
  const auto* xt = static_cast<const TX*>(x);
  auto* ot = static_cast<TX*>(out);
  if (sh.cols <= 64)
    return launch_blocks<TB, TX, kSplitA, SplitB, 4>(
        g, sh, xt, ot, partial, xscale, oscale, grid, stream);
  return launch_blocks<TB, TX, kSplitA, SplitB, 5>(
      g, sh, xt, ot, partial, xscale, oscale, grid, stream);
}

template <typename TB>
int launch_x(int bf16_x, const Groups& g, const Shape& sh, const void* x,
             void* out, float* partial, const float* xscale,
             const float* oscale, unsigned grid, cudaStream_t stream) {
  // x needs two parts at f32, and at bf16 too when it is scaled
  if (!bf16_x)
    return launch_nw<TB, float, true>(g, sh, x, out, partial, xscale, oscale,
                                      grid, stream);
  if (xscale)
    return launch_nw<TB, __nv_bfloat16, true>(g, sh, x, out, partial, xscale,
                                              oscale, grid, stream);
  return launch_nw<TB, __nv_bfloat16, false>(g, sh, x, out, partial, xscale,
                                             oscale, grid, stream);
}

// The table's groups (blocks, column tiles, row tiles, m, kb, chunks, first
// partial) checked; false on a malformed row.
bool read_groups(const int64_t* table, int groups, int tile, int64_t width,
                 int64_t partial_size, Groups& grp) {
  if (groups < 1 || groups > kMaxGroups) return false;
  grp = {};
  grp.count = groups;
  for (int g = 0; g < groups; ++g) {
    const int64_t* row = table + kTableCols * g;
    const int64_t m = row[3], kb = row[0] ? row[4] : 0, chunks = row[5];
    if (m < 0 || kb < 0 || kb > INT_MAX || chunks < 1 ||
        chunks > std::max<int64_t>(kb, 1) || (kb > 0 && row[1] == 0))
      return false;
    if (chunks > 1 && (row[6] < 0 || m * chunks > INT64_MAX / tile / width ||
                       row[6] + m * chunks * tile * width > partial_size))
      return false;
    grp.blocks[g] = reinterpret_cast<const void*>(row[0]);
    grp.bcol[g] = reinterpret_cast<const int*>(row[1]);
    grp.tiles[g] = reinterpret_cast<const int*>(row[2]);
    grp.m[g] = m;
    grp.kb[g] = static_cast<int>(kb);
    grp.chunks[g] = static_cast<int>(chunks);
    grp.part0[g] = row[6];
  }
  return true;
}

}  // namespace

extern "C" {

// out [n, width] (contiguous) = the dense blocks of the groups of table
// (host, int64 [groups, 7]: blocks pointer or 0, column tiles pointer, row
// tiles pointer or 0, m, kb, chunks, first partial of each) times x [nx,
// width] at row stride ldx (elements, a multiple of 16 bytes; x 16-byte
// aligned), both float32 (bf16_x == 0) or bfloat16 (1); blocks float32
// (block_type 0), bfloat16 (1) or int8 counts (2), each group's [m, kb,
// tile, tile] contiguous; xscale float32 [nx] and oscale float32 [n], each
// or null (counts: x's rows multiplied by xscale, out's rows by oscale;
// the square call, n == nx, passes one scale as both). Every row tile of
// out must be in exactly one group. A thread block covers cols columns (a
// multiple of 8, at most 80; W is cut into ceil(width / cols) column
// tiles). A group of chunks > 1 writes f32 partials [chunks, m, tile,
// width] at its first partial of partial (partial_size floats) in place of
// its rows of out: bsr_spmm_combine finishes them.
int bsr_spmm(const void* x, int64_t ldx, void* out, void* partial,
             int64_t partial_size, const void* xscale, const void* oscale,
             int64_t n, int64_t nx, int64_t width, int tile, int cols,
             int block_type, int bf16_x, const int64_t* table, int groups,
             void* stream) {
  const int elem_x = bf16_x ? 2 : 4;
  if (n < 0 || nx < 0 || width <= 0 || tile < 1 || tile > kMaxTile ||
      block_type < 0 || block_type > 2 || (bf16_x != 0 && bf16_x != 1) ||
      ldx < width ||
      ldx > INT_MAX / kDepth || ldx * elem_x % 16 != 0 || !aligned16(x) ||
      cols < 8 || cols % 8 || cols > kMaxCols)
    return cudaErrorInvalidValue;
  Groups grp;
  if (!read_groups(table, groups, tile, width, partial_size, grp))
    return cudaErrorInvalidValue;
  Shape sh;
  sh.n = n;
  sh.nx = nx;
  sh.width = width;
  sh.ldx = ldx;
  sh.tile = tile;
  sh.row_blocks = (tile + kRows - 1) / kRows;
  sh.cols = cols;
  const int64_t col_blocks = (width + cols - 1) / cols;
  if (col_blocks * sh.row_blocks > INT_MAX) return cudaErrorInvalidValue;
  sh.col_blocks = static_cast<int>(col_blocks);
  const int elem_b = block_type == 0 ? 4 : block_type == 1 ? 2 : 1;
  bool vec_a = int64_t(tile) * elem_b % 16 == 0;
  for (int g = 0; g < groups; ++g) {
    vec_a = vec_a && aligned16(grp.blocks[g]);
    if (grp.chunks[g] > 1 && !partial) return cudaErrorInvalidValue;
  }
  sh.vec_a = vec_a;
  int64_t total = 0;
  for (int g = 0; g < groups; ++g) {
    grp.block0[g] = total;
    total += grp.m[g] * grp.chunks[g] * col_blocks * sh.row_blocks;
    if (total > INT_MAX) return cudaErrorInvalidValue;
  }
  grp.block0[groups] = total;
  if (total == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(total);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(partial);
  const auto* xs = static_cast<const float*>(xscale);
  const auto* os = static_cast<const float*>(oscale);
  if (block_type == 0)
    return launch_x<float>(bf16_x, grp, sh, x, out, p, xs, os, grid, st);
  if (block_type == 1)
    return launch_x<__nv_bfloat16>(bf16_x, grp, sh, x, out, p, xs, os, grid,
                                   st);
  return launch_x<int8_t>(bf16_x, grp, sh, x, out, p, xs, os, grid, st);
}

// The split groups' rows of out [n, width] (contiguous): the sum of each
// one's chunks' partials in chunk order, times scale[node] where scale is
// not null (out's rows': a rectangular shard's oscale), rounded once to
// out's type (bf16_x). table (host, int64 [groups, 5]: first band, row
// tiles pointer or 0, m, chunks, first partial) is the host's combine
// plan (kernels/bsr.py combine_plan): the bands of combine_rows(width) rows
// of each group's m row tiles, numbered from 0 in order, one thread block
// each.
int bsr_spmm_combine(const void* partial, int64_t partial_size,
                     const void* scale, void* out, int64_t n, int64_t width,
                     int tile, int bf16_x, const int64_t* table, int groups,
                     void* stream) {
  if (n < 0 || width <= 0 || tile < 1 || tile > kMaxTile ||
      int64_t(tile) * width > INT_MAX || (bf16_x != 0 && bf16_x != 1) ||
      !partial || groups < 1 || groups > kMaxGroups)
    return cudaErrorInvalidValue;
  CombineGroups g = {};
  g.count = groups;
  const int rows = combine_rows(width);
  g.bands = (tile + rows - 1) / rows;
  int64_t total = 0;
  for (int i = 0; i < groups; ++i) {
    const int64_t* row = table + kCombineCols * i;
    const int64_t m = row[2], chunks = row[3], part0 = row[4];
    if (row[0] != total || m < 0 || chunks < 2 || chunks > INT_MAX ||
        part0 < 0 || m > (INT64_MAX - part0) / chunks / tile / width ||
        part0 + chunks * m * tile * width > partial_size)
      return cudaErrorInvalidValue;
    g.band0[i] = total;
    g.tiles[i] = reinterpret_cast<const int*>(row[1]);
    g.m[i] = m;
    g.chunks[i] = static_cast<int>(chunks);
    g.part0[i] = part0;
    total += m * g.bands;
    if (total > INT_MAX) return cudaErrorInvalidValue;
  }
  g.band0[groups] = total;
  if (total == 0 || n == 0) return cudaSuccess;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(partial);
  const auto* sc = static_cast<const float*>(scale);
  const int w = static_cast<int>(width);
  // 16-byte packs of partials: W % 4 == 0 keeps every first partial and
  // row a multiple of 4 floats apart
  bool vec = width % 4 == 0 && aligned16(partial);
  for (int i = 0; i < groups; ++i) vec = vec && g.part0[i] % 4 == 0;
  if (bf16_x) {
    if (vec && (reinterpret_cast<uintptr_t>(out) & 7) == 0)
      return launch_combine<__nv_bfloat16, 4>(g, n, w, tile, p, sc, out, st);
    return launch_combine<__nv_bfloat16, 1>(g, n, w, tile, p, sc, out, st);
  }
  if (vec && aligned16(out))
    return launch_combine<float, 4>(g, n, w, tile, p, sc, out, st);
  return launch_combine<float, 1>(g, n, w, tile, p, sc, out, st);
}

}  // extern "C"
