// Flash sigmoid attention for DIFFormer-a, hand-written for Hopper (sm_90a).
//
// Three kernels replace the three Pallas TPU kernels of
// difformer_tpu/kernels/pallas_sigmoid_attention.py:
//
//   sigattn_fwd_kernel  <- _fwd_kernel     (K2)  out = sigma(q k^T) v / rowsum
//   sigattn_dq_kernel   <- _bwd_dq_kernel  (K3)  dq = dl k
//   sigattn_dkv_kernel  <- _bwd_dkv_kernel (K4)  dk = dl^T q, dv = s^T dnum
//
// with s = sigma(q k^T) * key_mask, ds = dnum v^T + dden, dl = ds s (1 - s).
// Above M or D = 256 (the set track's widths) each takes its wide variant,
// sigattn_{fwd,dq,dkv}_wide_kernel (see "The wide path" below).
//
// What bounds them on this card: operations. Each kernel reads and writes
// O((N + L) H (M + D)) bytes but does O(N L H (M + D)) multiply-adds, so at
// the shapes DIFFormer-a runs (N = L in the thousands, M = D = 64 to 400)
// they sit far above the memory roofline. The design keeps every [N, L] intermediate
// out of device memory: a block owns one (head, tile of 64 rows) of its
// output (K2 and K3 query tiles, K4 key tiles) and loops over a chunk of
// the other side's tiles, recomputing the score tiles in shared memory and
// registers and keeping its f32 accumulators in registers. The split axis
// is that loop: the S blocks of an output tile take S contiguous chunks of
// it (S from one rule, loop_splits in kernels/sigmoid_attention.py, aimed
// at filling the card's SMs once), and with S > 1 they write raw f32
// partials that a second kernel sums in chunk order. No two blocks add into
// one output, so there are no atomics and two calls give bit-equal results.
// The TPU's ones-column denominator becomes a plain row sum, and rows past N
// or L are masked by predication, not by padded copies.
//
// Two designs. The narrow kernels multiply with FFMA on one layout: 64 x 64
// tiles, 256 threads, each warp owning 8 rows of the output tile against
// the 64 rows of a loop tile, each lane a 4 x 4 micro tile whose operands
// are single float4 reads from feature-major tiles of stride 68 (see K2
// and K4), loaded synchronously. The wide K2, K3 and K4 multiply on the
// tensor cores, in split-precision TF32 at f32 inputs (three mma.sync
// passes, f32's accuracy) and one TF32 pass at bf16, from a ring of
// shared-memory stages filled by cp.async ("The wide path" below). bf16
// inputs are widened to f32 in shared memory: a bf16 x bf16 product is
// exact in f32, so both reproduce "bf16 products, f32 sums". The TPU
// kernel's rounding points are kept: s is rounded to v's dtype before s v
// (and the denominator sums the rounded s, as the TPU's ones column does),
// dnum to v's dtype inside ds and dv, and dl to k's dtype for dq and to
// q's dtype for dk. The narrow kernels' move to the tensor cores is later
// work (ROADMAP queue B).
//
// Layouts: q [N, H, M], k [L, H, M], v [L, H, D] are read through element
// strides (a head stride of 0 broadcasts one value head over H); dnum
// [N, H, D], dden [N, H] and every output are contiguous. Offsets are 64-bit.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after its launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of every block
// widest M and D of the narrow path, whose blocks hold whole feature
// columns of their own tile; wider problems take the wide path (below)
constexpr int kNarrowWidth = 256;
constexpr int kTile = 64;    // rows (queries or keys) of every tile
constexpr int kStride = kTile + 4;  // of the feature-major tiles

struct Strides {
  int64_t n, h, c;  // element strides of a [rows, H, C] view
};

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  // p[0..3], 16-byte aligned
  static __device__ __forceinline__ void load4(const float* p,
                                               float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // p[0..3], 8-byte aligned: a bf16 is the high half of its f32
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float (&x)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// K2: forward. One block per (query tile, head, key chunk): the blocks of a
// (query tile, head) split the key tiles in S contiguous chunks, so that a
// graph of a few thousand nodes, with fewer query tiles than SMs, still
// fills the card. With S > 1 each block writes raw f32 partials of num and
// den, and sigattn_fwd_combine sums them.
//
// Tiles are 64 queries by 64 keys. Each of the 8 warps of a block owns 8
// query rows against all 64 keys, its 32 lanes split 2 x 16, and a lane
// owns a 4 x 4 micro tile: queries row0..row0+3 by keys col0..col0+3, and
// the same queries by features col0 + 64 g + (0..3) of the output. Each
// operand of its outer products is one float4 read from shared memory: q,
// k and s are stored feature- (key-) major with a stride of 68 floats, v
// row-major, so 16 FFMAs take 2 reads and a warp's reads cover 2 or 16
// neighbouring float4s.
// The stride keeps the transposed float4 stores at the least wavefronts
// their size allows. A warp reads back only the scores it wrote, so the
// exchange through shared memory needs __syncwarp, not a block barrier,
// and a row's sum stays within the 16 lanes that share it.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j0 + j] += a_i b_j for the 4 x 4 outer product of two float4s.
template <int C>
__device__ __forceinline__ void outer4(float (&acc)[4][C], int j0, float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j0 + j] = fmaf(av[i], bv[j], acc[i][j0 + j]);
}

// dst[c * kStride + r] = round_R(src[r0 + r, h, c]) for r < kTile, c < C;
// rows at or past nrows read as 0. Thread t takes the columns c = t mod 64
// (+ 64 i), so a warp reads 32 neighbouring columns of a row, and four
// rows of a column at a time, which it stores as one float4.
template <typename S, typename R = float>
__device__ __forceinline__ void load_tile_fmajor(float* dst,
                                                 const S* __restrict__ src,
                                                 Strides s, int64_t r0,
                                                 int64_t nrows, int h, int C) {
  constexpr int kCols = 64, kGroups = kThreads / kCols;
  const int r = 4 * (threadIdx.x / kCols);
  for (int c = threadIdx.x % kCols; c < C; c += kCols) {
    const S* p = src + (r0 + r) * s.n + h * s.h + c * s.c;
#pragma unroll
    for (int i = 0; i < kTile; i += 4 * kGroups) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = r0 + r + i + u < nrows
                   ? Num<R>::round(Num<S>::load(p + (i + u) * s.n))
                   : 0.f;
      *reinterpret_cast<float4*>(dst + c * kStride + r + i) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// dst[r * CW + c] = src[r0 + r, h, c] for r < kTile, c < CW; rows at or
// past nrows and columns at or past C read as 0.
template <typename S, int CW>
__device__ __forceinline__ void load_tile_rows(float* dst,
                                               const S* __restrict__ src,
                                               Strides s, int64_t r0,
                                               int64_t nrows, int h, int C) {
  constexpr int kRows = kThreads / CW;  // rows per pass of the block
  const int r = threadIdx.x / CW, c = threadIdx.x % CW;
  const S* p = src + (r0 + r) * s.n + h * s.h + c * s.c;
#pragma unroll 4
  for (int i = 0; i < kTile; i += kRows)
    dst[(r + i) * CW + c] = r0 + r + i < nrows && c < C
                                ? Num<S>::load(p + i * s.n)
                                : 0.f;
}

// At G = 1 the kernel keeps at most 85 registers a thread, so three blocks
// (and their 68 KB of shared memory at M = 64) stay resident on an SM.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 3 : 1)
    sigattn_fwd_kernel(const T* __restrict__ q, Strides sq,
                       const T* __restrict__ k, Strides sk,
                       const T* __restrict__ v, Strides sv,
                       const float* __restrict__ mask, void* __restrict__ out,
                       float* __restrict__ den_out, float* __restrict__ ws,
                       int64_t N, int64_t L, int H, int M, int D, int chunk,
                       bool normalize) {
  constexpr int BT = kTile, P = kStride, CW = 64 * G;
  extern __shared__ float4 fwd_smem[];
  float* Qs = reinterpret_cast<float*>(fwd_smem);  // [M][P]  q tile
  float* Ks = Qs + M * P;    // [M][P]  k tile
  float* Vs = Ks + M * P;    // [BT][CW] v tile; columns >= D are 0
  float* Ss = Vs + BT * CW;  // [BT][P] Ss[j * P + i] = s[i, j] in v's dtype

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 8 + (lane / 16) * 4;
  const int col0 = (lane % 16) * 4;
  const int h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kb = static_cast<int64_t>(blockIdx.z) * chunk * BT;
  const int64_t ke = kb + static_cast<int64_t>(chunk) * BT < L
                         ? kb + static_cast<int64_t>(chunk) * BT
                         : L;

  load_tile_fmajor<T>(Qs, q, sq, q0, N, h, M);

  float acc[4][4 * G] = {};
  float den[4] = {};
  for (int64_t k0 = kb; k0 < ke; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_fmajor<T>(Ks, k, sk, k0, L, h, M);
    load_tile_rows<T, CW>(Vs, v, sv, k0, L, h, D);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < M; ++c)
      outer4(s, 0, lds4(Qs + c * P + row0), lds4(Ks + c * P + col0));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t key = k0 + col0 + j;
      const float mk = key < L ? (mask ? mask[key] : 1.f) : 0.f;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Num<T>::round(sigmoid(s[i][j]) * mk);
        den[i] += p[i];
      }
      *reinterpret_cast<float4*>(Ss + (col0 + j) * P + row0) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncwarp();

#pragma unroll 8
    for (int j = 0; j < BT; ++j) {
      const float4 a = lds4(Ss + j * P + row0);
#pragma unroll
      for (int g = 0; g < G; ++g)
        outer4(acc, 4 * g, a, lds4(Vs + j * CW + 64 * g + col0));
    }
  }

  // row sums over the 16 lanes that share rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);

  const bool first = lane % 16 == 0;  // one writer of each row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + row0 + i;
    if (row >= N) continue;
    if (gridDim.z > 1) {  // raw partials of this key chunk
      const int64_t r = (blockIdx.z * N + row) * H + h;
      if (first) ws[gridDim.z * N * H * D + r] = den[i];
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) {
        const int d = 64 * (c / 4) + col0 + c % 4;
        if (d < D) ws[r * D + d] = acc[i][c];
      }
      continue;
    }
    const int64_t base = (row * H + h) * D;
    if (first) den_out[row * H + h] = den[i];
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) {
      const int d = 64 * (c / 4) + col0 + c % 4;
      if (d >= D) continue;
      if (normalize)
        Num<T>::store(static_cast<T*>(out) + base + d, acc[i][c] / den[i]);
      else
        static_cast<float*>(out)[base + d] = acc[i][c];
    }
  }
}

// Sums the S key-chunk partials of K2 in chunk order (no atomics, so the
// result is the same at every call): ws holds num [S, N, H, D] then
// den [S, N, H], all f32. Writes den and num/den in T, or the raw f32 num.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sigattn_fwd_combine(const float* __restrict__ ws, void* __restrict__ out,
                        float* __restrict__ den_out, int64_t rows, int D,
                        int S, bool normalize) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * D) return;
  const int64_t r = idx / D;
  const float* den_ws = ws + S * rows * D;
  float num = 0.f, den = 0.f;
  for (int s = 0; s < S; ++s) {
    num += ws[s * rows * D + idx];
    den += den_ws[s * rows + r];
  }
  if (idx - r * D == 0) den_out[r] = den;
  if (normalize)
    Num<T>::store(static_cast<T*>(out) + idx, num / den);
  else
    static_cast<float*>(out)[idx] = num;
}

// Sums S f32 slabs of n elements each in slab order (no atomics, so the
// result is the same at every call) and stores the sums in T: the combine of
// K4's query splits and K3's key splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sigattn_sum_partials(const float* __restrict__ ws, T* __restrict__ out,
                         int64_t n, int S) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += ws[s * n + idx];
  Num<T>::store(out + idx, sum);
}

// ---------------------------------------------------------------------------
// K4: dk and dv. One block per (key tile, head, feature group, query chunk):
// the blocks of a (key tile, head) split the query tiles in S contiguous
// chunks, as K2 splits its keys, and with S > 1 each writes raw f32
// partials that sigattn_sum_partials sums. Queries past N carry zero dnum
// and dden, and their scores are forced to 0, so they add nothing.
//
// Tiles are 64 keys by 64 queries. Each warp owns 8 keys against all 64
// queries of a tile, its lanes split 2 x 16: a lane owns keys row0..row0+3
// by queries col0..col0+3 of the score tiles s^T = k q^T (over M) and
// ds^T = v dnum^T (over D), both read as float4s from feature-major tiles
// of stride 68 (as K2's). It stores dl and s key-major, so the warp reads
// back only the rows it wrote (__syncwarp). Then it owns the same keys by
// features f0 + 16 u (u < 4) of its block's group of 64 output features,
// and takes dk += dl q and dv += s dnum four queries at a time: a float4 of
// dl (or s) along the queries of one key against a float4 of q (or dnum)
// along the queries of one feature, 2 reads per 16 FFMAs, from the same
// feature-major tiles that fed the scores. So no tile is held in two
// layouts: at M = D = 64 the block takes 102 KB of shared memory and two
// blocks fit on an SM. The q and dnum tiles hold 64 features at a time;
// at M or D above 64 the block streams the depth of the score products
// through them in groups of 64, its own group last, so that group stays
// for the accumulation, and the blocks of the other groups recompute the
// scores (above M or D = 256, the wide path below takes over).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ __forceinline__ int feature_groups(int M, int D) {
  return ((M > D ? M : D) + kTile - 1) / kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    sigattn_dkv_kernel(const T* __restrict__ q, Strides sq,
                       const T* __restrict__ k, Strides sk,
                       const T* __restrict__ v, Strides sv,
                       const float* __restrict__ mask,
                       const float* __restrict__ dnum,
                       const float* __restrict__ dden, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ ws, int64_t N,
                       int64_t L, int H, int M, int D, int chunk) {
  constexpr int BT = kTile, P = kStride;
  extern __shared__ float4 dkv_smem[];
  float* Ks = reinterpret_cast<float*>(dkv_smem);  // [M][P] k tile
  float* Vs = Ks + M * P;   // [D][P]  v tile
  float* Qs = Vs + D * P;   // [BT][P] 64 features of the q tile
  float* Ns = Qs + BT * P;  // [BT][P] the same of dnum, in v's dtype
  float* Ls = Ns + BT * P;  // [BT][P] Ls[j * P + i] = dl[i, j] in q's dtype
  float* Ss = Ls + BT * P;  // [BT][P] Ss[j * P + i] = s[i, j] in v's dtype
  float* dd = Ss + BT * P;  // [BT]    dden of the query tile

  const int groups = feature_groups(M, D);
  const int g = blockIdx.z % groups, split = blockIdx.z / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 8 + (lane / 16) * 4;  // keys
  const int col0 = (lane % 16) * 4;             // queries of the scores
  const int f0 = lane % 16;                     // features f0 + 16 u
  const int h = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t qb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t qe = qb + static_cast<int64_t>(chunk) * BT < N
                         ? qb + static_cast<int64_t>(chunk) * BT
                         : N;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  load_tile_fmajor<T>(Ks, k, sk, k0, L, h, M);
  load_tile_fmajor<T>(Vs, v, sv, k0, L, h, D);
  float mk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + row0 + i;
    mk[i] = key < L ? (mask ? mask[key] : 1.f) : 0.f;
  }

  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  for (int64_t q0 = qb; q0 < qe; q0 += BT) {
    float s[4][4] = {}, ds[4][4] = {};
    for (int t = 0; t < groups; ++t) {
      const int c0 = BT * ((g + 1 + t) % groups);  // ends with c0 = 64 g
      const int cm = M - c0 < BT ? M - c0 : BT;
      const int cd = D - c0 < BT ? D - c0 : BT;
      __syncthreads();  // Qs, Ns and dd are no longer read
      load_tile_fmajor<T>(Qs, q + c0 * sq.c, sq, q0, N, h, cm);
      load_tile_fmajor<float, T>(Ns, dnum + c0, sn, q0, N, h, cd);
      if (t == 0)
        for (int i = threadIdx.x; i < BT; i += kThreads)
          dd[i] = q0 + i < N ? dden[(q0 + i) * H + h] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cm; ++c)
        outer4(s, 0, lds4(Ks + (c0 + c) * P + row0),
               lds4(Qs + c * P + col0));
#pragma unroll 4
      for (int c = 0; c < cd; ++c)
        outer4(ds, 0, lds4(Vs + (c0 + c) * P + row0),
               lds4(Ns + c * P + col0));
    }

    const float4 d4 = lds4(dd + col0);
    const float ddq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj =
            q0 + col0 + j < N ? sigmoid(s[i][j]) * mk[i] : 0.f;
        l[j] = Num<T>::round((ds[i][j] + ddq[j]) * pj * (1.f - pj));
        p[j] = Num<T>::round(pj);
      }
      *reinterpret_cast<float4*>(Ls + (row0 + i) * P + col0) =
          make_float4(l[0], l[1], l[2], l[3]);
      *reinterpret_cast<float4*>(Ss + (row0 + i) * P + col0) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncwarp();

#pragma unroll 2
    for (int i = 0; i < BT; i += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = lds4(Ls + (row0 + u) * P + i);
        b[u] = lds4(Qs + (f0 + 16 * u) * P + i);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dk_acc[r][u] = dot4(a[r], b[u], dk_acc[r][u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = lds4(Ss + (row0 + u) * P + i);
        b[u] = lds4(Ns + (f0 + 16 * u) * P + i);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dv_acc[r][u] = dot4(a[r], b[u], dv_acc[r][u]);
    }
  }

  // raw partials of this query chunk: dk [S, L, H, M] then dv [S, L, H, D]
  const int splits = gridDim.z / groups;
  float* ws_dk = ws + split * L * H * M;
  float* ws_dv = ws + splits * L * H * M + split * L * H * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = k0 + row0 + r;
    if (row >= L) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int f = BT * g + f0 + 16 * u;
      if (splits > 1) {
        if (f < M) ws_dk[(row * H + h) * M + f] = dk_acc[r][u];
        if (f < D) ws_dv[(row * H + h) * D + f] = dv_acc[r][u];
        continue;
      }
      if (f < M) Num<T>::store(dk + (row * H + h) * M + f, dk_acc[r][u]);
      if (f < D) Num<T>::store(dv + (row * H + h) * D + f, dv_acc[r][u]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dq. One block per (query tile, head, feature group, key chunk): the
// blocks of a (query tile, head) split the key tiles in S contiguous
// chunks, as K2 does, and with S > 1 each writes raw f32 partials that
// sigattn_sum_partials sums. Keys past L and masked keys have p = 0, so
// they add nothing.
//
// K2's layout with a second score product and dl in place of s: tiles are
// 64 queries by 64 keys, each warp owns 8 queries against all 64 keys of a
// tile, and a lane owns queries row0..row0+3 by keys col0..col0+3 of the
// score tiles s = q k^T (over M) and ds = dnum v^T (over D), read as
// float4s from feature-major tiles of stride 68. It stores dl query-major
// for its warp alone (__syncwarp), then owns the same queries by features
// f0 + 16 u of its block's group of 64 features of dq, and takes dq += dl k
// four keys at a time from the feature-major k tile that fed the scores, as
// K4 does. At M = D = 64 the block takes 85 KB of shared memory, two to an
// SM. Wider q and dnum tiles stay whole; the k and v tiles hold 64
// features at a time, and the block streams the depth through them with
// its own group last.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    sigattn_dq_kernel(const T* __restrict__ q, Strides sq,
                      const T* __restrict__ k, Strides sk,
                      const T* __restrict__ v, Strides sv,
                      const float* __restrict__ mask,
                      const float* __restrict__ dnum,
                      const float* __restrict__ dden, T* __restrict__ dq,
                      float* __restrict__ ws, int64_t N, int64_t L, int H,
                      int M, int D, int chunk) {
  constexpr int BT = kTile, P = kStride;
  extern __shared__ float4 dq_smem[];
  float* Qs = reinterpret_cast<float*>(dq_smem);  // [M][P] q tile
  float* Ns = Qs + M * P;   // [D][P]  dnum tile in v's dtype
  float* Ks = Ns + D * P;   // [BT][P] 64 features of the k tile
  float* Vs = Ks + BT * P;  // [BT][P] 64 features of the v tile
  float* Ls = Vs + BT * P;  // [BT][P] Ls[i * P + j] = dl[i, j] in k's dtype

  const int depth = feature_groups(M, D), groups = (M + BT - 1) / BT;
  const int g = blockIdx.z % groups, split = blockIdx.z / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 8 + (lane / 16) * 4;  // queries
  const int col0 = (lane % 16) * 4;             // keys of the scores
  const int f0 = lane % 16;                     // features f0 + 16 u
  const int h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t ke = kb + static_cast<int64_t>(chunk) * BT < L
                         ? kb + static_cast<int64_t>(chunk) * BT
                         : L;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  load_tile_fmajor<T>(Qs, q, sq, q0, N, h, M);
  load_tile_fmajor<float, T>(Ns, dnum, sn, q0, N, h, D);
  float dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dd[i] = q0 + row0 + i < N ? dden[(q0 + row0 + i) * H + h] : 0.f;

  float acc[4][4] = {};
  for (int64_t k0 = kb; k0 < ke; k0 += BT) {
    float s[4][4] = {}, ds[4][4] = {};
    for (int t = 0; t < depth; ++t) {
      const int c0 = BT * ((g + 1 + t) % depth);  // ends with c0 = 64 g
      const int cm = M - c0 < BT ? M - c0 : BT;
      const int cd = D - c0 < BT ? D - c0 : BT;
      __syncthreads();  // Ks and Vs are no longer read
      load_tile_fmajor<T>(Ks, k + c0 * sk.c, sk, k0, L, h, cm);
      load_tile_fmajor<T>(Vs, v + c0 * sv.c, sv, k0, L, h, cd);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cm; ++c)
        outer4(s, 0, lds4(Qs + (c0 + c) * P + row0),
               lds4(Ks + c * P + col0));
#pragma unroll 4
      for (int c = 0; c < cd; ++c)
        outer4(ds, 0, lds4(Ns + (c0 + c) * P + row0),
               lds4(Vs + c * P + col0));
    }

    float mk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t key = k0 + col0 + j;
      mk[j] = key < L ? (mask ? mask[key] : 1.f) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sigmoid(s[i][j]) * mk[j];
        l[j] = Num<T>::round((ds[i][j] + dd[i]) * p * (1.f - p));
      }
      *reinterpret_cast<float4*>(Ls + (row0 + i) * P + col0) =
          make_float4(l[0], l[1], l[2], l[3]);
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BT; j += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = lds4(Ls + (row0 + u) * P + j);
        b[u] = lds4(Ks + (f0 + 16 * u) * P + j);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = dot4(a[r], b[u], acc[r][u]);
    }
  }

  const int splits = gridDim.z / groups;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + row0 + r;
    if (row >= N) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int f = BT * g + f0 + 16 * u;
      if (f >= M) continue;
      if (splits > 1)  // raw partials of this key chunk: [S, N, H, M]
        ws[((split * N + row) * H + h) * M + f] = acc[r][u];
      else
        Num<T>::store(dq + (row * H + h) * M + f, acc[r][u]);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide path: M or D above kNarrowWidth (the set track's hidden 300 and
// 400 at one head). K2, K3 and K4 multiply on the tensor cores
// (mma.sync.m16n8k8 TF32 with f32 sums) from a ring of cp.async stages.
//
// What bounds them: operations, and on this path the instructions around
// each product. mma.sync TF32 peaks near 320 TFLOP/s on an H100 (about 65 %
// of the 495 that wgmma reaches), so three passes give about 107 effective,
// 1.6 times FFMA's 67. Each product also needs its fragments loaded from
// shared memory and split, and with one block of 8 warps an SM those
// instructions, not the tensor cores, set the pace; the design keeps them
// few: ldmatrix where a fragment is a row-major tile, 4 accumulators in
// flight a warp, unrolled depth, no branch inside a tile's product.
//
// Precision. A TF32 operand keeps 10 of f32's 23 mantissa bits, too few for
// the f32 rule (rtol 1e-4). At f32 inputs each operand x is split into two
// TF32 values, hi = x with its low 13 bits cleared and lo = x - hi with its
// low 13 bits cleared, and a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b
// ("3xTF32", CUTLASS's OpMultiplyAddFastF32): the dropped lo_a lo_b and the
// cut bits of lo leave a relative error of about 2^-21 a product, f32's
// order (tests/test_torch_port_tf32_split.py emulates it against the JAX
// package). At bf16 inputs every operand is a bf16 value (q, k, v widened
// in shared memory, s, dnum and dl rounded to bf16 at the TPU kernel's
// rounding points), which TF32 holds exactly, so one TF32 pass is the exact
// bf16 product: "bf16 products, f32 sums", as before. mma.sync and not
// wgmma: its fragments live in registers, which keeps the split and the
// sigmoid between the two products simple; wgmma reads both operands from
// shared memory (hi and lo planes prepared once a stage, V transposed, as
// TF32 takes only K-major operands) and is the next step.
//
// Pipelining. A block walks one stream of 64-row x 64-feature tiles (the
// items) through a ring of up to kRing = 3 shared-memory stages: while item
// i is multiplied, items i + 1 and i + 2 are in flight. f32 tiles come by
// cp.async (16 bytes a copy where rows are aligned runs of unit stride,
// else 4; rows past the end and features past the width read as zeros);
// bf16 tiles are widened on the way, which cp.async cannot do, so they are
// loaded through registers, 4 features a load, when their stage is free.
// One __syncthreads an item orders the ring.
//
// Layouts. An m16n8k8 product reads A (16 x 8) row-major and B (8 x 8) as
// B[k][n] = X[n][k] (ldmatrix, two n-tiles at once) or X[k][n] (4-byte
// loads). Tiles read the first way have a stride of 4 mod 32 floats
// (kLdN = 68; resident tiles resident_ld(C)), the second way 8 mod 32
// (kLdK = 72), so the 32 lanes of a load hit 32 banks. A warp's tile is 16
// rows by 32 columns (4 accumulators of 4 f32 a lane) over a depth of 64.
//
// K2 (sigattn_fwd_wide_kernel): a block owns 64 query rows and up to
// kFwdChunks x 64 = 448 output features, and keeps its query tile resident
// (64 x 324 floats at M = 300, 64 x 452 at 400), loaded once. For each key
// tile the items are the k tile's 64-feature chunks (s = q k^T), then the v
// tile's chunks of the block's features (num += s v). The 8 warps take 16
// query rows each by half the keys of s, then by half of each chunk of
// num: acc[7][4][4], 112 f32 a lane. s goes through shared memory (Ps),
// rounded to v's dtype, between the two products. 156 KB of shared memory
// at M = D = 300, 189 KB at 400.
//
// K4 (sigattn_dkv_wide_kernel): a block owns 32 keys, with its k and v
// tiles resident, and up to kDkvChunks x 64 = 448 features of dk and of dv
// side by side. Warps 0-3 take s^T = k q^T and dk += dl q, warps 4-7
// ds^T = v dnum^T and dv += s dnum, each 16 keys by 32 queries or features;
// a stage holds a chunk of q and the same chunk of dnum. For each query
// tile the items are the chunks in the score layout, then in the product
// layout (q and dnum are read twice, from L2). After the score items, s
// and ds meet in shared memory and every thread takes dl = (ds + dden)
// s (1 - s) and s at their rounding points for its share. One pass over
// s feeds both dk and dv: the M-deep score product is not repeated for dv,
// as the FFMA design's second launch did. acc[7][4][4], 112 f32 a lane.
// 211 KB of shared memory at M = D = 300 (three stages), 207 KB at 400 (two
// fit, which ran as fast as three with the tiles streamed).
//
// K3 (sigattn_dq_wide_kernel) replaces an FFMA design of the narrow
// kernel's layout (20 % of the FP32 bound, 255 registers, unsplit). It is
// K2's block and warp layout with a second score product and a second
// pass over k: a block owns 64 queries and up to kDqChunks x 64 = 448
// features of dq, with its q and dnum tiles resident (dnum rounded to v's
// dtype). For each key tile the items are the k tile's chunks (s = q k^T,
// M deep), the v tile's chunks (ds = dnum v^T, D deep), then the k tile's
// chunks of the block's features again, now in the product layout (dq +=
// dl k; k is read twice from L2, as K4 reads q and dnum). s and ds share
// one fragment: after s each lane writes p = sigma(s) x mask into its own
// entries of the dl tile, and after ds reads them back and writes dl =
// (ds + dden) p (1 - p) in k's dtype, so a lane holds 112 accumulators and
// 16 scores, as K2. At M = D = 300 the resident tiles leave room for two
// stages (220 KB); at 400 q stays resident and dnum's chunks come through
// the ring with v's; wider, both stream (dq_ring). On an H100 both tiles
// resident with two stages ran 3 % faster at 300 than q alone with three,
// and 7 % faster than neither; at 400 q alone 4 % faster than neither.
//
// All three run one block of 256 threads on an SM (224 to 235 registers at
// f32, none spilled), so the split of the loop axis sets the waves: S = 5
// at N = L = 15000 (WIDE_BLOCKS_PER_SM in kernels/sigmoid_attention.py).
// Where the resident tiles and two stages do not fit (M above 640 in K2,
// M + D above about 1090 in K4), the block's own tiles come chunk by
// chunk through the ring with the others instead (`resident` false).
// ---------------------------------------------------------------------------
constexpr int kRing = 3;           // shared-memory stages of K2-K4
constexpr int kLdN = kTile + 4;    // tiles read as B[k][n] = X[n][k]
constexpr int kLdK = kTile + 8;    // tiles read as B[k][n] = X[k][n]
constexpr int kStage = kTile * kLdK;  // floats of one stage
constexpr int kFwdChunks = 7;      // K2: 448 output features a block
constexpr int kDqChunks = 7;       // K3: 448 features of dq a block
constexpr int kDkvChunks = 7;      // K4: 448 features of dk and of dv a block
constexpr int kKeyTile = 32;       // K4: keys of a block

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Stride of a resident [rows][C] tile read as A: C rounded up to whole
// chunks of 64 (zero past C), plus 4, so 4 mod 32.
__host__ __device__ __forceinline__ int resident_ld(int C) {
  return cdiv(C, kTile) * kTile + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
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

// dst[r * ld + c] = round_R(src[r0 + r, h, c0 + c]) for r < Rows and
// c < width (a multiple of 4), 0 for rows at or past nrows and features at
// or past C. f32 without rounding goes by cp.async: 16 bytes a copy when
// vec (unit feature stride, row and head strides and the base a multiple of
// 16 bytes), else 4; the caller commits the group. Anything else is loaded
// and widened through registers, 4 features a load where vec and the tile
// is whole.
template <int Rows, typename S, typename R = S>
__device__ __forceinline__ void fill_tile(float* dst, int ld,
                                          const S* __restrict__ src,
                                          Strides s, int64_t r0,
                                          int64_t nrows, int h, int c0, int C,
                                          int width, bool vec) {
  constexpr bool kAsync =
      std::is_same<S, float>::value && std::is_same<R, float>::value;
  if (vec && width == kTile && c0 + kTile <= C && r0 + Rows <= nrows) {
    // a whole tile: each thread takes 4 features of every 16th row
    constexpr int kPerRow = kTile / 4, kRowsPass = kThreads / kPerRow;
    constexpr int kPasses = Rows / kRowsPass;
    const int r = threadIdx.x / kPerRow, c = 4 * (threadIdx.x % kPerRow);
    const S* p = src + (r0 + r) * s.n + h * s.h + c0 + c;
    if constexpr (kAsync) {
#pragma unroll
      for (int u = 0; u < kPasses; ++u)
        cp_async16(dst + (r + u * kRowsPass) * ld + c, p + u * kRowsPass * s.n,
                   16);
    } else {  // all loads first, then the widened stores
      float x[kPasses][4];
#pragma unroll
      for (int u = 0; u < kPasses; ++u)
        Num<S>::load4(p + u * kRowsPass * s.n, x[u]);
#pragma unroll
      for (int u = 0; u < kPasses; ++u)
        *reinterpret_cast<float4*>(dst + (r + u * kRowsPass) * ld + c) =
            make_float4(Num<R>::round(x[u][0]), Num<R>::round(x[u][1]),
                        Num<R>::round(x[u][2]), Num<R>::round(x[u][3]));
    }
    return;
  }
  if constexpr (kAsync) {
    if (vec) {
      const int per_row = width / 4;
      for (int i = threadIdx.x; i < Rows * per_row; i += kThreads) {
        const int r = i / per_row, c = 4 * (i % per_row);
        const int left = C - c0 - c;
        const int bytes =
            r0 + r < nrows && left > 0 ? 4 * (left < 4 ? left : 4) : 0;
        cp_async16(dst + r * ld + c,
                   bytes ? src + (r0 + r) * s.n + h * s.h + c0 + c : src,
                   bytes);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < Rows * width; i += kThreads) {
    const int r = i / width, c = i % width;
    const bool ok = r0 + r < nrows && c0 + c < C;
    const S* p = src + (r0 + r) * s.n + h * s.h + (c0 + c) * s.c;
    if constexpr (kAsync)
      cp_async4(dst + r * ld + c, ok ? p : src, ok ? 4 : 0);
    else
      dst[r * ld + c] = ok ? Num<R>::round(Num<S>::load(p)) : 0.f;
  }
}

// Whether fill_tile may copy rows of src 16 bytes at a time.
__host__ __forceinline__ bool vec_rows(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.c == 1 &&
         s.n % 4 == 0 && s.h % 4 == 0;
}

// Four 8 x 4 tiles of f32 from shared memory in one instruction: lane
// 8 j + r gives the address of row r of tile j (16 bytes, 16-byte aligned),
// and lane 4 g + t receives word t of row g of tile j in x[j]. ldmatrix
// moves 16-bit pairs, which keeps the 32-bit words whole.
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

// Fragments of mma.m16n8k8 (lane = 4 g + t): A[16][8] at A[0] with stride
// ld (a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]); B[8][8] as
// X[n][k], two n-tiles at once (rows 0-7 and 8-15 of X), or as X[k][n].
// ldmatrix's reads hit 32 banks where ld is 4 mod 32.
__device__ __forceinline__ void frag_a(float (&a)[4], const float* A,
                                       int ld) {
  const int j = (threadIdx.x % 32) / 8, r = threadIdx.x % 8;
  ldsm_x4(a, A + (r + 8 * (j % 2)) * ld + 4 * (j / 2));
}

__device__ __forceinline__ void frag_b_nmajor2(float (&b0)[2],
                                               float (&b1)[2], const float* X,
                                               int ld) {
  const int j = (threadIdx.x % 32) / 8, r = threadIdx.x % 8;
  float x[4];
  ldsm_x4(x, X + (r + 8 * (j / 2)) * ld + 4 * (j % 2));
  b0[0] = x[0];
  b0[1] = x[1];
  b1[0] = x[2];
  b1[1] = x[3];
}

__device__ __forceinline__ void frag_b_kmajor(float (&b)[2], const float* X,
                                              int ld) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  b[0] = X[t * ld + g];
  b[1] = X[(t + 4) * ld + g];
}

// x = hi + lo in TF32 values (lo only with Split: at bf16 inputs x is a
// bf16 value and hi = x exactly).
template <bool Split, int K>
struct Tf32 {
  uint32_t hi[K], lo[K];
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

// d += a b: the small products first, then hi hi.
template <bool Split>
__device__ __forceinline__ void mma(float (&d)[4], const Tf32<Split, 4>& a,
                                    const Tf32<Split, 2>& b) {
  if (Split) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
  }
  mma_tf32(d, a.hi, b.hi);
}

// acc (a warp's 16 x 32 tile, 4 n-tiles) += A (16 x 64, row-major, stride
// lda) B (64 x 32): B[k][n] = X[n][k] (NMajor) or X[k][n], stride ldb. The
// 8 steps of depth are unrolled and each loads its fragments before its 4
// products, so the loads of later steps overlap the products of earlier
// ones, and 4 accumulators are in flight.
template <bool Split, bool NMajor>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const float* A,
                                         int lda, const float* X, int ldb) {
#pragma unroll
  for (int ks = 0; ks < kTile / 8; ++ks) {
    float af[4], bf[4][2];
    frag_a(af, A + 8 * ks, lda);
    if (NMajor) {
      frag_b_nmajor2(bf[0], bf[1], X + 8 * ks, ldb);
      frag_b_nmajor2(bf[2], bf[3], X + 16 * ldb + 8 * ks, ldb);
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        frag_b_kmajor(bf[nt], X + 8 * ks * ldb + 8 * nt, ldb);
    }
    const Tf32<Split, 4> a(af);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma<Split>(acc[nt], a, Tf32<Split, 2>(bf[nt]));
  }
}

// Waits until at most stages - 2 groups of copies are in flight.
__device__ __forceinline__ void ring_wait(int stages) {
  if (stages >= 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Which inputs fill_tile may copy 16 bytes at a time.
enum VecFlags { kVecQ = 1, kVecK = 2, kVecV = 4, kVecDnum = 8 };
// Which of its tiles the wide K3 keeps resident.
enum DqResident { kResQ = 1, kResDnum = 2 };

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sigattn_fwd_wide_kernel(const T* __restrict__ q, Strides sq,
                            const T* __restrict__ k, Strides sk,
                            const T* __restrict__ v, Strides sv,
                            const float* __restrict__ mask,
                            void* __restrict__ out,
                            float* __restrict__ den_out,
                            float* __restrict__ ws, int64_t N, int64_t L,
                            int H, int M, int D, int chunk, bool normalize,
                            int vec, int stages, bool resident) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int BT = kTile;
  extern __shared__ float4 fwdw_smem[];
  // the q tile stays in shared memory, or (too wide) its chunks come with
  // k's in the ring
  const int ldq = resident ? resident_ld(M) : kLdN;
  const int stage = resident ? kStage : kStage + BT * kLdN;
  float* Ps = reinterpret_cast<float*>(fwdw_smem);  // [BT][kLdN] s, v dtype
  float* Dx = Ps + BT * kLdN;            // [2][BT] row sums of key halves
  float* Qs = Dx + 2 * BT;               // [BT][ldq] q tile, if resident
  float* ring = Qs + (resident ? BT * ldq : 0);  // stages of `stage` floats

  const int out_chunks = cdiv(D, BT);
  const int zgroups = cdiv(out_chunks, kFwdChunks);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int d0 = z * kFwdChunks * BT;
  const int chunks = out_chunks - z * kFwdChunks < kFwdChunks
                         ? out_chunks - z * kFwdChunks
                         : kFwdChunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;  // rows 16 rg, half of keys
  const int h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t ke = kb + static_cast<int64_t>(chunk) * BT < L
                         ? kb + static_cast<int64_t>(chunk) * BT
                         : L;
  const int m_chunks = cdiv(M, BT);
  const int per_tile = m_chunks + chunks;  // items of one key tile
  const int items = static_cast<int>((ke - kb + BT - 1) / BT) * per_tile;

  // item i: chunk j of key tile i / per_tile, of k (j < m_chunks) or of v
  auto fill = [&](int i) {
    if (i < items) {
      const int j = i % per_tile;
      const int64_t k0 = kb + static_cast<int64_t>(i / per_tile) * BT;
      float* dst = ring + (i % stages) * stage;
      if (j < m_chunks) {
        fill_tile<BT>(dst, kLdN, k, sk, k0, L, h, j * BT, M, BT,
                      vec & kVecK);
        if (!resident)
          fill_tile<BT>(dst + kStage, kLdN, q, sq, q0, N, h, j * BT, M, BT,
                        vec & kVecQ);
      } else
        fill_tile<BT>(dst, kLdK, v, sv, k0, L, h, d0 + (j - m_chunks) * BT,
                      D, BT, vec & kVecV);
    }
    cp_async_commit();
  };

  for (int c0 = 0; resident && c0 < m_chunks * BT; c0 += BT)
    fill_tile<BT>(Qs + c0, ldq, q, sq, q0, N, h, c0, M, BT, vec & kVecQ);
  for (int i = 0; i < stages - 1; ++i) fill(i);

  float acc[kFwdChunks][4][4] = {};
  float s[4][4] = {};
  float den[2] = {};  // rows g and g + 8 of the warp's 16
  const float* Qw = Qs + rg * 16 * ldq;
  const float* Pw = Ps + rg * 16 * kLdN;
  for (int i = 0; i < items; ++i) {
    ring_wait(stages);
    __syncthreads();  // item i is in; item i - 1's stage is free
    fill(i + stages - 1);
    const float* st = ring + (i % stages) * stage;
    const int j = i % per_tile;
    if (j < m_chunks) {  // s += q k^T over this chunk of M
      warp_mma<kSplit, true>(
          s, resident ? Qw + j * BT : st + kStage + rg * 16 * kLdN, ldq,
          st + 32 * half * kLdN, kLdN);
      if (j == m_chunks - 1) {  // s = sigma(s) x mask in v's dtype
        const int64_t k0 = kb + static_cast<int64_t>(i / per_tile) * BT;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * half + 8 * nt + 2 * t;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t key = k0 + col + e % 2;
            const float mk = key < L ? (mask ? mask[key] : 1.f) : 0.f;
            p[e] = Num<T>::round(sigmoid(s[nt][e]) * mk);
            den[e / 2] += p[e];
            s[nt][e] = 0.f;
          }
          *reinterpret_cast<float2*>(Ps + (16 * rg + g) * kLdN + col) =
              make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(Ps + (16 * rg + g + 8) * kLdN + col) =
              make_float2(p[2], p[3]);
        }
      }
    } else {  // num += s v over this chunk of the block's features
      const int c = j - m_chunks;
#pragma unroll
      for (int cc = 0; cc < kFwdChunks; ++cc)
        if (cc == c)
          warp_mma<kSplit, false>(acc[cc], Pw, kLdN, st + 32 * half, kLdK);
    }
  }
  cp_async_wait<0>();

  // row sums: over the 4 lanes of a row, then the two key halves
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    den[e] += __shfl_xor_sync(0xffffffffu, den[e], 1);
    den[e] += __shfl_xor_sync(0xffffffffu, den[e], 2);
  }
  if (t == 0) {
    Dx[half * BT + 16 * rg + g] = den[0];
    Dx[half * BT + 16 * rg + g + 8] = den[1];
  }
  __syncthreads();

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = 16 * rg + g + 8 * e2;
    const int64_t row = q0 + r;
    if (row >= N) continue;
    const float dsum = Dx[r] + Dx[BT + r];
    const int64_t o = splits > 1 ? (split * N + row) * H + h : row * H + h;
    if (z == 0 && half == 0 && t == 0) {
      if (splits > 1)
        ws[splits * N * H * D + o] = dsum;
      else
        den_out[o] = dsum;
    }
#pragma unroll
    for (int cc = 0; cc < kFwdChunks; ++cc) {
      if (cc >= chunks) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + cc * BT + 32 * half + 8 * nt + 2 * t + e;
          if (d >= D) continue;
          const float x = acc[cc][nt][2 * e2 + e];
          if (splits > 1)  // raw partials of this key chunk
            ws[o * D + d] = x;
          else if (normalize)
            Num<T>::store(static_cast<T*>(out) + o * D + d, x / dsum);
          else
            static_cast<float*>(out)[o * D + d] = x;
        }
    }
  }
}

// K3's wide path (see "The wide path" above): s over M, then ds over D, in
// the same registers (p = sigma(s) x mask waits in the dl tile), then
// dq += dl k. Keys past L and masked keys have p = 0, so they add nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sigattn_dq_wide_kernel(const T* __restrict__ q, Strides sq,
                           const T* __restrict__ k, Strides sk,
                           const T* __restrict__ v, Strides sv,
                           const float* __restrict__ mask,
                           const float* __restrict__ dnum,
                           const float* __restrict__ dden,
                           T* __restrict__ dq, float* __restrict__ ws,
                           int64_t N, int64_t L, int H, int M, int D,
                           int chunk, int vec, int stages, int stage,
                           int resident) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int BT = kTile;
  extern __shared__ float4 dqw_smem[];
  // the q and dnum tiles stay in shared memory, or (too wide) their chunks
  // come with k's and v's in the ring
  const bool res_q = resident & kResQ, res_n = resident & kResDnum;
  const int ldq = res_q ? resident_ld(M) : kLdN;
  const int ldn = res_n ? resident_ld(D) : kLdN;
  float* Ls = reinterpret_cast<float*>(dqw_smem);  // [BT][kLdN] p, then dl
  float* Qs = Ls + BT * kLdN;                 // [BT][ldq] q tile
  float* Ns = Qs + (res_q ? BT * ldq : 0);    // [BT][ldn] dnum in v's dtype
  float* ring = Ns + (res_n ? BT * ldn : 0);  // stages of `stage` floats

  const int m_chunks = cdiv(M, BT), d_chunks = cdiv(D, BT);
  const int zgroups = cdiv(m_chunks, kDqChunks);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int m0 = z * kDqChunks * BT;
  const int chunks = m_chunks - z * kDqChunks < kDqChunks
                         ? m_chunks - z * kDqChunks
                         : kDqChunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;  // rows 16 rg, half of keys
  const int h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t ke = kb + static_cast<int64_t>(chunk) * BT < L
                         ? kb + static_cast<int64_t>(chunk) * BT
                         : L;
  const int scores = m_chunks + d_chunks;  // items of s and ds
  const int per_tile = scores + chunks;    // items of one key tile
  const int items = static_cast<int>((ke - kb + BT - 1) / BT) * per_tile;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  // item i of key tile i / per_tile: chunk j of k (j < m_chunks) or of v,
  // with the same chunk of q or dnum where it streams, in the score
  // layout; then chunk c of the block's features of k in the product
  // layout
  auto fill = [&](int i) {
    if (i < items) {
      const int j = i % per_tile;
      const int64_t k0 = kb + static_cast<int64_t>(i / per_tile) * BT;
      float* dst = ring + (i % stages) * stage;
      if (j < m_chunks) {
        fill_tile<BT>(dst, kLdN, k, sk, k0, L, h, j * BT, M, BT,
                      vec & kVecK);
        if (!res_q)
          fill_tile<BT>(dst + kStage, kLdN, q, sq, q0, N, h, j * BT, M, BT,
                        vec & kVecQ);
      } else if (j < scores) {
        const int c0 = (j - m_chunks) * BT;
        fill_tile<BT>(dst, kLdN, v, sv, k0, L, h, c0, D, BT, vec & kVecV);
        if (!res_n)
          fill_tile<BT, float, T>(dst + kStage, kLdN, dnum, sn, q0, N, h, c0,
                                  D, BT, vec & kVecDnum);
      } else
        fill_tile<BT>(dst, kLdK, k, sk, k0, L, h, m0 + (j - scores) * BT, M,
                      BT, vec & kVecK);
    }
    cp_async_commit();
  };

  for (int c0 = 0; res_q && c0 < m_chunks * BT; c0 += BT)
    fill_tile<BT>(Qs + c0, ldq, q, sq, q0, N, h, c0, M, BT, vec & kVecQ);
  for (int c0 = 0; res_n && c0 < d_chunks * BT; c0 += BT)
    fill_tile<BT, float, T>(Ns + c0, ldn, dnum, sn, q0, N, h, c0, D, BT,
                            vec & kVecDnum);
  for (int i = 0; i < stages - 1; ++i) fill(i);

  float dd[2];  // dden of rows g and g + 8 of the warp's 16
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int64_t row = q0 + 16 * rg + g + 8 * e;
    dd[e] = row < N ? dden[row * H + h] : 0.f;
  }

  float acc[kDqChunks][4][4] = {};
  float sc[4][4] = {};  // s, then ds
  const float* Lw = Ls + rg * 16 * kLdN;
  for (int i = 0; i < items; ++i) {
    ring_wait(stages);
    __syncthreads();  // item i is in; item i - 1's stage is free
    fill(i + stages - 1);
    const float* st = ring + (i % stages) * stage;
    const int j = i % per_tile;
    if (j < scores) {  // s += q k^T (j < m_chunks), ds += dnum v^T
      const bool ds = j >= m_chunks;
      const int c0 = (ds ? j - m_chunks : j) * BT;
      const bool res = ds ? res_n : res_q;
      warp_mma<kSplit, true>(
          sc,
          res ? (ds ? Ns + rg * 16 * ldn : Qs + rg * 16 * ldq) + c0
              : st + kStage + rg * 16 * kLdN,
          res ? (ds ? ldn : ldq) : kLdN, st + 32 * half * kLdN, kLdN);
      if (j == m_chunks - 1 || j == scores - 1) {
        // the lane's own entries of the dl tile: p = sigma(s) x mask
        // after s, then dl = (ds + dden) p (1 - p) in k's dtype after ds
        const int64_t k0 = kb + static_cast<int64_t>(i / per_tile) * BT;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * half + 8 * nt + 2 * t;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float2* dst = reinterpret_cast<float2*>(
                Ls + (16 * rg + g + 8 * e2) * kLdN + col);
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = sc[nt][2 * e2 + e];
              if (ds) {
                const float p = e == 0 ? dst->x : dst->y;
                x[e] = Num<T>::round((a + dd[e2]) * p * (1.f - p));
              } else {
                const int64_t key = k0 + col + e;
                const float mk = key < L ? (mask ? mask[key] : 1.f) : 0.f;
                x[e] = sigmoid(a) * mk;
              }
              sc[nt][2 * e2 + e] = 0.f;
            }
            *dst = make_float2(x[0], x[1]);
          }
        }
      }
    } else {  // dq += dl k over this chunk of the block's features
      const int c = j - scores;
#pragma unroll
      for (int cc = 0; cc < kDqChunks; ++cc)
        if (cc == c)
          warp_mma<kSplit, false>(acc[cc], Lw, kLdN, st + 32 * half, kLdK);
    }
  }
  cp_async_wait<0>();

  // dq [N, H, M], or with S > 1 raw partials of this key chunk [S, N, H, M]
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int64_t row = q0 + 16 * rg + g + 8 * e2;
    if (row >= N) continue;
    const int64_t o = splits > 1 ? (split * N + row) * H + h : row * H + h;
#pragma unroll
    for (int cc = 0; cc < kDqChunks; ++cc) {
      if (cc >= chunks) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = m0 + cc * BT + 32 * half + 8 * nt + 2 * t + e;
          if (f >= M) continue;
          const float x = acc[cc][nt][2 * e2 + e];
          if (splits > 1)
            ws[o * M + f] = x;
          else
            Num<T>::store(dq + o * M + f, x);
        }
    }
  }
}

// K4's wide path (see "The wide path" above): dk and dv in one launch, from
// one pass over s. Queries past N carry zero dnum, dden and q, and their
// scores are forced to 0, so they add nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sigattn_dkv_wide_kernel(const T* __restrict__ q, Strides sq,
                            const T* __restrict__ k, Strides sk,
                            const T* __restrict__ v, Strides sv,
                            const float* __restrict__ mask,
                            const float* __restrict__ dnum,
                            const float* __restrict__ dden,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ ws, int64_t N, int64_t L,
                            int H, int M, int D, int chunk, int vec,
                            int stages, bool resident) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int BT = kTile, BK = kKeyTile;
  extern __shared__ float4 dkvw_smem[];
  // the k and v tiles stay in shared memory, or (too wide) their chunks
  // come with q's and dnum's in the ring
  const int ldk = resident ? resident_ld(M) : kLdN;
  const int ldv = resident ? resident_ld(D) : kLdN;
  const int stage = 2 * kStage + (resident ? 0 : 2 * BK * kLdN);
  float* Ls = reinterpret_cast<float*>(dkvw_smem);  // [BK][kLdN] ds, dl
  float* Ss = Ls + BK * kLdN;          // [BK][kLdN] s, then in v's dtype
  float* dd = Ss + BK * kLdN;          // [BT] dden of the query tile
  float* Ks = dd + BT;                 // [BK][ldk] k tile, if resident
  float* Vs = Ks + (resident ? BK * ldk : 0);    // [BK][ldv] v tile
  float* ring = Vs + (resident ? BK * ldv : 0);  // stages of `stage` floats

  // chunk p of 64 features of dk (p < m_chunks) and of dv (p < d_chunks)
  const int m_chunks = cdiv(M, BT), d_chunks = cdiv(D, BT);
  const int pairs = m_chunks > d_chunks ? m_chunks : d_chunks;
  const int zgroups = cdiv(pairs, kDkvChunks);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int p_first = z * kDkvChunks;
  const int chunks =
      pairs - p_first < kDkvChunks ? pairs - p_first : kDkvChunks;
  // ds is needed for dl, which only dk's chunks use
  const bool need_ds = p_first < m_chunks;
  const int score_items = need_ds ? pairs : m_chunks;
  const int per_tile = score_items + chunks;  // items of one query tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // warps 0-3 take s and dk (side 0), 4-7 ds and dv (side 1), each 16 keys
  // (kr) by half of the 64 queries or features (half)
  const int side = warp / 4, kr = warp % 2, half = (warp / 2) % 2;
  const int h = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BK;
  const int64_t qb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t qe = qb + static_cast<int64_t>(chunk) * BT < N
                         ? qb + static_cast<int64_t>(chunk) * BT
                         : N;
  const int items = static_cast<int>((qe - qb + BT - 1) / BT) * per_tile;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  // item i of query tile i / per_tile: chunk j of q and of dnum in the
  // score layout (j < score_items), then chunk p of each in the product
  // layout; a stage holds q's chunk, then dnum's
  auto fill = [&](int i) {
    if (i < items) {
      const int j = i % per_tile;
      const int64_t q0 = qb + static_cast<int64_t>(i / per_tile) * BT;
      float* dst = ring + (i % stages) * stage;
      const bool scores = j < score_items;
      const int p = scores ? j : p_first + j - score_items;
      const int ld = scores ? kLdN : kLdK;
      if (p < m_chunks)
        fill_tile<BT>(dst, ld, q, sq, q0, N, h, p * BT, M, BT, vec & kVecQ);
      if (p < d_chunks && (need_ds || !scores))
        fill_tile<BT, float, T>(dst + kStage, ld, dnum, sn, q0, N, h, p * BT,
                                D, BT, vec & kVecDnum);
      if (scores && !resident && p < m_chunks)
        fill_tile<BK>(dst + 2 * kStage, kLdN, k, sk, k0, L, h, p * BT, M, BT,
                      vec & kVecK);
      if (scores && !resident && p < d_chunks && need_ds)
        fill_tile<BK>(dst + 2 * kStage + BK * kLdN, kLdN, v, sv, k0, L, h,
                      p * BT, D, BT, vec & kVecV);
    }
    cp_async_commit();
  };

  for (int c0 = 0; resident && c0 < m_chunks * BT; c0 += BT)
    fill_tile<BK>(Ks + c0, ldk, k, sk, k0, L, h, c0, M, BT, vec & kVecK);
  for (int c0 = 0; resident && c0 < d_chunks * BT; c0 += BT)
    fill_tile<BK>(Vs + c0, ldv, v, sv, k0, L, h, c0, D, BT, vec & kVecV);
  for (int i = 0; i < stages - 1; ++i) fill(i);

  float mk[2];  // the mask of keys g and g + 8 of the warp's 16
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int64_t key = k0 + 16 * kr + g + 8 * e;
    mk[e] = key < L ? (mask ? mask[key] : 1.f) : 0.f;
  }

  float acc[kDkvChunks][4][4] = {};  // dk (side 0) or dv (side 1)
  float sc[4][4] = {};               // s^T (side 0) or ds^T (side 1)
  const int side_chunks = side == 0 ? m_chunks : (need_ds ? d_chunks : 0);
  const float* Aw = (side == 0 ? Ks + 16 * kr * ldk : Vs + 16 * kr * ldv);
  const int lda = side == 0 ? ldk : ldv;
  for (int i = 0; i < items; ++i) {
    ring_wait(stages);
    __syncthreads();  // item i is in; item i - 1's stage is free
    fill(i + stages - 1);
    const float* base = ring + (i % stages) * stage;
    const float* st = base + side * kStage;
    const int j = i % per_tile;
    const int64_t q0 = qb + static_cast<int64_t>(i / per_tile) * BT;
    if (j == 0 && threadIdx.x < BT)
      dd[threadIdx.x] =
          q0 + threadIdx.x < N ? dden[(q0 + threadIdx.x) * H + h] : 0.f;
    if (j < score_items) {  // s^T += k q^T, ds^T += v dnum^T: one chunk
      if (j < side_chunks)
        warp_mma<kSplit, true>(
            sc,
            resident ? Aw + j * BT
                     : base + 2 * kStage + (side * BK + 16 * kr) * kLdN,
            lda, st + 32 * half * kLdN, kLdN);
      if (j == score_items - 1) {
        // side 0 writes p = sigma(s) x mask (0 past N), side 1 ds; then
        // each thread takes dl and s at the rounding points of its share
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * half + 8 * nt + 2 * t;
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = side == 1 ? sc[nt][e]
                   : q0 + col + e % 2 < N ? sigmoid(sc[nt][e]) * mk[e / 2]
                                          : 0.f;
            sc[nt][e] = 0.f;
          }
          float* dst = side == 0 ? Ss : Ls;
          const int r = 16 * kr + g;
          *reinterpret_cast<float2*>(dst + r * kLdN + col) =
              make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(dst + (r + 8) * kLdN + col) =
              make_float2(x[2], x[3]);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < BK * BT; e += kThreads) {
          const int o = (e / BT) * kLdN + e % BT;
          const float p = Ss[o];
          Ls[o] = Num<T>::round((Ls[o] + dd[e % BT]) * p * (1.f - p));
          Ss[o] = Num<T>::round(p);
        }
      }
    } else {  // dk += dl q (side 0) or dv += s dnum (side 1): chunk p
      const int c = j - score_items, p = p_first + c;
      if (p < (side == 0 ? m_chunks : d_chunks)) {
        const float* Ap = (side == 0 ? Ls : Ss) + 16 * kr * kLdN;
#pragma unroll
        for (int cc = 0; cc < kDkvChunks; ++cc)
          if (cc == c)
            warp_mma<kSplit, false>(acc[cc], Ap, kLdN, st + 32 * half, kLdK);
      }
    }
  }
  cp_async_wait<0>();

  // dk [L, H, M] and dv [L, H, D], or with S > 1 raw partials of this
  // query chunk: dk [S, L, H, M] then dv [S, L, H, D]
  const int C = side == 0 ? M : D;
  T* dst = side == 0 ? dk : dv;
  float* part = side == 0 ? ws + split * L * H * M
                          : ws + splits * L * H * M + split * L * H * D;
#pragma unroll
  for (int cc = 0; cc < kDkvChunks; ++cc) {
    if (cc >= chunks) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = k0 + 16 * kr + g + 8 * (e / 2);
        const int f =
            (p_first + cc) * BT + 32 * half + 8 * nt + 2 * t + e % 2;
        if (row >= L || f >= C) continue;
        if (splits > 1)
          part[(row * H + h) * C + f] = acc[cc][nt][e];
        else
          Num<T>::store(dst + (row * H + h) * C + f, acc[cc][nt][e]);
      }
  }
}

// ---------------------------------------------------------------------------
// Launchers. Every tile is 64 x 64. K2 holds G = 1, 2 or 4 groups of 64
// output features in one block for D up to 256 (at M = D = 256 its shared
// memory is 217 KB of the 227 KB a block may have); K3 and K4 put their
// feature groups on the grid's z axis beside the split, and at M = D = 256
// take 191 KB and 209 KB. On the wide path K2, K3 and K4 put their groups
// of 7 chunks of 64 output features (K4: of dk and of dv) there, and their
// shared memory grows with the resident tiles (fwd_ring, dq_ring,
// dkv_ring): K4's wide blocks own 32 keys, every other block 64 rows.
// ---------------------------------------------------------------------------
struct Problem {
  const void *q, *k, *v;
  Strides sq, sk, sv;
  const float* mask;
  int64_t N, L;
  int H, M, D;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_floats * sizeof(float)));
}

// Sums the S slabs of n partials in ws into out.
template <typename T>
cudaError_t sum_partials(const float* ws, void* out, int64_t n, int S,
                         cudaStream_t stream) {
  sigattn_sum_partials<T>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(ws, static_cast<T*>(out), n, S);
  return cudaGetLastError();
}

bool wide(const Problem& p) {
  return p.M > kNarrowWidth || p.D > kNarrowWidth;
}

// The stages of `stage` floats that fit beside `fixed` floats in the
// 227 KB a block may have, at most kRing; 0 where fewer than 2 fit.
int ring_stages(size_t fixed, size_t stage) {
  constexpr size_t kMax = 232448 / sizeof(float);
  const size_t fit = fixed < kMax ? (kMax - fixed) / stage : 0;
  return fit < 2 ? 0 : static_cast<int>(fit < kRing ? fit : kRing);
}

// The ring of the wide K2 or K4: its stages, floats a stage, and whether
// the block's own tiles stay resident beside it (where two stages or more
// fit: at M = D = 400 K4 holds two, which an H100 ran faster than three
// with the tiles streamed), or come chunk by chunk through the ring;
// `floats` is the shared memory.
struct Ring {
  int stages, stage;
  bool resident;
  size_t floats;
};
Ring wide_ring(size_t fixed, size_t resident_tiles, int stage,
               int stream_stage) {
  Ring r{ring_stages(fixed + resident_tiles, stage), stage, true, 0};
  if (r.stages == 0)
    r = Ring{ring_stages(fixed, stream_stage), stream_stage, false, 0};
  r.floats = fixed + (r.resident ? resident_tiles : 0) +
             static_cast<size_t>(r.stages) * r.stage;
  return r;
}
Ring fwd_ring(const Problem& p) {
  return wide_ring(kTile * kLdN + 2 * kTile, kTile * resident_ld(p.M),
                   kStage, kStage + kTile * kLdN);
}
Ring dkv_ring(const Problem& p) {
  return wide_ring(2 * kKeyTile * kLdN + kTile,
                   kKeyTile * (resident_ld(p.M) + resident_ld(p.D)),
                   2 * kStage, 2 * kStage + 2 * kKeyTile * kLdN);
}

// The ring of the wide K3: the q and dnum tiles resident beside two
// stages or more where they fit (M = D = 300: two stages, 220 KB), else
// the q tile alone, its stages holding a v chunk and the same chunk of
// dnum, else neither; `resident` holds the DqResident flags.
struct DqRing {
  int stages, stage, resident;
  size_t floats;
};
DqRing dq_ring(const Problem& p) {
  const size_t fixed = kTile * kLdN;  // the dl tile
  const size_t q_tile = kTile * resident_ld(p.M);
  const size_t n_tile = kTile * resident_ld(p.D);
  const int stream_stage = kStage + kTile * kLdN;
  DqRing r{ring_stages(fixed + q_tile + n_tile, kStage), kStage,
           kResQ | kResDnum, 0};
  if (r.stages == 0)
    r = DqRing{ring_stages(fixed + q_tile, stream_stage), stream_stage,
               kResQ, 0};
  if (r.stages == 0)
    r = DqRing{ring_stages(fixed, stream_stage), stream_stage, 0, 0};
  r.floats = fixed + (r.resident & kResQ ? q_tile : 0) +
             (r.resident & kResDnum ? n_tile : 0) +
             static_cast<size_t>(r.stages) * r.stage;
  return r;
}

// Which of q, k, v and dnum fill_tile may copy 16 bytes at a time.
int vec_flags(const Problem& p, const float* dnum) {
  return (vec_rows(p.q, p.sq) ? kVecQ : 0) | (vec_rows(p.k, p.sk) ? kVecK : 0) |
         (vec_rows(p.v, p.sv) ? kVecV : 0) |
         (vec_rows(dnum, {static_cast<int64_t>(p.H) * p.D, p.D, 1})
              ? kVecDnum
              : 0);
}

// The groups of output features that each kernel puts on the z axis.
int fwd_groups(const Problem& p) {
  return wide(p) ? cdiv(cdiv(p.D, kTile), kFwdChunks) : 1;
}
int dq_groups(const Problem& p) {
  return wide(p) ? cdiv(cdiv(p.M, kTile), kDqChunks) : cdiv(p.M, kTile);
}
int dkv_groups(const Problem& p) {
  return wide(p) ? cdiv(feature_groups(p.M, p.D), kDkvChunks)
                 : feature_groups(p.M, p.D);
}

// Launches a K2 kernel (with the wide kernel's vec flags as Extra), and
// with splits > 1 the combine of its partials.
template <typename T, typename Kernel, typename... Extra>
cudaError_t fwd_launch(Kernel kernel, size_t smem, const Problem& p,
                       void* out, float* den, float* ws, int splits,
                       int chunk, bool normalize, cudaStream_t stream,
                       Extra... extra) {
  constexpr int BT = kTile;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H,
                  splits * fwd_groups(p));
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, out, den, ws, p.N, p.L, p.H,
      p.M, p.D, chunk, normalize, extra...);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t rows = p.N * p.H;
  sigattn_fwd_combine<T>
      <<<static_cast<unsigned>((rows * p.D + kThreads - 1) / kThreads),
         kThreads, 0, stream>>>(ws, out, den, rows, p.D, splits, normalize);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t fwd(const Problem& p, void* out, float* den, float* ws,
                int splits, int chunk, bool normalize, cudaStream_t stream) {
  constexpr int BT = kTile, P = kStride;
  return fwd_launch<T>(sigattn_fwd_kernel<T, G>,
                       2 * p.M * P + BT * 64 * G + BT * P, p, out, den, ws,
                       splits, chunk, normalize, stream);
}

// The wide kernel, or G groups of 64 output features that cover D.
template <typename T>
cudaError_t fwd_for_width(const Problem& p, void* out, float* den, float* ws,
                          int splits, int chunk, bool normalize,
                          cudaStream_t stream) {
  if (wide(p)) {
    const Ring r = fwd_ring(p);
    return fwd_launch<T>(sigattn_fwd_wide_kernel<T>, r.floats, p, out, den,
                         ws, splits, chunk, normalize, stream,
                         vec_flags(p, nullptr), r.stages, r.resident);
  }
  if (p.D <= 64)
    return fwd<T, 1>(p, out, den, ws, splits, chunk, normalize, stream);
  if (p.D <= 128)
    return fwd<T, 2>(p, out, den, ws, splits, chunk, normalize, stream);
  return fwd<T, 4>(p, out, den, ws, splits, chunk, normalize, stream);
}

template <typename T>
cudaError_t dq(const Problem& p, const float* dnum, const float* dden,
               void* dq_out, float* ws, int splits, int chunk,
               cudaStream_t stream) {
  constexpr int BT = kTile, P = kStride;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H,
                  splits * dq_groups(p));
  const auto* q = static_cast<const T*>(p.q);
  const auto* k = static_cast<const T*>(p.k);
  const auto* v = static_cast<const T*>(p.v);
  auto* out = static_cast<T*>(dq_out);
  cudaError_t e;
  if (wide(p)) {
    const DqRing r = dq_ring(p);
    e = prepare(sigattn_dq_wide_kernel<T>, r.floats);
    if (e != cudaSuccess) return e;
    sigattn_dq_wide_kernel<T>
        <<<grid, kThreads, r.floats * sizeof(float), stream>>>(
            q, p.sq, k, p.sk, v, p.sv, p.mask, dnum, dden, out, ws, p.N, p.L,
            p.H, p.M, p.D, chunk, vec_flags(p, dnum), r.stages, r.stage,
            r.resident);
  } else {
    const size_t smem = (p.M + p.D + 3 * BT) * P;
    e = prepare(sigattn_dq_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    sigattn_dq_kernel<T><<<grid, kThreads, smem * sizeof(float), stream>>>(
        q, p.sq, k, p.sk, v, p.sv, p.mask, dnum, dden, out, ws, p.N, p.L, p.H,
        p.M, p.D, chunk);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return sum_partials<T>(ws, dq_out, p.N * p.H * p.M, splits, stream);
}

// Launches one K4 kernel over tiles of `rows` keys, splits x dkv_groups z
// blocks (with the wide kernel's vec flags as Extra).
template <typename T, typename Kernel, typename... Extra>
cudaError_t dkv_launch(Kernel kernel, size_t smem, int rows,
                       const Problem& p, const float* dnum, const float* dden,
                       void* dk_out, void* dv_out, float* ws, int splits,
                       int chunk, cudaStream_t stream, Extra... extra) {
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.L + rows - 1) / rows), p.H,
                  splits * dkv_groups(p));
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, dnum, dden,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), ws, p.N, p.L, p.H,
      p.M, p.D, chunk, extra...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(const Problem& p, const float* dnum, const float* dden,
                void* dk_out, void* dv_out, float* ws, int splits, int chunk,
                cudaStream_t stream) {
  constexpr int BT = kTile, P = kStride;
  cudaError_t e;
  if (wide(p)) {
    const Ring r = dkv_ring(p);
    e = dkv_launch<T>(sigattn_dkv_wide_kernel<T>, r.floats, kKeyTile, p, dnum,
                      dden, dk_out, dv_out, ws, splits, chunk, stream,
                      vec_flags(p, dnum), r.stages, r.resident);
  } else {
    e = dkv_launch<T>(sigattn_dkv_kernel<T>, (p.M + p.D + 4 * BT) * P + BT,
                      BT, p, dnum, dden, dk_out, dv_out, ws, splits, chunk,
                      stream);
  }
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t rows = p.L * p.H;
  e = sum_partials<T>(ws, dk_out, rows * p.M, splits, stream);
  if (e != cudaSuccess) return e;
  return sum_partials<T>(ws + splits * rows * p.M, dv_out, rows * p.D, splits,
                         stream);
}

bool valid(int dtype, const Problem& p) {
  return (dtype == 0 || dtype == 1) && p.N > 0 && p.L > 0 && p.H > 0 &&
         p.H <= 65535 && p.M > 0 && p.D > 0;
}

// splits chunks of chunk tiles cover the loop's rows, none of them empty,
// the grid's z axis holds splits * groups blocks, and a workspace holds the
// partials when there is more than one split.
bool valid_split(int64_t loop_rows, int splits, int chunk, const void* ws,
                 int groups = 1) {
  const int64_t tiles = (loop_rows + kTile - 1) / kTile;
  return splits >= 1 && static_cast<int64_t>(splits) * groups <= 65535 &&
         chunk >= 1 &&
         static_cast<int64_t>(splits) * chunk >= tiles &&
         static_cast<int64_t>(splits - 1) * chunk < tiles &&
         (splits == 1 || ws != nullptr);
}

}  // namespace

extern "C" {

// splits blocks per (query tile, head, and on the wide path group of 512
// output features) each take chunk key tiles of kTile keys; with
// splits > 1, ws holds splits * N * H * (D + 1) floats.
int sigattn_fwd(int dtype, int normalize, const void* q, const void* k,
                const void* v, const void* mask, void* out, void* den,
                void* ws, int64_t N, int64_t L, int H, int M, int D,
                int splits, int chunk, int64_t sqn, int64_t sqh, int64_t sqm,
                int64_t skn, int64_t skh, int64_t skm, int64_t svn,
                int64_t svh, int64_t svd, void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p) || !valid_split(L, splits, chunk, ws, fwd_groups(p)))
    return cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* den_f = static_cast<float*>(den);
  auto* ws_f = static_cast<float*>(ws);
  return dtype == 0 ? fwd_for_width<float>(p, out, den_f, ws_f, splits, chunk,
                                           normalize != 0, st)
                    : fwd_for_width<__nv_bfloat16>(p, out, den_f, ws_f, splits,
                                                   chunk, normalize != 0, st);
}

// splits blocks per (query tile, head) each take chunk key tiles of kTile
// keys; with splits > 1, ws holds splits * N * H * M floats.
int sigattn_dq(int dtype, const void* q, const void* k, const void* v,
               const void* mask, const void* dnum, const void* dden,
               void* dq_out, void* ws, int64_t N, int64_t L, int H, int M,
               int D, int splits, int chunk, int64_t sqn, int64_t sqh,
               int64_t sqm, int64_t skn, int64_t skh, int64_t skm,
               int64_t svn, int64_t svh, int64_t svd, void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p) ||
      !valid_split(L, splits, chunk, ws, dq_groups(p)))
    return cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* dn = static_cast<const float*>(dnum);
  auto* dd = static_cast<const float*>(dden);
  auto* ws_f = static_cast<float*>(ws);
  return dtype == 0
             ? dq<float>(p, dn, dd, dq_out, ws_f, splits, chunk, st)
             : dq<__nv_bfloat16>(p, dn, dd, dq_out, ws_f, splits, chunk, st);
}

// splits blocks per (key tile, head) each take chunk query tiles of
// kTile queries; with splits > 1, ws holds splits * L * H * (M + D)
// floats.
int sigattn_dkv(int dtype, const void* q, const void* k, const void* v,
                const void* mask, const void* dnum, const void* dden,
                void* dk_out, void* dv_out, void* ws, int64_t N, int64_t L,
                int H, int M, int D, int splits, int chunk, int64_t sqn,
                int64_t sqh, int64_t sqm, int64_t skn, int64_t skh,
                int64_t skm, int64_t svn, int64_t svh, int64_t svd,
                void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p) ||
      !valid_split(N, splits, chunk, ws, dkv_groups(p)))
    return cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* dn = static_cast<const float*>(dnum);
  auto* dd = static_cast<const float*>(dden);
  auto* ws_f = static_cast<float*>(ws);
  return dtype == 0 ? dkv<float>(p, dn, dd, dk_out, dv_out, ws_f, splits,
                                 chunk, st)
                    : dkv<__nv_bfloat16>(p, dn, dd, dk_out, dv_out, ws_f,
                                         splits, chunk, st);
}

}  // extern "C"
