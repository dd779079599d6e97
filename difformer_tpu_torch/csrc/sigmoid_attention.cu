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
// the shapes DIFFormer-a runs (N = L in the thousands, M = D = 64) they sit
// far above the memory roofline. The design keeps every [N, L] intermediate
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
// The kernels multiply with FFMA on one layout: 64 x 64 tiles, 256 threads,
// each warp owning 8 rows of the output tile against the 64 rows of a loop
// tile, each lane a 4 x 4 micro tile whose operands are single float4 reads
// from feature-major tiles of stride 68 (see K2 and K4). bf16 inputs are
// widened to f32 in shared memory: a bf16 x bf16 product is exact in f32, so
// this reproduces "bf16 products, f32 sums", and f32 inputs stay exact f32
// (no TF32). The TPU kernel's rounding points are kept: s is rounded to v's
// dtype before s v (and the denominator sums the rounded s, as the TPU's
// ones column does), dnum to v's dtype inside ds and dv, and dl to k's dtype
// for dq and to q's dtype for dk. Tensor cores (mma / wgmma), TMA and
// pipelining are later work.
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
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
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
// 400 at one head). A block can no longer hold whole feature columns of its
// own tile (2 M 68 floats of q and k alone pass the 227 KB a block may have
// at M = 400), so every tile goes through shared memory 64 features at a
// time, and each loop tile takes two passes:
//
//   1. the score tiles (s over M, and for K3 and K4 ds over D), summed over
//      the 64-feature chunks of both operands before the sigmoid;
//   2. the products that use them, one 64-feature chunk of the block's
//      output at a time, streaming that chunk of the other operand.
//
// A block keeps WG chunks of its output in registers (acc [4][4 WG] a
// lane), so the scores are computed once for every WG x 64 output features,
// not once for every 64 as the narrow path's feature groups would: 512
// features, one z group up to M, D = 512 (K4: one group of dk and one of
// dv). Wider outputs take more z groups.
// The accumulators need up to 255 registers a thread, so one block runs
// on an SM; the tile layouts and the rounding points are the narrow path's.
// ---------------------------------------------------------------------------
constexpr int kWideFwdGroups = 8;  // K2: 512 output features a block
constexpr int kWideDqGroups = 8;   // K3: 512 features of dq a block
constexpr int kWideDkvGroups = 8;  // K4: 512 features of dk or dv a block

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The number of 64-feature chunks of the block's output range that start
// below C, at most WG; the range starts at z WG 64.
__device__ __forceinline__ int chunks_in_range(int C, int z, int WG) {
  const int left = C - z * WG * kTile;
  return left <= 0 ? 0 : (cdiv(left, kTile) < WG ? cdiv(left, kTile) : WG);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sigattn_fwd_wide_kernel(const T* __restrict__ q, Strides sq,
                            const T* __restrict__ k, Strides sk,
                            const T* __restrict__ v, Strides sv,
                            const float* __restrict__ mask,
                            void* __restrict__ out,
                            float* __restrict__ den_out,
                            float* __restrict__ ws, int64_t N, int64_t L,
                            int H, int M, int D, int chunk, bool normalize) {
  constexpr int BT = kTile, P = kStride, WG = kWideFwdGroups;
  extern __shared__ float4 fwdw_smem[];
  float* Qs = reinterpret_cast<float*>(fwdw_smem);  // [BT][P] 64 features
  float* Ks = Qs + BT * P;   // [BT][P] the same features of the k tile
  float* Vs = Ks + BT * P;   // [BT][BT] 64 features of the v tile
  float* Ss = Vs + BT * BT;  // [BT][P] Ss[j * P + i] = s[i, j] in v's dtype

  const int zgroups = cdiv(D, WG * BT);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int d0 = z * WG * BT, groups = chunks_in_range(D, z, WG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 8 + (lane / 16) * 4;
  const int col0 = (lane % 16) * 4;
  const int h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kb = static_cast<int64_t>(split) * chunk * BT;
  const int64_t ke = kb + static_cast<int64_t>(chunk) * BT < L
                         ? kb + static_cast<int64_t>(chunk) * BT
                         : L;

  float acc[4][4 * WG] = {};
  float den[4] = {};
  for (int64_t k0 = kb; k0 < ke; k0 += BT) {
    float s[4][4] = {};
    for (int c0 = 0; c0 < M; c0 += BT) {  // pass 1: s over M
      const int cm = M - c0 < BT ? M - c0 : BT;
      __syncthreads();  // Qs, Ks (and Ss, Vs) are no longer read
      load_tile_fmajor<T>(Qs, q + c0 * sq.c, sq, q0, N, h, cm);
      load_tile_fmajor<T>(Ks, k + c0 * sk.c, sk, k0, L, h, cm);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cm; ++c)
        outer4(s, 0, lds4(Qs + c * P + row0), lds4(Ks + c * P + col0));
    }
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
#pragma unroll
    for (int g = 0; g < WG; ++g) {  // pass 2: num += s v, 64 features a time
      if (g < groups) {
        const int c0 = d0 + g * BT;
        __syncthreads();  // Vs is no longer read; Ss is written
        load_tile_rows<T, BT>(Vs, v + c0 * sv.c, sv, k0, L, h, D - c0);
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < BT; ++j)
          outer4(acc, 4 * g, lds4(Ss + j * P + row0),
                 lds4(Vs + j * BT + col0));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);

  const bool first = lane % 16 == 0 && z == 0;  // one writer of a row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + row0 + i;
    if (row >= N) continue;
    const int64_t r = splits > 1 ? (split * N + row) * H + h : row * H + h;
    if (splits > 1 && first) ws[splits * N * H * D + r] = den[i];
    if (splits == 1 && first) den_out[r] = den[i];
#pragma unroll
    for (int c = 0; c < 4 * WG; ++c) {
      const int d = d0 + 64 * (c / 4) + col0 + c % 4;
      if (c / 4 >= groups || d >= D) continue;
      if (splits > 1)  // raw partials of this key chunk
        ws[r * D + d] = acc[i][c];
      else if (normalize)
        Num<T>::store(static_cast<T*>(out) + r * D + d, acc[i][c] / den[i]);
      else
        static_cast<float*>(out)[r * D + d] = acc[i][c];
    }
  }
}

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
                           int chunk) {
  constexpr int BT = kTile, P = kStride, WG = kWideDqGroups;
  extern __shared__ float4 dqw_smem[];
  float* Qs = reinterpret_cast<float*>(dqw_smem);  // [BT][P] 64 features
  float* Ns = Qs + BT * P;  // [BT][P] 64 features of dnum in v's dtype
  float* Ks = Ns + BT * P;  // [BT][P] 64 features of the k tile
  float* Vs = Ks + BT * P;  // [BT][P] 64 features of the v tile
  float* Ls = Vs + BT * P;  // [BT][P] Ls[i * P + j] = dl[i, j] in k's dtype

  const int zgroups = cdiv(M, WG * BT);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int m0 = z * WG * BT, groups = chunks_in_range(M, z, WG);
  const int depth = feature_groups(M, D);
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

  float dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dd[i] = q0 + row0 + i < N ? dden[(q0 + row0 + i) * H + h] : 0.f;

  float acc[4][4 * WG] = {};
  for (int64_t k0 = kb; k0 < ke; k0 += BT) {
    float s[4][4] = {}, ds[4][4] = {};
    for (int t = 0; t < depth; ++t) {  // pass 1: s over M, ds over D
      const int c0 = BT * t;
      const int cm = M - c0 < BT ? M - c0 : BT;
      const int cd = D - c0 < BT ? D - c0 : BT;
      __syncthreads();  // the tiles (and Ks after pass 2) are no longer read
      load_tile_fmajor<T>(Qs, q + c0 * sq.c, sq, q0, N, h, cm);
      load_tile_fmajor<float, T>(Ns, dnum + c0, sn, q0, N, h, cd);
      load_tile_fmajor<T>(Ks, k + c0 * sk.c, sk, k0, L, h, cm);
      load_tile_fmajor<T>(Vs, v + c0 * sv.c, sv, k0, L, h, cd);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cm; ++c)
        outer4(s, 0, lds4(Qs + c * P + row0), lds4(Ks + c * P + col0));
#pragma unroll 4
      for (int c = 0; c < cd; ++c)
        outer4(ds, 0, lds4(Ns + c * P + row0), lds4(Vs + c * P + col0));
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

#pragma unroll
    for (int g = 0; g < WG; ++g) {  // pass 2: dq += dl k, 64 features a time
      if (g < groups) {
        const int c0 = m0 + g * BT;
        __syncthreads();  // Ks is no longer read; Ls is written
        load_tile_fmajor<T>(Ks, k + c0 * sk.c, sk, k0, L, h,
                            M - c0 < BT ? M - c0 : BT);
        __syncthreads();
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
            for (int u = 0; u < 4; ++u)
              acc[r][4 * g + u] = dot4(a[r], b[u], acc[r][4 * g + u]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + row0 + r;
    if (row >= N) continue;
#pragma unroll
    for (int c = 0; c < 4 * WG; ++c) {
      const int f = m0 + BT * (c / 4) + f0 + 16 * (c % 4);
      if (c / 4 >= groups || f >= M) continue;
      if (splits > 1)  // raw partials of this key chunk: [S, N, H, M]
        ws[((split * N + row) * H + h) * M + f] = acc[r][c];
      else
        Num<T>::store(dq + (row * H + h) * M + f, acc[r][c]);
    }
  }
}

// K4 takes two launches, one for dk (ForDv false) and one for dv: a dv
// block needs only s (over M), a dk block s and ds, and neither holds the
// other's accumulators. Each puts its groups of 512 features of dk (or dv)
// on the z axis.
template <typename T, bool ForDv>
__global__ void __launch_bounds__(kThreads, 1)
    sigattn_dkv_wide_kernel(const T* __restrict__ q, Strides sq,
                            const T* __restrict__ k, Strides sk,
                            const T* __restrict__ v, Strides sv,
                            const float* __restrict__ mask,
                            const float* __restrict__ dnum,
                            const float* __restrict__ dden,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ ws, int64_t N, int64_t L,
                            int H, int M, int D, int chunk) {
  constexpr int BT = kTile, P = kStride, WG = kWideDkvGroups;
  extern __shared__ float4 dkvw_smem[];
  float* Ks = reinterpret_cast<float*>(dkvw_smem);  // [BT][P] 64 features
  float* Vs = Ks + BT * P;  // [BT][P] 64 features of the v tile
  float* Qs = Vs + BT * P;  // [BT][P] 64 features of q (pass 2: q or dnum)
  float* Ns = Qs + BT * P;  // [BT][P] 64 features of dnum, in v's dtype
  float* Ls = Ns + BT * P;  // [BT][P] Ls[j * P + i] = dl[i, j] in q's dtype
  //                           (dk) or s[i, j] in v's dtype (dv)
  float* dd = Ls + BT * P;  // [BT]    dden of the query tile

  constexpr bool for_dv = ForDv;
  const int C = for_dv ? D : M;  // width of the output
  const int zgroups = cdiv(C, WG * BT);
  const int z = blockIdx.z % zgroups, split = blockIdx.z / zgroups;
  const int splits = gridDim.z / zgroups;
  const int f_base = z * WG * BT, groups = chunks_in_range(C, z, WG);
  // a dv block's scores are s over M only
  const int depth = for_dv ? cdiv(M, BT) : feature_groups(M, D);
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

  float mk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + row0 + i;
    mk[i] = key < L ? (mask ? mask[key] : 1.f) : 0.f;
  }

  float acc[4][4 * WG] = {};
  for (int64_t q0 = qb; q0 < qe; q0 += BT) {
    float s[4][4] = {}, ds[4][4] = {};
    for (int t = 0; t < depth; ++t) {  // pass 1: s^T over M, ds^T over D
      const int c0 = BT * t;
      const int cm = M - c0 < BT ? M - c0 : BT;
      const int cd = for_dv ? 0 : (D - c0 < BT ? D - c0 : BT);
      __syncthreads();  // the tiles and dd are no longer read
      load_tile_fmajor<T>(Ks, k + c0 * sk.c, sk, k0, L, h, cm);
      load_tile_fmajor<T>(Qs, q + c0 * sq.c, sq, q0, N, h, cm);
      load_tile_fmajor<T>(Vs, v + c0 * sv.c, sv, k0, L, h, cd);
      load_tile_fmajor<float, T>(Ns, dnum + c0, sn, q0, N, h, cd);
      if (t == 0 && !for_dv)
        for (int i = threadIdx.x; i < BT; i += kThreads)
          dd[i] = q0 + i < N ? dden[(q0 + i) * H + h] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cm; ++c)
        outer4(s, 0, lds4(Ks + c * P + row0), lds4(Qs + c * P + col0));
#pragma unroll 4
      for (int c = 0; c < cd; ++c)
        outer4(ds, 0, lds4(Vs + c * P + row0), lds4(Ns + c * P + col0));
    }

    // dden of the score tile's queries (a dv block does not read it)
    const float4 d4 = for_dv ? make_float4(0.f, 0.f, 0.f, 0.f)
                             : lds4(dd + col0);
    const float ddq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj =
            q0 + col0 + j < N ? sigmoid(s[i][j]) * mk[i] : 0.f;
        w[j] = for_dv ? Num<T>::round(pj)
                      : Num<T>::round((ds[i][j] + ddq[j]) * pj * (1.f - pj));
      }
      *reinterpret_cast<float4*>(Ls + (row0 + i) * P + col0) =
          make_float4(w[0], w[1], w[2], w[3]);
    }

#pragma unroll
    for (int g = 0; g < WG; ++g) {  // pass 2: dk += dl q or dv += s dnum
      if (g < groups) {
        const int c0 = f_base + g * BT;
        const int cw = C - c0 < BT ? C - c0 : BT;
        __syncthreads();  // Qs is no longer read; Ls is written
        if (for_dv)
          load_tile_fmajor<float, T>(Qs, dnum + c0, sn, q0, N, h, cw);
        else
          load_tile_fmajor<T>(Qs, q + c0 * sq.c, sq, q0, N, h, cw);
        __syncthreads();
#pragma unroll 4
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
              acc[r][4 * g + u] = dot4(a[r], b[u], acc[r][4 * g + u]);
        }
      }
    }
  }

  // raw partials of this query chunk: dk [S, L, H, M] then dv [S, L, H, D]
  T* out = for_dv ? dv : dk;
  float* part = for_dv ? ws + splits * L * H * M + split * L * H * D
                       : ws + split * L * H * M;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = k0 + row0 + r;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < 4 * WG; ++c) {
      const int f = f_base + BT * (c / 4) + f0 + 16 * (c % 4);
      if (c / 4 >= groups || f >= C) continue;
      if (splits > 1)
        part[(row * H + h) * C + f] = acc[r][c];
      else
        Num<T>::store(out + (row * H + h) * C + f, acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. Every tile is 64 x 64. K2 holds G = 1, 2 or 4 groups of 64
// output features in one block for D up to 256 (at M = D = 256 its shared
// memory is 217 KB of the 227 KB a block may have); K3 and K4 put their
// feature groups on the grid's z axis beside the split, and at M = D = 256
// take 191 KB and 209 KB. The wide kernels take 69, 87 and 87 KB at any
// width, and put their groups of 512 output features on the z axis; K4's
// wide path is two launches, dk's and dv's.
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

// The groups of output features that each kernel puts on the z axis.
int fwd_groups(const Problem& p) {
  return wide(p) ? cdiv(p.D, kWideFwdGroups * kTile) : 1;
}
int dq_groups(const Problem& p) {
  return cdiv(p.M, (wide(p) ? kWideDqGroups : 1) * kTile);
}
// (the wide path's two launches: the larger of dk's and dv's groups)
int dkv_groups(const Problem& p) {
  const int widest = p.M > p.D ? p.M : p.D;
  return wide(p) ? cdiv(widest, kWideDkvGroups * kTile)
                 : feature_groups(p.M, p.D);
}

// Launches a K2 kernel, and with splits > 1 the combine of its partials.
template <typename T, typename Kernel>
cudaError_t fwd_launch(Kernel kernel, size_t smem, const Problem& p,
                       void* out, float* den, float* ws, int splits,
                       int chunk, bool normalize, cudaStream_t stream) {
  constexpr int BT = kTile;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H,
                  splits * fwd_groups(p));
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, out, den, ws, p.N, p.L, p.H,
      p.M, p.D, chunk, normalize);
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
  constexpr int BT = kTile, P = kStride;
  if (wide(p))
    return fwd_launch<T>(sigattn_fwd_wide_kernel<T>, 3 * BT * P + BT * BT,
                         p, out, den, ws, splits, chunk, normalize, stream);
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
  const size_t smem = (wide(p) ? 5 * BT : p.M + p.D + 3 * BT) * P;
  auto kernel = wide(p) ? sigattn_dq_wide_kernel<T> : sigattn_dq_kernel<T>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H,
                  splits * dq_groups(p));
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, dnum, dden,
      static_cast<T*>(dq_out), ws, p.N, p.L, p.H, p.M, p.D, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return sum_partials<T>(ws, dq_out, p.N * p.H * p.M, splits, stream);
}

// Launches one K4 kernel over splits x groups z blocks.
template <typename T, typename Kernel>
cudaError_t dkv_launch(Kernel kernel, size_t smem, int groups,
                       const Problem& p, const float* dnum, const float* dden,
                       void* dk_out, void* dv_out, float* ws, int splits,
                       int chunk, cudaStream_t stream) {
  constexpr int BT = kTile;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.L + BT - 1) / BT), p.H,
                  splits * groups);
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, dnum, dden,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), ws, p.N, p.L, p.H,
      p.M, p.D, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(const Problem& p, const float* dnum, const float* dden,
                void* dk_out, void* dv_out, float* ws, int splits, int chunk,
                cudaStream_t stream) {
  constexpr int BT = kTile, P = kStride, G = kWideDkvGroups * kTile;
  cudaError_t e;
  if (wide(p)) {  // dk, then dv
    const size_t smem = 5 * BT * P + BT;
    e = dkv_launch<T>(sigattn_dkv_wide_kernel<T, false>, smem, cdiv(p.M, G),
                      p, dnum, dden, dk_out, dv_out, ws, splits, chunk,
                      stream);
    if (e == cudaSuccess)
      e = dkv_launch<T>(sigattn_dkv_wide_kernel<T, true>, smem, cdiv(p.D, G),
                        p, dnum, dden, dk_out, dv_out, ws, splits, chunk,
                        stream);
  } else {
    e = dkv_launch<T>(sigattn_dkv_kernel<T>, (p.M + p.D + 4 * BT) * P + BT,
                      feature_groups(p.M, p.D), p, dnum, dden, dk_out, dv_out,
                      ws, splits, chunk, stream);
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
