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
//
// What bounds them on this card: operations. Each kernel reads and writes
// O((N + L) H (M + D)) bytes but does O(N L H (M + D)) multiply-adds, so at
// the shapes DIFFormer-a runs (N = L in the thousands, M = D = 64) they sit
// far above the memory roofline. The design keeps every [N, L] intermediate
// out of device memory: a block owns one (head, tile of BT rows), loops over
// the other side's tiles (K2: a chunk of them) inside the block, recomputes
// the score tile in shared memory and keeps its f32 accumulators in
// registers. No two blocks add into one output, so no atomics are needed
// and results are deterministic: K2's key chunks write separate partials,
// which a second kernel sums in a fixed order. The TPU's ones-column
// denominator becomes a plain row sum, and rows past N or L are masked by
// predication, not by padded copies.
//
// The kernels multiply with FFMA. K3 and K4 run on a 16 x 16 thread grid
// (each thread owns a BT/16 x BT/16 score sub-tile and BT/16 x CT
// accumulators, read as scalars from shared memory); K2 reads its operands
// as float4s (see K2). bf16 inputs are widened to f32 in shared memory: a
// bf16 x bf16 product is exact in f32, so this reproduces "bf16 products,
// f32 sums", and f32 inputs
// stay exact f32 (no TF32). The TPU kernel's rounding points are kept: s is
// rounded to v's dtype before s v (and the denominator sums the rounded s,
// as the TPU's ones column does), dnum to v's dtype inside ds and dv, and dl
// to k's dtype for dq and to q's dtype for dk. Tensor cores (mma / wgmma),
// TMA and pipelining are later work.
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
constexpr int kMaxWidth = 256;  // largest M and D the kernels take
constexpr int kKeyTile = 64;    // K2 splits the keys in chunks of such tiles

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

// dst[c * (BT + 1) + r] = round_R(src[r0 + r, h, c]) for r < BT, c < C;
// rows at or past nrows read as 0. Column-major with a padded stride, so the
// score loops read a row of the tile without bank conflicts.
template <typename S, typename R, int BT>
__device__ __forceinline__ void load_cols(float* dst, const S* __restrict__ src,
                                          Strides s, int64_t r0, int64_t nrows,
                                          int h, int C) {
  constexpr int P = BT + 1;
  for (int idx = threadIdx.x; idx < BT * C; idx += kThreads) {
    const int r = idx / C, c = idx - r * C;
    const int64_t row = r0 + r;
    dst[c * P + r] =
        row < nrows
            ? Num<R>::round(Num<S>::load(src + row * s.n + h * s.h + c * s.c))
            : 0.f;
  }
}

__device__ __forceinline__ void zero(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.f;
}

// acc[i][j] += sum_c A[c * P + ty * R + i] * B[c * P + tx + 16 j]: one
// R x R sub-tile of a BT x BT product over a depth of C, both operands
// column-major in shared memory.
template <int BT>
__device__ __forceinline__ void tile_product(float (&acc)[BT / 16][BT / 16],
                                             const float* A, const float* B,
                                             int C, int tx, int ty) {
  constexpr int P = BT + 1, R = BT / 16;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[c * P + ty * R + i];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[c * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
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
constexpr int kFwdStride = kKeyTile + 4;  // of the q, k and s tiles

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

// dst[c * kFwdStride + r] = src[r0 + r, h, c] for r < kKeyTile, c < C;
// rows at or past nrows read as 0. Thread t takes the columns c = t mod 64
// (+ 64 i), so a warp reads 32 neighbouring columns of a row, and four
// rows of a column at a time, which it stores as one float4.
template <typename S>
__device__ __forceinline__ void load_tile_fmajor(float* dst,
                                                 const S* __restrict__ src,
                                                 Strides s, int64_t r0,
                                                 int64_t nrows, int h, int C) {
  constexpr int kCols = 64, kGroups = kThreads / kCols;
  const int r = 4 * (threadIdx.x / kCols);
  for (int c = threadIdx.x % kCols; c < C; c += kCols) {
    const S* p = src + (r0 + r) * s.n + h * s.h + c * s.c;
#pragma unroll
    for (int i = 0; i < kKeyTile; i += 4 * kGroups) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = r0 + r + i + u < nrows ? Num<S>::load(p + (i + u) * s.n) : 0.f;
      *reinterpret_cast<float4*>(dst + c * kFwdStride + r + i) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// dst[r * CW + c] = src[r0 + r, h, c] for r < kKeyTile, c < CW; rows at or
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
  for (int i = 0; i < kKeyTile; i += kRows)
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
  constexpr int BT = kKeyTile, P = kFwdStride, CW = 64 * G;
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

// ---------------------------------------------------------------------------
// K3: dq. One block per (query tile, head), looping over key tiles.
// ---------------------------------------------------------------------------
template <typename T, int BT, int CT>
__global__ void __launch_bounds__(kThreads)
    sigattn_dq_kernel(const T* __restrict__ q, Strides sq,
                      const T* __restrict__ k, Strides sk,
                      const T* __restrict__ v, Strides sv,
                      const float* __restrict__ mask,
                      const float* __restrict__ dnum,
                      const float* __restrict__ dden, T* __restrict__ dq,
                      int64_t N, int64_t L, int H, int M, int D) {
  constexpr int P = BT + 1, R = BT / 16, CW = CT * 16;
  extern __shared__ float smem[];
  float* Qs = smem;          // [M][P]  q tile
  float* Ns = Qs + M * P;    // [D][P]  dnum tile in v's dtype
  float* Ks = Ns + D * P;    // [CW][P] k tile; rows >= M stay 0
  float* Vs = Ks + CW * P;   // [D][P]  v tile
  float* Ls = Vs + D * P;    // [BT][P] Ls[j * P + i] = dl[i, j] in k's dtype
  float* dd = Ls + BT * P;   // [BT]    dden of the query tile

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  zero(Ks, CW * P);
  load_cols<T, float, BT>(Qs, q, sq, q0, N, h, M);
  load_cols<float, T, BT>(Ns, dnum, sn, q0, N, h, D);
  for (int i = threadIdx.x; i < BT; i += kThreads)
    dd[i] = q0 + i < N ? dden[(q0 + i) * H + h] : 0.f;

  float acc[R][CT] = {};
  for (int64_t k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_cols<T, float, BT>(Ks, k, sk, k0, L, h, M);
    load_cols<T, float, BT>(Vs, v, sv, k0, L, h, D);
    __syncthreads();

    float s[R][R] = {}, ds[R][R] = {};
    tile_product<BT>(s, Qs, Ks, M, tx, ty);
    tile_product<BT>(ds, Ns, Vs, D, tx, ty);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t key = k0 + tx + 16 * j;
      const float mk = key < L ? (mask ? mask[key] : 1.f) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sigmoid(s[i][j]) * mk;
        const float dl = (ds[i][j] + dd[ty * R + i]) * p * (1.f - p);
        Ls[(tx + 16 * j) * P + ty * R + i] = Num<T>::round(dl);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float a[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Ls[j * P + ty * R + i];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float b = Ks[(tx + 16 * c) * P + j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = q0 + ty * R + i;
    if (row >= N) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int m = tx + 16 * c;
      if (m < M) Num<T>::store(dq + (row * H + h) * M + m, acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: dk and dv. One block per (key tile, head), looping over query tiles.
// Queries past N carry zero dnum and dden, so they add nothing.
// ---------------------------------------------------------------------------
template <typename T, int BT, int CT>
__global__ void __launch_bounds__(kThreads)
    sigattn_dkv_kernel(const T* __restrict__ q, Strides sq,
                       const T* __restrict__ k, Strides sk,
                       const T* __restrict__ v, Strides sv,
                       const float* __restrict__ mask,
                       const float* __restrict__ dnum,
                       const float* __restrict__ dden, T* __restrict__ dk,
                       T* __restrict__ dv, int64_t N, int64_t L, int H, int M,
                       int D) {
  constexpr int P = BT + 1, R = BT / 16, CW = CT * 16;
  extern __shared__ float smem[];
  float* Ks = smem;          // [M][P]  k tile
  float* Vs = Ks + M * P;    // [D][P]  v tile
  float* Qs = Vs + D * P;    // [CW][P] q tile; rows >= M stay 0
  float* Ns = Qs + CW * P;   // [CW][P] dnum tile in v's dtype; rows >= D stay 0
  float* Ls = Ns + CW * P;   // [BT][P] Ls[i * P + j] = dl[i, j] in q's dtype
  float* Ss = Ls + BT * P;   // [BT][P] Ss[i * P + j] = s[i, j] in v's dtype
  float* dd = Ss + BT * P;   // [BT]    dden of the query tile
  float* mk = dd + BT;       // [BT]    key mask of the key tile (0 past L)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, h = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const Strides sn{static_cast<int64_t>(H) * D, D, 1};

  zero(Qs, 2 * CW * P);
  load_cols<T, float, BT>(Ks, k, sk, k0, L, h, M);
  load_cols<T, float, BT>(Vs, v, sv, k0, L, h, D);
  for (int j = threadIdx.x; j < BT; j += kThreads)
    mk[j] = k0 + j < L ? (mask ? mask[k0 + j] : 1.f) : 0.f;

  // this thread's rows are keys ty * R + i, its score columns queries
  // tx + 16 j, its accumulator columns features tx + 16 c
  float dk_acc[R][CT] = {}, dv_acc[R][CT] = {};
  for (int64_t q0 = 0; q0 < N; q0 += BT) {
    __syncthreads();
    load_cols<T, float, BT>(Qs, q, sq, q0, N, h, M);
    load_cols<float, T, BT>(Ns, dnum, sn, q0, N, h, D);
    for (int i = threadIdx.x; i < BT; i += kThreads)
      dd[i] = q0 + i < N ? dden[(q0 + i) * H + h] : 0.f;
    __syncthreads();

    float s[R][R] = {}, ds[R][R] = {};
    tile_product<BT>(s, Ks, Qs, M, tx, ty);
    tile_product<BT>(ds, Vs, Ns, D, tx, ty);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int qi = tx + 16 * j;
      const bool live = q0 + qi < N;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = live ? sigmoid(s[i][j]) * mk[ty * R + i] : 0.f;
        const float dl = (ds[i][j] + dd[qi]) * p * (1.f - p);
        Ls[qi * P + ty * R + i] = Num<T>::round(dl);
        Ss[qi * P + ty * R + i] = Num<T>::round(p);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float a[R], b[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Ls[j * P + ty * R + i];
        b[i] = Ss[j * P + ty * R + i];
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float qv = Qs[(tx + 16 * c) * P + j];
        const float nv = Ns[(tx + 16 * c) * P + j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dk_acc[i][c] = fmaf(a[i], qv, dk_acc[i][c]);
          dv_acc[i][c] = fmaf(b[i], nv, dv_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = k0 + ty * R + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int f = tx + 16 * c;
      if (f < M) Num<T>::store(dk + (row * H + h) * M + f, dk_acc[i][c]);
      if (f < D) Num<T>::store(dv + (row * H + h) * D + f, dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. K2's tiles are 64 x 64, with G = 1, 2 or 4 groups of 64
// output features for D up to 256 (at M = D = 256 its shared memory is
// 217 KB of the 227 KB a block may have). For K3 and K4 the tile shape
// follows the wider of M and D: BT = 64 rows with up to 128 accumulator
// columns, BT = 32 rows up to 256, so their shared memory stays under
// 170 KB.
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

template <typename T, int G>
cudaError_t fwd(const Problem& p, void* out, float* den, float* ws,
                int splits, int chunk, bool normalize, cudaStream_t stream) {
  constexpr int BT = kKeyTile, P = kFwdStride;
  const size_t smem = 2 * p.M * P + BT * 64 * G + BT * P;
  auto kernel = sigattn_fwd_kernel<T, G>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H, splits);
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

// G groups of 64 output features cover D.
template <typename T>
cudaError_t fwd_for_width(const Problem& p, void* out, float* den, float* ws,
                          int splits, int chunk, bool normalize,
                          cudaStream_t stream) {
  if (p.D <= 64)
    return fwd<T, 1>(p, out, den, ws, splits, chunk, normalize, stream);
  if (p.D <= 128)
    return fwd<T, 2>(p, out, den, ws, splits, chunk, normalize, stream);
  return fwd<T, 4>(p, out, den, ws, splits, chunk, normalize, stream);
}

template <typename T, int BT, int CT>
cudaError_t dq(const Problem& p, const float* dnum, const float* dden,
               void* dq_out, cudaStream_t stream) {
  constexpr int P = BT + 1, CW = CT * 16;
  const size_t smem = (p.M + 2 * p.D + CW + BT) * P + BT;
  auto kernel = sigattn_dq_kernel<T, BT, CT>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H);
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, dnum, dden,
      static_cast<T*>(dq_out), p.N, p.L, p.H, p.M, p.D);
  return cudaGetLastError();
}

template <typename T, int BT, int CT>
cudaError_t dkv(const Problem& p, const float* dnum, const float* dden,
                void* dk_out, void* dv_out, cudaStream_t stream) {
  constexpr int P = BT + 1, CW = CT * 16;
  const size_t smem = (p.M + p.D + 2 * CW + 2 * BT) * P + 2 * BT;
  auto kernel = sigattn_dkv_kernel<T, BT, CT>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.L + BT - 1) / BT), p.H);
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, dnum, dden,
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), p.N, p.L, p.H, p.M,
      p.D);
  return cudaGetLastError();
}

// Calls F<T, BT, CT>::run for the element type (0 f32, 1 bf16) and the
// tile shape that fits max(M, D).
#define SIGATTN_DISPATCH(dtype, width, CALL)            \
  do {                                                  \
    if ((dtype) == 0) {                                 \
      using T = float;                                  \
      if ((width) <= 64) return CALL(T, 64, 4);         \
      if ((width) <= 128) return CALL(T, 64, 8);        \
      return CALL(T, 32, 16);                           \
    }                                                   \
    using T = __nv_bfloat16;                            \
    if ((width) <= 64) return CALL(T, 64, 4);           \
    if ((width) <= 128) return CALL(T, 64, 8);          \
    return CALL(T, 32, 16);                             \
  } while (0)

bool valid(int dtype, const Problem& p) {
  return (dtype == 0 || dtype == 1) && p.N > 0 && p.L > 0 && p.H > 0 &&
         p.H <= 65535 && p.M > 0 && p.D > 0 && p.M <= kMaxWidth &&
         p.D <= kMaxWidth;
}

}  // namespace

extern "C" {

// splits blocks per (query tile, head) each take chunk key tiles of
// kKeyTile keys; with splits > 1, ws holds splits * N * H * (D + 1) floats.
int sigattn_fwd(int dtype, int normalize, const void* q, const void* k,
                const void* v, const void* mask, void* out, void* den,
                void* ws, int64_t N, int64_t L, int H, int M, int D,
                int splits, int chunk, int64_t sqn, int64_t sqh, int64_t sqm,
                int64_t skn, int64_t skh, int64_t skm, int64_t svn,
                int64_t svh, int64_t svd, void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  const int64_t tiles = (L + kKeyTile - 1) / kKeyTile;
  if (!valid(dtype, p) || splits < 1 || splits > 65535 || chunk < 1 ||
      static_cast<int64_t>(splits) * chunk < tiles ||
      static_cast<int64_t>(splits - 1) * chunk >= tiles ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* den_f = static_cast<float*>(den);
  auto* ws_f = static_cast<float*>(ws);
  return dtype == 0 ? fwd_for_width<float>(p, out, den_f, ws_f, splits, chunk,
                                           normalize != 0, st)
                    : fwd_for_width<__nv_bfloat16>(p, out, den_f, ws_f, splits,
                                                   chunk, normalize != 0, st);
}

int sigattn_dq(int dtype, const void* q, const void* k, const void* v,
               const void* mask, const void* dnum, const void* dden,
               void* dq_out, int64_t N, int64_t L, int H, int M, int D,
               int64_t sqn, int64_t sqh, int64_t sqm, int64_t skn,
               int64_t skh, int64_t skm, int64_t svn, int64_t svh,
               int64_t svd, void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p)) return cudaErrorInvalidValue;
  const int width = M > D ? M : D;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* dn = static_cast<const float*>(dnum);
  auto* dd = static_cast<const float*>(dden);
#define SIGATTN_DQ(T, BT, CT) dq<T, BT, CT>(p, dn, dd, dq_out, st)
  SIGATTN_DISPATCH(dtype, width, SIGATTN_DQ);
#undef SIGATTN_DQ
}

int sigattn_dkv(int dtype, const void* q, const void* k, const void* v,
                const void* mask, const void* dnum, const void* dden,
                void* dk_out, void* dv_out, int64_t N, int64_t L, int H, int M,
                int D, int64_t sqn, int64_t sqh, int64_t sqm, int64_t skn,
                int64_t skh, int64_t skm, int64_t svn, int64_t svh,
                int64_t svd, void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p)) return cudaErrorInvalidValue;
  const int width = M > D ? M : D;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* dn = static_cast<const float*>(dnum);
  auto* dd = static_cast<const float*>(dden);
#define SIGATTN_DKV(T, BT, CT) dkv<T, BT, CT>(p, dn, dd, dk_out, dv_out, st)
  SIGATTN_DISPATCH(dtype, width, SIGATTN_DKV);
#undef SIGATTN_DKV
}

}  // extern "C"
