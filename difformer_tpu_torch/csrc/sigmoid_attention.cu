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
// the other side's tiles inside the block, recomputes the score tile in
// shared memory and keeps its f32 accumulators in registers. Blocks never
// share an output row, so no atomics are needed and results are
// deterministic. The TPU's ones-column denominator becomes a plain row sum,
// and rows past N or L are masked by predication, not by padded copies.
//
// This first version multiplies with FFMA on a 16 x 16 thread grid (each
// thread owns a BT/16 x BT/16 score sub-tile and BT/16 x CT accumulators).
// bf16 inputs are widened to f32 in shared memory: a bf16 x bf16 product is
// exact in f32, so this reproduces "bf16 products, f32 sums", and f32 inputs
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

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxWidth = 256;  // largest M and D the kernels take

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

// dst[r * CW + c] = src[r0 + r, h, c] for r < BT, c < C (row-major).
template <typename S, int BT, int CW>
__device__ __forceinline__ void load_rows(float* dst, const S* __restrict__ src,
                                          Strides s, int64_t r0, int64_t nrows,
                                          int h, int C) {
  for (int idx = threadIdx.x; idx < BT * C; idx += kThreads) {
    const int r = idx / C, c = idx - r * C;
    const int64_t row = r0 + r;
    dst[r * CW + c] =
        row < nrows ? Num<S>::load(src + row * s.n + h * s.h + c * s.c) : 0.f;
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
// K2: forward. One block per (query tile, head), looping over key tiles.
// ---------------------------------------------------------------------------
template <typename T, int BT, int CT>
__global__ void __launch_bounds__(kThreads)
    sigattn_fwd_kernel(const T* __restrict__ q, Strides sq,
                       const T* __restrict__ k, Strides sk,
                       const T* __restrict__ v, Strides sv,
                       const float* __restrict__ mask, void* __restrict__ out,
                       float* __restrict__ den_out, int64_t N, int64_t L, int H,
                       int M, int D, bool normalize) {
  constexpr int P = BT + 1, R = BT / 16, CW = CT * 16;
  extern __shared__ float smem[];
  float* Qs = smem;          // [M][P]   q tile
  float* Ks = Qs + M * P;    // [M][P]   k tile
  float* Vs = Ks + M * P;    // [BT][CW] v tile, row-major; columns >= D stay 0
  float* Ss = Vs + BT * CW;  // [BT][P]  Ss[j * P + i] = s[i, j] in v's dtype

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;

  zero(Vs, BT * CW);
  load_cols<T, float, BT>(Qs, q, sq, q0, N, h, M);

  float acc[R][CT] = {};
  float den[R] = {};
  for (int64_t k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    load_cols<T, float, BT>(Ks, k, sk, k0, L, h, M);
    load_rows<T, BT, CW>(Vs, v, sv, k0, L, h, D);
    __syncthreads();

    float s[R][R] = {};
    tile_product<BT>(s, Qs, Ks, M, tx, ty);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t key = k0 + tx + 16 * j;
      const float mk = key < L ? (mask ? mask[key] : 1.f) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = Num<T>::round(sigmoid(s[i][j]) * mk);
        den[i] += p;
        Ss[(tx + 16 * j) * P + ty * R + i] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float a[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Ss[j * P + ty * R + i];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float b = Vs[j * CW + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
  }

  // the 16 threads of a half-warp share rows: sum their partial row sums
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = q0 + ty * R + i;
    if (row >= N) continue;
    const int64_t base = (row * H + h) * D;
    if (tx == 0) den_out[row * H + h] = den[i];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      if (normalize)
        Num<T>::store(static_cast<T*>(out) + base + d, acc[i][c] / den[i]);
      else
        static_cast<float*>(out)[base + d] = acc[i][c];
    }
  }
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
// Launchers. The tile shape follows the wider of M and D: BT = 64 rows with
// up to 128 accumulator columns, BT = 32 rows up to 256, so the shared
// memory of every kernel stays under 170 KB.
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

template <typename T, int BT, int CT>
cudaError_t fwd(const Problem& p, void* out, float* den, bool normalize,
                cudaStream_t stream) {
  constexpr int P = BT + 1, CW = CT * 16;
  const size_t smem = 2 * p.M * P + BT * CW + BT * P;
  auto kernel = sigattn_fwd_kernel<T, BT, CT>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((p.N + BT - 1) / BT), p.H);
  kernel<<<grid, kThreads, smem * sizeof(float), stream>>>(
      static_cast<const T*>(p.q), p.sq, static_cast<const T*>(p.k), p.sk,
      static_cast<const T*>(p.v), p.sv, p.mask, out, den, p.N, p.L, p.H, p.M,
      p.D, normalize);
  return cudaGetLastError();
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

int sigattn_fwd(int dtype, int normalize, const void* q, const void* k,
                const void* v, const void* mask, void* out, void* den,
                int64_t N, int64_t L, int H, int M, int D, int64_t sqn,
                int64_t sqh, int64_t sqm, int64_t skn, int64_t skh,
                int64_t skm, int64_t svn, int64_t svh, int64_t svd,
                void* stream) {
  const Problem p{q, k, v, {sqn, sqh, sqm}, {skn, skh, skm}, {svn, svh, svd},
                  static_cast<const float*>(mask), N, L, H, M, D};
  if (!valid(dtype, p)) return cudaErrorInvalidValue;
  const int width = M > D ? M : D;
  auto* st = static_cast<cudaStream_t>(stream);
  auto* den_f = static_cast<float*>(den);
#define SIGATTN_FWD(T, BT, CT) fwd<T, BT, CT>(p, out, den_f, normalize != 0, st)
  SIGATTN_DISPATCH(dtype, width, SIGATTN_FWD);
#undef SIGATTN_FWD
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
