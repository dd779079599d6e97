// Loads and stores of V consecutive values as one access, held as V floats:
// the vector moves of the port's sparse kernels (spmm.cu, ell.cu, bsr.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// V consecutive values of T moved as one access and held as V floats:
// float (V = 1), float4 (V a multiple of 4), a bf16 (V = 1) or 8 bf16 in
// one 16-byte load (V = 8). A bf16 store rounds to nearest even.
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&a)[1]) {
    a[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1]) {
    *p = a[0];
  }
};

template <int V>
struct PackFloat4 {
  static_assert(V % 4 == 0, "float4 packs hold a multiple of 4 values");
  static __device__ __forceinline__ void load(const float* p, float (&a)[V]) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      a[i] = t.x;
      a[i + 1] = t.y;
      a[i + 2] = t.z;
      a[i + 3] = t.w;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[V]) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  }
};
template <>
struct Pack<float, 4> : PackFloat4<4> {};
template <>
struct Pack<float, 8> : PackFloat4<8> {};

template <>
struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&a)[1]) {
    a[0] = __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[1]) {
    *p = __float2bfloat16_rn(a[0]);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  // a bf16 is the high half of the float with the same bits
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&a)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] = __uint_as_float(w[i] << 16);
      a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[8]) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<unsigned int>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i]))) |
             (static_cast<unsigned int>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i + 1])))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
