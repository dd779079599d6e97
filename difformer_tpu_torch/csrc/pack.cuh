// Loads and stores of V consecutive values as one access, held as V floats:
// the vector moves of the port's sparse kernels (spmm.cu, ell.cu, bsr.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// V consecutive values of T moved as one access and held as V floats:
// float (V = 1), float4 (V a multiple of 4), a bf16 (V = 1), 4 bf16 in one
// 8-byte access (V = 4) or 8 bf16 in one 16-byte access (V = 8). A bf16
// store rounds to nearest even.
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

// bf16 pairs packed into a 32-bit word, low half first, and back
__device__ __forceinline__ void unpack_bf16x2(unsigned int w, float* a) {
  // a bf16 is the high half of the float with the same bits
  a[0] = __uint_as_float(w << 16);
  a[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned int pack_bf16x2(const float* a) {
  return static_cast<unsigned int>(
             __bfloat16_as_ushort(__float2bfloat16_rn(a[0]))) |
         (static_cast<unsigned int>(
              __bfloat16_as_ushort(__float2bfloat16_rn(a[1])))
          << 16);
}

template <>
struct Pack<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&a)[4]) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(t.x, a);
    unpack_bf16x2(t.y, a + 2);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(a),
                                              pack_bf16x2(a + 2));
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&a)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack_bf16x2(t.x, a);
    unpack_bf16x2(t.y, a + 2);
    unpack_bf16x2(t.z, a + 4);
    unpack_bf16x2(t.w, a + 6);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&a)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(a), pack_bf16x2(a + 2), pack_bf16x2(a + 4),
                   pack_bf16x2(a + 6));
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
