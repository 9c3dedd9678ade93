// Shared helpers for the hand-written Hopper kernels: f32 <-> storage-type
// conversion, the dtype switch of the C entry points (0 = float32,
// 1 = bfloat16, the codes of roma_tpu_torch/_ext.py DTYPE_CODES), and the
// pixel reads and 16-byte stores of the bilinear samplers (Kernels C, G).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roma {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round an f32 value to the storage type T and back (the I/O-dtype rounding
// between stages that the reference computes)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// the f32 values of a 16-byte vector of 8 bf16 or 4 f32 (the last argument
// picks the element type)
__device__ __forceinline__ void unpack16(const uint4& r, float (&f)[8], __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16(const uint4& r, float (&f)[4], float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// batch, head and row strides (in elements) of a (B, H, N, D) view whose
// last dim is contiguous
struct Strides {
  long long b, h, n;
};

// opt a kernel into more than 48 KB of dynamic shared memory when needed
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Reading a pixel's C channels (Kernels C and G). Channel j of a run of raw
// 32-bit words, as f32, and one element loaded alone.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  __device__ static float get(const uint32_t* w, int j) { return __uint_as_float(w[j]); }
  __device__ static float load(const float* p) { return __ldg(p); }
};
template <>
struct Elem<__nv_bfloat16> {
  __device__ static float get(const uint32_t* w, int j) {
    const uint32_t u = w[j >> 1];  // little-endian: the even element is the low half
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
};

// NW words from p in loads of VB bytes (p aligned to VB)
template <int VB, int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  static_assert(NW * 4 % VB == 0, "whole vectors");
  if constexpr (VB == 16) {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 u = __ldg(static_cast<const uint4*>(p) + k);
      w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z, w[4 * k + 3] = u.w;
    }
  } else if constexpr (VB == 8) {
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) {
      const uint2 u = __ldg(static_cast<const uint2*>(p) + k);
      w[2 * k] = u.x, w[2 * k + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = __ldg(static_cast<const unsigned int*>(p) + k);
  }
}

// The C contiguous channels of the pixel at p, as f32, in the widest loads
// their alignment allows (the image's base 16-byte aligned): for an even C
// every pixel starts on a multiple of gcd(C * sizeof(T), 16) bytes, so the
// pixel is whole vectors of that width; for an odd C a pixel starts on an
// odd or an even element, and one lone element plus (C - 1) / 2 aligned
// pairs cover it either way, so every thread of a warp issues the same loads
// (bf16, C = 9: five loads a pixel, not nine).
template <typename T, int C>
__device__ __forceinline__ void read_tap(const T* p, float (&v)[C]) {
  constexpr int ES = sizeof(T);
  static_assert(C >= 2, "C >= 2");
  if constexpr (C % 2 == 0) {
    constexpr int NB = C * ES;
    constexpr int VB = NB % 16 == 0 ? 16 : NB % 8 == 0 ? 8 : 4;
    uint32_t w[NB / 4];
    load_words<VB>(p, w);
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = Elem<T>::get(w, j);
  } else {
    const bool odd = (reinterpret_cast<uintptr_t>(p) & (2 * ES - 1)) != 0;  // p is not on a pair
    const float lone = Elem<T>::load(p + (odd ? 0 : C - 1));
    uint32_t w[(C - 1) * ES / 4];
    load_words<2 * ES>(p + (odd ? 1 : 0), w);
    v[0] = odd ? lone : Elem<T>::get(w, 0);
#pragma unroll
    for (int j = 1; j < C - 1; ++j) v[j] = odd ? Elem<T>::get(w, j - 1) : Elem<T>::get(w, j);
    v[C - 1] = odd ? Elem<T>::get(w, C - 2) : lone;
  }
}

// two f32 values rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes of outputs (o 16-byte aligned) from 16 / sizeof(T) f32 values at
// s (16-byte aligned), rounded to T
__device__ __forceinline__ void store16(float* o, const float* s) {
  *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ void store16(__nv_bfloat16* o, const float* s) {
  const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
  *reinterpret_cast<uint4*>(o) =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

}  // namespace roma

#define ROMA_DISPATCH_DTYPE(code, ...)                  \
  switch (code) {                                       \
    case 0: {                                           \
      using scalar_t = float;                           \
      __VA_ARGS__;                                      \
      break;                                            \
    }                                                   \
    case 1: {                                           \
      using scalar_t = __nv_bfloat16;                   \
      __VA_ARGS__;                                      \
      break;                                            \
    }                                                   \
    default:                                            \
      return static_cast<int>(cudaErrorInvalidValue);   \
  }
