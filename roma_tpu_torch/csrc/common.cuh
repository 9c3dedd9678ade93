// Shared helpers for the hand-written Hopper kernels: f32 <-> storage-type
// conversion and the dtype switch of the C entry points (0 = float32,
// 1 = bfloat16, the codes of roma_tpu_torch/_ext.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
