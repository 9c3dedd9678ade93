// Kernel B: bilinear local correlation around a warp.
//
// Replaces roma_tpu/ops/tile_window.py:_corr_kernel (entry
// windowed_local_corr), and with it the reference's fused-local-corr CUDA
// extension. For every query pixel q with warp target w(q), the (2r+1)^2
// window points one feature pixel apart around w(q) all share one bilinear
// fraction, so their corners tile a (2r+2)^2 integer patch of f1. The kernel
// dots f0[q] / sqrt(C) with each integer tap (zero outside the image), keeps
// the (2r+2)^2 dots in shared memory, and folds them into the (2r+1)^2
// bilinear taps, dy-major, as roma_tpu/ops/local_corr.py:_combine_corners.
//
// What bounds it on the H100: the f1 reads, (2r+2)^2 * C elements per query,
// which neighbouring queries mostly share through L1/L2; the arithmetic is
// one FMA per element read. Design: one warp per query, lanes across the
// channels, so every tap is one coalesced C-wide row read and a 5-step
// shuffle reduction; f0[q] is staged once in shared memory. No windows, no
// miss budgets: every tap is read directly, so any warp is exact and any
// radius runs through the same code.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) local_corr_kernel(
    const T* __restrict__ f0, const T* __restrict__ f1, const float* __restrict__ warp,
    T* __restrict__ out, int B, int H, int W, int C, int R) {
  extern __shared__ float sm[];
  const int P = 2 * R + 2, K1 = 2 * R + 1;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* f0s = sm + wid * C;
  float* dps = sm + WARPS * C + wid * P * P;
  const long long q = (long long)blockIdx.x * WARPS + wid;
  if (q >= (long long)B * H * W) return;  // warp-uniform; no block barrier below
  const int b = (int)(q / ((long long)H * W));

  const float sq = sqrtf((float)C);
  const T* f0q = f0 + q * C;
  for (int c = lane; c < C; c += 32) f0s[c] = roma::to_f32(f0q[c]) / sq;
  __syncwarp();

  // unnormalize as roma_tpu/ops/local_corr.py:_base_indices
  const float ix = (warp[2 * q] + 1.f) * (float)W / 2.f - 0.5f;
  const float iy = (warp[2 * q + 1] + 1.f) * (float)H / 2.f - 0.5f;
  const float x0f = floorf(ix), y0f = floorf(iy);
  const float fx = ix - x0f, fy = iy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;

  const T* f1b = f1 + (size_t)b * H * W * C;
  for (int t = 0; t < P * P; ++t) {
    const int yy = y0 + t / P - R, xx = x0 + t % P - R;
    float d = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* row = f1b + ((size_t)yy * W + xx) * C;
      for (int c = lane; c < C; c += 32) d = fmaf(f0s[c], roma::to_f32(row[c]), d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    }
    if (lane == 0) dps[t] = d;
  }
  __syncwarp();

  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  T* o = out + q * K1 * K1;
  for (int k = lane; k < K1 * K1; k += 32) {
    const float* dp = dps + (k / K1) * P + k % K1;
    o[k] = roma::from_f32<T>(w00 * dp[0] + w01 * dp[1] + w10 * dp[P] + w11 * dp[P + 1]);
  }
}

}  // namespace

extern "C" int roma_local_corr(const void* f0, const void* f1, const void* warp, void* out,
                               int B, int H, int W, int C, int R, int dtype, void* stream) {
  if (R < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = (long long)B * H * W;
  const int P = 2 * R + 2;
  const size_t smem = (size_t)WARPS * (C + P * P) * sizeof(float);
  const unsigned blocks = (unsigned)((nq + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    cudaError_t err = roma::allow_smem(local_corr_kernel<scalar_t>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    local_corr_kernel<scalar_t><<<blocks, WARPS * 32, smem, s>>>(
        static_cast<const scalar_t*>(f0), static_cast<const scalar_t*>(f1),
        static_cast<const float*>(warp), static_cast<scalar_t*>(out), B, H, W, C, R);
  });
  return static_cast<int>(cudaGetLastError());
}
