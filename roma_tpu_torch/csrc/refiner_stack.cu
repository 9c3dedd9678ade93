// Kernel D: one folded ConvRefiner block, launched once per block of a stack.
//
// Replaces roma_tpu/ops/pallas_refiner.py:_cmajor_kernel (entry
// fused_refiner_stack). A folded block (fold_block: BatchNorm folded into the
// depthwise conv, all f32) computes, with zero SAME padding,
//   t[c]   = round(relu(sum_{u,v} x[y+u-p, x+v-p, c] * dw[u, v, c] + db[c]))
//   out[d] = round(sum_c t[c] * w2[c, d] + b2[d])
// where round() is the I/O dtype, as the TPU kernel stores between stages.
//
// What bounds it on the H100: at the scale-1 shape (864^2 x C24, B=2) a block
// reads and writes ~72 MB each in bf16 against ~3.5 GFLOP of f32 FMAs, so
// memory and the CUDA cores' FMA rate are about even. Design: one block per 8x32 spatial tile, one thread per
// pixel. The tile plus a K/2-pixel halo is staged in shared memory
// channel-major (C, rows, cols) so neighbouring threads read neighbouring
// addresses; the folded weights sit in shared memory too. Each thread keeps
// its C depthwise outputs in registers (C <= 32, the routing bound of
// roma_tpu/models/matcher.py) and does the C x C pointwise product there,
// so the intermediate never reaches device memory.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 32, MAXC = 32;

template <typename T>
__global__ void __launch_bounds__(TH * TW) refiner_block_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H,
    int W, int C, int K) {
  extern __shared__ float sm[];
  const int p = K / 2, RH = TH + 2 * p, RW = TW + 2 * p;
  float* tile = sm;                // C x RH x RW
  float* dws = tile + C * RH * RW;  // K*K x C
  float* w2s = dws + K * K * C;     // C x C (in, out)
  float* dbs = w2s + C * C;
  float* b2s = dbs + C;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < C * RH * RW; i += TH * TW) {
    const int c = i % C, pix = i / C, r = pix / RW, col = pix % RW;
    const int gy = y0 + r - p, gx = x0 + col - p;
    tile[(c * RH + r) * RW + col] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                        ? roma::to_f32(xb[((size_t)gy * W + gx) * C + c])
                                        : 0.f;
  }
  for (int i = tid; i < K * K * C; i += TH * TW) dws[i] = dw[i];
  for (int i = tid; i < C * C; i += TH * TW) w2s[i] = w2[i];
  for (int i = tid; i < C; i += TH * TW) {
    dbs[i] = db[i];
    b2s[i] = b2[i];
  }
  __syncthreads();

  const int py = tid / TW, px = tid % TW;
  const int gy = y0 + py, gx = x0 + px;
  if (gy >= H || gx >= W) return;

  float t[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    t[c] = 0.f;
    if (c < C) {
      float acc = 0.f;
      const float* src = tile + (c * RH + py) * RW + px;
      for (int u = 0; u < K; ++u)
        for (int v = 0; v < K; ++v) acc = fmaf(src[u * RW + v], dws[(u * K + v) * C + c], acc);
      t[c] = roma::round_to<T>(fmaxf(acc + dbs[c], 0.f));
    }
  }
  T* o = out + (((size_t)b * H + gy) * W + gx) * C;
  for (int d = 0; d < C; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc = fmaf(t[c], w2s[c * C + d], acc);
    o[d] = roma::from_f32<T>(acc + b2s[d]);
  }
}

}  // namespace

extern "C" int roma_refiner_block(const void* x, const void* dw, const void* db, const void* w2,
                                  const void* b2, void* out, int B, int H, int W, int C, int K,
                                  int dtype, void* stream) {
  if (C < 1 || C > MAXC || K < 1 || K % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int p = K / 2;
  const size_t smem =
      ((size_t)C * (TH + 2 * p) * (TW + 2 * p) + K * K * C + C * C + 2 * C) * sizeof(float);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    cudaError_t err = roma::allow_smem(refiner_block_kernel<scalar_t>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    refiner_block_kernel<scalar_t><<<grid, TH * TW, smem, s>>>(
        static_cast<const scalar_t*>(x), static_cast<const float*>(dw),
        static_cast<const float*>(db), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<scalar_t*>(out), H, W, C, K);
  });
  return static_cast<int>(cudaGetLastError());
}
