// Kernel C: exact bilinear grid sample of an NHWC feature map.
//
// Replaces roma_tpu/ops/lane_warp.py:_lane_kernel (entry lane_warp, via the
// warp_sample dispatcher): grid_sample(y, flow) with bilinear weights, zeros
// padding, align_corners=False, ix = (x + 1) * W / 2 - 0.5 as
// roma_tpu/ops/tile_window.py. Output is (B, Hq, Wq, C) in y's dtype.
//
// What bounds it on the H100: bytes. Each output element reads four taps and
// does seven FMAs; at the scale-1 shape (864^2 x C9, B=2) the whole call
// moves ~0.1 GB. The TPU kernel's windows, lane packing and miss fixups
// exist because the TPU has no fast gather; the H100 gathers through L1/L2.
// Design: one thread per output element (query, channel), so consecutive
// threads read consecutive channels of each tap and write consecutive
// outputs; the four taps combine in f32 in the order of the TPU package's
// corner-packed gather.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) warp_sample_kernel(
    const T* __restrict__ y, const float* __restrict__ flow, T* __restrict__ out, int B,
    int H, int W, int C, int Hq, int Wq) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Hq * Wq * C) return;
  const int c = (int)(idx % C);
  const long long q = idx / C;
  const int b = (int)(q / ((long long)Hq * Wq));

  const float ix = (flow[2 * q] + 1.f) * (float)W / 2.f - 0.5f;
  const float iy = (flow[2 * q + 1] + 1.f) * (float)H / 2.f - 0.5f;
  const float x0f = floorf(ix), y0f = floorf(iy);
  const float fx = ix - x0f, fy = iy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;

  const T* yb = y + (size_t)b * H * W * C + c;
  auto tap = [&](int yy, int xx) -> float {
    return (yy >= 0 && yy < H && xx >= 0 && xx < W)
               ? roma::to_f32(yb[((size_t)yy * W + xx) * C])
               : 0.f;
  };
  const float r = tap(y0, x0) * ((1.f - fy) * (1.f - fx)) + tap(y0, x0 + 1) * ((1.f - fy) * fx) +
                  tap(y0 + 1, x0) * (fy * (1.f - fx)) + tap(y0 + 1, x0 + 1) * (fy * fx);
  out[idx] = roma::from_f32<T>(r);
}

}  // namespace

extern "C" int roma_warp_sample(const void* y, const void* flow, void* out, int B, int H,
                                int W, int C, int Hq, int Wq, int dtype, void* stream) {
  const long long total = (long long)B * Hq * Wq * C;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    warp_sample_kernel<scalar_t><<<blocks, 256, 0, s>>>(
        static_cast<const scalar_t*>(y), static_cast<const float*>(flow),
        static_cast<scalar_t*>(out), B, H, W, C, Hq, Wq);
  });
  return static_cast<int>(cudaGetLastError());
}
