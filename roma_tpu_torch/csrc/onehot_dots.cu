// Kernels K and L: the Hopper answers to tools/bench_onehot_dots.py's two
// questions about the windowed sampler.
//
// Kernel K replaces tools/bench_onehot_dots.py:_kern_f32 and :_kern_2bf16.
// Per tile i and query q the TPU kernels contract the whole (WH, CWW) window
// with a (WH, QS) one-hot matrix on the MXU and keep row 0, i.e.
//   o[i, 0, q] = (1 - fy) win[i, yl, 0] + fy win[i, yl + 1, 0]
// with a row outside [0, WH) contributing 0. The tool's Q1 asks whether one
// f32 weighted one-hot dot beats two exact bf16 0/1 dots with an f32 combine.
// On Hopper neither is a product: the two taps are direct loads through L1,
// as Kernel G reads its taps, so the full (CWW x QS) contraction (2.8e15 MACs
// at the tool's size) is never formed. The two entries keep the two numerical
// forms: the f32 entry accumulates the weighted taps as a dot does (fma), the
// 2bf16 entry takes the two exact picks and combines them t0 (1 - fy) + t1 fy
// with separately rounded products. What bounds it: bytes, the yl and fy it
// reads and o it writes (12 bytes a query) and one 32-byte sector per window
// row a tile touches; one thread per query, coalesced over q.
//
// Kernel L replaces tools/bench_onehot_dots.py:_dma_kernel: per tile i,
//   o[i] = sum_{r < WH, s < NS, x < XQC} tab[img_i, oy_i + r, jx_i + s, x]
// in f32, which the TPU kernel gets from a scalar-prefetched window DMA and a
// sum. What bounds it: bytes, the WH x NS x XQC bf16 window a tile reads.
// Design: a block per tile reads its own indices (the scalar prefetch's
// role); each window row is NS x XQC contiguous values (the jx + s are
// adjacent), read as 16-byte vectors by consecutive threads, summed in f32 in
// a fixed order per thread, then a warp-shuffle and a block reduction: no
// atomics, so the result does not depend on block order. A tile whose window
// leaves the table gets NaN (the plain version's answer too). A TMA-fed
// version, the real counterpart of the DMA, is later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int KT = 256, LT = 256;

template <bool TWO_BF16>
__global__ void __launch_bounds__(KT) onehot_dot_kernel(const __nv_bfloat16* __restrict__ win,
                                                        const int* __restrict__ yl,
                                                        const float* __restrict__ fy,
                                                        float* __restrict__ out, long long n,
                                                        int WH, int CWW, int T) {
  const long long idx = (long long)blockIdx.x * KT + threadIdx.x;
  if (idx >= n) return;
  const __nv_bfloat16* col = win + idx / T * WH * (long long)CWW;  // column 0 of the tile's window
  const int y = yl[idx];
  const float f = fy[idx];
  const float t0 = (y >= 0 && y < WH) ? __bfloat162float(col[(long long)y * CWW]) : 0.f;
  const float t1 = (y + 1 >= 0 && y + 1 < WH) ? __bfloat162float(col[(long long)(y + 1) * CWW]) : 0.f;
  if (TWO_BF16)
    out[idx] = __fadd_rn(__fmul_rn(t0, 1.f - f), __fmul_rn(t1, f));
  else
    out[idx] = fmaf(t1, f, fmaf(t0, 1.f - f, 0.f));
}

__global__ void __launch_bounds__(LT) window_sum_kernel(const __nv_bfloat16* __restrict__ tab,
                                                        const int* __restrict__ oy,
                                                        const int* __restrict__ jx,
                                                        const int* __restrict__ img,
                                                        float* __restrict__ out, int B, int HP,
                                                        int NJ, int XQC, int WH, int NS) {
  const int i = blockIdx.x;
  const int b = img[i], y = oy[i], j = jx[i];
  if (b < 0 || b >= B || y < 0 || y + WH > HP || j < 0 || j + NS > NJ) {
    if (threadIdx.x == 0) out[i] = nanf("");
    return;
  }
  const int row_vecs = NS * XQC / 8;  // 16-byte vectors in a window row
  const __nv_bfloat16* base = tab + (((long long)b * HP + y) * NJ + j) * XQC;
  const long long row_stride = (long long)NJ * XQC;
  float acc = 0.f;
  for (int e = threadIdx.x; e < WH * row_vecs; e += LT) {
    const int r = e / row_vecs, v = e % row_vecs;
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(base + r * row_stride + v * 8));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc += f.x;
      acc += f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float part[LT / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < LT / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) out[i] = s;
  }
}

}  // namespace

// win (NT, WH, CWW) bf16, yl int32 and fy f32 (NT, 1, T), out f32 (NT, 1, T)
extern "C" int roma_onehot_dot(const void* win, const void* yl, const void* fy, void* out, int NT,
                               int WH, int CWW, int T, int two_bf16, void* stream) {
  if (NT < 1 || WH < 1 || CWW < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)NT * T;
  const long long blocks = (n + KT - 1) / KT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(win);
  const auto* y = static_cast<const int*>(yl);
  const auto* f = static_cast<const float*>(fy);
  auto* o = static_cast<float*>(out);
  if (two_bf16)
    onehot_dot_kernel<true><<<static_cast<unsigned>(blocks), KT, 0, s>>>(w, y, f, o, n, WH, CWW, T);
  else
    onehot_dot_kernel<false><<<static_cast<unsigned>(blocks), KT, 0, s>>>(w, y, f, o, n, WH, CWW, T);
  return static_cast<int>(cudaGetLastError());
}

// tab (B, HP, NJ, XQC) bf16 with XQC % 8 == 0; oy, jx, img int32 (NT,);
// out f32 (NT,)
extern "C" int roma_window_sum(const void* tab, const void* oy, const void* jx, const void* img,
                               void* out, int NT, int B, int HP, int NJ, int XQC, int WH, int NS,
                               void* stream) {
  if (NT < 1 || B < 1 || HP < 1 || NJ < 1 || XQC < 8 || XQC % 8 != 0 || WH < 1 || NS < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  window_sum_kernel<<<NT, LT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(oy),
      static_cast<const int*>(jx), static_cast<const int*>(img), static_cast<float*>(out), B, HP,
      NJ, XQC, WH, NS);
  return static_cast<int>(cudaGetLastError());
}
