// Kernels K and L: the Hopper answers to tools/bench_onehot_dots.py's two
// questions about the windowed sampler.
//
// Kernel K replaces tools/bench_onehot_dots.py:_kern_f32 and :_kern_2bf16.
// Per tile i and query q the TPU kernels contract the whole (WH, CWW) window
// with a (WH, QS) one-hot matrix on the MXU and keep row 0, i.e.
//   o[i, 0, q] = (1 - fy) win[i, yl, 0] + fy win[i, yl + 1, 0]
// with a row outside [0, WH) contributing 0. On Hopper neither form is a
// product: the full (CWW x QS) contraction (2.8e15 MACs at the tool's size)
// is never formed. The two entries keep the two numerical forms: the f32
// entry accumulates the weighted taps as a dot does (fma), the 2bf16 entry
// takes the two exact picks and combines them t0 (1 - fy) + t1 fy with
// separately rounded products, the plain version's bits. What bounds it:
// bytes, the yl and fy it reads and o it writes (12 bytes a query), and one
// 32-byte sector per window row of column 0. Design: a block owns a chunk of
// KCHUNK queries of one tile (no per-query division) and stages the tile's
// column 0 in shared memory once, as f32 (WH scattered 2-byte loads, one
// sector a row). On the vector path (T % 4 == 0, 16-byte bases) a thread
// first issues the loads of its KV groups of 4 queries (an int4 of yl and a
// float4 of fy each), then helps stage the column, then writes each group
// by one float4 store; measured on an H100 at the tool's sizes, 1.2%
// faster than staging the column first and 3% faster than a thread a
// query. The scalar path (any T) takes a query a thread.
//
// Kernel L replaces tools/bench_onehot_dots.py:_dma_kernel: per tile i,
//   o[i] = sum_{r < WH, s < NS, x < XQC} tab[img_i, oy_i + r, jx_i + s, x]
// in f32, which the TPU kernel gets from a scalar-prefetched window DMA and a
// sum. What bounds it: bytes, each table row some window covers read once.
// The windows overlap (at the tool's sizes each covered byte lies in ~11 of
// them), and every window is a union of whole table rows (b, y, j), so L
// sums each row once and then adds up each tile's row sums, in two phases
// with no atomics (the result does not depend on block order):
//  1. row sums, rowsum[b, y, j] = sum_x tab[b, y, j, x] in f32, into a
//     scratch the wrapper allocates, for the rows some window covers: the
//     scratch zeroed, a marking pass flags each covered row (a thread a
//     window row), then a warp a flagged row sums it by 16-byte __ldg loads,
//     L_UNROLL in flight a lane. Measured on an H100 at the tool's sizes this
//     beat summing every row (no marking pass, 17% more bytes; kernel_variants'
//     l_all_rows) by 4% and a ring of cp.async.bulk row copies into shared
//     memory by 7%.
//  2. tile sums, a warp a tile adding its WH x NS row sums in a fixed order
//     (the scratch stays in L2); a window that leaves the table gives NaN,
//     as the plain version does.
// A lane adds its values in order and a warp joins its lanes by a fixed
// xor-shuffle tree, in both phases.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// --- Kernel K ------------------------------------------------------------
constexpr int KT = 256;       // threads a block
constexpr int KCHUNK = 4096;  // queries a block (a multiple of 4)

// a query's two taps from the staged column (a row outside [0, WH) gives 0),
// combined as the entry's form does
template <bool TWO_BF16>
__device__ __forceinline__ float pick(const float* col, unsigned wh, int y, float f) {
  const unsigned u = static_cast<unsigned>(y);
  const float t0 = u < wh ? col[u] : 0.f;
  const float t1 = u + 1u < wh ? col[u + 1u] : 0.f;  // y = -1: u + 1 wraps to row 0
  if (TWO_BF16) return __fadd_rn(__fmul_rn(t0, 1.f - f), __fmul_rn(t1, f));
  return fmaf(t1, f, fmaf(t0, 1.f - f, 0.f));
}

constexpr int KV = KCHUNK / (4 * KT);  // vector path: 16-byte vectors of yl (and of fy) a thread

template <bool TWO_BF16, bool VEC>
__global__ void __launch_bounds__(KT) onehot_dot_kernel(const __nv_bfloat16* __restrict__ win,
                                                        const int* __restrict__ yl,
                                                        const float* __restrict__ fy,
                                                        float* __restrict__ out, int WH, int CWW,
                                                        int T, int chunks) {
  extern __shared__ float col[];  // column 0 of the tile's window, WH values
  const int tile = blockIdx.x / chunks;
  const int q0 = (blockIdx.x - tile * chunks) * KCHUNK;
  const int q1 = min(T, q0 + KCHUNK);
  const __nv_bfloat16* c0 = win + (long long)tile * WH * CWW;
  const long long base = (long long)tile * T;
  const int* y = yl + base;
  const float* f = fy + base;
  float* o = out + base;
  if (VEC) {
    // base and q0 are multiples of 4, so every access is 16-byte aligned; a
    // thread's KV vectors of yl and fy are in flight while the column is
    // staged
    int4 yv[KV];
    float4 fv[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int q = q0 + 4 * (threadIdx.x + k * KT);
      if (q < q1) {
        yv[k] = __ldg(reinterpret_cast<const int4*>(y + q));
        fv[k] = __ldg(reinterpret_cast<const float4*>(f + q));
      }
    }
    for (int r = threadIdx.x; r < WH; r += KT) col[r] = __bfloat162float(c0[(long long)r * CWW]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int q = q0 + 4 * (threadIdx.x + k * KT);
      if (q < q1) {
        float4 ov;
        ov.x = pick<TWO_BF16>(col, WH, yv[k].x, fv[k].x);
        ov.y = pick<TWO_BF16>(col, WH, yv[k].y, fv[k].y);
        ov.z = pick<TWO_BF16>(col, WH, yv[k].z, fv[k].z);
        ov.w = pick<TWO_BF16>(col, WH, yv[k].w, fv[k].w);
        *reinterpret_cast<float4*>(o + q) = ov;
      }
    }
  } else {
    for (int r = threadIdx.x; r < WH; r += KT) col[r] = __bfloat162float(c0[(long long)r * CWW]);
    __syncthreads();
    for (int q = q0 + threadIdx.x; q < q1; q += KT) o[q] = pick<TWO_BF16>(col, WH, __ldg(y + q), __ldg(f + q));
  }
}

template <bool TWO_BF16, bool VEC>
cudaError_t launch_onehot(const void* win, const void* yl, const void* fy, void* out, int blocks, int WH,
                          int CWW, int T, int chunks, cudaStream_t s) {
  onehot_dot_kernel<TWO_BF16, VEC><<<blocks, KT, WH * sizeof(float), s>>>(
      static_cast<const __nv_bfloat16*>(win), static_cast<const int*>(yl), static_cast<const float*>(fy),
      static_cast<float*>(out), WH, CWW, T, chunks);
  return cudaGetLastError();
}

// --- Kernel L ------------------------------------------------------------
constexpr int LW = 8;  // warps a block
constexpr int LT = 32 * LW;
constexpr int L_UNROLL = 8;  // phase 1: 16-byte loads a lane issues before it adds

// acc plus the 8 bf16 values of a 16-byte vector, in order
__device__ __forceinline__ float add8(float acc, const uint4& q) {
  float f[8];
  roma::unpack16(q, f, __nv_bfloat16());
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += f[i];
  return acc;
}

// the sum of a warp's 32 values, the same on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool in_table(int b, int y, int j, int B, int HP, int NJ, int WH, int NS) {
  return b >= 0 && b < B && y >= 0 && y <= HP - WH && j >= 0 && j <= NJ - NS;
}

// the marking pass: a thread a window row (r, s) of a tile flags its table
// row with 1 (the scratch was zeroed); a window off the table flags nothing
__global__ void __launch_bounds__(LT) mark_rows_kernel(const int* __restrict__ oy, const int* __restrict__ jx,
                                                       const int* __restrict__ img, float* __restrict__ rowsum,
                                                       long long n, int B, int HP, int NJ, int WH, int NS) {
  const long long e = (long long)blockIdx.x * LT + threadIdx.x;
  if (e >= n) return;
  const int i = static_cast<int>(e / (WH * NS)), rs = static_cast<int>(e % (WH * NS));
  const int b = img[i], y = oy[i], j = jx[i];
  if (!in_table(b, y, j, B, HP, NJ, WH, NS)) return;
  rowsum[((long long)b * HP + y + rs / NS) * NJ + j + rs % NS] = 1.f;
}

// phase 1: a warp sums table row `row` (nv 16-byte vectors), lane l taking
// vectors l, l + 32, ..., all its loads issued before it adds; a row the
// marking pass left at 0 is skipped
__global__ void __launch_bounds__(LT) row_sum_kernel(const uint4* __restrict__ tab, float* __restrict__ rowsum,
                                                     long long nrows, int nv) {
  const long long row = (long long)blockIdx.x * LW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nrows || rowsum[row] == 0.f) return;
  const uint4* p = tab + row * nv;
  float acc = 0.f;
  for (int v0 = 0; v0 < nv; v0 += 32 * L_UNROLL) {
    uint4 q[L_UNROLL];
#pragma unroll
    for (int k = 0; k < L_UNROLL; ++k) {
      const int v = v0 + 32 * k + lane;
      q[k] = v < nv ? __ldg(p + v) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < L_UNROLL; ++k) acc = add8(acc, q[k]);
  }
  acc = warp_sum(acc);
  if (lane == 0) rowsum[row] = acc;
}

// phase 2: a warp adds tile i's WH x NS row sums, lane l taking window rows
// l, l + 32, ... (s fastest), in a fixed order
__global__ void __launch_bounds__(LT) tile_sum_kernel(const float* __restrict__ rowsum, const int* __restrict__ oy,
                                                      const int* __restrict__ jx, const int* __restrict__ img,
                                                      float* __restrict__ out, int NT, int B, int HP, int NJ,
                                                      int WH, int NS) {
  const int i = blockIdx.x * LW + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= NT) return;
  const int b = img[i], y = oy[i], j = jx[i];
  if (!in_table(b, y, j, B, HP, NJ, WH, NS)) {
    if (lane == 0) out[i] = nanf("");
    return;
  }
  const float* p = rowsum + ((long long)b * HP + y) * NJ + j;
  float acc = 0.f;
#pragma unroll 4
  for (int e = lane; e < WH * NS; e += 32) {
    const int r = e / NS;
    acc += p[(long long)r * NJ + e - r * NS];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[i] = acc;
}

}  // namespace

// win (NT, WH, CWW) bf16, yl int32 and fy f32 (NT, 1, T), out f32 (NT, 1, T);
// vec: 4 queries a thread (T % 4 == 0, yl, fy and out 16-byte aligned);
// T at most INT_MAX - KCHUNK, so a chunk's query indices stay ints
extern "C" int roma_onehot_dot(const void* win, const void* yl, const void* fy, void* out, int NT, int WH,
                               int CWW, int T, int two_bf16, int vec, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(yl) | reinterpret_cast<uintptr_t>(fy) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (NT < 1 || WH < 1 || CWW < 1 || T < 1 || T > 0x7fffffff - KCHUNK || (vec && (T % 4 || !aligned)) ||
      WH * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (T + KCHUNK - 1) / KCHUNK;
  const long long blocks = (long long)NT * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  cudaError_t err;
  if (two_bf16)
    err = vec ? launch_onehot<true, true>(win, yl, fy, out, nb, WH, CWW, T, chunks, s)
              : launch_onehot<true, false>(win, yl, fy, out, nb, WH, CWW, T, chunks, s);
  else
    err = vec ? launch_onehot<false, true>(win, yl, fy, out, nb, WH, CWW, T, chunks, s)
              : launch_onehot<false, false>(win, yl, fy, out, nb, WH, CWW, T, chunks, s);
  return static_cast<int>(err);
}

// tab (B, HP, NJ, XQC) bf16 with XQC % 8 == 0 and a 16-byte base; oy, jx, img
// int32 (NT,); rowsum f32 (B * HP * NJ,) scratch; out f32 (NT,)
extern "C" int roma_window_sum(const void* tab, const void* oy, const void* jx, const void* img, void* rowsum,
                               void* out, int NT, int B, int HP, int NJ, int XQC, int WH, int NS, void* stream) {
  if (NT < 1 || B < 1 || HP < 1 || NJ < 1 || XQC < 8 || XQC % 8 != 0 || WH < 1 || NS < 1 ||
      (long long)WH * NS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = (long long)B * HP * NJ;
  const long long row_blocks = (nrows + LW - 1) / LW;
  const long long n = (long long)NT * WH * NS;
  const long long mark_blocks = (n + LT - 1) / LT;
  if (row_blocks > 0x7fffffffLL || mark_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(rowsum);
  const auto* y = static_cast<const int*>(oy);
  const auto* j = static_cast<const int*>(jx);
  const auto* b = static_cast<const int*>(img);
  cudaError_t err = cudaMemsetAsync(rs, 0, nrows * sizeof(float), s);
  if (err) return static_cast<int>(err);
  mark_rows_kernel<<<static_cast<unsigned>(mark_blocks), LT, 0, s>>>(y, j, b, rs, n, B, HP, NJ, WH, NS);
  row_sum_kernel<<<static_cast<unsigned>(row_blocks), LT, 0, s>>>(static_cast<const uint4*>(tab), rs, nrows,
                                                                  XQC / 8);
  tile_sum_kernel<<<(NT + LW - 1) / LW, LT, 0, s>>>(rs, y, j, b, static_cast<float*>(out), NT, B, HP, NJ, WH,
                                                    NS);
  return static_cast<int>(cudaGetLastError());
}
