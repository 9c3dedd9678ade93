// Kernels I and J: one folded wide-C ConvRefiner block per launch.
//
// Replace graveyard/pallas_refiner_lanemajor.py:_lane_kernel (I: NHWC) and
// graveyard/pallas_hcw_refiner.py:_block_kernel (J: (B, H, C, W)). A folded
// block (fold_block: BatchNorm folded into the depthwise conv, f32 weights)
// computes, with zero SAME padding,
//   t[c]   = round(relu(sum_{u,v} x[y+u-2, x+v-2, c] * dw[u, v, c] + db[c]))
//   out[d] = round(sum_c t[c] * round(w2[c, d]) + b2[d])
// where round() is the I/O dtype, with f32 accumulation, as the TPU kernels
// and roma_tpu/ops/pallas_refiner.py:refiner_stack_reference compute it.
//
// What bounds it on the H100: the 1x1 product, C^2 MACs a pixel against 25 C
// for the depthwise. In bf16 a block does C/2 operations a byte of its input
// and output, 72 to 689 at the released widths (C 144..1377) against the
// card's ~295 for bf16 tensor-core products: the product's rate bounds C >=
// 1137, bytes bound C = 144, C = 569 sits at the ridge. In f32 the product
// runs on the CUDA cores (as on the TPU, f32 x f32) and bounds every width.
//
// Design: a block owns an 8x8 pixel tile and TN output channels, and walks
// the input channels in steps of 32. Each step stages the step's 12x12 halo
// as f32 in shared memory (the loop runs along the layout's contiguous dim:
// channels for I, columns for J), computes depthwise + ReLU for the tile (one
// thread per tile row and channel, the 12 halo values of a row in
// registers), stores them rounded to the I/O dtype beside the step's slice of
// w2, and adds the 64 x TN product into registers: in f32 on the CUDA cores
// (TN = 64, a 4x4 tile a thread), in bf16 on the tensor cores with mma.sync
// m16n8k16 and f32 accumulation (TN = 128, a 32x32 tile a warp). Both operands
// are then exactly the rounded values above, so the tensor-core products are
// exact and only the summation order differs from the TPU's.
//
// Cost of the simple design: a block that owns TN of the C output channels
// recomputes the depthwise, and rereads the halo, once per TN tile, i.e.
// ceil(C / TN) times: 22x in f32 and 11x in bf16 at C = 1377, 3x and 2x at
// C = 144. That adds 25 ceil(C / TN) / C CUDA-core MACs per product MAC: 40%
// (f32) at C = 1377, 52% at C = 144, and in bf16 it is most of the CUDA-core
// work beside the tensor cores. Nothing is pipelined: a step's loads,
// depthwise and product run one after another between barriers.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int KS = 5, P = KS / 2;                 // depthwise size, halo
constexpr int TH = 8, TW = 8, TM = TH * TW;       // a block's pixel tile
constexpr int RH = TH + 2 * P, RW = TW + 2 * P;   // with its halo
constexpr int KC = 32;                            // input channels a step
constexpr int HS = RH * RW + 1;                   // halo channel stride (odd: conflict-free)
constexpr int NT = 256;                           // threads: one warp per tile row
static_assert(NT / 32 == TH && KC == 32, "the depthwise maps warps to tile rows, lanes to channels");

// element strides of (b, y, x, c) and the sizes
struct Dims {
  int H, W, C;
  long long sb, sy, sx, sc;
};

// f32 x f32 on the CUDA cores: 64 x 64 outputs, pixels tm + 16 i and
// channels 4 tn + j of a thread. t is [m][k], w is [k][n].
struct ProductF32 {
  using A = float;
  static constexpr int TN = 64;
  static constexpr int TS = KC + 1;  // t row stride (odd: conflict-free)
  static constexpr int WS = KC * TN;
  float acc[4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ static void store_t(A* ts, int m, int k, float v) { ts[m * TS + k] = v; }
  __device__ static void load_w(const float* __restrict__ w2, A* ws, int C, int k0, int n0) {
    for (int i = threadIdx.x; i < KC * TN; i += NT) {
      const int k = i / TN, n = i % TN;
      ws[i] = (k0 + k < C && n0 + n < C) ? w2[(long long)(k0 + k) * C + n0 + n] : 0.f;
    }
  }
  __device__ void step(const A* ts, const A* ws) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(ws + k * TN + 4 * tn);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = ts[(tm + 16 * i) * TS + k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }
  template <typename F>
  __device__ void each(F f) const {  // f(pixel, channel, sum)
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(tm + 16 * i, 4 * tn + j, acc[i][j]);
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16 x bf16 -> f32 on the tensor cores: 64 x 128 outputs, warp w owns
// pixels 32 (w % 2) .. +32 and channels 32 (w / 2) .. +32 as 2 x 4 m16n8
// tiles. t is [m][k] (the A operand, row-major), w is [n][k] (B, "col").
struct ProductBF16 {
  using A = __nv_bfloat16;
  static constexpr int TN = 128;
  static constexpr int TS = KC + 8;  // row stride of t and w: 80 bytes, conflict-free fragments
  static constexpr int WS = TN * TS;
  float acc[2][4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ static void store_t(A* ts, int m, int k, float v) { ts[m * TS + k] = __float2bfloat16(v); }
  __device__ static void load_w(const float* __restrict__ w2, A* ws, int C, int k0, int n0) {
    for (int i = threadIdx.x; i < KC * TN; i += NT) {
      const int k = i / TN, n = i % TN;
      ws[n * TS + k] = __float2bfloat16(
          (k0 + k < C && n0 + n < C) ? w2[(long long)(k0 + k) * C + n0 + n] : 0.f);
    }
  }
  __device__ void step(const A* ts, const A* ws) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int m0 = 32 * (warp % 2), n0 = 32 * (warp / 2);
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const A* p = ts + (m0 + 16 * mi + g) * TS + k + 2 * q;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * TS);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * TS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const A* p = ws + (n0 + 8 * ni + g) * TS + k + 2 * q;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float* d = acc[mi][ni];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]), "r"(b0), "r"(b1));
        }
      }
    }
  }
  template <typename F>
  __device__ void each(F f) const {  // the m16n8 accumulator layout
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int m0 = 32 * (warp % 2), n0 = 32 * (warp / 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(m0 + 16 * mi + g + 8 * (e / 2), n0 + 8 * ni + 2 * q + e % 2, acc[mi][ni][e]);
  }
};

template <typename T, bool CLAST>
__global__ void __launch_bounds__(NT) wide_block_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, Dims d) {
  using Prod = std::conditional_t<std::is_same<T, float>::value, ProductF32, ProductBF16>;
  using A = typename Prod::A;
  __shared__ float halo[KC * HS];
  __shared__ float dws[KS * KS * KC];
  __shared__ float dbs[KC];
  __shared__ __align__(16) A ts[TM * Prod::TS];
  __shared__ __align__(16) A ws[Prod::WS];

  const int tiles_x = (d.W + TW - 1) / TW;
  const int n0 = blockIdx.x * Prod::TN;
  const int y0 = (blockIdx.y / tiles_x) * TH, x0 = (blockIdx.y % tiles_x) * TW;
  const T* xb = x + blockIdx.z * d.sb;
  const int r = threadIdx.x / 32, c = threadIdx.x % 32;  // depthwise: tile row, channel
  Prod prod;
  prod.zero();

  for (int k0 = 0; k0 < d.C; k0 += KC) {
    for (int i = threadIdx.x; i < KC * RH * RW; i += NT) {
      int cc, rr, col;
      if (CLAST) {
        cc = i % KC;
        rr = i / KC / RW;
        col = i / KC % RW;
      } else {
        col = i % RW;
        rr = i / RW % RH;
        cc = i / (RW * RH);
      }
      const int gy = y0 + rr - P, gx = x0 + col - P, gc = k0 + cc;
      halo[cc * HS + rr * RW + col] = (gy >= 0 && gy < d.H && gx >= 0 && gx < d.W && gc < d.C)
                                          ? roma::to_f32(xb[gy * d.sy + gx * d.sx + gc * d.sc])
                                          : 0.f;
    }
    for (int i = threadIdx.x; i < KS * KS * KC; i += NT) {
      const int t = i / KC, cc = i % KC;
      dws[i] = k0 + cc < d.C ? dw[(long long)t * d.C + k0 + cc] : 0.f;
    }
    if (threadIdx.x < KC) dbs[threadIdx.x] = k0 + threadIdx.x < d.C ? db[k0 + threadIdx.x] : 0.f;
    Prod::load_w(w2, ws, d.C, k0, n0);
    __syncthreads();

    float acc[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[j] = 0.f;
    const float* src = halo + c * HS + r * RW;
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      float row[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) row[j] = src[u * RW + j];
#pragma unroll
      for (int v = 0; v < KS; ++v) {
        const float wt = dws[(u * KS + v) * KC + c];
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[j] = fmaf(row[j + v], wt, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TW; ++j) Prod::store_t(ts, r * TW + j, c, fmaxf(acc[j] + dbs[c], 0.f));
    __syncthreads();

    prod.step(ts, ws);
    __syncthreads();
  }

  T* ob = out + blockIdx.z * d.sb;
  prod.each([&](int m, int n, float v) {
    const int gy = y0 + m / TW, gx = x0 + m % TW, gn = n0 + n;
    if (gy < d.H && gx < d.W && gn < d.C)
      ob[gy * d.sy + gx * d.sx + gn * d.sc] = roma::from_f32<T>(v + b2[gn]);
  });
}

}  // namespace

// layout 0: x and out are (B, H, W, C) (Kernel I); 1: (B, H, C, W) (Kernel J)
extern "C" int roma_wide_refiner_block(const void* x, const void* dw, const void* db, const void* w2,
                                       const void* b2, void* out, int B, int H, int W, int C,
                                       int layout, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{H, W, C, (long long)H * W * C, 0, 0, 0};
  if (layout == 0) {
    d.sy = (long long)W * C, d.sx = C, d.sc = 1;
  } else {
    d.sy = (long long)C * W, d.sx = 1, d.sc = W;
  }
  const int tn = dtype == 0 ? ProductF32::TN : ProductBF16::TN;
  const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((C + tn - 1) / tn, static_cast<unsigned>(tiles), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    const scalar_t* xs = static_cast<const scalar_t*>(x);
    scalar_t* os = static_cast<scalar_t*>(out);
    const float *dwf = static_cast<const float*>(dw), *dbf = static_cast<const float*>(db),
                *w2f = static_cast<const float*>(w2), *b2f = static_cast<const float*>(b2);
    if (layout == 0)
      wide_block_kernel<scalar_t, true><<<grid, NT, 0, s>>>(xs, dwf, dbf, w2f, b2f, os, d);
    else
      wide_block_kernel<scalar_t, false><<<grid, NT, 0, s>>>(xs, dwf, dbf, w2f, b2f, os, d);
  });
  return static_cast<int>(cudaGetLastError());
}
