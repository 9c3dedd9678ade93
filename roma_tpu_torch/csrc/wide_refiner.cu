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
// The 8x8-tile kernel (Kernels I and J in f32): a block
// owns an 8x8 pixel tile and TN output channels, and walks the input
// channels in steps of 32. Each step stages the step's 12x12 halo as f32 in
// shared memory (the loop runs along the layout's contiguous dim: channels
// for I, columns for J), computes depthwise + ReLU for the tile (one thread
// per tile row and channel, the 12 halo values of a row in registers),
// stores them rounded to the I/O dtype beside the step's slice of w2, and
// adds the 64 x TN product into registers: in f32 on the CUDA cores (TN =
// 64, a 4x4 tile a thread), in bf16 on the tensor cores with mma.sync
// m16n8k16 and f32 accumulation (TN = 128, a 32x32 tile a warp). Both
// operands are then exactly the rounded values above, so the tensor-core
// products are exact and only the summation order differs from the TPU's.
// Its cost: a block that owns TN of the C output channels recomputes the
// depthwise, and rereads the halo, once per TN tile, i.e. ceil(C / TN)
// times (11x in bf16 at C = 1377), which in bf16 is most of its CUDA-core
// work; w2 is read as f32 and rounded again by every block at every step,
// and nothing is pipelined.
//
// The tensor-core kernel (Kernel J in bf16, hcw_tc_kernel) computes what
// the TPU kernel computes: the depthwise once per pixel, then one
// (C, C) @ (C, N) product for a block's N pixels: NR image rows of WT
// columns, as many as t fits beside the pipelines (launch_hcw_tc: 4 x 64 at
// C = 144, 2 x 64 at 569, 2 x 32 at 1137, 1 x 32 at 1377). The product's
// time follows the w2 tiles a block streams (it did not move with the
// ring's depth), so more pixels a block is fewer w2 tiles a pixel; it is
// also more output rows for each staged input row.
//   * Phase 1, the depthwise for all C channels of the block's pixels, once:
//     in chunks of 1024 / WT channels, the NR + 4 input rows of each channel
//     over WT + 4 columns (runs of 2 (WT + 4) bytes along W) are staged by a
//     warp a row, DEPTH - 1 chunks ahead: by 8-byte cp.async copies
//     where W % 4 == 0 (from column x0 - 4), 4-byte copies of element pairs
//     where W is even, plain loads issued together where it is odd. A thread
//     computes 4 columns of one channel in all NR rows (each staged row read
//     once, for up to 5 output rows; its 25 taps and bias loaded a chunk
//     ahead), adds the bias, ReLU, rounds to bf16 and stores t[c][pixel]
//     into shared memory in the layout the product reads (rows padded by 16
//     bytes for ldmatrix).
//   * Phase 2, out[d, p] = sum_c w2r[d, c] t[c, p] on the tensor cores
//     (mma.sync m16n8k16, f32 accumulation; t by ldmatrix.trans): 8 warps
//     of 32 x 32 output tiles, an M-chunk of 256 / (N / 32) output channels
//     at a time. w2r is w2^T rounded to bf16 once and kept beside the folded
//     block (ops/wide_refiner.py:block_w2t), zero-padded, so its tiles of 64
//     input channels (48 at C <= 336) stream through a cp.async ring of
//     16-byte copies with no bounds; a stage's fragments are all loaded
//     before its products. The ring and the staged chunks share one region
//     of shared memory. The epilogue adds the bias, rounds once and stores
//     along W (bf16 pairs for an even W; rows of the released widths 35, 70,
//     108 and 140 do not start on 16 bytes, so no wider store). A warp skips
//     the pixels past the image's last row and column.
//   * A block computes every output channel of its pixels: splitting them
//     over blocks to fill the 132 SMs at s16 (140 blocks) recomputes the
//     depthwise a split, and measured no faster there and slower at s8.
//
// Kernel I in bf16 (nhwc_tc_kernel) runs the same two phases on NHWC; see
// the note above it.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// Kernel J in bf16: the depthwise once per pixel, the product on the tensor
// cores (see the note at the top).

using tc::bf16;

// buffers of each phase's cp.async pipeline (3 measured ~1.5% faster than 6)
constexpr int DEPTH = 3;
// the wrapper pads w2^T (out, in) with zeros to multiples of these (W2_COLS:
// a multiple of every KC, so a w2 tile lies inside)
constexpr int W2_ROWS = 256, W2_COLS = 192;

// A block's pixels: NR image rows of WT columns, N = NR WT in all. 8 warps
// as WM (output channels) x WN (pixels), each a 32 x 32 tile of m16n8k16
// products; a warp's 32 pixels lie in one image row. KC input channels a w2
// tile (a ring stage).
template <int WT_, int NR_, int KC_>
struct Hcw {
  static constexpr int WT = WT_, NR = NR_, KC = KC_;
  static constexpr int N = NR * WT;
  static constexpr int WN = N / 32, WM = 8 / WN, MB = 32 * WM;  // MB output channels an M-chunk
  static constexpr int DC = 1024 / WT;  // channels a depthwise chunk: a thread a (channel, 4 columns)
  static constexpr int R = 4;           // depthwise columns a thread (all NR rows)
  static constexpr int JN = WT / R;     // threads a channel
  static constexpr int SR = NR + 2 * P;  // staged rows a channel
  static constexpr int SW = WT + 8;     // a staged row: WT + 4 (or WT + 8) columns, 16-byte multiple
  static constexpr int TS = N + 8;      // a row of t (ldmatrix: conflict-free)
  static constexpr int RS = KC + 8;     // a row of a w2 tile
  static constexpr int ROWS = DC * SR / (NT / 32);  // staged rows a warp
  static constexpr int PASSES = (WT + 2 * P + 31) / 32;  // lanes' passes over a staged row of elements
  static constexpr int STAGE = MB * RS;      // elements of a w2 tile
  static constexpr int CHUNK = DC * SR * SW;  // elements of a staged chunk
  static_assert(WN * WM == 8 && DC * JN == NT && W2_ROWS % MB == 0 && ROWS * (NT / 32) == DC * SR &&
                    W2_COLS % KC == 0 && KC % 16 == 0, "tiles");
  // t's rows: C rounded up to KC (the product's k), then to DC (phase 1)
  __host__ __device__ static int t_rows(int C) {
    const int kp = (C + KC - 1) / KC * KC;
    return (kp + DC - 1) / DC * DC;
  }
};

// the shared memory: t, then one region that holds DEPTH staged chunks in
// phase 1 and DEPTH w2 tiles in phase 2
template <class K>
size_t smem_hcw(int C) {
  return 2 * ((size_t)K::t_rows(C) * K::TS + DEPTH * std::max(K::STAGE, K::CHUNK));
}

// 8 bytes global -> shared without passing through registers; ok = false
// reads nothing and writes zeros
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(tc::smem_addr(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

// x (B, H, C, W), w2p the zero-padded bf16 w2^T (rows: output channels,
// row stride ldw >= kp), out (B, H, C, W). Block blockIdx.x: image rows y0 .. y0 +
// NR of image b, columns x0 .. x0 + WT, all output channels. V: the
// elements of one staging copy, the most that W allows (W % 4 == 0: 4, by
// 8-byte cp.async from column x0 - 4; W even: 2, by 4-byte cp.async from
// x0 - 2; else 1, by plain loads issued together); W is then a multiple of
// V, so a copy is on the image or off it as a whole.
template <class K, int V>
__global__ void __launch_bounds__(NT, 1) hcw_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const bf16* __restrict__ w2p, const float* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C,
    int ldw, int nseg, int nrb) {
  constexpr int WT = K::WT, NR = K::NR, KC = K::KC;
  constexpr int OFF = V == 4 ? 4 : P;  // staged column s is image column x0 - OFF + s
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = (C + KC - 1) / KC * KC, kt = K::t_rows(C);
  bf16* ts = reinterpret_cast<bf16*>(smem);  // t [kt][TS]: rows input channels, cols pixels (row-major)
  bf16* reg = ts + kt * K::TS;               // phase 1: [DEPTH][DC * SR rows][SW]; phase 2: [DEPTH][MB][RS]

  const int seg = blockIdx.x % nseg, rb = blockIdx.x / nseg % nrb, b = blockIdx.x / nseg / nrb;
  const int x0 = seg * WT, y0 = rb * NR;
  const int nm = (C + K::MB - 1) / K::MB, nk = kp / KC, nst = nm * nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Phase 1: t for all kp channels of the block's pixels, once. Staged row
  // r = (cc, u) of chunk c0 holds image row y0 + u - 2 of channel c0 + cc,
  // columns x0 - OFF .. x0 + WT + OFF (zeros off the image and past C).
  const bf16* xb = x + b * H * C * W;
  auto load_x = [&](int c0, bf16* buf) {
    if constexpr (V > 1) {
#pragma unroll
      for (int k = 0; k < K::ROWS; ++k) {
        const int r = warp + k * (NT / 32), gy = y0 + r % K::SR - P, gc = c0 + r / K::SR;
        const bool rok = gy >= 0 && gy < H && gc < C;
        const bf16* src = xb + (rok ? (gy * C + gc) * W : 0) + x0 - OFF;
        for (int p = lane; p < (WT + 2 * OFF) / V; p += 32) {
          const int gx = x0 - OFF + V * p;
          const bool ok = rok && gx >= 0 && gx < W;
          if constexpr (V == 4)
            cp8(buf + r * K::SW + V * p, ok ? src + V * p : xb, ok);
          else
            tc::cp4(buf + r * K::SW + V * p, ok ? src + V * p : xb, ok);
        }
      }
    } else {  // all loads of the chunk first, then the stores
      bf16 v[K::ROWS][K::PASSES];
#pragma unroll
      for (int k = 0; k < K::ROWS; ++k) {
        const int r = warp + k * (NT / 32), gy = y0 + r % K::SR - P, gc = c0 + r / K::SR;
        const bool rok = gy >= 0 && gy < H && gc < C;
        const bf16* src = xb + (rok ? (gy * C + gc) * W : 0) + x0 - P;
#pragma unroll
        for (int p = 0; p < K::PASSES; ++p) {
          const int s = lane + 32 * p, gx = x0 - P + s;
          v[k][p] = rok && s < WT + 2 * P && gx >= 0 && gx < W ? src[s] : __float2bfloat16(0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < K::ROWS; ++k)
#pragma unroll
        for (int p = 0; p < K::PASSES; ++p)
          if (lane + 32 * p < WT + 2 * P) buf[(warp + k * (NT / 32)) * K::SW + lane + 32 * p] = v[k][p];
    }
  };
  // a thread: channel dc of each chunk, columns R dj .. of all NR rows; its
  // 25 taps and bias are loaded a chunk ahead
  const int dc = threadIdx.x / K::JN, dj = threadIdx.x % K::JN;
  auto weights = [&](int c0, float (&w)[KS * KS + 1]) {
    const int c = c0 + dc;
#pragma unroll
    for (int t = 0; t < KS * KS; ++t) w[t] = c < C ? __ldg(dw + t * C + c) : 0.f;
    w[KS * KS] = c < C ? __ldg(db + c) : 0.f;
  };
  const int nch = kt / K::DC;
  for (int j = 0; j < DEPTH - 1; ++j) {
    if (j < nch) load_x(j * K::DC, reg + j * K::CHUNK);
    tc::cp_commit();
  }
  float wnext[KS * KS + 1];
  weights(0, wnext);
  int slot = 0;  // chunk ch's buffer, ch % DEPTH
  for (int ch = 0; ch < nch; ++ch) {
    tc::cp_wait<DEPTH - 2>();  // chunk ch has landed
    __syncthreads();           // ... for every thread, and chunk ch - 1's buffer is free
    const int c0 = ch * K::DC;
    if (ch + DEPTH - 1 < nch) load_x(c0 + (DEPTH - 1) * K::DC, reg + (slot == 0 ? DEPTH - 1 : slot - 1) * K::CHUNK);
    tc::cp_commit();
    float w[KS * KS + 1];
#pragma unroll
    for (int t = 0; t <= KS * KS; ++t) w[t] = wnext[t];
    if (ch + 1 < nch) weights(c0 + K::DC, wnext);

    const bool live = c0 + dc < C && x0 + dj * K::R < W;
    float acc[NR][K::R];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < K::R; ++i) acc[r][i] = 0.f;
    if (live) {
      const bf16* src = reg + slot * K::CHUNK + dc * K::SR * K::SW + dj * K::R + OFF - P;
#pragma unroll
      for (int sr = 0; sr < K::SR; ++sr) {  // each staged row feeds up to 5 output rows
        float row[K::R + 2 * P];
        uint32_t wd[(K::R + 2 * P) / 2];
#pragma unroll
        for (int k = 0; k < (K::R + 2 * P) / 2; ++k)  // 4-byte shared loads (pairs on 4 bytes)
          wd[k] = reinterpret_cast<const uint32_t*>(src + sr * K::SW)[k];
#pragma unroll
        for (int i = 0; i < K::R + 2 * P; ++i) row[i] = roma::Elem<bf16>::get(wd, i);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int u = sr - r;
          if (u < 0 || u >= KS) continue;
#pragma unroll
          for (int v = 0; v < KS; ++v)
#pragma unroll
            for (int i = 0; i < K::R; ++i) acc[r][i] = fmaf(row[i + v], w[u * KS + v], acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      uint2 tv = make_uint2(0u, 0u);  // past C (w2p is zero there) or past the image's last column
      if (live)
        tv = make_uint2(roma::pack_bf16(fmaxf(acc[r][0] + w[KS * KS], 0.f), fmaxf(acc[r][1] + w[KS * KS], 0.f)),
                        roma::pack_bf16(fmaxf(acc[r][2] + w[KS * KS], 0.f), fmaxf(acc[r][3] + w[KS * KS], 0.f)));
      *reinterpret_cast<uint2*>(ts + (c0 + dc) * K::TS + r * WT + dj * K::R) = tv;
    }
    slot = slot + 1 == DEPTH ? 0 : slot + 1;
  }
  __syncthreads();  // t is complete, and the staged chunks' region is free for the ring

  // Phase 2: out[d, p] = sum_c w2p[d, c] t[c, p] + b2[d] for each M-chunk,
  // w2 tiles streamed through the cp.async ring, the sum in f32 registers.
  // Ring stage i: M-chunk i / nk, input channels (i % nk) KC .., in buffer
  // i % DEPTH; the loads run DEPTH - 1 tiles ahead (counters, no divisions
  // in the loop).
  int l_slot = 0, l_k = 0, l_m = 0;  // the next tile to load
  auto load_next = [&]() {
    bf16* dst = reg + l_slot * K::STAGE;
    const bf16* src = w2p + (l_m * K::MB) * ldw + l_k * KC;
#pragma unroll
    for (int j = threadIdx.x; j < K::MB * KC / 8; j += NT) {
      const int r = j / (KC / 8), c = j % (KC / 8) * 8;
      tc::cp16(dst + r * K::RS + c, src + r * ldw + c, true);
    }
    l_slot = l_slot + 1 == DEPTH ? 0 : l_slot + 1;
    if (++l_k == nk) l_k = 0, ++l_m;
  };
  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < nst) load_next();
    tc::cp_commit();
  }
  const int g = lane / 4, q = lane % 4, wm = warp % K::WM, wn = warp / K::WM;
  const int yr = y0 + 32 * wn / WT, xw = x0 + 32 * wn % WT;  // the warp's image row and first column
  const int nact = yr >= H || xw >= W ? 0 : min(4, (W - xw + 7) / 8);  // its n-tiles of 8 columns on the image
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  bf16* orow = out + (b * H + yr) * C * W;
  int c_slot = 0, c_k = 0, c_m = 0;  // the tile to compute
  for (int i = 0; i < nst; ++i) {
    tc::cp_wait<DEPTH - 2>();
    __syncthreads();
    if (i + DEPTH - 1 < nst) load_next();
    tc::cp_commit();
    const bf16* wt = reg + c_slot * K::STAGE;
    const int kb = c_k * KC;
    if (nact > 0) {  // all 4 n-tiles (t is zero past the image's last column)
      constexpr int KK = KC / 16;
      uint32_t a[KK][2][4], bq[KK][2][4];  // the stage's fragments, loaded before its products
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        tc::frag_a<KC>(a[k][0], wt, 32 * wm, 16 * k);
        tc::frag_a<KC>(a[k][1], wt, 32 * wm + 16, 16 * k);
        tc::frag_bt<K::N>(bq[k][0], ts, kb + 16 * k, 32 * wn);
        tc::frag_bt<K::N>(bq[k][1], ts, kb + 16 * k, 32 * wn + 16);
      }
#pragma unroll
      for (int k = 0; k < KK; ++k)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            tc::mma(acc[mi][2 * nj], a[k][mi], bq[k][nj][0], bq[k][nj][1]);
            tc::mma(acc[mi][2 * nj + 1], a[k][mi], bq[k][nj][2], bq[k][nj][3]);
          }
    }
    c_slot = c_slot + 1 == DEPTH ? 0 : c_slot + 1;
    if (++c_k < nk) continue;
    // the M-chunk's epilogue: bias, one rounding, stores along W
    if (nact > 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = c_m * K::MB + 32 * wm + 16 * mi + g + 8 * h;
          if (d >= C) continue;
          const float bias = __ldg(b2 + d);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int xc = xw + 8 * nt + 2 * q;
            const float v0 = acc[mi][nt][2 * h] + bias, v1 = acc[mi][nt][2 * h + 1] + bias;
            bf16* o = orow + d * W + xc;
            if constexpr (V > 1) {  // W even: an even column's pair is on the image or off it
              if (xc < W) *reinterpret_cast<uint32_t*>(o) = roma::pack_bf16(v0, v1);
            } else {
              if (xc < W) o[0] = __float2bfloat16(v0);
              if (xc + 1 < W) o[1] = __float2bfloat16(v1);
            }
          }
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    c_k = 0, ++c_m;
  }
}

template <class K, int V>
cudaError_t launch_hcw(const bf16* x, const float* dw, const float* db, const bf16* w2p, int ldw, const float* b2,
                       bf16* out, int B, int H, int W, int C, size_t smem, cudaStream_t s) {
  constexpr int WT = K::WT, NR = K::NR;
  auto kernel = hcw_tc_kernel<K, V>;
  cudaError_t err = roma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nseg = (W + WT - 1) / WT, nrb = (H + NR - 1) / NR;
  const long long blocks = (long long)B * nrb * nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, s>>>(x, dw, db, w2p, b2, out, H, W, C, ldw, nseg, nrb);
  return cudaGetLastError();
}

template <int WT, int NR, int KC>
bool try_hcw(int C, int optin, const bf16* x, const float* dw, const float* db, const bf16* w2p, int ldw,
             const float* b2, bf16* out, int B, int H, int W, cudaStream_t s, cudaError_t& err) {
  using K = Hcw<WT, NR, KC>;
  const size_t smem = smem_hcw<K>(C);
  if (smem > (size_t)optin) return false;
  err = W % 4 == 0   ? launch_hcw<K, 4>(x, dw, db, w2p, ldw, b2, out, B, H, W, C, smem, s)
        : W % 2 == 0 ? launch_hcw<K, 2>(x, dw, db, w2p, ldw, b2, out, B, H, W, C, smem, s)
                     : launch_hcw<K, 1>(x, dw, db, w2p, ldw, b2, out, B, H, W, C, smem, s);
  return true;
}

// The most pixels a block whose t fits the shared memory beside the
// pipelines' buffers: 4 rows of 64 columns (C <= 336 on an H100: the
// released C = 144), 2 rows (C <= 640: 569), 2 rows of 32 columns (C <=
// 1216: 1137), else 1 row of 32 (C <= 1472: 1377). More pixels a block is
// fewer w2 tiles a pixel, and more output rows for each staged input row. A w2 tile holds 64 input channels (fewer
// barriers a product), 48 at C <= 336, where 64 would pad C = 144 by a third.
int launch_hcw_tc(const void* x, const void* dw, const void* db, const void* w2p, const void* b2, void* out,
                  int B, int H, int W, int C, cudaStream_t s) {
  const int ldw = (C + W2_COLS - 1) / W2_COLS * W2_COLS;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xs = static_cast<const bf16*>(x);
  const auto *dwf = static_cast<const float*>(dw), *dbf = static_cast<const float*>(db),
             *b2f = static_cast<const float*>(b2);
  const auto* w2 = static_cast<const bf16*>(w2p);
  auto* os = static_cast<bf16*>(out);
#define ROMA_HCW_ARGS C, optin, xs, dwf, dbf, w2, ldw, b2f, os, B, H, W, s, err
  if (!try_hcw<64, 4, 48>(ROMA_HCW_ARGS) && !try_hcw<64, 2, 64>(ROMA_HCW_ARGS) &&
      !try_hcw<32, 2, 64>(ROMA_HCW_ARGS) && !try_hcw<32, 1, 64>(ROMA_HCW_ARGS))
    err = cudaErrorInvalidValue;
#undef ROMA_HCW_ARGS
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Kernel I in bf16 (nhwc_tc_kernel): J's two phases, designed for NHWC.
//
// A block owns NR image rows of WT columns (N = NR WT pixels, the
// configurations of launch_hcw_tc, picked the same way) and every output
// channel of them.
//   * Phase 1, the depthwise once per pixel for all C channels: chunks of DC
//     = 2048 / WT channels are staged [row][column][channel] (a pixel's
//     chunk is one run along C), double-buffered. A thread takes a channel
//     pair and 4 columns of all NR rows: 4-byte shared loads of pairs, each
//     staged row read once for up to 5 output rows. t is stored
//     [pixel][channel] (rows of kt + 8 elements), the row-major A operand.
//     The staging at C % 8 == 0 (C = 144) is 16-byte cp.async copies. At any
//     other C a pixel's run starts on an odd element every other pixel (at
//     an odd C), so it copies the aligned 4-byte words that cover the run
//     by cp.async (V = 4; the base 4-byte aligned), and a thread joins its
//     pair from two staged words with one byte permute where the run starts
//     odd (the parity of its index in x). Loading the words, or single
//     elements, through registers waits on every load and measured 1.2-1.4x
//     slower over the released widths (PERF.md, section 6).
//   * Phase 2, out[p, d] = sum_c t[p, c] w2r[d, c] on mma.sync m16n8k16 (t by
//     ldmatrix without .trans, w2^T's tiles [out][in] as the "col" B
//     operand, by ldmatrix), w2^T from block_w2t through J's 3-deep cp.async
//     ring of 64-channel tiles (48 at C <= 336), NB = 256 / (N / 32) output
//     channels at a time. The accumulator's pairs are adjacent output
//     channels of one pixel.
//   * The epilogue stages each NB-channel chunk [pixel][channel] in shared
//     memory and writes it as runs: a pixel's chunk, or, when one chunk holds
//     all C channels, a whole image row of the block (WT C elements). A run
//     is written as up to 7 single elements to reach 16 bytes, then 16-byte
//     stores, then the tail; never a pair a store at an odd C.
//   * Shared memory bounds the pixels a block at C >= 1137, as in J: t is N
//     rows of kt bf16, so 2 x 32 pixels at C = 1137 and 1 x 32 at 1377, and
//     the product streams all of w2 from L2 for so few pixels. The design
//     keeps t whole (one depthwise a pixel) and measures the cost there
//     (kernel_variants: i_no_2x32).
template <int WT_, int NR_, int KC_>
struct Nhwc {
  static constexpr int WT = WT_, NR = NR_, KC = KC_;
  static constexpr int N = NR * WT;
  static constexpr int WN = N / 32, WM = 8 / WN, NB = 32 * WM;  // NB output channels a chunk
  static constexpr int DC = 2048 / WT;   // channels a staged chunk: a thread a (pair, 4 columns)
  static constexpr int PAIRS = DC / 2;
  static constexpr int R = 4;             // depthwise columns a thread (all NR rows)
  static constexpr int SR = NR + 2 * P, SWC = WT + 2 * P;  // staged rows and columns
  static constexpr int DCS = DC + 8;      // a staged pixel's elements (16-byte multiple; conflict-free pairs)
  static constexpr int RS = KC + 8;       // a row of a w2 tile
  static constexpr int STAGE = NB * RS;   // elements of a w2 tile
  static constexpr int CHUNK = SR * SWC * DCS;
  static constexpr int OUT = N * NB;      // the epilogue's staging
  static_assert(WN * WM == 8 && PAIRS * (WT / R) == NT && W2_ROWS % NB == 0 && W2_COLS % KC == 0 &&
                    KC % 16 == 0 && DC % 16 == 0, "tiles");
  // t's columns: C rounded up to KC (the product's k), then to DC (phase 1)
  __host__ __device__ static int t_cols(int C) {
    const int kp = (C + KC - 1) / KC * KC;
    return (kp + DC - 1) / DC * DC;
  }
};

constexpr int NHWC_SDEPTH = 2;  // staged chunks in flight (phase 1)

// t, then one region (NHWC_SDEPTH staged chunks in phase 1, DEPTH w2 tiles
// in phase 2), then the epilogue's staging
template <class K>
size_t smem_nhwc(int C) {
  return 2 * ((size_t)K::N * (K::t_cols(C) + 8) +
              std::max((size_t)DEPTH * K::STAGE, (size_t)NHWC_SDEPTH * K::CHUNK) + K::OUT);
}

// Stage channels c0 .. c0 + DC of the block's SR x SWC halo pixels of the
// image at element boff of x into buf [row][column][DCS] (zeros off the
// image and past C). V = 8: 16-byte cp.async (C % 8 == 0, base 16-byte
// aligned); V = 4: 4-byte cp.async of the aligned words that cover each
// pixel's run (base 4-byte aligned; a run starts odd where its index in x,
// boff included, is odd, and the reader joins its pairs with a permute).
template <class K, int V>
__device__ __forceinline__ void nhwc_stage(const bf16* __restrict__ x, int boff, bf16* buf, int c0, int y0, int x0,
                                           int H, int W, int C) {
  static_assert(V == 4 || V == 8, "staging");
  constexpr int PER = V == 4 ? K::DC / 2 + 1 : K::DC / 8, ITEMS = K::SR * K::SWC * PER;
  for (int i = threadIdx.x; i < ITEMS; i += NT) {
    const int v = i % PER, pix = i / PER, sr = pix / K::SWC, sc = pix % K::SWC;
    const int gy = y0 - P + sr, gx = x0 - P + sc;
    const bool on = gy >= 0 && gy < H && gx >= 0 && gx < W;
    if constexpr (V == 4) {  // the words covering elements c0 .. c0 + DC of a pixel, from the one at or before c0
      const int e = boff + (gy * W + gx) * C + c0, w0 = e & ~1;  // the run's first element and word
      // a word that holds an element of the run lies in x's allocation
      const bool ok = on && w0 + 2 * v < e + min(K::DC, C - c0);
      tc::cp4(buf + pix * K::DCS + 2 * v, ok ? x + w0 + 2 * v : x, ok);
    } else {
      const bf16* xb = x + boff;
      const int c = c0 + 8 * v;
      const bool ok = on && c < C;
      tc::cp16(buf + pix * K::DCS + 8 * v, ok ? xb + ((long long)gy * W + gx) * C + c : xb, ok);
    }
  }
}

// x, out (B, H, W, C) bf16; w2p the zero-padded bf16 w2^T (rows: output
// channels, row stride ldw). Block blockIdx.x: image rows y0 .. y0 + NR of
// image b, columns x0 .. x0 + WT, all output channels.
template <class K, int V>
__global__ void __launch_bounds__(NT, 1) nhwc_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const bf16* __restrict__ w2p, const float* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C,
    int ldw, int nseg, int nrb) {
  constexpr int WT = K::WT, NR = K::NR, KC = K::KC, R = K::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = K::t_cols(C), TS = kt + 8, kp = (C + KC - 1) / KC * KC;
  bf16* ts = reinterpret_cast<bf16*>(smem);  // t [N][TS]: rows pixels, cols input channels
  bf16* reg = ts + K::N * TS;                // phase 1: [SDEPTH][CHUNK]; phase 2: [DEPTH][STAGE]
  constexpr int REGION = DEPTH * K::STAGE > NHWC_SDEPTH * K::CHUNK ? DEPTH * K::STAGE : NHWC_SDEPTH * K::CHUNK;
  bf16* os = reg + REGION;                   // [N][nbw]: an output chunk

  const int seg = blockIdx.x % nseg, rb = blockIdx.x / nseg % nrb, b = blockIdx.x / nseg / nrb;
  const int x0 = seg * WT, y0 = rb * NR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int boff = b * H * W * C;

  // Phase 1. A thread: channels c0 + 2 cp, + 1 of each chunk, output columns
  // R j .. R j + 3 of all NR rows (staged columns R j .. R j + 7).
  const int cp = threadIdx.x % K::PAIRS, j = threadIdx.x / K::PAIRS;
  const int nch = kt / K::DC;
  nhwc_stage<K, V>(x, boff, reg, 0, y0, x0, H, W, C);
  tc::cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * K::DC, c = c0 + 2 * cp;
    float w[2][KS * KS + 1];  // the pair's taps and biases, loaded before the wait
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < KS * KS; ++t) w[h][t] = c + h < C ? __ldg(dw + t * C + c + h) : 0.f;
      w[h][KS * KS] = c + h < C ? __ldg(db + c + h) : 0.f;
    }
    tc::cp_wait<0>();  // chunk ch has landed
    __syncthreads();   // ... for every thread, and chunk ch - 1's buffer is free
    if (ch + 1 < nch)
      nhwc_stage<K, V>(x, boff, reg + ((ch + 1) % NHWC_SDEPTH) * K::CHUNK, c0 + K::DC, y0, x0, H, W, C);
    tc::cp_commit();

    const bool live = c < C && x0 + R * j < W;
    float acc[NR][R][2];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[r][i][0] = acc[r][i][1] = 0.f;
    if (live) {
      const bf16* src = reg + (ch % NHWC_SDEPTH) * K::CHUNK + R * j * K::DCS + 2 * cp;
      // V = 4: staged pixel (sr, s) starts odd when its first element's index
      // in x is odd (off the image it is zeros either way)
      const int par0 = (boff + ((y0 - P) * W + x0 - P + R * j) * C + c0) & 1, prow = (W * C) & 1, pcol = C & 1;
#pragma unroll
      for (int sr = 0; sr < K::SR; ++sr) {  // each staged row feeds up to 5 output rows
        float row[R + 2 * P][2];
#pragma unroll
        for (int s = 0; s < R + 2 * P; ++s) {
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(src + (sr * K::SWC + s) * K::DCS);
          uint32_t u = wp[0];
          if constexpr (V == 4) {
            if ((par0 + sr * prow + s * pcol) & 1) u = __byte_perm(u, wp[1], 0x5432);
          }
          row[s][0] = __uint_as_float(u << 16);
          row[s][1] = __uint_as_float(u & 0xffff0000u);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int u = sr - r;
          if (u < 0 || u >= KS) continue;
#pragma unroll
          for (int v = 0; v < KS; ++v)
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) acc[r][i][h] = fmaf(row[i + v][h], w[h][u * KS + v], acc[r][i][h]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < R; ++i)  // zero past C (staged words hold the next pixel there) and past the image
        *reinterpret_cast<uint32_t*>(ts + (r * WT + R * j + i) * TS + c) =
            live ? roma::pack_bf16(fmaxf(acc[r][i][0] + w[0][KS * KS], 0.f),
                                   c + 1 < C ? fmaxf(acc[r][i][1] + w[1][KS * KS], 0.f) : 0.f)
                 : 0u;
  }
  __syncthreads();  // t is complete, and the staged chunks' region is free for the ring

  // Phase 2: out[p, d] = sum_c t[p, c] w2p[d, c] + b2[d] for each chunk of
  // NB output channels; ring stage i: chunk i / nk, input channels
  // (i % nk) KC .., in buffer i % DEPTH, loaded DEPTH - 1 tiles ahead.
  const int nm = (C + K::NB - 1) / K::NB, nk = kp / KC, nst = nm * nk;
  int l_slot = 0, l_k = 0, l_m = 0;  // the next tile to load
  auto load_next = [&]() {
    bf16* dst = reg + l_slot * K::STAGE;
    const bf16* src = w2p + (l_m * K::NB) * ldw + l_k * KC;
#pragma unroll
    for (int jj = threadIdx.x; jj < K::NB * KC / 8; jj += NT) {
      const int r = jj / (KC / 8), cc = jj % (KC / 8) * 8;
      tc::cp16(dst + r * K::RS + cc, src + r * ldw + cc, true);
    }
    l_slot = l_slot + 1 == DEPTH ? 0 : l_slot + 1;
    if (++l_k == nk) l_k = 0, ++l_m;
  };
  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < nst) load_next();
    tc::cp_commit();
  }
  const int g = lane / 4, q = lane % 4, wm = warp % K::WM, wn = warp / K::WM;
  const int m0 = 32 * wn, n0 = 32 * wm;  // the warp's pixels (one image row) and output channels
  const bool active = y0 + m0 / WT < H && x0 + m0 % WT < W;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  const bf16* arow = ts + (m0 + (lane & 15)) * TS + ((lane >> 4) << 3);  // this lane's ldmatrix row
  int c_slot = 0, c_k = 0, c_m = 0;  // the tile to compute
  for (int i = 0; i < nst; ++i) {
    tc::cp_wait<DEPTH - 2>();
    __syncthreads();
    if (i + DEPTH - 1 < nst) load_next();
    tc::cp_commit();
    const bf16* wt = reg + c_slot * K::STAGE;
    const int kb = c_k * KC;
    if (active) {  // pixels past the image's last column have t = 0
      constexpr int KK = KC / 16;
      uint32_t a[KK][2][4], bq[KK][2][4];  // the stage's fragments, loaded before its products
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        tc::ldsm4(a[k][0], arow + kb + 16 * k);
        tc::ldsm4(a[k][1], arow + 16 * TS + kb + 16 * k);
        tc::frag_b<KC>(bq[k][0], wt, n0, 16 * k);
        tc::frag_b<KC>(bq[k][1], wt, n0 + 16, 16 * k);
      }
#pragma unroll
      for (int k = 0; k < KK; ++k)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            tc::mma(acc[mi][2 * nj], a[k][mi], bq[k][nj][0], bq[k][nj][1]);
            tc::mma(acc[mi][2 * nj + 1], a[k][mi], bq[k][nj][2], bq[k][nj][3]);
          }
    }
    c_slot = c_slot + 1 == DEPTH ? 0 : c_slot + 1;
    if (++c_k < nk) continue;
    // the chunk's epilogue: bias, one rounding, staged [pixel][nbw], then
    // written as runs (see the note above)
    const int nb0 = c_m * K::NB, nbw = min(K::NB, C - nb0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * nt + 2 * q + e;
        if (n >= nbw) continue;
        const float bias = __ldg(b2 + nb0 + n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            os[(m0 + 16 * mi + g + 8 * h) * nbw + n] = __float2bfloat16(acc[mi][nt][2 * h + e] + bias);
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    __syncthreads();
    {
      // runs: NR image rows of WT C elements when the chunk is all of C, else
      // N pixels of nbw; each run as units of a head, 16-byte vectors, a tail
      const bool rows = nbw == C;
      const int nruns = rows ? NR : K::N, units = (rows ? WT * C : nbw) / 8 + 2;
      for (int it = threadIdx.x; it < nruns * units; it += NT) {
        const int run = it / units, u = it % units;
        int gy, len;
        long long e0;
        const bf16* src;
        if (rows) {
          gy = y0 + run;
          len = max(0, min(WT, W - x0)) * C;
          e0 = (((long long)b * H + gy) * W + x0) * C;
          src = os + run * WT * C;
        } else {
          const int gx = x0 + run % WT;
          gy = y0 + run / WT;
          len = gx < W ? nbw : 0;
          e0 = (((long long)b * H + gy) * W + gx) * C + nb0;
          src = os + run * nbw;
        }
        if (gy >= H || len == 0) continue;
        const int head = min(len, (int)((8 - (e0 & 7)) & 7)), nv = (len - head) >> 3;
        bf16* dst = out + e0;
        if (u == 0) {
          for (int k = 0; k < head; ++k) dst[k] = src[k];
        } else if (u <= nv) {
          const int s = head + 8 * (u - 1);
          uint32_t wd[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wd[k] = (uint32_t)__bfloat16_as_ushort(src[s + 2 * k]) |
                    ((uint32_t)__bfloat16_as_ushort(src[s + 2 * k + 1]) << 16);
          *reinterpret_cast<uint4*>(dst + s) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        } else if (u == nv + 1) {
          for (int k = head + 8 * nv; k < len; ++k) dst[k] = src[k];
        }
      }
    }
    c_k = 0, ++c_m;
  }
}

template <class K, int V>
cudaError_t launch_nhwc(const bf16* x, const float* dw, const float* db, const bf16* w2p, int ldw,
                        const float* b2, bf16* out, int B, int H, int W, int C, size_t smem, cudaStream_t s) {
  auto kernel = nhwc_tc_kernel<K, V>;
  cudaError_t err = roma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nseg = (W + K::WT - 1) / K::WT, nrb = (H + K::NR - 1) / K::NR;
  const long long blocks = (long long)B * nrb * nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, s>>>(x, dw, db, w2p, b2, out, H, W, C, ldw, nseg, nrb);
  return cudaGetLastError();
}

template <int WT, int NR, int KC>
bool try_nhwc(int C, int optin, const bf16* x, const float* dw, const float* db, const bf16* w2p, int ldw,
              const float* b2, bf16* out, int B, int H, int W, cudaStream_t s, cudaError_t& err) {
  using K = Nhwc<WT, NR, KC>;
  const size_t smem = smem_nhwc<K>(C);
  if (smem > (size_t)optin) return false;
  err = C % 8 == 0 ? launch_nhwc<K, 8>(x, dw, db, w2p, ldw, b2, out, B, H, W, C, smem, s)
                   : launch_nhwc<K, 4>(x, dw, db, w2p, ldw, b2, out, B, H, W, C, smem, s);
  return true;
}

// The block's pixels as launch_hcw_tc picks them: the most whose t fits.
int launch_nhwc_tc(const void* x, const void* dw, const void* db, const void* w2p, const void* b2, void* out,
                   int B, int H, int W, int C, cudaStream_t s) {
  const int ldw = (C + W2_COLS - 1) / W2_COLS * W2_COLS;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xs = static_cast<const bf16*>(x);
  const auto *dwf = static_cast<const float*>(dw), *dbf = static_cast<const float*>(db),
             *b2f = static_cast<const float*>(b2);
  const auto* w2 = static_cast<const bf16*>(w2p);
  auto* os = static_cast<bf16*>(out);
#define ROMA_NHWC_ARGS C, optin, xs, dwf, dbf, w2, ldw, b2f, os, B, H, W, s, err
  if (!try_nhwc<64, 4, 48>(ROMA_NHWC_ARGS) && !try_nhwc<64, 2, 64>(ROMA_NHWC_ARGS) &&
      !try_nhwc<32, 2, 64>(ROMA_NHWC_ARGS) && !try_nhwc<32, 1, 64>(ROMA_NHWC_ARGS))
    err = cudaErrorInvalidValue;
#undef ROMA_NHWC_ARGS
  return static_cast<int>(err);
}

}  // namespace

// layout 0: x and out are (B, H, W, C) (Kernel I); 1: (B, H, C, W) (Kernel
// J). path 0: the 8x8-tile kernel, w2 the folded f32 (C_in, C_out); path 1
// (layout 1, bf16 only): J's tensor-core kernel, path 2 (layout 0, bf16
// only): I's, w2 for both the folded w2^T rounded to bf16 and zero-padded to
// (W2_ROWS, W2_COLS) multiples (ops/wide_refiner.py:padded_w2t).
extern "C" int roma_wide_refiner_block(const void* x, const void* dw, const void* db, const void* w2,
                                       const void* b2, void* out, int B, int H, int W, int C,
                                       int layout, int path, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (layout != 0 && layout != 1) || path < 0 || path > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (layout != 1 || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_hcw_tc(x, dw, db, w2, b2, out, B, H, W, C, s);
  }
  if (path == 2) {
    if (layout != 0 || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nhwc_tc(x, dw, db, w2, b2, out, B, H, W, C, s);
  }
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
