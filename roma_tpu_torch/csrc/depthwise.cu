// Kernel N: the depthwise half of a folded wide ConvRefiner block.
//
// Replaces no TPU kernel: the JAX package runs the wide stacks (scales 16 to
// 2, C = 1377, 1137, 569, 144) as XLA convolutions, and the port ran them as
// cuDNN's depthwise conv, its channel padding, the bias add, BatchNorm and
// ReLU, five device passes a block. With BatchNorm folded into the depthwise
// weights (ops/refiner_stack.py:fold_block, f32) it computes, with zero SAME
// padding, on NHWC,
//   t[c] = round(relu(sum_{u,v} x[y+u-2, x+v-2, c] * dw[u, v, c] + db[c]))
// in one pass: x read once (its halo through shared memory and L2), t written
// once, f32 accumulation, one rounding to the I/O dtype. The block's 1x1
// product follows as one library GEMM with its bias in the epilogue
// (ops/depthwise.py:wide_stack).
//
// What bounds it on the H100: bytes, on paper. Each element is read and
// written once, 4 bytes in bf16, against 25 f32 FMAs: 6.25 FMAs a byte,
// under the CUDA cores' ~10 (33.5 TFMA/s over 3.35 TB/s). But every other
// instruction takes an FMA's issue slot: at ~1900 instructions a thread for
// its 800 FMAs, a copy of this kernel without its loads ran as fast as with
// them, so the issue rate bounded it. The design keeps the instructions an
// element few (~1700 a thread, 800 of them FMAs; a copy without its FMAs,
// the copies, the halo and the stores alone, takes ~70% of its time):
//  * the channels are padded to a multiple of 8 by the caller once a stack
//    (ops/depthwise.py:padded_width), so a pixel's channels start on 16
//    bytes, and the tile is staged by 16-byte cp.async copies, the halo zero
//    filled by the copy itself: no padding pass, no bounds in the inner loop;
//  * a block owns CG channels (64; 144 where that idles fewer, C = 144) of an
//    8-row by 2 NCP-column output tile, a compile-time shape, so each shared
//    load is a constant offset of one base; a thread owns one channel pair
//    (a 32-bit bf16 pair or a 64-bit f32 pair in shared memory, so a warp
//    reads consecutive words) in two adjacent columns and all 8 rows. Its 50
//    weights stay in registers and it reads each of its (8 + 4) x 6 staged
//    taps once: 2.25 shared loads an output element against 25 FMAs; the
//    accumulators start at the bias;
//  * the output is stored from registers, a warp's channel pairs one
//    contiguous run of a pixel, bounds checked only on a tile at the edge;
//  * two blocks an SM; the grid runs a tile's channel groups one after the
//    other, so the groups of a pixel are read together in whole sectors,
//    then the neighbouring tiles, which share their halos and find those
//    rows in L2.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int K = 5, PAD = K / 2;
constexpr int TH = 8;       // output rows a thread (and a tile)
constexpr int C_ALIGN = 8;  // ops/depthwise.py:C_ALIGN

// two channels of a staged pixel as f32, and two f32 values stored as T
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  v[0] = u.x, v[1] = u.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&v)[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(u << 16), v[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = roma::pack_bf16(a, b);
}

// A block: CG channels (CG / 2 pairs) of a TH x TW output tile, TW = 2 NCP
// columns, CG / 2 * NCP = 288 threads. The tile's shape is compile-time, so
// every shared-memory address of the inner loop is a constant offset of one
// per-thread base.
template <int CG, int NCP>
struct Shape {
  static constexpr int CPB = CG / 2, NT = CPB * NCP, TW = 2 * NCP;
  static constexpr int RH = TH + 2 * PAD, RW = TW + 2 * PAD;  // the staged tile with its halo
  template <typename T>
  static constexpr size_t smem() { return (size_t)RH * RW * CG * sizeof(T); }
};
using Wide = Shape<64, 9>;    // any C: groups of 64 channels, the last one partial
using Narrow = Shape<144, 4>;  // C = 144, the scale-2 stacks: one group, all of a pixel

template <typename T, int CG, int NCP>
__global__ void __launch_bounds__(Shape<CG, NCP>::NT, 2) dw_bn_relu_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    T* __restrict__ out, int H, int W, int C, int tiles_w, int groups) {
  using S = Shape<CG, NCP>;
  constexpr int EPV = 16 / sizeof(T), CPP = CG / EPV;  // elements a 16-byte copy, copies a pixel
  extern __shared__ __align__(16) unsigned char smraw[];
  T* tile = reinterpret_cast<T*>(smraw);  // RH rows x RW columns x CG channels
  const int b = blockIdx.y, g = blockIdx.x % groups, t = blockIdx.x / groups;
  const int c0 = g * CG, y0 = (t / tiles_w) * TH, x0 = (t % tiles_w) * S::TW;
  const int cg_act = min(CG, C - c0);  // a multiple of C_ALIGN

  // Stage the tile, zero outside the image. A thread copies chunk `ch` of
  // every PS-th pixel (PS = NT / CPP, a whole number): its pixels' rows and
  // columns, and their addresses, advance by constants.
  {
    static_assert(S::NT % CPP == 0, "a thread keeps one chunk of a pixel");
    constexpr int PS = S::NT / CPP, DR = PS / S::RW, DC = PS % S::RW;
    const int ch = threadIdx.x % CPP;
    int pix = threadIdx.x / CPP, r = pix / S::RW, col = pix % S::RW;
    const long long row = (long long)W * C;
    // pixel (r, col) of the tile, wherever it lies (read only inside the image)
    const T* src = x + ((long long)b * H + y0 - PAD + r) * row + (long long)(x0 - PAD + col) * C + c0 + ch * EPV;
    T* dst = tile + pix * CG + ch * EPV;
    if (ch * EPV < cg_act) {
#pragma unroll
      for (int k = 0; k < (S::RH * S::RW + PS - 1) / PS; ++k) {
        if (pix < S::RH * S::RW) {
          const bool ok = (unsigned)(y0 - PAD + r) < (unsigned)H && (unsigned)(x0 - PAD + col) < (unsigned)W;
          tc::cp16(dst, ok ? src : x, ok);
        }
        pix += PS, dst += PS * CG, r += DR, col += DC, src += DR * row + (long long)DC * C;
        if (col >= S::RW) col -= S::RW, ++r, src += row - (long long)S::RW * C;
      }
    }
  }
  tc::cp_commit();

  const int pair = threadIdx.x % S::CPB, colp = threadIdx.x / S::CPB;
  const bool active = 2 * pair < cg_act;
  const int c = c0 + 2 * pair;
  float w[K * K][2], bias[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) load2(dw + (size_t)i * C + c, w[i]);
    load2(db + c, bias);
  }
  tc::cp_wait<0>();
  __syncthreads();
  if (!active) return;

  // acc[o][j][q]: output row o, column 2 colp + j, channel c + q; the bias
  // first, then the taps row by row
  float acc[TH][2][2];
#pragma unroll
  for (int o = 0; o < TH; ++o)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[o][j][0] = bias[0], acc[o][j][1] = bias[1];
  const T* base = tile + 2 * colp * CG + 2 * pair;
#pragma unroll
  for (int r = 0; r < S::RH; ++r) {  // staged row r feeds output rows r - 4 .. r
    float in[K + 1][2];
#pragma unroll
    for (int j = 0; j < K + 1; ++j) load2(base + (r * S::RW + j) * CG, in[j]);
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int o = r - dy;
      if (o < 0 || o >= TH) continue;
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc[o][0][q] = fmaf(in[dx][q], w[dy * K + dx][q], acc[o][0][q]);
          acc[o][1][q] = fmaf(in[dx + 1][q], w[dy * K + dx][q], acc[o][1][q]);
        }
    }
  }

  // one row pointer a row; bounds only on a tile at the image's edge
  const int gx = x0 + 2 * colp;
  T* ob = out + ((size_t)(b * H + y0) * W + gx) * C + c;
  const size_t row = (size_t)W * C;
  if (y0 + TH <= H && x0 + S::TW <= W) {
#pragma unroll
    for (int o = 0; o < TH; ++o)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        store2(ob + o * row + j * C, fmaxf(acc[o][j][0], 0.f), fmaxf(acc[o][j][1], 0.f));
  } else {
#pragma unroll
    for (int o = 0; o < TH; ++o)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (y0 + o < H && gx + j < W)
          store2(ob + o * row + j * C, fmaxf(acc[o][j][0], 0.f), fmaxf(acc[o][j][1], 0.f));
  }
}

// launch one instantiation: a block's channel group fastest, so a pixel's
// groups are read together (whole sectors), then spatial tiles, then images
template <typename T, typename S>
cudaError_t launch(const T* x, const float* dw, const float* db, T* out, int B, int H, int W, int C,
                   cudaStream_t s) {
  constexpr int CG = 2 * S::CPB, NCP = S::NT / S::CPB;
  const int tiles_w = (W + S::TW - 1) / S::TW, tiles_h = (H + TH - 1) / TH, groups = (C + CG - 1) / CG;
  if ((long long)groups * tiles_w * tiles_h > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = roma::allow_smem(dw_bn_relu_kernel<T, CG, NCP>, S::template smem<T>());
  if (err != cudaSuccess) return err;
  dw_bn_relu_kernel<T, CG, NCP><<<dim3(groups * tiles_w * tiles_h, B), S::NT, S::template smem<T>(), s>>>(
      x, dw, db, out, H, W, C, tiles_w, groups);
  return cudaGetLastError();
}

// the group width that leaves fewer idle channels, 64 on a tie
bool narrow_fits(int C) { return (C + 143) / 144 * 144 - C < (C + 63) / 64 * 64 - C; }

}  // namespace

extern "C" int roma_depthwise_bn_relu(const void* x, const void* dw, const void* db, void* out, int B,
                                      int H, int W, int C, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < C_ALIGN || C % C_ALIGN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  ROMA_DISPATCH_DTYPE(dtype, {
    const auto* xi = static_cast<const scalar_t*>(x);
    const auto *w = static_cast<const float*>(dw), *bias = static_cast<const float*>(db);
    auto* o = static_cast<scalar_t*>(out);
    err = narrow_fits(C) ? launch<scalar_t, Narrow>(xi, w, bias, o, B, H, W, C, s)
                         : launch<scalar_t, Wide>(xi, w, bias, o, B, H, W, C, s);
  });
  return static_cast<int>(err);
}
