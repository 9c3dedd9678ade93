// Kernel D: one folded ConvRefiner block, launched once per block of a stack.
//
// Replaces roma_tpu/ops/pallas_refiner.py:_cmajor_kernel (entry
// fused_refiner_stack). A folded block (fold_block: BatchNorm folded into the
// depthwise conv, all f32) computes, with zero SAME padding,
//   t[c]   = round(relu(sum_{u,v} x[y+u-p, x+v-p, c] * dw[u, v, c] + db[c]))
//   out[d] = round(sum_c t[c] * w2[c, d] + b2[d])
// where round() is the I/O dtype, as the TPU kernel stores between stages.
//
// What bounds it on the H100: at the scale-1 shapes (560^2 and 864^2, C = 24,
// B = 2) a block moves 48 bytes of bf16 in and out per pixel against 600 f32
// depthwise FMAs and 576 pointwise ones, so the memory and the CUDA cores'
// FMA rate are about even once the pointwise product leaves the CUDA cores.
//
// Two instantiations:
//  * C = 24, K = 5 (the scale-1 width at released dims and at
//    RoMaConfig.tiny()): a 16 x 32 output tile, its 20 x 36 halo staged in
//    shared memory channel-major in f32 by 16-byte loads. The depthwise is
//    register-blocked: a warp takes one channel, its lanes one column each,
//    and a lane keeps the channel's 25 weights and the tile's 16 output rows
//    in registers, so it reads each of the column's 20 x 5 taps once: 100
//    shared loads for 400 FMAs, against two loads an FMA in a
//    thread-per-pixel loop (runs of 4 and 8 rows measured 2% slower). t is
//    rounded to the I/O dtype as it is stored. In bf16 the
//    pointwise product runs on the tensor cores: t is exact as a bf16
//    operand, and w2 (f32) is split into hi = bf16(w2) and lo =
//    bf16(w2 - hi), so t.hi + t.lo by mma.sync m16n8k16 with an f32
//    accumulator leaves w2's rest below 2^-16 of it, far inside one bf16
//    ulp of the output. float32 I/O keeps an exact f32 product on the CUDA
//    cores. The output tile is staged in shared memory and written by
//    16-byte stores, a tile row one contiguous run. x's base must be 16-byte
//    aligned (the wrapper checks).
//  * any other C <= 32 and odd K: one thread per pixel of an 8 x 32 tile,
//    the design this kernel started from.
#include "common.cuh"
#include "refiner_c24.cuh"

namespace {

constexpr int MAXC = 32;

// ---------------------------------------------------------------------------
// generic instantiation: any C <= 32, any odd K
constexpr int GTH = 8, GTW = 32;

template <typename T>
__global__ void __launch_bounds__(GTH * GTW) refiner_block_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H,
    int W, int C, int K) {
  extern __shared__ float sm[];
  const int p = K / 2, RH = GTH + 2 * p, RW = GTW + 2 * p;
  float* tile = sm;                 // C x RH x RW
  float* dws = tile + C * RH * RW;  // K*K x C
  float* w2s = dws + K * K * C;     // C x C (in, out)
  float* dbs = w2s + C * C;
  float* b2s = dbs + C;
  const int b = blockIdx.z, y0 = blockIdx.y * GTH, x0 = blockIdx.x * GTW;
  const int tid = threadIdx.x;

  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < C * RH * RW; i += GTH * GTW) {
    const int c = i % C, pix = i / C, r = pix / RW, col = pix % RW;
    const int gy = y0 + r - p, gx = x0 + col - p;
    tile[(c * RH + r) * RW + col] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                        ? roma::to_f32(xb[((size_t)gy * W + gx) * C + c])
                                        : 0.f;
  }
  for (int i = tid; i < K * K * C; i += GTH * GTW) dws[i] = dw[i];
  for (int i = tid; i < C * C; i += GTH * GTW) w2s[i] = w2[i];
  for (int i = tid; i < C; i += GTH * GTW) {
    dbs[i] = db[i];
    b2s[i] = b2[i];
  }
  __syncthreads();

  const int py = tid / GTW, px = tid % GTW;
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

size_t generic_smem(int C, int K) {
  const int p = K / 2;
  return ((size_t)C * (GTH + 2 * p) * (GTW + 2 * p) + K * K * C + C * C + 2 * C) * sizeof(float);
}

}  // namespace

// ---------------------------------------------------------------------------
// the C = 24, K = 5 instantiation (its shared pieces: refiner_c24.cuh)
namespace c24 {
namespace {

constexpr int TH = 16, TW = 32;
constexpr int RH = TH + 2 * P, RW = TW + 2 * P, PLANE = RH * RW;  // 20 x 36 staged pixels
constexpr int NPIX = TH * TW;                                    // 512 output pixels
constexpr int TPAIR = NPIX + 8;  // words per channel pair of the bf16 t tile; = 8 mod 32
constexpr int TROW = C + 1;      // f32 t tile row stride (odd: lanes on distinct banks)
static_assert(C % NW == 0 && NPIX % 16 == 0, "tile shape");

template <typename T>
struct Smem {
  // staged tile (C planes of RH x RW, f32); reused for the output tile
  static constexpr size_t tile = 0;
  static constexpr size_t dws = tile + (size_t)C * PLANE * 4;  // C x KK
  static constexpr size_t db = dws + (size_t)C * KK * 4;
  static constexpr size_t b2 = db + C * 4;
  static constexpr size_t w2 = b2 + C * 4;  // C x C, f32 path only
  static constexpr bool tc = sizeof(T) == 2;
  static constexpr size_t t = w2 + (tc ? 0 : (size_t)C * C * 4);
  static constexpr size_t bytes = t + (tc ? (size_t)(C / 2) * TPAIR * 4 : (size_t)NPIX * TROW * 4);
  static_assert(tile + (size_t)NPIX * C * sizeof(T) <= dws, "the output tile fits the staged one");
};

template <typename T>
__global__ void __launch_bounds__(NT, 2) refiner_block_c24_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H, int W) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smraw[];
  float* tile = reinterpret_cast<float*>(smraw + S::tile);
  float* dws = reinterpret_cast<float*>(smraw + S::dws);
  float* dbs = reinterpret_cast<float*>(smraw + S::db);
  float* b2s = reinterpret_cast<float*>(smraw + S::b2);
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;

  stage(x + (size_t)b * H * W * C, tile, PLANE, y0 - P, x0 - P, RH, RW, H, W);
  stage_weights(dw, db, b2, dws, dbs, b2s, 1);
  if constexpr (!S::tc) {
    float* w2s = reinterpret_cast<float*>(smraw + S::w2);
    for (int i = tid; i < C * C; i += NT) w2s[i] = w2[i];
  }
  __syncthreads();

  // depthwise: warp wid takes channels wid, wid + 8, wid + 16; lane = column
  for (int c = wid; c < C; c += NW) {
    float wr[KK];
#pragma unroll
    for (int i = 0; i < KK; ++i) wr[i] = dws[c * KK + i];
    const float bias = dbs[c];
    float acc[TH][1];
#pragma unroll
    for (int o = 0; o < TH; ++o) acc[o][0] = 0.f;
    const float* src = tile + c * PLANE + lane;
#pragma unroll
    for (int ir = 0; ir < RH; ++ir) {
      float v[K];
#pragma unroll
      for (int q = 0; q < K; ++q) v[q] = src[ir * RW + q];
      taps<TH, 1>(ir, v, wr, acc);
    }
#pragma unroll
    for (int o = 0; o < TH; ++o) {
      const int pix = o * TW + lane;
      const float tv = fmaxf(acc[o][0] + bias, 0.f);
      if constexpr (S::tc) {
        // channel pair c / 2 of pixel pix, channel c in its c % 2 half
        reinterpret_cast<__nv_bfloat16*>(smraw + S::t)[((c >> 1) * TPAIR + pix) * 2 + (c & 1)] =
            __float2bfloat16(tv);
      } else {
        reinterpret_cast<float*>(smraw + S::t)[pix * TROW + c] = tv;
      }
    }
  }
  __syncthreads();

  if constexpr (S::tc) {
    // pointwise on the tensor cores: a warp takes 16-pixel row tiles
    const int g = lane >> 2, t = lane & 3;
    uint32_t bh[2][3][2], bl[2][3][2];
    w2_frags(w2, lane, bh, bl);
    float bias[3][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      bias[j][0] = b2s[8 * j + 2 * t];
      bias[j][1] = b2s[8 * j + 2 * t + 1];
    }
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(smraw + S::t);
    uint32_t* ow = reinterpret_cast<uint32_t*>(smraw + S::tile);  // (NPIX, C) bf16, 12 words a pixel
    for (int m0 = wid * 16; m0 < NPIX; m0 += NW * 16) {
      float acc[3][4];
      pointwise16(tw, TPAIR, m0, lane, bh, bl, acc);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ow[(m0 + g) * (C / 2) + 4 * j + t] = tc::pack(acc[j][0] + bias[j][0], acc[j][1] + bias[j][1]);
        ow[(m0 + g + 8) * (C / 2) + 4 * j + t] = tc::pack(acc[j][2] + bias[j][0], acc[j][3] + bias[j][1]);
      }
    }
  } else {
    // pointwise in f32 on the CUDA cores: a thread per pixel
    const float* w2s = reinterpret_cast<const float*>(smraw + S::w2);
    const float* ts = reinterpret_cast<const float*>(smraw + S::t);
    float* os = tile;
    for (int pix = tid; pix < NPIX; pix += NT) {
      float tv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) tv[c] = ts[pix * TROW + c];
#pragma unroll
      for (int d = 0; d < C; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc = fmaf(tv[c], w2s[c * C + d], acc);
        os[pix * C + d] = acc + b2s[d];
      }
    }
  }
  __syncthreads();

  store_tile(reinterpret_cast<const uint4*>(smraw + S::tile), out + (size_t)b * H * W * C, y0, x0, TH, TW, H, W);
}

}  // namespace
}  // namespace c24

extern "C" int roma_refiner_block(const void* x, const void* dw, const void* db, const void* w2,
                                  const void* b2, void* out, int B, int H, int W, int C, int K,
                                  int dtype, void* stream) {
  if (C < 1 || C > MAXC || K < 1 || K % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == c24::C && K == c24::K) {
    dim3 grid((W + c24::TW - 1) / c24::TW, (H + c24::TH - 1) / c24::TH, B);
    ROMA_DISPATCH_DTYPE(dtype, {
      constexpr size_t smem = c24::Smem<scalar_t>::bytes;
      cudaError_t err = roma::allow_smem(c24::refiner_block_c24_kernel<scalar_t>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      c24::refiner_block_c24_kernel<scalar_t><<<grid, c24::NT, smem, s>>>(
          static_cast<const scalar_t*>(x), static_cast<const float*>(dw),
          static_cast<const float*>(db), static_cast<const float*>(w2),
          static_cast<const float*>(b2), static_cast<scalar_t*>(out), H, W);
    });
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = generic_smem(C, K);
  dim3 grid((W + GTW - 1) / GTW, (H + GTH - 1) / GTH, B);
  ROMA_DISPATCH_DTYPE(dtype, {
    cudaError_t err = roma::allow_smem(refiner_block_kernel<scalar_t>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    refiner_block_kernel<scalar_t><<<grid, GTH * GTW, smem, s>>>(
        static_cast<const scalar_t*>(x), static_cast<const float*>(dw),
        static_cast<const float*>(db), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<scalar_t*>(out), H, W, C, K);
  });
  return static_cast<int>(cudaGetLastError());
}
