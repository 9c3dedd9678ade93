// The pieces Kernels D (refiner_stack.cu) and H (refiner_chain.cu) share at
// the scale-1 refiner's C = 24, K = 5: the channel-major staging of a region
// by 16-byte loads, the register-blocked depthwise's step over one staged
// row, the pointwise's B fragments of w2 = hi + lo and its m16n8k16 product
// of 16 pixels, and the 16-byte stores of an output tile. Each kernel keeps
// its own tile, its own depthwise loop and what it does with the product.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace c24 {

constexpr int C = 24, K = 5, P = K / 2, KK = K * K;
constexpr int NT = 256, NW = NT / 32;

// Stage image rows gy0 .. gy0 + RH, columns gx0 .. gx0 + RW of xb (H, W, C)
// channel-major into plane (channel c at plane[c PS ..], PS >= RH RW), f32
// planes as f32, bf16 planes as bf16's bits, zeros off the image: 16-byte
// loads, a warp's lanes on 32 consecutive pixels of one vector column, so a
// lane's stores go to distinct planes on distinct banks. xb's base is
// 16-byte aligned (the wrappers check).
template <typename T, typename S>
__device__ __forceinline__ void stage(const T* __restrict__ xb, S* plane, int PS, int gy0, int gx0, int RH, int RW,
                                      int H, int W) {
  constexpr int EPV = 16 / sizeof(T), VPP = C / EPV;  // elements a vector, vectors a pixel
  const int n = RH * RW;
  for (int i = threadIdx.x; i < VPP * n; i += NT) {
    const int k = i / n, p = i - k * n, r = p / RW, col = p - r * RW;
    const int gy = gy0 + r, gx = gx0 + col;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      raw = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * C) + k);
    if constexpr (std::is_same<S, __nv_bfloat16>::value) {  // bf16 into bf16: the bits as they are
      static_assert(std::is_same<T, S>::value, "a bf16 plane stages bf16");
      const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned short* dst = reinterpret_cast<unsigned short*>(plane);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        dst[(k * EPV + e) * PS + p] = static_cast<unsigned short>(wv[e >> 1] >> (16 * (e & 1)));
    } else {
      float f[EPV];
      roma::unpack16(raw, f, T());
#pragma unroll
      for (int e = 0; e < EPV; ++e) plane[(k * EPV + e) * PS + p] = f[e];
    }
  }
}

// G blocks' depthwise weights dw (G, K, K, C) into dws [G][C][KK] (a
// channel's 25 taps together), db and b2 (G, C) into dbs and b2s
__device__ __forceinline__ void stage_weights(const float* __restrict__ dw, const float* __restrict__ db,
                                              const float* __restrict__ b2, float* dws, float* dbs, float* b2s,
                                              int G) {
  for (int i = threadIdx.x; i < G * C * KK; i += NT) {
    const int g = i / (C * KK), c = i / KK % C, uv = i % KK;
    dws[i] = dw[(g * KK + uv) * C + c];
  }
  for (int i = threadIdx.x; i < G * C; i += NT) {
    dbs[i] = db[i];
    b2s[i] = b2[i];
  }
}

// One staged row ir of the register-blocked depthwise: a lane holds a
// channel's 25 weights wr and NO output rows of NCOL adjacent columns in
// acc, and v the row's K + NCOL - 1 taps. Output row o takes staged row ir
// as its tap row u = ir - o, so over ir ascending each output sums its taps
// u-major, v-minor (the plain version's order). ir is a constant of the
// caller's unrolled loop.
template <int NO, int NCOL>
__device__ __forceinline__ void taps(int ir, const float (&v)[K + NCOL - 1], const float (&wr)[KK],
                                     float (&acc)[NO][NCOL]) {
#pragma unroll
  for (int u = K - 1; u >= 0; --u) {
    const int o = ir - u;
    if (o >= 0 && o < NO) {
#pragma unroll
      for (int q = 0; q < K; ++q)
#pragma unroll
        for (int cc = 0; cc < NCOL; ++cc) acc[o][cc] = fmaf(v[q + cc], wr[u * K + q], acc[o][cc]);
    }
  }
}

// Lane lane's B fragments of the pointwise's w2 (C_in, C_out), f32: w2 =
// hi + lo with hi = bf16(w2) and lo = bf16(w2 - hi), so the two bf16
// products leave w2's rest below 2^-16 of it, far inside one bf16 ulp of the
// output; K padded from 24 to 32 by zeros. [k16 step s][n8 tile j][register].
__device__ __forceinline__ void w2_frags(const float* __restrict__ w2, int lane, uint32_t (&bh)[2][3][2],
                                         uint32_t (&bl)[2][3][2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int n = 8 * j + g;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * s + 2 * t + 8 * h;
        const float w0 = k < C ? __ldg(w2 + k * C + n) : 0.f, w1 = k + 1 < C ? __ldg(w2 + (k + 1) * C + n) : 0.f;
        const float h0 = __bfloat162float(__float2bfloat16(w0)), h1 = __bfloat162float(__float2bfloat16(w1));
        bh[s][j][h] = tc::pack(h0, h1);
        bl[s][j][h] = tc::pack(w0 - h0, w1 - h1);
      }
  }
}

// The pointwise of pixels m0 .. m0 + 16 of t (bf16 channel pairs, [C / 2]
// rows of TPAIR words): (16 x 32) x (32 x 24) as two k16 steps x three n8
// tiles x (hi, lo), acc[j] the m16n8 accumulator of output channels 8 j ..
__device__ __forceinline__ void pointwise16(const uint32_t* tw, int TPAIR, int m0, int lane,
                                            const uint32_t (&bh)[2][3][2], const uint32_t (&bl)[2][3][2],
                                            float (&acc)[3][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    a[s][0] = tw[(8 * s + t) * TPAIR + m0 + g];
    a[s][1] = tw[(8 * s + t) * TPAIR + m0 + g + 8];
    a[s][2] = s == 0 ? tw[(4 + t) * TPAIR + m0 + g] : 0u;  // channels 24..31 are zero
    a[s][3] = s == 0 ? tw[(4 + t) * TPAIR + m0 + g + 8] : 0u;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      tc::mma(acc[j], a[s], bh[s][j][0], bh[s][j][1]);
      tc::mma(acc[j], a[s], bl[s][j][0], bl[s][j][1]);
    }
  }
}

// Write the TH x TW output tile staged [pixel][C] at os to ob (H, W, C) at
// rows y0 .., columns x0 ..: a tile row is TW C contiguous elements, written
// by 16-byte stores (ob's base 16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_tile(const uint4* os, T* ob, int y0, int x0, int TH, int TW, int H, int W) {
  constexpr int VPP = C * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < TH * TW * VPP; i += NT) {
    const int r = i / (TW * VPP), cc = i - r * (TW * VPP);
    const int gy = y0 + r, gx = x0 + cc / VPP;
    if (gy < H && gx < W) reinterpret_cast<uint4*>(ob + ((size_t)gy * W + x0) * C)[cc] = os[i];
  }
}

}  // namespace c24
