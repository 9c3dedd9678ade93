// Kernel C: exact bilinear grid sample of an NHWC feature map.
//
// Replaces roma_tpu/ops/lane_warp.py:_lane_kernel (entry lane_warp, via the
// warp_sample dispatcher): grid_sample(y, flow) with bilinear weights, zeros
// padding, align_corners=False, ix = (x + 1) * W / 2 - 0.5 as
// roma_tpu/ops/tile_window.py. y is (B, H, W, C), flow (B, Hq, Wq, 2) f32,
// the output (B, Hq, Wq, C) in y's dtype. For each query the kernel computes,
// in f32 and in the order of the plain version (ops/grid_sample.py),
//   fx = ix - floor(ix), fy likewise, the weights (1-fy)(1-fx), (1-fy)fx,
//   fy(1-fx), fy fx, and ((t00 w00 + t01 w01) + t10 w10) + t11 w11
// over the taps on the image (a tap off it adds nothing; the plain version
// adds tap * 0), every product and sum rounded on its own (__fmul_rn,
// __fadd_rn: no contraction), then one rounding to y's dtype. So on finite
// inputs the kernel gives warp_sample_reference's bits.
//
// What bounds it on the H100: bytes. Per query it reads 8 bytes of flow and
// four taps of C channels (mostly from L1/L2: neighbouring queries share
// taps) and writes C values; the nine main-path shapes of a 560 -> 864
// match (B = 2) move ~445 MB, 0.133 ms at the memory rate. The TPU kernel's
// windows, lane packing and miss fixups exist because the TPU has no fast
// gather; the H100 gathers through L1/L2. A query's coordinates, fractions,
// weights and on-image tests are computed once, in 32-bit indexing (the
// wrapper checks that the sizes fit), never per channel. Three paths, picked
// by the wrapper (ops/warp_sample.py:warp_sample_checks):
//   * vector: a pixel is whole 16-byte vectors (bf16 C % 8 == 0, f32
//     C % 4 == 0; the model's C = 64, 256, 512): G = C * sizeof(T) / 16 / NV
//     lanes a query, each loading NV 16-byte vectors of each of the 4 tap
//     rows, combining them in f32 and storing 16 bytes per vector. NV = 2
//     for rows of 32 vectors or more (C = 512 in bf16: a warp a query; C =
//     256: 16 lanes a query; ~5% faster there than a warp of one vector
//     each), else 1 (C = 64: 8 lanes a query, 4 queries a warp).
//     Neighbouring lanes read neighbouring vectors of one tap row: each tap
//     is coalesced, and every query's flow is one broadcast load.
//   * registers: C = 3, 5, 7, 9 (odd widths; the model's scale-1 x_hat is
//     C = 9): a thread per query with the pixel's channels in f32 registers,
//     each tap read by roma::read_tap (one lone element plus aligned pairs),
//     the block's 256 x C outputs staged in shared memory and written with
//     16-byte stores (a thread per (query, channel) would make 2-byte loads
//     18 bytes apart at C = 9, which no warp coalesces).
//   * scalar: any other C, a thread per output element.
#include "common.cuh"  // Elem, read_tap, store16, pack_bf16

namespace {

using roma::Elem;

constexpr int NT = 256;  // threads a block, every path

// one query's bilinear taps: the weights, which taps lie on the image, and
// the image-local pixel index of tap (0, 0) (taps (0, 1), (1, 0), (1, 1) are
// pix + 1, pix + W, pix + W + 1; an index is used only where its tap is on
// the image)
struct Taps {
  float w[4];
  bool ok[4];
  int pix;
};

__device__ __forceinline__ Taps query_taps(const float* __restrict__ flow, int q, int H, int W) {
  const float gx = __ldg(flow + 2 * q), gy = __ldg(flow + 2 * q + 1);
  // (g + 1) * W / 2 - 0.5, each step rounded as the plain version rounds it
  const float ix = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 0.5f), 0.5f);
  const float iy = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 0.5f), 0.5f);
  const float x0f = floorf(ix), y0f = floorf(iy);
  const float fx = __fsub_rn(ix, x0f), fy = __fsub_rn(iy, y0f);
  const float ax = __fsub_rn(1.f, fx), ay = __fsub_rn(1.f, fy);
  Taps t;
  t.w[0] = __fmul_rn(ay, ax);
  t.w[1] = __fmul_rn(ay, fx);
  t.w[2] = __fmul_rn(fy, ax);
  t.w[3] = __fmul_rn(fy, fx);
  // the on-image tests in f32, so a coordinate far off the image is never
  // converted to an int
  const bool c0 = x0f >= 0.f && x0f <= (float)(W - 1), c1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool r0 = y0f >= 0.f && y0f <= (float)(H - 1), r1 = y0f >= -1.f && y0f <= (float)(H - 2);
  t.ok[0] = r0 && c0;
  t.ok[1] = r0 && c1;
  t.ok[2] = r1 && c0;
  t.ok[3] = r1 && c1;
  const bool any = (r0 || r1) && (c0 || c1);
  t.pix = any ? (int)y0f * W + (int)x0f : 0;
  return t;
}

__device__ __forceinline__ int tap_offset(int k, int W) { return (k >> 1) * W + (k & 1); }

// one 16-byte vector of outputs from f32 registers, rounded to T
__device__ __forceinline__ void store_vec(float* o, const float (&a)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float (&a)[8]) {
  *reinterpret_cast<uint4*>(o) = make_uint4(roma::pack_bf16(a[0], a[1]), roma::pack_bf16(a[2], a[3]),
                                            roma::pack_bf16(a[4], a[5]), roma::pack_bf16(a[6], a[7]));
}

// 16-byte vectors of a row: G lanes a query, NV vectors a lane
template <typename T, int NV>
__global__ void __launch_bounds__(NT) warp_vec_kernel(const T* __restrict__ y, const float* __restrict__ flow,
                                                     T* __restrict__ out, int nq, int nq_img, int H, int W,
                                                     int C, int G) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int i = blockIdx.x * NT + threadIdx.x;
  const int q = i / G, lane = i - q * G;
  if (q >= nq) return;
  const Taps t = query_taps(flow, q, H, W);
  const T* yb = y + (q / nq_img) * H * W * C;
  uint4 r[4][NV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4* p = reinterpret_cast<const uint4*>(yb + (t.pix + tap_offset(k, W)) * C) + lane;
#pragma unroll
    for (int v = 0; v < NV; ++v) r[k][v] = t.ok[k] ? __ldg(p + v * G) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.ok[k]) continue;  // an off-image tap adds nothing
      float f[E];
      roma::unpack16(r[k][v], f, T());
#pragma unroll
      for (int j = 0; j < E; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(f[j], t.w[k]));
    }
    store_vec(out + q * C + (lane + v * G) * E, acc);
  }
}

// a thread per query, the C channels in registers
template <typename T, int C>
__global__ void __launch_bounds__(NT) warp_reg_kernel(const T* __restrict__ y, const float* __restrict__ flow,
                                                     T* __restrict__ out, int nq, int nq_img, int H, int W) {
  __shared__ __align__(16) float stage[NT * C];  // the block's outputs, f32
  const int q0 = blockIdx.x * NT, q = q0 + threadIdx.x;
  const int nb = min(NT, nq - q0);  // the block's queries
  if (q < nq) {
    const Taps t = query_taps(flow, q, H, W);
    const T* yb = y + (q / nq_img) * H * W * C;
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.ok[k]) continue;
      float v[C];
      roma::read_tap<T, C>(yb + (t.pix + tap_offset(k, W)) * C, v);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], t.w[k]));
    }
#pragma unroll
    for (int j = 0; j < C; ++j) stage[threadIdx.x * C + j] = acc[j];
  }
  __syncthreads();
  // one rounding, 16-byte stores of the block's contiguous output range
  T* o = out + q0 * C;
  const int n = nb * C;
  constexpr int VEC = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int nvec = n / VEC;
    for (int v = threadIdx.x; v < nvec; v += NT) roma::store16(o + v * VEC, stage + v * VEC);
    done = nvec * VEC;
  }
  for (int i = done + threadIdx.x; i < n; i += NT) o[i] = roma::from_f32<T>(stage[i]);
}

// a thread per output element, any C
template <typename T>
__global__ void __launch_bounds__(NT) warp_scalar_kernel(const T* __restrict__ y, const float* __restrict__ flow,
                                                        T* __restrict__ out, int n, int nq_img, int H, int W,
                                                        int C) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int q = i / C, c = i - q * C;
  const Taps t = query_taps(flow, q, H, W);
  const T* yb = y + (q / nq_img) * H * W * C + c;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.ok[k]) acc = __fadd_rn(acc, __fmul_rn(Elem<T>::load(yb + (t.pix + tap_offset(k, W)) * C), t.w[k]));
  out[i] = roma::from_f32<T>(acc);
}

unsigned blocks_for(long long threads) { return static_cast<unsigned>((threads + NT - 1) / NT); }

}  // namespace

// path: 0 scalar, 1 registers (C = 3, 5, 7, 9), 2 vector (C * sizeof(T) % 16
// == 0); the wrapper has checked that B * H * W * C and B * Hq * Wq * C fit
// an int and that y's base is aligned for the path
extern "C" int roma_warp_sample(const void* y, const void* flow, void* out, int B, int H, int W, int C,
                                int Hq, int Wq, int path, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Hq < 1 || Wq < 1 || path < 0 || path > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq_img = Hq * Wq, nq = B * nq_img;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    const scalar_t* ys = static_cast<const scalar_t*>(y);
    const float* fl = static_cast<const float*>(flow);
    scalar_t* os = static_cast<scalar_t*>(out);
    if (path == 2) {
      constexpr int E = 16 / sizeof(scalar_t);
      if (C % E) return static_cast<int>(cudaErrorInvalidValue);
      const int L = C / E;  // vectors a row
      if (L >= 32 && L % 2 == 0) {
        warp_vec_kernel<scalar_t, 2><<<blocks_for((long long)nq * (L / 2)), NT, 0, s>>>(ys, fl, os, nq, nq_img, H,
                                                                                         W, C, L / 2);
      } else {
        warp_vec_kernel<scalar_t, 1><<<blocks_for((long long)nq * L), NT, 0, s>>>(ys, fl, os, nq, nq_img, H, W, C,
                                                                                   L);
      }
    } else if (path == 1) {
      const unsigned g = blocks_for(nq);
      switch (C) {
        case 3: warp_reg_kernel<scalar_t, 3><<<g, NT, 0, s>>>(ys, fl, os, nq, nq_img, H, W); break;
        case 5: warp_reg_kernel<scalar_t, 5><<<g, NT, 0, s>>>(ys, fl, os, nq, nq_img, H, W); break;
        case 7: warp_reg_kernel<scalar_t, 7><<<g, NT, 0, s>>>(ys, fl, os, nq, nq_img, H, W); break;
        case 9: warp_reg_kernel<scalar_t, 9><<<g, NT, 0, s>>>(ys, fl, os, nq, nq_img, H, W); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    } else {
      warp_scalar_kernel<scalar_t><<<blocks_for((long long)nq * C), NT, 0, s>>>(ys, fl, os, nq * C, nq_img, H, W,
                                                                                  C);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
