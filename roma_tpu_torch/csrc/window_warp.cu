// Kernel G: the windowed tile sampler, exact bilinear per query tile plus
// compacted fixups. One source, two entries:
//   roma_window_warp     replaces roma_tpu/ops/tile_window.py:123 _warp_kernel
//                        (entry windowed_warp, the v2 sampler: 16x16 tiles,
//                        64x128 windows, 32 fixup slots);
//   roma_window_warp_v1  replaces graveyard/window_warp_v1.py:86 _kernel (entry
//                        windowed_grid_sample: 64x64 tiles, 128x192 windows,
//                        64 fixup slots).
//
// For tile i (image b = i / nt) with window origin (oy[i], ox[i]) in the
// image zero-padded by pm, query q of the tile computes, in f32,
//   v = in_window(q) ? sum over the taps (u, w) in (0,0), (0,1), (1,0), (1,1)
//                      of x_uw * weight_uw : 0
//   v += fval[i, s]          for the slot s with fpos[i, s] == q, if any
// with x_uw the padded image at (oy + yl + u, ox + xl + w) (0 off the image),
// in_window(q) = 0 <= yl <= wh-2 and 0 <= xl <= ww-2, and one rounding to the
// I/O dtype at the end, as the TPU kernels compute `where(ok, acc, 0) + fix`.
// The weights, products and sums are warp_tiles_reference's, in its order
// and without contraction (__fmul_rn, __fadd_rn), so on finite inputs the
// kernel gives the plain version's bits. The output is (tiles, T, C),
// query-major.
//
// What bounds it on the H100: bytes. Per query it reads four int/float
// fields and four taps of C channels, and writes C values; at the v2
// sampler's 864^2 x C9 shape (B = 2, 5,832 tiles) the call moves ~85 MB
// against ~0.1 GFLOP, ~25 us at the memory rate. The TPU kernels stage each
// tile's window in VMEM and sample it with one-hot matmuls, because the TPU
// has no fast gather; a bf16 v2 window is 147 KB and an f32 v1 window does
// not fit in a block's shared memory, so here the taps come through L1 from
// the unpadded image (a padded-window position off the image is a zero of
// the padding). The design spends as few instructions per byte as it can:
//   * One thread per query, 256 queries a block. A v2 tile is one block, a
//     v1 tile (T = 4,096) sixteen, so B = 2 at 864^2 launches 5,832 or 6,272
//     blocks of 256 threads: no 1,024-thread block, no half-empty last wave.
//   * A thread reads its query's yl, xl, fy, fx once (neighbouring threads,
//     neighbouring words), tests window and image once per tap, and keeps
//     the C channels in f32 registers. C is a template parameter for 9 (the
//     model's x_hat) and 4, 5, 6 (the test shapes); a looped kernel, one
//     channel at a time with scalar loads, takes any other C.
//   * A tap's C contiguous values come in the widest loads their alignment
//     allows: for an even C every pixel starts on a multiple of
//     gcd(C * sizeof(T), 16) bytes, so the tap is whole vectors of that
//     width; for an odd C a pixel starts on an odd or an even element, and
//     one lone element plus (C - 1) / 2 aligned pairs cover it either way, so
//     every thread of a warp issues the same loads (bf16, C = 9: five loads
//     a tap, not nine).
//   * The block's outputs are staged in shared memory in f32 (256 x C x 4
//     bytes, 9.2 KB at C = 9). After one barrier the slots whose query falls
//     in the block's range add their fixups there (positions are distinct,
//     as compact_miss makes them, so the order does not matter and nothing
//     races); after a second the block rounds its range once and writes it
//     with 16-byte stores. No per-tile slot table is built.
#include <cstdint>

#include "common.cuh"  // Elem, read_tap, store16

namespace {

constexpr int QB = 256;  // queries (threads) a block of the templated kernels

using roma::Elem;
using roma::read_tap;
using roma::store16;

// CT channels in registers, or CT = 0: the looped kernel for a run-time C
template <typename T, int CT>
__global__ void __launch_bounds__(QB) window_warp_kernel(
    const T* __restrict__ x, const int* __restrict__ yl, const int* __restrict__ xl,
    const float* __restrict__ fy, const float* __restrict__ fx, const int* __restrict__ oy,
    const int* __restrict__ ox, const int* __restrict__ fpos, const float* __restrict__ fval,
    T* __restrict__ out, int nt, int chunks, int H, int W, int c_arg, int Tq, int kf, int wh, int ww,
    int pm) {
  extern __shared__ __align__(16) float stage[];  // the block's queries x C, f32
  const int C = CT > 0 ? CT : c_arg;
  const int tile = blockIdx.x / chunks, tid = threadIdx.x;
  const int q0 = (blockIdx.x - tile * chunks) * blockDim.x;  // the block's first query
  const int nq = min(static_cast<int>(blockDim.x), Tq - q0);

  if (tid < nq) {
    const size_t qi = (size_t)tile * Tq + q0 + tid;
    const int ylq = __ldg(yl + qi), xlq = __ldg(xl + qi);
    float* s = stage + tid * C;
    if (ylq >= 0 && ylq <= wh - 2 && xlq >= 0 && xlq <= ww - 2) {
      const float wy = __ldg(fy + qi), wx = __ldg(fx + qi);
      const int yy = __ldg(oy + tile) - pm + ylq, xx = __ldg(ox + tile) - pm + xlq;  // image coords
      const float ay = 1.f - wy, ax = 1.f - wx;
      const float wt[4] = {__fmul_rn(ay, ax), __fmul_rn(ay, wx), __fmul_rn(wy, ax), __fmul_rn(wy, wx)};
      const bool r0 = static_cast<unsigned>(yy) < static_cast<unsigned>(H);
      const bool r1 = static_cast<unsigned>(yy + 1) < static_cast<unsigned>(H);
      const bool c0 = static_cast<unsigned>(xx) < static_cast<unsigned>(W);
      const bool c1 = static_cast<unsigned>(xx + 1) < static_cast<unsigned>(W);
      const bool ok[4] = {r0 && c0, r0 && c1, r1 && c0, r1 && c1};
      const long long pix = ((long long)(tile / nt) * H + yy) * W + xx;  // tap (0, 0); only read if on the image
      const long long off[4] = {pix, pix + 1, pix + W, pix + W + 1};
      if constexpr (CT > 0) {
        float acc[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[j] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;  // an off-image tap adds 0
          float v[CT];
          read_tap<T, CT>(x + off[k] * CT, v);
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wt[k]));
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) s[j] = acc[j];
      } else {
        for (int c = 0; c < C; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (ok[k]) acc = __fadd_rn(acc, __fmul_rn(Elem<T>::load(x + off[k] * C + c), wt[k]));
          s[c] = acc;
        }
      }
    } else {
      for (int c = 0; c < C; ++c) s[c] = 0.f;
    }
  }
  __syncthreads();

  // the fixups of the slots whose query lies in this block's range
  for (int sl = tid; sl < kf; sl += blockDim.x) {
    const int p = __ldg(fpos + (size_t)tile * kf + sl) - q0;  // the sentinel Tq lands past nq
    if (p >= 0 && p < nq) {
      const float* fv = fval + ((size_t)tile * kf + sl) * C;
      for (int c = 0; c < C; ++c) stage[p * C + c] = __fadd_rn(stage[p * C + c], __ldg(fv + c));
    }
  }
  __syncthreads();

  // one rounding, 16-byte stores of the block's contiguous output range
  T* o = out + ((size_t)tile * Tq + q0) * C;
  const int n = nq * C;
  constexpr int VEC = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int nvec = n / VEC;
    for (int v = tid; v < nvec; v += blockDim.x) store16(o + v * VEC, stage + v * VEC);
    done = nvec * VEC;
  }
  for (int i = done + tid; i < n; i += blockDim.x) o[i] = roma::from_f32<T>(stage[i]);
}

template <typename T, int CT>
cudaError_t launch_c(const void* x, const void* yl, const void* xl, const void* fy, const void* fx,
                     const void* oy, const void* ox, const void* fpos, const void* fval, void* out,
                     int n_tiles, int nt, int H, int W, int C, int Tq, int kf, int wh, int ww, int pm,
                     int threads, cudaStream_t s) {
  const size_t smem = (size_t)threads * C * sizeof(float);
  cudaError_t err = roma::allow_smem(window_warp_kernel<T, CT>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (Tq + threads - 1) / threads;
  window_warp_kernel<T, CT><<<(unsigned)n_tiles * chunks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(yl), static_cast<const int*>(xl),
      static_cast<const float*>(fy), static_cast<const float*>(fx), static_cast<const int*>(oy),
      static_cast<const int*>(ox), static_cast<const int*>(fpos), static_cast<const float*>(fval),
      static_cast<T*>(out), nt, chunks, H, W, C, Tq, kf, wh, ww, pm);
  return cudaGetLastError();
}

int launch(const void* x, const void* yl, const void* xl, const void* fy, const void* fx,
           const void* oy, const void* ox, const void* fpos, const void* fval, void* out,
           int n_tiles, int nt, int H, int W, int C, int Tq, int kf, int wh, int ww, int pm,
           int dtype, void* stream) {
  if (n_tiles < 1 || nt < 1 || C < 1 || Tq < 1 || kf < 0 || wh < 2 || ww < 2 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the templated kernels' vector loads need a 16-byte aligned image
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the looped kernel stages at most 96 KB: fewer queries a block for a wide C
  int looped = QB;
  while (looped > 32 && (size_t)looped * C * sizeof(float) > 96 * 1024) looped /= 2;
#define ROMA_WARP_ARGS x, yl, xl, fy, fx, oy, ox, fpos, fval, out, n_tiles, nt, H, W, C, Tq, kf, wh, ww, pm
  ROMA_DISPATCH_DTYPE(dtype, {
    cudaError_t err;
    switch (aligned ? C : 0) {
      case 4: err = launch_c<scalar_t, 4>(ROMA_WARP_ARGS, QB, s); break;
      case 5: err = launch_c<scalar_t, 5>(ROMA_WARP_ARGS, QB, s); break;
      case 6: err = launch_c<scalar_t, 6>(ROMA_WARP_ARGS, QB, s); break;
      case 9: err = launch_c<scalar_t, 9>(ROMA_WARP_ARGS, QB, s); break;
      default: err = launch_c<scalar_t, 0>(ROMA_WARP_ARGS, looped, s);
    }
    return static_cast<int>(err);
  });
#undef ROMA_WARP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The two entries launch the same kernels: the v1 and v2 samplers differ
// in their tiles and windows, which are arguments.
extern "C" int roma_window_warp(const void* x, const void* yl, const void* xl, const void* fy,
                                const void* fx, const void* oy, const void* ox, const void* fpos,
                                const void* fval, void* out, int n_tiles, int nt, int H, int W,
                                int C, int Tq, int kf, int wh, int ww, int pm, int dtype,
                                void* stream) {
  return launch(x, yl, xl, fy, fx, oy, ox, fpos, fval, out, n_tiles, nt, H, W, C, Tq, kf, wh, ww,
                pm, dtype, stream);
}

extern "C" int roma_window_warp_v1(const void* x, const void* yl, const void* xl, const void* fy,
                                   const void* fx, const void* oy, const void* ox,
                                   const void* fpos, const void* fval, void* out, int n_tiles,
                                   int nt, int H, int W, int C, int Tq, int kf, int wh, int ww,
                                   int pm, int dtype, void* stream) {
  return launch(x, yl, xl, fy, fx, oy, ox, fpos, fval, out, n_tiles, nt, H, W, C, Tq, kf, wh, ww,
                pm, dtype, stream);
}
