// Kernel G: the windowed tile sampler, exact bilinear per query tile plus
// compacted fixups. One source, two entries:
//   roma_window_warp     replaces roma_tpu/ops/tile_window.py:_warp_kernel
//                        (entry windowed_warp, the v2 sampler: 16x16 tiles,
//                        64x128 windows, 32 fixup slots);
//   roma_window_warp_v1  replaces graveyard/window_warp_v1.py:_kernel (entry
//                        windowed_grid_sample: 64x64 tiles, 128x192 windows,
//                        64 fixup slots).
//
// For tile i (image b = i / nt) with window origin (oy[i], ox[i]) in the
// image zero-padded by pm, query q of the tile computes, in f32,
//   v = in_window(q) ? ((1-fy) v00 + fy v10) (1-fx) + ((1-fy) v01 + fy v11) fx : 0
//   v += fval[i, s]          for the slot s with fpos[i, s] == q, if any
// with v_uv the padded image at (oy + yl + u, ox + xl + v), in_window(q) =
// 0 <= yl <= wh-2 and 0 <= xl <= ww-2, and one rounding to the I/O dtype at
// the end, as the TPU kernels compute `where(ok, acc, 0) + fix`. The output
// is (tiles, T, C), query-major.
//
// What bounds it on the H100: bytes. Per query it reads four int/float
// fields and four taps of C channels, and writes C values; at the v2
// sampler's 864^2 x C9 shape (B = 2, 5,832 tiles) the call moves ~85 MB
// against ~0.1 GFLOP. The TPU kernels stage each tile's window in VMEM
// and sample it with one-hot matmuls, because the TPU has no fast gather;
// a bf16 window of the v2 default is 147 KB, and the v1 window does not fit
// whole in a block's 227 KB of shared memory. This kernel reads each
// in-window query's four taps through L1 instead, straight from the
// unpadded image: a padded-window position outside the image is a zero of
// the padding, so a tap outside [0, H) x [0, W) reads 0 and the result is
// the padded window's. One block per tile, one thread per (query, channel)
// element so neighbouring threads read neighbouring channels of a tap and
// write neighbouring outputs. The tile's slot of each query (its fixup) is
// looked up in a shared table of T ints built from fpos; the positions are
// distinct, as compact_miss makes them.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(1024) window_warp_kernel(const T* __restrict__ x, const int* __restrict__ yl,
                                   const int* __restrict__ xl, const float* __restrict__ fy,
                                   const float* __restrict__ fx, const int* __restrict__ oy,
                                   const int* __restrict__ ox, const int* __restrict__ fpos,
                                   const float* __restrict__ fval, T* __restrict__ out, int nt,
                                   int H, int W, int C, int Tq, int kf, int wh, int ww, int pm) {
  extern __shared__ int slot_of[];  // Tq entries: the fixup slot of each query, or -1
  const int tile = blockIdx.x, tid = threadIdx.x;
  for (int q = tid; q < Tq; q += blockDim.x) slot_of[q] = -1;
  __syncthreads();
  for (int s = tid; s < kf; s += blockDim.x) {
    const int p = fpos[(size_t)tile * kf + s];
    if (p >= 0 && p < Tq) slot_of[p] = s;  // the sentinel Tq matches no query
  }
  __syncthreads();

  const T* xb = x + (size_t)(tile / nt) * H * W * C;
  const int y_org = oy[tile] - pm, x_org = ox[tile] - pm;  // window origin, image coords
  const size_t q_base = (size_t)tile * Tq;
  const float* fv = fval + (size_t)tile * kf * C;
  auto tap = [&](int yy, int xx, int c) -> float {
    return (yy >= 0 && yy < H && xx >= 0 && xx < W) ? roma::to_f32(xb[((size_t)yy * W + xx) * C + c])
                                                    : 0.f;
  };
  for (int idx = tid; idx < Tq * C; idx += blockDim.x) {
    const int q = idx / C, c = idx - q * C;
    const size_t qi = q_base + q;
    const int ylq = yl[qi], xlq = xl[qi];
    float v = 0.f;
    if (ylq >= 0 && ylq <= wh - 2 && xlq >= 0 && xlq <= ww - 2) {
      const int yy = y_org + ylq, xx = x_org + xlq;
      const float wy = fy[qi], wx = fx[qi];
      const float top = tap(yy, xx, c) * (1.f - wy) + tap(yy + 1, xx, c) * wy;
      const float bot = tap(yy, xx + 1, c) * (1.f - wy) + tap(yy + 1, xx + 1, c) * wy;
      v = top * (1.f - wx) + bot * wx;
    }
    const int s = slot_of[q];
    if (s >= 0) v += fv[(size_t)s * C + c];
    out[qi * C + c] = roma::from_f32<T>(v);
  }
}

int launch(const void* x, const void* yl, const void* xl, const void* fy, const void* fx,
           const void* oy, const void* ox, const void* fpos, const void* fval, void* out,
           int n_tiles, int nt, int H, int W, int C, int Tq, int kf, int wh, int ww, int pm,
           int dtype, int threads, void* stream) {
  if (n_tiles < 1 || nt < 1 || C < 1 || Tq < 1 || kf < 0 || wh < 2 || ww < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)Tq * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    cudaError_t err = roma::allow_smem(window_warp_kernel<scalar_t>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_warp_kernel<scalar_t><<<n_tiles, threads, smem, s>>>(
        static_cast<const scalar_t*>(x), static_cast<const int*>(yl),
        static_cast<const int*>(xl), static_cast<const float*>(fy),
        static_cast<const float*>(fx), static_cast<const int*>(oy),
        static_cast<const int*>(ox), static_cast<const int*>(fpos),
        static_cast<const float*>(fval), static_cast<scalar_t*>(out), nt, H, W, C, Tq, kf, wh,
        ww, pm);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v2 tiles are small (T = 256 at the default): one thread per query-channel
// element of a 256-thread block covers a C = 9 tile in nine steps.
extern "C" int roma_window_warp(const void* x, const void* yl, const void* xl, const void* fy,
                                const void* fx, const void* oy, const void* ox, const void* fpos,
                                const void* fval, void* out, int n_tiles, int nt, int H, int W,
                                int C, int Tq, int kf, int wh, int ww, int pm, int dtype,
                                void* stream) {
  return launch(x, yl, xl, fy, fx, oy, ox, fpos, fval, out, n_tiles, nt, H, W, C, Tq, kf, wh, ww,
                pm, dtype, 256, stream);
}

// v1 tiles are 16x larger (T = 4096): a 1024-thread block, so a tile's
// 36,864 elements at C = 9 take 36 steps, and the 392 tiles of a B = 2,
// 864^2 batch still give each of the 132 SMs about three blocks.
extern "C" int roma_window_warp_v1(const void* x, const void* yl, const void* xl, const void* fy,
                                   const void* fx, const void* oy, const void* ox,
                                   const void* fpos, const void* fval, void* out, int n_tiles,
                                   int nt, int H, int W, int C, int Tq, int kf, int wh, int ww,
                                   int pm, int dtype, void* stream) {
  return launch(x, yl, xl, fy, fx, oy, ox, fpos, fval, out, n_tiles, nt, H, W, C, Tq, kf, wh, ww,
                pm, dtype, 1024, stream);
}
