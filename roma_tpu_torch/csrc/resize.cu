// Kernel M: Pillow's 8-bit bicubic resize of uint8 RGB images (B, H, W, 3),
// bit for bit, fused with the [0, 1] scaling, the ImageNet normalization and
// the cast to the net's dtype: out (B, h, w, 3) in float32 or bfloat16.
//
// M replaces no TPU kernel: the JAX package resizes on the host with PIL
// (roma_tpu/utils/image.py resize). It was added because on the H100 the
// single-pair match spent about a third of a request in four PIL resizes on
// the host while the card sat idle.
//
// Arithmetic, Pillow's (libImaging/Resample.c, ImagingResampleHorizontal_8bpc
// and ImagingResampleVertical_8bpc): the per-axis tables of
// roma_tpu_torch/ops/resize.py pillow_coeffs give each output column and row
// its first tap, its tap count and int32 weights in 22-bit fixed point. The
// horizontal pass runs first: 1 << 21 plus the sum of pixel * weight in
// int32, then clip8 (>> 22, clamped to 0..255) into a uint8 intermediate;
// then the vertical pass on that intermediate, the same way. A pass whose
// size does not change has the identity table (Pillow skips the pass; one
// tap of weight 1 << 22 gives the same bytes). The epilogue is the float ops
// PyTorch runs on the card for imagenet_normalize(x.float() / 255.0):
// x * (1.0f / 255.0f) (its division by a CPU scalar multiplies by the
// reciprocal), (x - mean) / std in IEEE single (__fsub_rn, __fdiv_rn: no
// contraction into an FMA), then round to nearest even into bfloat16.
//
// What bounds it on the H100: bytes. At the single-pair traffic (two 720x960
// images to 560^2 and to 864^2) it reads 4.1 MB of uint8 and writes 12.7 MB
// of bf16, ~5 us at the memory's rate; the arithmetic is a few integer
// multiply-adds a byte. The design keeps the intermediate out of device
// memory: a block takes a tile of output rows and columns of one image,
// resamples horizontally into shared memory only the input rows its
// vertical taps read (Pillow's ybox for the tile), then runs the vertical
// pass and the epilogue from shared memory and writes the tile's rows as
// contiguous runs of 3 * columns elements. The wrapper picks the tile
// (ops/resize.py resize_plan) so that the intermediate fits 48 KB.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PB = 22;  // Pillow's PRECISION_BITS for 8-bit images
constexpr int SMEM_MAX = 48 * 1024;
constexpr float INV255 = 1.0f / 255.0f;

__device__ __forceinline__ unsigned char clip8(int s) {
  s >>= PB;
  return static_cast<unsigned char>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// table row i: [first tap, tap count, weight 0 .. weight k - 1], k + 2 ints
template <typename T>
__global__ void __launch_bounds__(THREADS) pil_bicubic_normalize_kernel(
    const unsigned char* __restrict__ in, T* __restrict__ out, const int* __restrict__ xtab,
    const int* __restrict__ ytab, int H, int W, int h, int w, int kx, int ky, int tile_r, int tile_c) {
  extern __shared__ unsigned char mid[];  // [span][tile_c][3]: the horizontal pass's rows
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * tile_c;
  const int nr = min(tile_r, h - r0), nc = min(tile_c, w - c0);
  const int sx = kx + 2, sy = ky + 2;
  const int y0 = __ldg(ytab + (size_t)r0 * sy);
  const int* last = ytab + (size_t)(r0 + nr - 1) * sy;
  const int span = __ldg(last) + __ldg(last + 1) - y0;
  const unsigned char* img = in + (size_t)blockIdx.z * H * W * 3;

  for (int i = threadIdx.x; i < span * nc; i += THREADS) {
    const int r = i / nc, c = i - r * nc;
    const int* t = xtab + (size_t)(c0 + c) * sx;
    const int n = __ldg(t + 1);
    const unsigned char* p = img + ((size_t)(y0 + r) * W + __ldg(t)) * 3;
    int s0 = 1 << (PB - 1), s1 = s0, s2 = s0;
    for (int k = 0; k < n; ++k) {
      const int wk = __ldg(t + 2 + k);
      s0 += __ldg(p + 3 * k) * wk;
      s1 += __ldg(p + 3 * k + 1) * wk;
      s2 += __ldg(p + 3 * k + 2) * wk;
    }
    unsigned char* q = mid + (r * tile_c + c) * 3;
    q[0] = clip8(s0);
    q[1] = clip8(s1);
    q[2] = clip8(s2);
  }
  __syncthreads();

  const int row = nc * 3, pitch = tile_c * 3;
  T* o = out + (((size_t)blockIdx.z * h + r0) * w + c0) * 3;
  for (int i = threadIdx.x; i < nr * row; i += THREADS) {
    const int r = i / row, e = i - r * row;  // e = column * 3 + channel
    const int* t = ytab + (size_t)(r0 + r) * sy;
    const int n = __ldg(t + 1);
    const unsigned char* p = mid + (__ldg(t) - y0) * pitch + e;
    int s = 1 << (PB - 1);
    for (int k = 0; k < n; ++k) s += p[k * pitch] * __ldg(t + 2 + k);
    const int ch = e % 3;
    const float mean = ch == 0 ? 0.485f : (ch == 1 ? 0.456f : 0.406f);  // utils/image.py IMAGENET_MEAN
    const float sd = ch == 0 ? 0.229f : (ch == 1 ? 0.224f : 0.225f);   // IMAGENET_STD
    const float v = __fmul_rn(static_cast<float>(clip8(s)), INV255);
    o[(size_t)r * w * 3 + e] = roma::from_f32<T>(__fdiv_rn(__fsub_rn(v, mean), sd));
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (_ext.DTYPE_CODES); span: the most input rows
// a tile of tile_r output rows reads (ops/resize.py resize_plan). Shapes the
// kernel cannot take are refused, never run.
extern "C" int roma_resize_normalize(const void* in, void* out, const void* xtab, const void* ytab, int B,
                                     int H, int W, int h, int w, int kx, int ky, int tile_r, int tile_c,
                                     int span, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || h < 1 || w < 1 || kx < 1 || ky < 1 || tile_r < 1 ||
      tile_c < 1 || span < 1 || (h + tile_r - 1) / tile_r > 65535 ||
      static_cast<long long>(span) * tile_c * 3 > SMEM_MAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + tile_c - 1) / tile_c, (h + tile_r - 1) / tile_r, B);
  const size_t smem = static_cast<size_t>(span) * tile_c * 3;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const unsigned char*>(in);
  const auto* tx = static_cast<const int*>(xtab);
  const auto* ty = static_cast<const int*>(ytab);
  if (dtype == 0)
    pil_bicubic_normalize_kernel<float><<<grid, THREADS, smem, s>>>(x, static_cast<float*>(out), tx, ty, H, W, h,
                                                                    w, kx, ky, tile_r, tile_c);
  else
    pil_bicubic_normalize_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        x, static_cast<__nv_bfloat16*>(out), tx, ty, H, W, h, w, kx, ky, tile_r, tile_c);
  return static_cast<int>(cudaGetLastError());
}
