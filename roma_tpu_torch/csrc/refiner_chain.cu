// Kernel H: a chain of folded ConvRefiner blocks in one launch, the
// intermediate planes kept in shared memory.
//
// Replaces roma_tpu/ops/pallas_refiner.py:_cmajor_packed_kernel (entry
// _fused_cmajor_packed), the TPU kernel that runs a whole stack of folded
// blocks per strip with a halo of 2 rows per block, on channel chunks of cg.
// Each block (fold_block: BatchNorm folded into the depthwise conv, all f32)
// computes, with zero SAME padding,
//   t[c]   = round(relu(sum_{u,v} x[y+u-p, x+v-p, c] * dw[u, v, c] + db[c]))
//   out[d] = round(sum_c t[c] * w2[c, d] + b2[d]), zeroed outside the image
// where round() is the I/O dtype, as the TPU kernel rounds after each stage
// (pallas_refiner.py:332,340); the zeroing is the padding the next block
// sees (:339). Kernel D (refiner_stack.cu) computes the same per launch of
// one block.
//
// What bounds it on the H100: at the scale-1 stack (9 blocks, C = 24, 864^2,
// B = 2) the f32 FMAs: 9 x (25 C + C^2) per pixel, ~32 GFLOP on the CUDA
// cores against 72 MB read and written once in bf16. Design: one block per
// TH x TW output tile of one image; the tile plus a halo of p = K/2 pixels
// per block of the group on every side is staged channel-major
// (C, rows, cols) in shared memory, in the I/O dtype (every stored value is
// already rounded to it, so nothing is lost), and ping-pongs between two
// planes: each stage computes, for every pixel of its shrinking region, the
// depthwise outputs on channel chunks of cg and folds each into the C
// pointwise sums held in registers, so no intermediate reaches device memory.
// Nine blocks of C = 24 need a halo of 18, and two float32 planes of that
// overflow a block's 227 KB, so one launch takes a group of g blocks (the
// wrapper picks g, the entry below the tile that fits; the result depends on
// neither) and a stack takes ceil(9 / g) launches.
#include "common.cuh"

namespace {

constexpr int MAXC = 32, MAXCG = 8, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) refiner_chain_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H, int W,
    int C, int K, int G, int TH, int TW, int cg) {
  extern __shared__ float sm[];
  const int p = K / 2, halo = p * G, RH = TH + 2 * halo, RW = TW + 2 * halo, plane = RH * RW;
  float* dws = sm;                  // G x K*K x C
  float* dbs = dws + G * K * K * C;  // G x C
  float* w2s = dbs + G * C;          // G x C x C (in, out)
  float* b2s = w2s + G * C * C;      // G x C
  T* buf0 = reinterpret_cast<T*>(b2s + G * C);  // C x RH x RW
  T* buf1 = buf0 + (size_t)C * plane;
  const int tid = threadIdx.x, b = blockIdx.z;
  const int gy0 = blockIdx.y * TH - halo, gx0 = blockIdx.x * TW - halo;

  for (int i = tid; i < G * K * K * C; i += THREADS) dws[i] = dw[i];
  for (int i = tid; i < G * C * C; i += THREADS) w2s[i] = w2[i];
  for (int i = tid; i < G * C; i += THREADS) {
    dbs[i] = db[i];
    b2s[i] = b2[i];
  }
  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < C * plane; i += THREADS) {
    const int c = i % C, pix = i / C, r = pix / RW, col = pix % RW;
    const int gy = gy0 + r, gx = gx0 + col;
    buf0[c * plane + pix] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                ? xb[((size_t)gy * W + gx) * C + c]
                                : roma::from_f32<T>(0.f);
  }
  __syncthreads();

  for (int k = 0; k < G; ++k) {
    const T* src = (k & 1) ? buf1 : buf0;
    T* dst = (k & 1) ? buf0 : buf1;
    const float* kdw = dws + k * K * K * C;
    const float* kdb = dbs + k * C;
    const float* kw2 = w2s + k * C * C;
    const float* kb2 = b2s + k * C;
    const int lo = p * (k + 1), nr = RH - 2 * lo, nc = RW - 2 * lo;  // region of valid outputs
    for (int i = tid; i < nr * nc; i += THREADS) {
      const int r = lo + i / nc, col = lo + i % nc;
      float o[MAXC];
#pragma unroll
      for (int d = 0; d < MAXC; ++d) o[d] = 0.f;
      for (int c0 = 0; c0 < C; c0 += cg) {
        const int n_c = min(cg, C - c0);
        float acc[MAXCG];
#pragma unroll
        for (int j = 0; j < MAXCG; ++j) acc[j] = 0.f;
        for (int u = 0; u < K; ++u) {
          for (int v = 0; v < K; ++v) {
            const T* s = src + (size_t)c0 * plane + (r - p + u) * RW + (col - p + v);
            const float* wt = kdw + (u * K + v) * C + c0;
#pragma unroll
            for (int j = 0; j < MAXCG; ++j)
              if (j < n_c) acc[j] = fmaf(roma::to_f32(s[j * plane]), wt[j], acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < MAXCG; ++j) {
          if (j < n_c) {
            const float t = roma::round_to<T>(fmaxf(acc[j] + kdb[c0 + j], 0.f));
            const float* wrow = kw2 + (c0 + j) * C;
#pragma unroll
            for (int d = 0; d < MAXC; ++d)
              if (d < C) o[d] = fmaf(t, wrow[d], o[d]);
          }
        }
      }
      const int gy = gy0 + r, gx = gx0 + col;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (k == G - 1) {  // the region is now the TH x TW tile itself
        if (inside) {
          T* po = out + (((size_t)b * H + gy) * W + gx) * C;
#pragma unroll
          for (int d = 0; d < MAXC; ++d)
            if (d < C) po[d] = roma::from_f32<T>(o[d] + kb2[d]);
        }
      } else {
#pragma unroll
        for (int d = 0; d < MAXC; ++d)
          if (d < C) dst[d * plane + r * RW + col] = roma::from_f32<T>(inside ? o[d] + kb2[d] : 0.f);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The tiling is decided here, once: the tile is s_rows rows by the widest TW
// whose group weights (f32) and two C x (TH + 2 halo) x (TW + 2 halo) planes
// in the I/O dtype fit in the device's opt-in shared memory per block; TH is
// halved while TW < 8. The result does not depend on the tile.
extern "C" int roma_refiner_chain(const void* x, const void* dw, const void* db, const void* w2,
                                  const void* b2, void* out, int B, int H, int W, int C, int K,
                                  int G, int s_rows, int cg, int dtype, void* stream) {
  if (C < 1 || C > MAXC || K < 1 || K % 2 == 0 || G < 1 || s_rows < 1 || cg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cg = min(cg, MAXCG);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long halo = (long long)(K / 2) * G, es = dtype == 1 ? 2 : 4;
  const long long weights = (long long)G * (K * K * C + C * C + 2 * C) * 4;
  long long TH = s_rows, TW;
  for (;;) {
    TW = (limit - weights) / (2 * es * C * (TH + 2 * halo)) - 2 * halo;
    if (TW >= 8 || TH == 1) break;
    TH = TH / 2 > 1 ? TH / 2 : 1;
  }
  if (TW < 1) return static_cast<int>(cudaErrorInvalidValue);  // the group does not fit
  const size_t smem = weights + 2 * es * C * (TH + 2 * halo) * (TW + 2 * halo);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    err = roma::allow_smem(refiner_chain_kernel<scalar_t>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    refiner_chain_kernel<scalar_t><<<grid, THREADS, smem, s>>>(
        static_cast<const scalar_t*>(x), static_cast<const float*>(dw),
        static_cast<const float*>(db), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<scalar_t*>(out), H, W, C, K, G, (int)TH,
        (int)TW, cg);
  });
  return static_cast<int>(cudaGetLastError());
}
