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
// What bounds it on the H100: at the scale-1 stack (9 blocks, C = 24, 560^2
// and 864^2, B = 2) a block does 600 depthwise FMAs and 576 pointwise ones
// a pixel against 48 bytes of bf16 in and out. With the pointwise on the
// tensor cores, the depthwise's f32 FMAs on the CUDA cores bound it (Kernel
// D's row counts the same), and each launch of a group saves one HBM round
// trip of the planes between blocks.
//
// Two bodies, picked by the wrapper's checks (ops/refiner_stack.py:
// packed_checks) before the launch:
//  * c24, the scale-1 stack in bf16 (C = 24, K = 5), Kernel D's design run
//    over a group of G <= 3 blocks. A block owns a 16 x TW output tile, TW =
//    32 - 4 (G - 1), so the staged region is 36 columns wide for every G and
//    the first stage's outputs are 32 columns. The region (halo 2 G) is
//    staged channel-major by 16-byte loads into one bf16 plane: every stored
//    value is already rounded to bf16, so the plane loses nothing and holds
//    twice the pixels an f32 one would. Each stage takes its whole shrinking
//    region at once: the depthwise register-blocked as in D (a warp a
//    channel; a half-warp half the rows, a lane two columns from three
//    4-byte loads a staged row, its 25 weights and 2 x rows / 2 sums in
//    registers), t rounded into a buffer, then the pointwise on mma.sync
//    m16n8k16 with w2 split into bf16 hi + lo (D's split, w2 kept f32 to
//    2^-16 of itself; the fragments made once a block), written over the
//    plane, which the depthwise has finished reading, zeroed outside the
//    image: one plane, so two blocks fit an SM at every G. The last stage
//    writes the output tile [pixel][C] over the plane for 16-byte stores.
//    The group's recompute at G = 2: (20 x 32 + 16 x 28) / (16 x 28), 2.4
//    stage-pixels an output pixel against D's 2.
//  * generic, any other C <= 32 and odd K, and float32: one thread a pixel,
//    f32 planes or bf16 ones in the I/O dtype, the pointwise in f32 on the
//    CUDA cores into 32 registers, the depthwise on channel chunks of cg;
//    the group's g and the tile (s_rows rows by the widest TW that fits)
//    are the wrapper's and the entry's, and the result depends on neither.
#include "common.cuh"
#include "refiner_c24.cuh"

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

// ---------------------------------------------------------------------------
// The C = 24, K = 5 chain in bf16 (the scale-1 stack), on Kernel D's design
// (its shared pieces: refiner_c24.cuh).
namespace c24 {
namespace {

constexpr int TH = 16;  // output rows a block (even: the half-warps split a stage's rows)
constexpr int RW = 36;  // plane columns: TW + 4 G, TW = 32 - 4 (G - 1)
constexpr int FRAG = 24;  // a block's pointwise B fragments (w2 = hi + lo), words a lane
static_assert(C % NW == 0 && TH % 2 == 0, "tile shape");

__host__ __device__ constexpr int tw_of(int g) { return 32 - 4 * (g - 1); }
__host__ __device__ constexpr int rh_of(int g) { return TH + 4 * g; }
// a plane's channel stride (elements): RH x RW padded to 8 mod 64, so that
// the pointwise's stores to channels d and d + 2 (lanes t and t + 1) fall 8
// banks apart
__host__ __device__ constexpr int ps_of(int g) { return rh_of(g) * RW + ((8 - rh_of(g) * RW) % 64 + 64) % 64; }
// words a channel pair of t: the first stage's region, TH + 4 (G - 1) rows of
// 32 columns, + 8 (= 8 mod 32: conflict-free A fragments)
__host__ __device__ constexpr int tpair_of(int g) { return (TH + 4 * (g - 1)) * 32 + 8; }

// the plane C x PS (bf16), t (C / 2 x TPAIR words), then G blocks' B
// fragments (FRAG x 32 lanes), dw (C x KK), db, b2
__host__ __device__ constexpr size_t plane_bytes(int g) { return (size_t)C * ps_of(g) * 2; }
__host__ __device__ constexpr size_t smem_bytes(int g) {
  return plane_bytes(g) + (size_t)(C / 2) * tpair_of(g) * 4 + (size_t)g * (FRAG * 32 + C * KK + 2 * C) * 4;
}

__device__ __forceinline__ float lo16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The depthwise of one stage into t: output rows lo .. lo + 2 HR, columns lo
// .. lo + nc of the plane. Warp wid takes channels wid, wid + 8, wid + 16;
// half-warp h the rows lo + h HR .., lane l of it the columns lo + 2 l, + 1:
// three 4-byte loads (6 columns) a staged row, 25 weights and 2 HR sums in
// registers, each staged row read once for up to 5 output rows.
template <int HR>
__device__ __forceinline__ void depthwise(const __nv_bfloat16* plane, __nv_bfloat16* t, const float* dws,
                                          const float* dbs, int PS, int TPAIR, int lo, int nc, int wid, int lane) {
  const int h = lane >> 4, l = lane & 15;
  const bool live = 2 * l < nc;  // nc is even
  for (int c = wid; c < C; c += NW) {
    float wr[KK];
#pragma unroll
    for (int i = 0; i < KK; ++i) wr[i] = dws[c * KK + i];
    const float cb = dbs[c];
    float acc[HR][2];
#pragma unroll
    for (int o = 0; o < HR; ++o) acc[o][0] = acc[o][1] = 0.f;
    if (live) {
      // staged row lo - P + h HR + ir, columns lo - P + 2 l .. + 6 (lo - P even)
      const uint32_t* s0 =
          reinterpret_cast<const uint32_t*>(plane + c * PS + (lo - P + h * HR) * RW + lo - P + 2 * l);
#pragma unroll
      for (int ir = 0; ir < HR + 2 * P; ++ir) {
        const uint32_t w0 = s0[ir * (RW / 2)], w1 = s0[ir * (RW / 2) + 1], w2 = s0[ir * (RW / 2) + 2];
        const float v[6] = {lo16(w0), hi16(w0), lo16(w1), hi16(w1), lo16(w2), hi16(w2)};
        taps<HR, 2>(ir, v, wr, acc);
      }
    }
    __nv_bfloat16* tc_ = t + (c >> 1) * TPAIR * 2 + (c & 1);  // channel c of pixel p at tc_[2 p]
#pragma unroll
    for (int o = 0; o < HR; ++o) {
      const int p = (h * HR + o) * 32 + 2 * l;
      tc_[2 * p] = __float2bfloat16(fmaxf(acc[o][0] + cb, 0.f));
      tc_[2 * p + 2] = __float2bfloat16(fmaxf(acc[o][1] + cb, 0.f));
    }
  }
}

// out (B, H, W, C) bf16 from x, G folded blocks (dw (G, K, K, C), db (G, C),
// w2 (G, C_in, C_out), b2 (G, C), f32). Block: output rows y0 .. y0 + TH,
// columns x0 .. x0 + TW of image blockIdx.z.
__global__ void __launch_bounds__(NT, 2) refiner_chain_c24_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ w2, const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H, int W,
    int G) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int TW = tw_of(G), RH = rh_of(G), PS = ps_of(G), TPAIR = tpair_of(G), halo = P * G;
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(smraw);             // [C][PS]
  uint32_t* tw = reinterpret_cast<uint32_t*>(smraw + plane_bytes(G));         // [C / 2][TPAIR] bf16 pairs
  uint32_t* frags = tw + (C / 2) * TPAIR;                                     // [G][FRAG][32]
  float* dws = reinterpret_cast<float*>(frags + G * FRAG * 32);                // [G][C][KK]
  float* dbs = dws + G * C * KK;                                              // [G][C]
  float* b2s = dbs + G * C;                                                   // [G][C]
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int gy0 = y0 - halo, gx0 = x0 - halo;  // the plane's first image row and column
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;

  stage(x + (size_t)b * H * W * C, plane, PS, gy0, gx0, RH, RW, H, W);
  stage_weights(dw, db, b2, dws, dbs, b2s, G);
  // warp k < G: block k's B fragments, kept in shared memory (held in
  // registers through the depthwise they measured slower); word q of the
  // hi fragments at q, of the lo ones at 12 + q
  if (wid < G) {
    uint32_t bh[2][3][2], bl[2][3][2];
    w2_frags(w2 + (size_t)wid * C * C, lane, bh, bl);
    uint32_t* f = frags + wid * FRAG * 32 + lane;
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      f[q * 32] = bh[q / 6][q / 2 % 3][q % 2];
      f[(12 + q) * 32] = bl[q / 6][q / 2 % 3][q % 2];
    }
  }
  __syncthreads();

  const int g8 = lane >> 2, t4 = lane & 3;
  for (int k = 0; k < G; ++k) {
    const bool last = k == G - 1;
    const int lo = P * (k + 1), nr = RH - 2 * lo, nc = RW - 2 * lo;  // output rows and columns from lo
    // the depthwise of the whole region into t, half the rows a half-warp
    // (nr = TH + 4 m)
    switch ((nr - TH) / 4) {
      case 0: depthwise<TH / 2>(plane, reinterpret_cast<__nv_bfloat16*>(tw), dws + k * C * KK, dbs + k * C, PS,
                                TPAIR, lo, nc, wid, lane); break;
      case 1: depthwise<TH / 2 + 2>(plane, reinterpret_cast<__nv_bfloat16*>(tw), dws + k * C * KK, dbs + k * C, PS,
                                    TPAIR, lo, nc, wid, lane); break;
      default: depthwise<TH / 2 + 4>(plane, reinterpret_cast<__nv_bfloat16*>(tw), dws + k * C * KK, dbs + k * C,
                                     PS, TPAIR, lo, nc, wid, lane); break;
    }
    __syncthreads();  // t is complete and the plane is read: the pointwise writes its output over it
    // pointwise on the tensor cores: 16-pixel tiles of the region (half a
    // row of 32 columns each)
    uint32_t bh[2][3][2], bl[2][3][2];
    const uint32_t* f = frags + k * FRAG * 32 + lane;
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      bh[q / 6][q / 2 % 3][q % 2] = f[q * 32];
      bl[q / 6][q / 2 % 3][q % 2] = f[(12 + q) * 32];
    }
    float bias[3][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      bias[j][0] = b2s[k * C + 8 * j + 2 * t4];
      bias[j][1] = b2s[k * C + 8 * j + 2 * t4 + 1];
    }
    for (int m0 = wid * 16; m0 < nr * 32; m0 += NW * 16) {
      const int r = lo + m0 / 32, cbase = m0 % 32;
      if (cbase >= nc) continue;
      float acc[3][4];
      pointwise16(tw, TPAIR, m0, lane, bh, bl, acc);
      const bool rin = gy0 + r >= 0 && gy0 + r < H;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int cl = cbase + g8 + 8 * hh, col = lo + cl;  // the pixel's plane column
        if (cl >= nc) continue;
        const bool inside = rin && gx0 + col >= 0 && gx0 + col < W;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float v0 = acc[j][2 * hh] + bias[j][0], v1 = acc[j][2 * hh + 1] + bias[j][1];
          const int d = 8 * j + 2 * t4;
          if (last) {  // the output tile, [pixel][C] over the plane, for 16-byte stores
            reinterpret_cast<uint32_t*>(plane)[((r - lo) * TW + cl) * (C / 2) + (d >> 1)] = tc::pack(v0, v1);
          } else {  // the next block's input; zero outside the image is its padding
            plane[d * PS + r * RW + col] = __float2bfloat16(inside ? v0 : 0.f);
            plane[(d + 1) * PS + r * RW + col] = __float2bfloat16(inside ? v1 : 0.f);
          }
        }
      }
    }
    __syncthreads();
  }

  store_tile(reinterpret_cast<const uint4*>(plane), out + (size_t)b * H * W * C, y0, x0, TH, TW, H, W);
}

}  // namespace
}  // namespace c24

// The tiling is decided here, once: the tile is s_rows rows by the widest TW
// whose group weights (f32) and two C x (TH + 2 halo) x (TW + 2 halo) planes
// in the I/O dtype fit in the device's opt-in shared memory per block; TH is
// halved while TW < 8. The result does not depend on the tile.
// path 1: the C = 24, K = 5 bf16 chain (c24), G <= 3 blocks, its own tile
// (s_rows and cg unused); path 0: the generic body.
extern "C" int roma_refiner_chain(const void* x, const void* dw, const void* db, const void* w2,
                                  const void* b2, void* out, int B, int H, int W, int C, int K,
                                  int G, int s_rows, int cg, int dtype, int path, void* stream) {
  if (C < 1 || C > MAXC || K < 1 || K % 2 == 0 || G < 1 || s_rows < 1 || cg < 1 || path < 0 || path > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1) {
    if (C != c24::C || K != c24::K || dtype != 1 || G > 3) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = c24::smem_bytes(G);
    cudaError_t err = roma::allow_smem(c24::refiner_chain_c24_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tw = c24::tw_of(G);
    dim3 grid((W + tw - 1) / tw, (H + c24::TH - 1) / c24::TH, B);
    c24::refiner_chain_c24_kernel<<<grid, c24::NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dw), static_cast<const float*>(db),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), H, W,
        G);
    return static_cast<int>(cudaGetLastError());
  }
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
