// Kernel B: bilinear local correlation around a warp.
//
// Replaces roma_tpu/ops/tile_window.py:_corr_kernel (entry
// windowed_local_corr), and with it the reference's fused-local-corr CUDA
// extension. For every query pixel q with warp target w(q), the (2r+1)^2
// window points one feature pixel apart around w(q) all share one bilinear
// fraction, so their corners tile a P^2 = (2r+2)^2 integer patch of f1. The
// kernel dots f0[q] / sqrt(C) with each integer tap (zero outside the image),
// keeps the P^2 dots in shared memory, and folds them into the (2r+1)^2
// bilinear taps, dy-major, as roma_tpu/ops/local_corr.py:_combine_corners.
//
// What bounds it on the H100: the tap reads, P^2 * C elements per query,
// which neighbouring queries mostly share through L1/L2 (the unique bytes,
// f0, f1 and the output once, are a small part); the arithmetic is one FMA
// per element read. So the instructions a tap costs, and the loads a warp
// keeps in flight, bound it. Design: one warp per query, lanes across the
// channels, four warps a block. A lane keeps its slice of f0[q], scaled
// once, in f32 registers and reads its slice of every tap row with NV
// 16-byte loads (C = 256 in bf16: one; C = 512: two), so one load
// instruction moves 512 bytes of the row; the loads of four taps are issued
// together. Each lane sums its partial dots of 16 taps in registers, and
// one butterfly transpose-reduce (8 + 4 + 2 + 1 shuffles, then one more
// across the half-warps) leaves tap t's sum on lane t: 16 shuffles for 16
// taps, against 5 a tap for a reduction per tap; a last round of 4 taps
// (r = 2 has 36) is reduced as such. With one vector a lane the patch width
// is a compile-time constant for the radii the models use (2, 3, 7), which
// folds each tap's row, column and bounds arithmetic into constants. Sixteen
// taps a round rather than 32 and four warps a block rather than eight
// measured faster (fewer registers, more warps resident), and so did a warp
// with one query over one that walks a column of queries (more warps in
// flight beats the better L1 reuse). No windows, no miss budgets: every tap
// is read directly, so any warp is exact and any radius runs through the
// same code. A row that is not a whole number of 16-byte vectors (or wider
// than 4 a lane) takes the scalar loop (NV = 0), one element a lane and a
// shuffle reduction a tap.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;   // queries a block takes, a warp each
constexpr int ROUND = 16;  // taps a lane sums in registers before one transpose-reduce

// unnormalize as roma_tpu/ops/local_corr.py:_base_indices
struct Corner {
  int y0, x0;
  float fy, fx;
};

__device__ __forceinline__ Corner corner(const float* warp, long long q, int H, int W) {
  const float ix = (warp[2 * q] + 1.f) * (float)W / 2.f - 0.5f;
  const float iy = (warp[2 * q + 1] + 1.f) * (float)H / 2.f - 0.5f;
  const float x0f = floorf(ix), y0f = floorf(iy);
  return {(int)y0f, (int)x0f, iy - y0f, ix - x0f};
}

// the (2r+1)^2 bilinear taps of query q from its P^2 integer-tap dots
template <typename T>
__device__ __forceinline__ void fold(const float* dps, const Corner& cn, T* o, int R, int lane) {
  const int P = 2 * R + 2, K1 = 2 * R + 1;
  const float w00 = (1.f - cn.fy) * (1.f - cn.fx), w01 = (1.f - cn.fy) * cn.fx;
  const float w10 = cn.fy * (1.f - cn.fx), w11 = cn.fy * cn.fx;
  for (int k = lane; k < K1 * K1; k += 32) {
    const float* dp = dps + (k / K1) * P + k % K1;
    o[k] = roma::from_f32<T>(w00 * dp[0] + w01 * dp[1] + w10 * dp[P] + w11 * dp[P + 1]);
  }
}

// Butterfly transpose-reduce of N partial sums a lane (one per tap): after
// the step of width S, part[i] (i < S) holds tap i + (the lane's bits from S
// to N) summed over N / S lanes; once S = 1, a plain reduction over the
// lane bits from N up. Then part[0] holds tap `lane % N` summed over all 32
// lanes: N - 1 + log2(32 / N) shuffles for N taps. A template, so that every
// index is a constant and part stays in registers.
template <int N, int S = N / 2>
__device__ __forceinline__ void transpose_reduce(float (&part)[N], int lane) {
  if constexpr (S >= 1) {
    const bool up = lane & S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float send = up ? part[i] : part[i + S];
      const float keep = up ? part[i + S] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    transpose_reduce<N, S / 2>(part, lane);
  } else {
#pragma unroll
    for (int off = N; off < 32; off <<= 1) part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
  }
}

// the narrowest round of the transpose-reduce that holds `rest` taps
__host__ __device__ constexpr int round_for(int rest) { return rest > 16 ? 32 : rest > 8 ? 16 : rest > 4 ? 8 : 4; }

// One query of the vector path: NV 16-byte vectors a lane, lane l reading
// vectors l, l + 32, ... of a row; the patch width P = 2r + 2 is PC when PC
// is not 0, so that every tap's place in the patch is a constant, else P_
// at run time.
template <typename T, int NV, int PC>
struct Query {
  static constexpr int EPV = 16 / sizeof(T);
  static constexpr int G = NV <= 2 ? 4 : 2;  // taps whose loads are issued together
  float a[NV][EPV];                          // the lane's slice of f0[q] / sqrt(C)
  bool on[NV];                               // the lane's vectors that lie in the row
  const uint4* f1v;                          // f1's image of the query, as 16-byte vectors
  Corner cn;
  int H, W, nvec, P_, lane;                  // nvec: vectors a row

  __device__ __forceinline__ int P() const { return PC ? PC : P_; }

  // the dots of taps t0 .. t0 + N (those below P^2) into dps[t0 ..]; an
  // off-image tap and a lane's vectors past the row load zeros
  template <int N>
  __device__ __forceinline__ void taps(float* dps, int t0) const {
    const int P = this->P(), R = P / 2 - 1, PP = P * P;
    int ty = t0 / P, tx = t0 - ty * P;  // tap t0's row and column in the patch
    float part[N];
#pragma unroll
    for (int j = 0; j < N; j += G) {
      uint4 raw[G][NV];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int yy = cn.y0 + ty - R, xx = cn.x0 + tx - R;
        const bool ok = t0 + j + u < PP && (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
        const uint4* row = f1v + (ok ? (yy * W + xx) * nvec : 0);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          raw[u][v] = ok && on[v] ? __ldg(row + v * 32 + lane) : make_uint4(0, 0, 0, 0);
        if (++tx == P) {
          tx = 0;
          ++ty;
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float d = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float f[EPV];
          roma::unpack16(raw[u][v], f, T());
#pragma unroll
          for (int e = 0; e < EPV; ++e) d = fmaf(a[v][e], f[e], d);
        }
        part[j + u] = d;
      }
    }
    transpose_reduce<N>(part, lane);
    if (lane < N && t0 + lane < PP) dps[t0 + lane] = part[0];
  }

  // every tap: rounds of ROUND, then the rest ((2r+2)^2 mod 32 is 0, 4 or
  // 16) in a round as narrow as it fits
  __device__ __forceinline__ void all_taps(float* dps) const {
    if constexpr (PC > 0) {
      constexpr int PP = PC * PC, rest = PP % ROUND;
#pragma unroll
      for (int t0 = 0; t0 + ROUND <= PP; t0 += ROUND) taps<ROUND>(dps, t0);
      if constexpr (rest > 0) taps<round_for(rest)>(dps, PP - rest);
    } else {
      const int PP = P_ * P_;
      int t0 = 0;
      for (; t0 + ROUND <= PP; t0 += ROUND) taps<ROUND>(dps, t0);
      const int rest = PP - t0;
      if (rest > 16)
        taps<32>(dps, t0);
      else if (rest > 8)
        taps<16>(dps, t0);
      else if (rest > 4)
        taps<8>(dps, t0);
      else if (rest > 0)
        taps<4>(dps, t0);
    }
  }
};

template <typename T, int NV, int PC>
__global__ void __launch_bounds__(WARPS * 32) local_corr_vec_kernel(
    const T* __restrict__ f0, const T* __restrict__ f1, const float* __restrict__ warp,
    T* __restrict__ out, int B, int H, int W, int C, int R) {
  using Q = Query<T, NV, PC>;
  extern __shared__ float sm[];
  const int P = 2 * R + 2;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dps = sm + wid * P * P;
  const long long q = (long long)blockIdx.x * WARPS + wid;
  if (q >= (long long)B * H * W) return;  // warp-uniform; no block barrier below
  const int b = (int)(q / ((long long)H * W));

  Q qs;
  qs.nvec = C / Q::EPV;
  const float sq = sqrtf((float)C);
  const uint4* f0q = reinterpret_cast<const uint4*>(f0 + q * C);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qs.on[v] = v * 32 + lane < qs.nvec;
    float f[Q::EPV];
    roma::unpack16(qs.on[v] ? __ldg(f0q + v * 32 + lane) : make_uint4(0, 0, 0, 0), f, T());
#pragma unroll
    for (int e = 0; e < Q::EPV; ++e) qs.a[v][e] = f[e] / sq;
  }
  qs.f1v = reinterpret_cast<const uint4*>(f1 + (size_t)b * H * W * C);
  qs.cn = corner(warp, q, H, W);
  qs.H = H, qs.W = W, qs.P_ = P, qs.lane = lane;
  qs.all_taps(dps);
  __syncwarp();
  fold(dps, qs.cn, out + q * (2 * R + 1) * (2 * R + 1), R, lane);
}

template <typename T, int NV, int PC>
cudaError_t launch_vec(unsigned blocks, cudaStream_t s, const T* f0, const T* f1, const float* warp, T* out,
                       int B, int H, int W, int C, int R) {
  const size_t smem = (size_t)WARPS * (2 * R + 2) * (2 * R + 2) * sizeof(float);
  const cudaError_t err = roma::allow_smem(local_corr_vec_kernel<T, NV, PC>, smem);
  if (err == cudaSuccess)
    local_corr_vec_kernel<T, NV, PC><<<blocks, WARPS * 32, smem, s>>>(f0, f1, warp, out, B, H, W, C, R);
  return err;
}

// one vector a lane (C = 256 in bf16): the patch widths of the models' radii
// (2, 3 and 7) as constants. With two or four vectors a lane the patch width
// stays a run-time value: constants measured slower there (their fully
// unrolled rounds issue more loads at once than the warps can keep in
// flight, the tap rows being twice as long).
template <typename T, int NV>
cudaError_t launch_const_p(unsigned blocks, cudaStream_t s, const T* f0, const T* f1, const float* warp, T* out,
                       int B, int H, int W, int C, int R) {
  switch (2 * R + 2) {
    case 6:
      return launch_vec<T, NV, 6>(blocks, s, f0, f1, warp, out, B, H, W, C, R);
    case 8:
      return launch_vec<T, NV, 8>(blocks, s, f0, f1, warp, out, B, H, W, C, R);
    case 16:
      return launch_vec<T, NV, 16>(blocks, s, f0, f1, warp, out, B, H, W, C, R);
    default:
      return launch_vec<T, NV, 0>(blocks, s, f0, f1, warp, out, B, H, W, C, R);
  }
}

// any C: one element a lane, a shuffle reduction a tap
template <typename T>
__global__ void __launch_bounds__(WARPS * 32) local_corr_kernel(
    const T* __restrict__ f0, const T* __restrict__ f1, const float* __restrict__ warp,
    T* __restrict__ out, int B, int H, int W, int C, int R) {
  extern __shared__ float sm[];
  const int P = 2 * R + 2;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* f0s = sm + wid * C;
  float* dps = sm + WARPS * C + wid * P * P;
  const long long q = (long long)blockIdx.x * WARPS + wid;
  if (q >= (long long)B * H * W) return;  // warp-uniform; no block barrier below
  const int b = (int)(q / ((long long)H * W));

  const float sq = sqrtf((float)C);
  const T* f0q = f0 + q * C;
  for (int c = lane; c < C; c += 32) f0s[c] = roma::to_f32(f0q[c]) / sq;
  __syncwarp();

  const Corner cn = corner(warp, q, H, W);
  const T* f1b = f1 + (size_t)b * H * W * C;
  for (int t = 0; t < P * P; ++t) {
    const int yy = cn.y0 + t / P - R, xx = cn.x0 + t % P - R;
    float d = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* row = f1b + ((size_t)yy * W + xx) * C;
      for (int c = lane; c < C; c += 32) d = fmaf(f0s[c], roma::to_f32(row[c]), d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    }
    if (lane == 0) dps[t] = d;
  }
  __syncwarp();
  fold(dps, cn, out + q * (2 * R + 1) * (2 * R + 1), R, lane);
}

}  // namespace

// nv: the 16-byte vectors a lane reads of a row (1, 2 or 4; the wrapper picks
// it from C and the dtype and checks the alignment), or 0 for the scalar loop
extern "C" int roma_local_corr(const void* f0, const void* f1, const void* warp, void* out,
                               int B, int H, int W, int C, int R, int nv, int dtype, void* stream) {
  if (R < 0 || C < 1 || !(nv == 0 || nv == 1 || nv == 2 || nv == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = (long long)B * H * W;
  const int P = 2 * R + 2;
  const unsigned blocks = (unsigned)((nq + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ROMA_DISPATCH_DTYPE(dtype, {
    const scalar_t* a = static_cast<const scalar_t*>(f0);
    const scalar_t* c = static_cast<const scalar_t*>(f1);
    const float* w = static_cast<const float*>(warp);
    scalar_t* o = static_cast<scalar_t*>(out);
    if (nv == 0) {
      const size_t smem = (size_t)WARPS * (C + P * P) * sizeof(float);
      cudaError_t err = roma::allow_smem(local_corr_kernel<scalar_t>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      local_corr_kernel<scalar_t><<<blocks, WARPS * 32, smem, s>>>(a, c, w, o, B, H, W, C, R);
    } else {
      const cudaError_t err = nv == 1   ? launch_const_p<scalar_t, 1>(blocks, s, a, c, w, o, B, H, W, C, R)
                              : nv == 2 ? launch_vec<scalar_t, 2, 0>(blocks, s, a, c, w, o, B, H, W, C, R)
                                        : launch_vec<scalar_t, 4, 0>(blocks, s, a, c, w, o, B, H, W, C, R);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
