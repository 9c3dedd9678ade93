// Kernel E: attention backward through strides.
//
// Replaces roma_tpu/ops/pallas_attention.py:_attn_bwd_kernel (entries
// fused_attention and fused_attention_packed under jax.grad). From q, k, v,
// the forward output o, the upstream gradient dout and the forward's float32
// row log-sum-exp (Kernel A's `lse` output) it computes dq, dk, dv of
// softmax(q k^T / sqrt(D)) v, with P = exp(q k^T / sqrt(D) - lse) rebuilt
// tile by tile and
//     dP = dout v^T,  dS = P o (dP - delta),  delta_i = rowsum(dP o P)_i
//                                                     = dout_i . o_i,
//     dq = dS k / sqrt(D),  dk = dS^T q / sqrt(D),  dv = P^T dout.
// Keys at index >= n_valid get P = 0 exactly, so their dk and dv are 0
// whatever the padded rows hold. All sums run in float32; the results are
// cast to the input dtype. Views as in Kernel A: q, k, v, dq, dk, dv share
// one set of (batch, head, row) strides (the packed (B, N, 3C) qkv and dqkv,
// or contiguous (B, H, N, D) tensors), o and dout share another.
//
// The TPU kernel keeps a whole (256, Npad) logit row block in VMEM and needs
// no residual; one (64, 1600) float32 tile is 400 KB, more than the 227 KB a
// Hopper block may use. So the forward saves the row log-sum-exp (4 bytes a
// row, no second pass over the keys), and the cross-block sums are split
// into two launches with no atomics, so the result does not depend on the
// order blocks run in:
//   1. dq pass: one block per (64-query tile, head, batch) computes delta for
//      its rows from o and dout, writes it to a float32 scratch, and loops
//      over 64-key tiles accumulating dq in registers;
//   2. dk/dv pass: one block per (32-key tile, head, batch) loops over
//      64-query tiles accumulating dk and dv in registers.
// What bounds it on the H100: arithmetic. Each pass recomputes the logits
// and dP (pass 1: 4 N^2 D multiply-adds, pass 2: 4 N^2 D), on the CUDA cores
// in float32 with tiles staged in shared memory (rows padded to D+1 floats,
// free of bank conflicts on the column walks). Tensor cores are a later step.
#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block, both passes
constexpr int BQ = 64;   // dq pass: queries per block; dk/dv pass: queries per tile
constexpr int BK = 64;   // dq pass: keys per tile
constexpr int BKK = 32;  // dk/dv pass: keys per block

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * BQ * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BKK * (D + 1) + 2 * BQ * (D + 1) + 2 * BKK * (BQ + 1) + 2 * BQ;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int r0,
                                          int rows, int limit) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * DP + c] = row < limit ? roma::to_f32(src[row * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int N, int H, int n_valid, float scale,
    roma::Strides in, roma::Strides os) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* dOs = Qs + BQ * DP;   // BQ x DP
  float* Ks = dOs + BQ * DP;   // BK x DP (o while delta is formed)
  float* Vs = Ks + BK * DP;    // BK x DP
  float* Ss = Vs + BK * DP;    // BQ x (BK + 1): dS
  float* Ls = Ss + BQ * (BK + 1);
  float* Ds = Ls + BQ;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const size_t in_off = b * in.b + h * in.h, o_off = b * os.b + h * os.h;
  const size_t row0 = ((size_t)b * H + h) * N;

  load_tile<T, D>(Qs, q + in_off, in.n, q0, BQ, N);
  load_tile<T, D>(dOs, dout + o_off, os.n, q0, BQ, N);
  load_tile<T, D>(Ks, o + o_off, os.n, q0, BQ, N);
  __syncthreads();
  {  // delta = rowsum(dout * o): two threads per row
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      acc = fmaf(dOs[r * DP + c], Ks[r * DP + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const int row = q0 + r;
    if (half == 0) {
      Ds[r] = acc;
      Ls[r] = row < N ? lse[row0 + row] : 0.f;
      if (row < N) delta[row0 + row] = acc;
    }
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n_valid; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/dS (and o) no longer read
    load_tile<T, D>(Ks, k + in_off, in.n, k0, BK, n_valid);
    load_tile<T, D>(Vs, v + in_off, in.n, k0, BK, n_valid);
    __syncthreads();

    // logits and dP: rows ty*4+i, keys j*8+tx
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * DP + c];
        gv[i] = dOs[(ty * 4 + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(j * 8 + tx) * DP + c];
        vv[j] = Vs[(j * 8 + tx) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + j * 8 + tx;
        const float p = (key < n_valid && q0 + r < N) ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ss[r * (BK + 1) + j * 8 + tx] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dq += dS K: columns c*8+tx
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = Ss[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kk = Ks[j * DP + c * 8 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(g[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    T* dst = dq + in_off + row * in.n;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dst[c * 8 + tx] = roma::from_f32<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int N, int H, int n_valid, float scale,
    roma::Strides in, roma::Strides os) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 8;
  constexpr int SP = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // BKK x DP
  float* Vs = Ks + BKK * DP;     // BKK x DP
  float* Qs = Vs + BKK * DP;     // BQ x DP
  float* dOs = Qs + BQ * DP;     // BQ x DP
  float* Ps = dOs + BQ * DP;     // BKK x SP: P^T
  float* Gs = Ps + BKK * SP;     // BKK x SP: dS^T
  float* Ls = Gs + BKK * SP;
  float* Ds = Ls + BQ;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BKK;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;  // keys ty*2+a, queries j*8+tx
  const size_t in_off = b * in.b + h * in.h, o_off = b * os.b + h * os.h;
  const size_t row0 = ((size_t)b * H + h) * N;

  float gk[2][CPT], gv[2][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gk[a][c] = gv[a][c] = 0.f;

  if (k0 < n_valid) {  // a tile of masked keys keeps dk = dv = 0
    load_tile<T, D>(Ks, k + in_off, in.n, k0, BKK, n_valid);
    load_tile<T, D>(Vs, v + in_off, in.n, k0, BKK, n_valid);
    for (int q0 = 0; q0 < N; q0 += BQ) {
      __syncthreads();  // the previous tile's Q/dO/P/dS no longer read
      load_tile<T, D>(Qs, q + in_off, in.n, q0, BQ, N);
      load_tile<T, D>(dOs, dout + o_off, os.n, q0, BQ, N);
      if (tid < BQ) {
        const int row = q0 + tid;
        Ls[tid] = row < N ? lse[row0 + row] : 0.f;
        Ds[tid] = row < N ? delta[row0 + row] : 0.f;
      }
      __syncthreads();

      float s[2][8], dp[2][8];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; ++c) {
        float kv[2], vv[2], qv[8], ov[8];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          kv[a] = Ks[(ty * 2 + a) * DP + c];
          vv[a] = Vs[(ty * 2 + a) * DP + c];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qv[j] = Qs[(j * 8 + tx) * DP + c];
          ov[j] = dOs[(j * 8 + tx) * DP + c];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[a][j] = fmaf(kv[a], qv[j], s[a][j]);
            dp[a][j] = fmaf(vv[a], ov[j], dp[a][j]);
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int kr = ty * 2 + a;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qr = j * 8 + tx;
          const float p =
              (k0 + kr < n_valid && q0 + qr < N) ? expf(s[a][j] * scale - Ls[qr]) : 0.f;
          Ps[kr * SP + qr] = p;
          Gs[kr * SP + qr] = p * (dp[a][j] - Ds[qr]);
        }
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T q: columns c*8+tx
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float p[2], g[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          p[a] = Ps[(ty * 2 + a) * SP + j];
          g[a] = Gs[(ty * 2 + a) * SP + j];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float ov = dOs[j * DP + c * 8 + tx];
          const float qv = Qs[j * DP + c * 8 + tx];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            gv[a][c] = fmaf(p[a], ov, gv[a][c]);
            gk[a][c] = fmaf(g[a], qv, gk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + ty * 2 + a;
    if (key >= N) continue;
    T* dkr = dk + in_off + key * in.n;
    T* dvr = dv + in_off + key * in.n;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkr[c * 8 + tx] = roma::from_f32<T>(gk[a][c] * scale);
      dvr[c * 8 + tx] = roma::from_f32<T>(gv[a][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int N,
                   int H, int n_valid, roma::Strides in, roma::Strides os, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const size_t smem1 = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = roma::allow_smem(attn_bwd_dq_kernel<T, D>, smem1);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, D><<<dim3((N + BQ - 1) / BQ, H, B), NT, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      N, H, n_valid, scale, in, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = dkv_smem_floats<D>() * sizeof(float);
  err = roma::allow_smem(attn_bwd_dkv_kernel<T, D>, smem2);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, D><<<dim3((N + BKK - 1) / BKK, H, B), NT, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, H,
      n_valid, scale, in, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" int roma_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int B, int H, int N, int D, int n_valid,
                                  long long in_b, long long in_h, long long in_n,
                                  long long out_b, long long out_h, long long out_n,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_valid < 1 || n_valid > N) return static_cast<int>(cudaErrorInvalidValue);
  const roma::Strides in{in_b, in_h, in_n}, os{out_b, out_h, out_n};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  ROMA_DISPATCH_DTYPE(dtype, {
    if (D == 64)
      return static_cast<int>(launch<scalar_t, 64>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s));
    if (D == 128)
      return static_cast<int>(launch<scalar_t, 128>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s));
    return static_cast<int>(cudaErrorInvalidValue);
  });
  return 0;
}
