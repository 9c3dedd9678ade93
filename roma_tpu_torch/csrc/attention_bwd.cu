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
// order blocks run in (two runs are bitwise equal):
//   1. dq pass: one block per (64-query tile, head, batch) computes delta for
//      its rows from o and dout, writes it to a float32 scratch, and loops
//      over 64-key tiles accumulating dq in registers;
//   2. dk/dv pass: one block per (key tile, head, batch) loops over 64-query
//      tiles accumulating dk and dv in registers.
// What bounds it on the H100: arithmetic. Each pass recomputes the logits
// and dP, so the split does 7 N^2 D multiply-adds (pass 1: S, dP, dS k;
// pass 2: S^T, dP^T, P^T dout, dS^T q) against the 5 N^2 D of the bound
// (10 N^2 D operations in chip_smoke.py): the price of having no atomics.
//
// bf16 (the *_tc kernels): both passes on mma.sync m16n8k16, bf16 x bf16 ->
// f32, four warps of 16 rows a block, tiles staged by 16-byte cp.async into
// padded shared memory and read by ldmatrix (tensor_core.cuh).
//   dq pass, 64 queries a block: the Q and dO tiles are staged once (their
//     A fragments held in registers at D = 64; at D = 128 they are reread
//     from shared memory each key tile, the registers being taken by the
//     64 f32 of dq a thread); K and V stream through a two-stage cp.async ring
//     (the next tile's copy overlapping this tile's products). S = Q K^T and
//     dP = dO V^T take K and V rows as they are; P = exp2(S scale log2e -
//     lse log2e) and dS = P (dP - delta) are formed on the accumulator
//     fragments, and dS, rounded to bf16, is the A operand of dq += dS K in
//     registers, with K through the transposing ldmatrix.
//   dk/dv pass, 64 keys a block: K and V staged once (A fragments in
//     registers at D = 64, reread at D = 128); a ring of Q, dO, lse and delta
//     tiles feeds S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out
//     with keys as rows and are, rounded to bf16, the A operands of
//     dv += P^T dO and dk += dS^T Q (Q and dO through the transposing
//     ldmatrix). At D = 128 a 64-query tile is taken in two sub-steps of
//     32 queries, in a loop that is not unrolled: the 128 f32 of dk and dv a
//     thread leave little room for the two logit tiles, and unrolled, ptxas
//     overlapped one sub-step's loads with the last one's products and
//     spilled (at 16 or 32 queries a sub-step).
//   P and dS are rounded to bf16 for the second products, where the forward
//   rounds P; ops/fused_attention.py:attention_backward_reference rounds at
//   the same places. The TPU kernel keeps them f32 (its products run in
//   f32); the CPU test pins that difference.
// The inputs' base must be 16-byte aligned and their strides multiples of 8
// elements (checked by the wrapper). Beyond this design: wgmma, TMA, warp
// specialisation.
//
// f32: on the CUDA cores, each thread a 4x8 (dq pass) or 2x8 (dk/dv pass,
// 32 keys a block) tile of the logits, tiles staged as f32 in shared memory
// with rows padded to D+1 floats (free of bank conflicts on the column
// walks).
#include "common.cuh"
#include "tensor_core.cuh"

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

// ---- bf16 on the tensor cores ----

constexpr int TK = 64;  // bf16 dk/dv pass: keys per block (4 warps of 16)

template <int D>
constexpr size_t dq_tc_smem_bytes() {  // Q, dO, 2 stages of {K, V}; lse, delta
  constexpr int LDS = tc::ld_of(D);
  return (2 * BQ + 4 * BK) * LDS * sizeof(__nv_bfloat16) + 2 * BQ * sizeof(float);
}

template <int D>
__host__ __device__ constexpr size_t dkv_tc_stage_bytes() {  // Q, dO, lse, delta of one query tile
  constexpr int LDS = tc::ld_of(D);
  return 2 * BQ * LDS * sizeof(__nv_bfloat16) + 2 * BQ * sizeof(float);
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {  // K, V; 2 stages
  constexpr int LDS = tc::ld_of(D);
  return 2 * TK * LDS * sizeof(__nv_bfloat16) + 2 * dkv_tc_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(NT) attn_bwd_dq_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k, const tc::bf16* __restrict__ v,
    const tc::bf16* __restrict__ o, const tc::bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, tc::bf16* __restrict__ dq, int N,
    int H, int n_valid, float scale, roma::Strides in, roma::Strides os) {
  using tc::bf16;
  constexpr int KC = D / 16, ND = D / 8, NS = BK / 8, LDS = tc::ld_of(D);
  constexpr bool AREG = D == 64;  // Q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // BQ x D
  bf16* dOs = Qs + BQ * LDS;                    // BQ x D
  bf16* KV = dOs + BQ * LDS;                    // 2 stages of {K, V}, BK x D each
  float* Ls = reinterpret_cast<float*>(KV + 4 * BK * LDS);  // lse (log2 units)
  float* Ds = Ls + BQ;                                    // delta

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long in_off = b * in.b + h * in.h, o_off = b * os.b + h * os.h;
  const size_t row0 = ((size_t)b * H + h) * N;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;
  const int ntiles = (n_valid + BK - 1) / BK;
  const float scale_log2 = scale * tc::LOG2E;

  tc::load_tile<D, BQ, NT>(Qs, q + in_off, in.n, q0, N);
  tc::load_tile<D, BQ, NT>(dOs, dout + o_off, os.n, q0, N);
  tc::load_tile<D, BK, NT>(KV, kb, in.n, 0, n_valid);
  tc::load_tile<D, BK, NT>(KV + BK * LDS, vb, in.n, 0, n_valid);
  tc::cp_commit();

  {  // delta = rowsum(dout * o) in f32, two threads a row, 16-byte loads
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float acc = 0.f;
    if (row < N) {
      const long long off = o_off + row * os.n + half * (D / 2);
      const uint4* po = reinterpret_cast<const uint4*>(o + off);
      const uint4* pg = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 a = po[i], c = pg[i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]), fc = __bfloat1622float2(c2[e]);
          acc = fmaf(fa.x, fc.x, acc);
          acc = fmaf(fa.y, fc.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      if (row < N) delta[row0 + row] = acc;
    } else {
      Ls[r] = row < N ? lse[row0 + row] * tc::LOG2E : 0.f;
    }
  }

  uint32_t qf[AREG ? KC : 1][4], gf[AREG ? KC : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float lr[2], dr[2];  // lse (log2 units) and delta of rows g, g + 8

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      bf16* nxt = KV + ((it + 1) & 1) * 2 * BK * LDS;
      tc::load_tile<D, BK, NT>(nxt, kb, in.n, (it + 1) * BK, n_valid);
      tc::load_tile<D, BK, NT>(nxt + BK * LDS, vb, in.n, (it + 1) * BK, n_valid);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = Ls[16 * warp + g + 8 * r];
        dr[r] = Ds[16 * warp + g + 8 * r];
      }
      if constexpr (AREG) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          tc::frag_a<D>(qf[kc], Qs, 16 * warp, 16 * kc);
          tc::frag_a<D>(gf[kc], dOs, 16 * warp, 16 * kc);
        }
      }
    }
    const bf16* Ks = KV + (it & 1) * 2 * BK * LDS;
    const bf16* Vs = Ks + BK * LDS;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], ga[4];
      if constexpr (AREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kc][e];
          ga[e] = gf[kc][e];
        }
      } else {
        tc::frag_a<D>(qa, Qs, 16 * warp, 16 * kc);
        tc::frag_a<D>(ga, dOs, 16 * warp, 16 * kc);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        tc::frag_b<D>(bb, Ks, 16 * np, 16 * kc);
        tc::mma(s[2 * np], qa, bb[0], bb[1]);
        tc::mma(s[2 * np + 1], qa, bb[2], bb[3]);
        tc::frag_b<D>(bb, Vs, 16 * np, 16 * kc);
        tc::mma(dp[2 * np], ga, bb[0], bb[1]);
        tc::mma(dp[2 * np + 1], ga, bb[2], bb[3]);
      }
    }

    const int k0 = it * BK;
    const bool edge = k0 + BK > n_valid;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lr[e >> 1]);
        if (edge && k0 + 8 * j + 2 * t + (e & 1) >= n_valid) p = 0.f;
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);  // dS
      }
    uint32_t da[NS / 2][4];
    tc::to_a<NS>(da, s);
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc)
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bb[4];
        tc::frag_bt<D>(bb, Ks, 16 * kc, 16 * dd);
        tc::mma(acc[2 * dd], da[kc], bb[0], bb[1]);
        tc::mma(acc[2 * dd + 1], da[kc], bb[2], bb[3]);
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    bf16* dst = dq + in_off + row * in.n + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = tc::pack(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k, const tc::bf16* __restrict__ v,
    const tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv, int N,
    int H, int n_valid, float scale, roma::Strides in, roma::Strides os) {
  using tc::bf16;
  constexpr int KC = D / 16, ND = D / 8, LDS = tc::ld_of(D);
  constexpr bool AREG = D == 64;        // K and V fragments held in registers
  constexpr int QS = D == 64 ? 64 : 32;  // queries a sub-step
  constexpr int NS = QS / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);  // TK x D
  bf16* Vs = Ks + TK * LDS;                     // TK x D
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + TK * LDS);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long in_off = b * in.b + h * in.h, o_off = b * os.b + h * os.h;
  const size_t row0 = ((size_t)b * H + h) * N;
  const float scale_log2 = scale * tc::LOG2E;

  // stage s holds Q and dO (BQ x D each), then lse and delta (BQ floats each)
  auto stage = [&](int st) { return reinterpret_cast<bf16*>(ring + st * dkv_tc_stage_bytes<D>()); };
  auto load_queries = [&](int st, int qt) {
    bf16* Qs = stage(st);
    tc::load_tile<D, BQ, NT>(Qs, q + in_off, in.n, qt, N);
    tc::load_tile<D, BQ, NT>(Qs + BQ * LDS, dout + o_off, os.n, qt, N);
    if (threadIdx.x < BQ) {
      float* Ls = reinterpret_cast<float*>(Qs + 2 * BQ * LDS);
      const int row = qt + threadIdx.x;
      const bool ok = row < N;
      tc::cp4(Ls + threadIdx.x, lse + row0 + (ok ? row : 0), ok);
      tc::cp4(Ls + BQ + threadIdx.x, delta + row0 + (ok ? row : 0), ok);
    }
  };

  float gk[ND][4], gv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  if (k0 < n_valid) {  // a tile of masked keys keeps dk = dv = 0
    tc::load_tile<D, TK, NT>(Ks, k + in_off, in.n, k0, n_valid);
    tc::load_tile<D, TK, NT>(Vs, v + in_off, in.n, k0, n_valid);
    load_queries(0, 0);
    tc::cp_commit();
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key_ok[r] = k0 + 16 * warp + g + 8 * r < n_valid;
    uint32_t kf[AREG ? KC : 1][4], vf[AREG ? KC : 1][4];
    const int nq = (N + BQ - 1) / BQ;

    for (int it = 0; it < nq; ++it) {
      if (it + 1 < nq) {
        load_queries((it + 1) & 1, (it + 1) * BQ);
        tc::cp_commit();
        tc::cp_wait<1>();
      } else {
        tc::cp_wait<0>();
      }
      __syncthreads();
      if constexpr (AREG) {
        if (it == 0) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            tc::frag_a<D>(kf[kc], Ks, 16 * warp, 16 * kc);
            tc::frag_a<D>(vf[kc], Vs, 16 * warp, 16 * kc);
          }
        }
      }
      const bf16* Qs = stage(it & 1);
      const bf16* dOs = Qs + BQ * LDS;
      const float* Ls = reinterpret_cast<const float*>(dOs + BQ * LDS);
      const float* Ds = Ls + BQ;
      const int qt = it * BQ;

#pragma unroll 1  // see the note at the top
      for (int sq = 0; sq < BQ; sq += QS) {
        float st[NS][4], dpt[NS][4];  // S^T, dP^T: rows keys, cols queries sq ..
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ka[4], va[4];
          if constexpr (AREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ka[e] = kf[kc][e];
              va[e] = vf[kc][e];
            }
          } else {
            tc::frag_a<D>(ka, Ks, 16 * warp, 16 * kc);
            tc::frag_a<D>(va, Vs, 16 * warp, 16 * kc);
          }
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bb[4];
            tc::frag_b<D>(bb, Qs, sq + 16 * np, 16 * kc);
            tc::mma(st[2 * np], ka, bb[0], bb[1]);
            tc::mma(st[2 * np + 1], ka, bb[2], bb[3]);
            tc::frag_b<D>(bb, dOs, sq + 16 * np, 16 * kc);
            tc::mma(dpt[2 * np], va, bb[0], bb[1]);
            tc::mma(dpt[2 * np + 1], va, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int c = sq + 8 * j + 2 * t;  // this thread's query pair c, c + 1
          const float2 lq = *reinterpret_cast<const float2*>(Ls + c);
          const float2 dq2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 1;
            float p = exp2f(st[j][e] * scale_log2 - (hi ? lq.y : lq.x) * tc::LOG2E);
            if (!key_ok[e >> 1] || qt + c + hi >= N) p = 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - (hi ? dq2.y : dq2.x));  // dS^T
          }
        }
        uint32_t pa[NS / 2][4], da[NS / 2][4];
        tc::to_a<NS>(pa, st);
        tc::to_a<NS>(da, dpt);
#pragma unroll
        for (int kc = 0; kc < NS / 2; ++kc)
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            uint32_t bb[4];
            tc::frag_bt<D>(bb, dOs, sq + 16 * kc, 16 * dd);
            tc::mma(gv[2 * dd], pa[kc], bb[0], bb[1]);
            tc::mma(gv[2 * dd + 1], pa[kc], bb[2], bb[3]);
            tc::frag_bt<D>(bb, Qs, sq + 16 * kc, 16 * dd);
            tc::mma(gk[2 * dd], da[kc], bb[0], bb[1]);
            tc::mma(gk[2 * dd + 1], da[kc], bb[2], bb[3]);
          }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + g + 8 * r;
    if (key >= N) continue;
    bf16* dkr = dk + in_off + key * in.n + 2 * t;
    bf16* dvr = dv + in_off + key * in.n + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j) = tc::pack(gk[j][2 * r] * scale, gk[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j) = tc::pack(gv[j][2 * r], gv[j][2 * r + 1]);
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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
                      const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int N,
                      int H, int n_valid, roma::Strides in, roma::Strides os, cudaStream_t stream) {
  using tc::bf16;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const size_t smem1 = dq_tc_smem_bytes<D>();
  cudaError_t err = roma::allow_smem(attn_bwd_dq_tc_kernel<D>, smem1);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_tc_kernel<D><<<dim3((N + BQ - 1) / BQ, H, B), NT, smem1, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), N, H, n_valid, scale, in, os);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = dkv_tc_smem_bytes<D>();
  err = roma::allow_smem(attn_bwd_dkv_tc_kernel<D>, smem2);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_tc_kernel<D><<<dim3((N + TK - 1) / TK, H, B), NT, smem2, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      N, H, n_valid, scale, in, os);
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
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(
        D == 64 ? launch<float, 64>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s)
                : launch<float, 128>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s));
  if (dtype == 1)
    return static_cast<int>(
        D == 64 ? launch_tc<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s)
                : launch_tc<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, N, H, n_valid, in, os, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
