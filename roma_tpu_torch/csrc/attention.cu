// Kernel A: attention forward through strides.
//
// Replaces roma_tpu/ops/pallas_attention.py:_attn_packed_kernel (entry
// fused_attention_packed) and :_attn_kernel (entry fused_attention). q, k, v
// and the output are (B, H, N, D) views given by their batch, head and row
// strides in elements (the last dim contiguous). The packed qkv Linear output
// (B, N, 3C), laid out [q | k | v] with head h owning columns h*D..h*D+D of
// each segment, is such a view (strides N*3C, D, 3C), and so is the
// token-major (B, N, C) output the proj Linear reads (strides N*C, D, C), so
// neither the head split nor the head merge is ever a copy; a contiguous
// (B, H, N, D) tensor is the per-head layout. Keys at index >= n_valid are
// masked out of the softmax. When `lse` is given, the row log-sum-exp of the
// scaled logits goes there as float32 (B, H, N): the training backward
// (Kernel E, attention_bwd.cu) rebuilds the probabilities from it.
//
// What bounds it on the H100: arithmetic. At the DINOv2 shape (N=1601,
// D=64) one batch-head is ~0.66 GFLOP of QK^T and PV against ~0.6 MB of
// q/k/v, so the (B, H, N, N) logits are the only thing worth keeping out of
// device memory. Design: one block per (64-query tile, head, batch), a loop
// over 64-key tiles staged in shared memory, online softmax (running max and
// sum) in f32, f32 accumulation; each of the 128 threads owns a 4x8 tile of
// the logits and a 4x(D/8) tile of the output in registers. Rows of the
// shared tiles are padded to D+1 floats so the column walks are free of bank
// conflicts. This runs on the CUDA cores in f32; tensor cores (wgmma) are a
// later step.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block

template <int D>
constexpr size_t attn_smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int N, int H, int n_valid,
    float scale, roma::Strides in, roma::Strides os) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;          // BQ x DP
  float* Ks = Qs + BQ * DP;  // BK x DP
  float* Vs = Ks + BK * DP;  // BK x D
  float* Ps = Vs + BK * D;   // BQ x (BK + 1)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;  // ty: 4 rows each
  const size_t in_off = b * in.b + h * in.h;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, row = q0 + r;
    Qs[r * DP + c] = row < N ? roma::to_f32(qb[row * in.n + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n_valid; k0 += BK) {
    __syncthreads();  // Q visible; the previous tile's K/V/P no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, key = k0 + r;
      const bool ok = key < n_valid;
      Ks[r * DP + c] = ok ? roma::to_f32(kb[key * in.n + c]) : 0.f;
      Vs[r * D + c] = ok ? roma::to_f32(vb[key * in.n + c]) : 0.f;
    }
    __syncthreads();

    // logits: rows ty*4+i, keys j*8+tx
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(j * 8 + tx) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 logits live on the 8 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + j * 8 + tx;
        s[i][j] = key < n_valid ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key k0 < n_valid is in every tile, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (BK + 1) + j * 8 + tx] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: output columns c*8+tx
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[j * D + c * 8 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    T* o = out + b * os.b + h * os.h + row * os.n;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[c * 8 + tx] = roma::from_f32<T>(acc[i][c] / l[i]);
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * N + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int N, int H, int n_valid, roma::Strides in, roma::Strides os,
                   cudaStream_t stream) {
  const size_t smem = attn_smem_floats<D>() * sizeof(float);
  cudaError_t err = roma::allow_smem(attn_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, H, n_valid, 1.f / sqrtf(static_cast<float>(D)), in, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" int roma_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int H, int N, int D, int n_valid,
                                  long long in_b, long long in_h, long long in_n,
                                  long long out_b, long long out_h, long long out_n,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_valid < 1 || n_valid > N) return static_cast<int>(cudaErrorInvalidValue);
  const roma::Strides in{in_b, in_h, in_n}, os{out_b, out_h, out_n};
  float* l = static_cast<float*>(lse);
  ROMA_DISPATCH_DTYPE(dtype, {
    if (D == 64) return static_cast<int>(launch<scalar_t, 64>(q, k, v, out, l, B, N, H, n_valid, in, os, s));
    if (D == 128) return static_cast<int>(launch<scalar_t, 128>(q, k, v, out, l, B, N, H, n_valid, in, os, s));
    return static_cast<int>(cudaErrorInvalidValue);
  });
  return 0;
}
