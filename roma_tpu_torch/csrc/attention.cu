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
// device memory, and the products belong on the tensor cores.
//
// bf16 (attn_fwd_tc_kernel): a flash-style forward on mma.sync m16n8k16,
// bf16 x bf16 -> f32, the products of the TPU kernel's bf16 operands computed
// exactly. A block of FWD_WARPS = 8 warps owns 16 query rows a warp (128
// queries: each K/V tile read from device memory serves twice the queries of
// a 4-warp block, which measured 9% slower); its Q tile is staged once and
// held in registers as A fragments. K and V stream in 64-key tiles through a
// two-stage shared-memory ring filled by 16-byte cp.async copies
// (zero-filled past n_valid), the next tile's copy in flight while this
// tile's products run; rows are padded (tensor_core.cuh) so the ldmatrix
// fragment loads are free of bank conflicts. S = Q K^T takes K rows as they
// are (ldmatrix), the online softmax (running max and sum, in log2 units for
// exp2f) runs on the accumulator fragments with the row reductions over the
// 4 lanes of a quad, keys >= n_valid get -inf, and the numerators, rounded to
// bf16 as the TPU kernel rounds them for its PV product
// (pallas_attention.py:282-285), become the A fragments of P V in registers;
// V comes through the transposing ldmatrix. Shared memory is
// (16 FWD_WARPS + 4 * 64) (D + 8) 2 bytes: 54 KB at D = 64, 102 KB at D = 128.
// The inputs' base must be 16-byte aligned and their strides multiples of 8
// elements (checked by the wrapper, ops/fused_attention.py). What still
// separates it from the card's peak: mma.sync instead of wgmma, one m16 tile
// a warp (a B fragment from shared memory feeds 2 products, so shared-memory
// bandwidth caps the products near half the tensor-core rate), no warp
// specialisation (the warps that compute also start the copies).
//
// f32 (attn_fwd_kernel): on the CUDA cores. Each of the 128 threads owns a
// 4x8 tile of the logits and a 4x(D/8) tile of the output in registers;
// shared tiles are f32 with rows padded to D+1 floats so the column walks
// are free of bank conflicts. It keeps f32 products, which the
// float32 checks hold to 1e-4 (a TF32 tensor-core product would not pass).
#include "common.cuh"
#include "tensor_core.cuh"

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

constexpr int FWD_WARPS = 8;  // bf16: warps (of 16 query rows) a block

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32) attn_fwd_tc_kernel(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k, const tc::bf16* __restrict__ v,
    tc::bf16* __restrict__ out, float* __restrict__ lse, int N, int H, int n_valid,
    float scale_log2, roma::Strides in, roma::Strides os) {
  using tc::bf16;
  constexpr int NTH = NW * 32, TQ = 16 * NW, KC = D / 16, ND = D / 8, NS = BK / 8;
  constexpr int LDS = tc::ld_of(D);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // TQ x D, rows LDS apart (all tiles)
  bf16* KV = Qs + TQ * LDS;                     // 2 stages of {K, V}, BK x D each

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long in_off = b * in.b + h * in.h;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;
  const int ntiles = (n_valid + BK - 1) / BK;

  tc::load_tile<D, TQ, NTH>(Qs, q + in_off, in.n, q0, N);
  tc::load_tile<D, BK, NTH>(KV, kb, in.n, 0, n_valid);
  tc::load_tile<D, BK, NTH>(KV + BK * LDS, vb, in.n, 0, n_valid);
  tc::cp_commit();

  uint32_t qf[KC][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // the next tile's copy overlaps this tile's products
      bf16* nxt = KV + ((it + 1) & 1) * 2 * BK * LDS;
      tc::load_tile<D, BK, NTH>(nxt, kb, in.n, (it + 1) * BK, n_valid);
      tc::load_tile<D, BK, NTH>(nxt + BK * LDS, vb, in.n, (it + 1) * BK, n_valid);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) tc::frag_a<D>(qf[kc], Qs, 16 * warp, 16 * kc);
    }
    const bf16* Ks = KV + (it & 1) * 2 * BK * LDS;
    const bf16* Vs = Ks + BK * LDS;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        tc::frag_b<D>(bb, Ks, 16 * np, 16 * kc);
        tc::mma(s[2 * np], qf[kc], bb[0], bb[1]);
        tc::mma(s[2 * np + 1], qf[kc], bb[2], bb[3]);
      }

    const int k0 = it * BK;
    const bool edge = k0 + BK > n_valid;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge && k0 + 8 * j + 2 * t + (e & 1) >= n_valid) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < n_valid is in every tile, so mx is finite; alpha = 0 on the first
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    uint32_t pa[NS / 2][4];
    tc::to_a<NS>(pa, s);
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        tc::frag_bt<D>(bb, Vs, 16 * kc, 16 * dp);
        tc::mma(o[2 * dp], pa[kc], bb[0], bb[1]);
        tc::mma(o[2 * dp + 1], pa[kc], bb[2], bb[3]);
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    bf16* dst = out + b * os.b + h * os.h + row * os.n + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = tc::pack(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && t == 0) lse[((size_t)b * H + h) * N + row] = m[r] * tc::LN2 + logf(l[r]);
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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                      int N, int H, int n_valid, roma::Strides in, roma::Strides os,
                      cudaStream_t stream) {
  constexpr int TQ = 16 * FWD_WARPS, LDS = tc::ld_of(D);
  const size_t smem = (TQ + 4 * BK) * LDS * sizeof(tc::bf16);
  cudaError_t err = roma::allow_smem(attn_fwd_tc_kernel<D, FWD_WARPS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TQ - 1) / TQ, H, B);
  attn_fwd_tc_kernel<D, FWD_WARPS><<<grid, FWD_WARPS * 32, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse, N, H, n_valid,
      tc::LOG2E / sqrtf(static_cast<float>(D)), in, os);
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
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(D == 64 ? launch<float, 64>(q, k, v, out, l, B, N, H, n_valid, in, os, s)
                                    : launch<float, 128>(q, k, v, out, l, B, N, H, n_valid, in, os, s));
  if (dtype == 1)
    return static_cast<int>(D == 64 ? launch_tc<64>(q, k, v, out, l, B, N, H, n_valid, in, os, s)
                                    : launch_tc<128>(q, k, v, out, l, B, N, H, n_valid, in, os, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
