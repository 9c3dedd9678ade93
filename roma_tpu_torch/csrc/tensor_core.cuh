// Tensor-core building blocks of the bf16 attention kernels (A and E):
// 16-byte cp.async copies into padded shared-memory tiles, ldmatrix
// fragment loads and mma.sync m16n8k16 (bf16 x bf16 -> f32).
//
// A tile holds R rows of D bf16 values (D = 64 or 128) at a row stride of
// D + 8 elements. ldmatrix reads one 16-byte chunk from each of 8
// consecutive rows: at a stride of D (128 or 256 bytes) those 8 chunks sit
// on the same 4 banks, an 8-way conflict; the 16 bytes of padding move each
// row to the next 4 banks, so the 8 chunks cover all 32. An XOR swizzle of
// the chunks avoids the conflict without the padding, but it makes every
// fragment's address a value computed at run time instead of a constant
// offset of one per-lane base, and those addresses cost registers: the
// swizzled build of the D = 128 dk/dv pass spilled.
//
// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4; a register holds two
// bf16 values, the lower column in its low half):
//   A (16 x 16, row-major): a0 (row g, col 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
//   B (16 x 8, k x n):      b0 (k 2t, n g), b1 (k 2t + 8, n g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, the same cols)
// So the accumulators of two adjacent n-tiles, packed to bf16 as
// {c0c1, c2c3} of the first and then of the second, are the A fragment of a
// 16-wide k-chunk of the next product: a probability tile never leaves the
// registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// row stride (elements) of a tile of D columns
__host__ __device__ constexpr int ld_of(int d) { return d + 8; }

// element offset of (row, col) in a tile of D columns
template <int D>
__device__ __forceinline__ int at(int row, int col) {
  return row * ld_of(D) + col;
}

// 16 bytes global -> shared without passing through registers; ok = false
// reads nothing and writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + R of a (rows, D) bf16 matrix with row stride ld (elements)
// into a tile, by NT threads; rows >= limit are zero-filled (their
// copy reads nothing, its source address is row 0)
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, long long ld, int r0, int limit) {
  constexpr int CPR = D / 8;  // chunks a row
  static_assert((R * CPR) % NT == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = threadIdx.x + j * NT, r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < limit;
    cp16(tile + at<D>(r, c), src + (ok ? (r0 + r) * ld : 0) + c, ok);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// A fragment: rows r0 .. r0 + 16, cols c0 .. c0 + 16 of a row-major tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm4(a, tile + at<D>(r0 + (lane & 15), c0 + ((lane >> 4) << 3)));
}

// B fragments of two n-tiles, k = c0 .. c0 + 16, from a tile stored [n][k]
// (n is the row): {b0, b1} of rows n0 .. n0 + 8 in b[0], b[1], of rows
// n0 + 8 .. n0 + 16 in b[2], b[3]
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm4(b, tile + at<D>(n0 + (lane & 7) + ((lane >> 4) << 3), c0 + (((lane >> 3) & 1) << 3)));
}

// B fragments of two n-tiles, k = rows k0 .. k0 + 16, from a tile stored
// [k][n] (k is the row), by the transposing load: {b0, b1} of cols
// n0 .. n0 + 8 in b[0], b[1], of cols n0 + 8 .. n0 + 16 in b[2], b[3]
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4t(b, tile + at<D>(k0 + (lane & 15), n0 + ((lane >> 4) << 3)));
}

// d += a b on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragments of the 16-wide k-chunks of a (16, 8 NJ) f32 accumulator
// tile, rounded to bf16 (see above)
template <int NJ>
__device__ __forceinline__ void to_a(uint32_t (&a)[NJ / 2][4], const float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j >> 1][(j & 1) * 2] = pack(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack(c[j][2], c[j][3]);
  }
}

}  // namespace tc
