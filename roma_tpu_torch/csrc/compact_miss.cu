// Kernel F: per-tile compaction of miss flags into kf fixup slots.
//
// Replaces roma_tpu/ops/window_util.py:_compact_kernel (entry _compact_miss):
// for tile i, out[i, s] = the query index of the (s+1)-th set flag of
// miss[i, 0:T], for s < kf; slots past the tile's count hold the sentinel T.
// The TPU kernel ranks the flags with a triangular-ones matmul per chunk of
// up to 1024 queries and carries the count from chunk to chunk.
//
// What bounds it on the H100: bytes. It reads T one-byte flags and writes kf
// int32 per tile and does a few integer operations per flag; at the v2
// sampler's 864^2 shape (5,832 tiles of 256) the whole call moves ~2.2 MB,
// ~0.7 us at the memory's rate, so a call is close to the cost of a launch.
// The design keeps a tile's flags in one round of wide loads and ranks them
// without barriers or serial loops. Three paths, picked by
// roma_tpu_torch/ops/window_util.py:compact_checks:
// - warp (T % 8 == 0, T <= 256, base 8-byte aligned; the v2 sampler's
//   T = 256): a warp a tile, WARP_TILES tiles a block. Lane l holds flags
//   8l .. 8l+7 as one 8-byte word; __popcll of the word masked to each
//   byte's low bit counts them, a 5-step __shfl_up_sync scan turns the
//   counts into each lane's first slot. No shared memory, no __syncthreads.
// - block (T % 16 == 0, T <= 16,384, base 16-byte aligned; the v1 sampler's
//   T = 4096): a block a tile, a warp a SEG-flag segment of one 16-byte load
//   a lane, so the whole tile is in flight at once. Each warp's count goes to
//   shared memory; after one __syncthreads every warp scans the counts by
//   shuffles for its own base.
// - generic (any T, any base): a thread a flag in chunks of up to 1024; a
//   warp's ballot and __popc rank its flags, thread 0 prefix-sums the warps'
//   counts in shared memory, the count carries to the next chunk as the TPU
//   kernel's `carry` does. Kernel F's first design, kept for what the vector
//   paths do not take.
// The result is integers: every path equals the plain version exactly.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024, MAX_WARPS = MAX_THREADS / 32;
constexpr int WARP_TILES = 8;  // tiles (one a warp) a block on the warp path
constexpr int SEG = 32 * 16;   // flags a warp on the block path, 16 a lane
constexpr unsigned long long LOW_BITS = 0x0101010101010101ull;  // each byte's low bit
enum Path { GENERIC = 0, WARP = 1, BLOCK = 2 };

__global__ void __launch_bounds__(MAX_THREADS) compact_miss_kernel(
    const unsigned char* __restrict__ miss, int* __restrict__ out, int T, int kf) {
  __shared__ int warp_base[MAX_WARPS];
  __shared__ int chunk_total;
  const int tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const unsigned char* m = miss + (size_t)tile * T;
  int* o = out + (size_t)tile * kf;

  int carry = 0;  // set flags in the chunks before this one
  for (int q0 = 0; q0 < T && carry < kf; q0 += blockDim.x) {
    const int q = q0 + tid;
    const bool set = q < T && m[q] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {  // exclusive prefix over the warps' counts
      int run = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int n = warp_base[w];
        warp_base[w] = run;
        run += n;
      }
      chunk_total = run;
    }
    __syncthreads();
    const int slot = carry + warp_base[warp] + rank;
    if (set && slot < kf) o[slot] = q;
    carry += chunk_total;
    __syncthreads();  // warp_base and chunk_total are rewritten next chunk
  }
  for (int s = carry + tid; s < kf; s += blockDim.x) o[s] = T;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Writes the query of each set flag of `bits` (8 flags, one a byte, each
// masked to its low bit; flag j is query q0 + j) into slots slot, slot + 1,
// ... below kf; returns the next slot.
__device__ __forceinline__ int put_slots(unsigned long long bits, int slot, int q0, int* o, int kf) {
  while (bits && slot < kf) {
    o[slot++] = q0 + ((__ffsll(static_cast<long long>(bits)) - 1) >> 3);
    bits &= bits - 1;
  }
  return slot;
}

__global__ void __launch_bounds__(32 * WARP_TILES) compact_warp_kernel(
    const unsigned long long* __restrict__ miss, int* __restrict__ out, int n_tiles, int T, int kf) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARP_TILES + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp leaves together
  const int words = T >> 3;
  const unsigned long long w = lane < words ? __ldg(miss + (size_t)tile * words + lane) & LOW_BITS : 0ull;
  const int n = __popcll(w);
  const int incl = warp_inclusive_scan(n, lane);
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int* o = out + (size_t)tile * kf;
  put_slots(w, incl - n, 8 * lane, o, kf);
  for (int s = total + lane; s < kf; s += 32) o[s] = T;
}

__global__ void __launch_bounds__(MAX_THREADS) compact_block_kernel(
    const uint4* __restrict__ miss, int* __restrict__ out, int T, int kf) {
  __shared__ int warp_count[MAX_WARPS];
  const int tile = blockIdx.x, v = threadIdx.x, lane = v & 31, warp = v >> 5;
  const int nwarps = blockDim.x >> 5, vecs = T >> 4;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (v < vecs) r = __ldg(miss + (size_t)tile * vecs + v);
  // little-endian: flag 16v + j is byte j of the vector
  const unsigned long long lo = ((static_cast<unsigned long long>(r.y) << 32) | r.x) & LOW_BITS;
  const unsigned long long hi = ((static_cast<unsigned long long>(r.w) << 32) | r.z) & LOW_BITS;
  const int n = __popcll(lo) + __popcll(hi);
  const int incl = warp_inclusive_scan(n, lane);
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  const int c = lane < nwarps ? warp_count[lane] : 0;
  const int cincl = warp_inclusive_scan(c, lane);
  const int base = __shfl_sync(0xffffffffu, cincl - c, warp);  // the warps before this one
  const int total = __shfl_sync(0xffffffffu, cincl, 31);
  int* o = out + (size_t)tile * kf;
  put_slots(hi, put_slots(lo, base + incl - n, 16 * v, o, kf), 16 * v + 8, o, kf);
  for (int s = total + v; s < kf; s += blockDim.x) o[s] = T;
}

// Whether `path` takes T flags a tile from base `addr`, and its grid.
bool plan(int path, int n_tiles, int T, uintptr_t addr, dim3& grid, dim3& block) {
  if (n_tiles < 1 || T < 1) return false;
  if (path == WARP) {
    grid = dim3((n_tiles + WARP_TILES - 1) / WARP_TILES), block = dim3(32 * WARP_TILES);
    return T % 8 == 0 && T <= 32 * 8 && addr % 8 == 0;
  }
  if (path == BLOCK) {
    grid = dim3(n_tiles), block = dim3(32 * ((T + SEG - 1) / SEG));
    return T % 16 == 0 && T <= MAX_WARPS * SEG && addr % 16 == 0;
  }
  grid = dim3(n_tiles), block = dim3(T >= MAX_THREADS ? MAX_THREADS : ((T + 31) / 32) * 32);
  return path == GENERIC;
}

}  // namespace

// path: 0 generic, 1 warp, 2 block (ops/window_util.py PATH_CODES); a vector
// path whose shape or base it cannot take is refused, never run.
extern "C" int roma_compact_miss(const void* miss, void* out, int n_tiles, int T, int kf, int path,
                                 void* stream) {
  dim3 grid, block;
  if (kf < 1 || !plan(path, n_tiles, T, reinterpret_cast<uintptr_t>(miss), grid, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (path == WARP)
    compact_warp_kernel<<<grid, block, 0, s>>>(static_cast<const unsigned long long*>(miss), o, n_tiles, T, kf);
  else if (path == BLOCK)
    compact_block_kernel<<<grid, block, 0, s>>>(static_cast<const uint4*>(miss), o, T, kf);
  else
    compact_miss_kernel<<<grid, block, 0, s>>>(static_cast<const unsigned char*>(miss), o, T, kf);
  return static_cast<int>(cudaGetLastError());
}
