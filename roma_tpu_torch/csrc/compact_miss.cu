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
// sampler's 864^2 shape (5,832 tiles of 256) the whole call moves ~2.2 MB.
// Design: one block per tile and one thread per flag of a chunk of up to
// 1024 queries. A warp's ballot and __popc give each set flag its rank in
// the warp; the warps' counts, prefix-summed in shared memory, turn ranks
// into slots; the count carries to the next chunk, as the TPU kernel's
// `carry` does, so a tile of 4,096 (the v1 sampler's) takes four chunks.
// The result is integers: it equals the plain version exactly.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024, MAX_WARPS = MAX_THREADS / 32;

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

}  // namespace

extern "C" int roma_compact_miss(const void* miss, void* out, int n_tiles, int T, int kf,
                                 void* stream) {
  if (n_tiles < 1 || T < 1 || kf < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = T >= MAX_THREADS ? MAX_THREADS : ((T + 31) / 32) * 32;
  compact_miss_kernel<<<n_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(miss), static_cast<int*>(out), T, kf);
  return static_cast<int>(cudaGetLastError());
}
