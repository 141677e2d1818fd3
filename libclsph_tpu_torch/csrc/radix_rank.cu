// radix_rank — the rank and histogram stage of one stable LSD radix pass
// over 128-key blocks.
//
// Replaces: libclsph_tpu/ops/radix_sort.py _rank_hist_kernel (called
// through the pallas_call of _radix_pass_fused), which one-hots each
// block's digits and scans them with a triangular matmul on the MXU.
//
// Computes, for keys (n,) int32 with n a multiple of 128 and the digit
// dg_i = (key_i >> shift) & (d - 1), d = 2^bits <= 128:
//   local[i]   = #{j <= i in i's 128-key block : dg_j == dg_i}  (1-based)
//   hist[k, b] = #{j in block b : dg_j == k}                   (digit-major)
// Both are exact integers; the results do not depend on scheduling.
//
// What bounds it on an H100: bytes. It reads 4 bytes and writes 4 bytes
// a key, plus d * n / 128 histogram words: about 9 MB at 1M keys, under
// 3 us at 3.35 TB/s, so a launch (a few us) costs more than the data. A
// sort runs one launch per pass (6 for 30-bit Morton codes at 5 bits).
//
// Design: one thread block of 128 threads (4 warps) per key block, one
// key a thread. Each warp ranks its 32 keys with __match_any_sync on the
// digit (the peer mask of equal digits) and __popc of the peers below the
// lane; the lowest lane of each peer group writes the group's size into
// shared memory per (warp, digit). One prefix over the four warps then
// gives the in-block rank, and the sum of the four gives the histogram
// column. No atomics: every count is written by exactly one thread, so
// the output is the same on every run. The histogram stores are strided
// by nb (one row per digit); they are d words a block against 256 bytes
// of keys and ranks, and the launch, not they, sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
radix_rank_kernel(const int* __restrict__ keys, int nb, int shift, int d,
                  int* __restrict__ local, int* __restrict__ hist) {
  __shared__ int warp_count[kWarps][kBlock];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) warp_count[k][t] = 0;
  __syncthreads();

  const long long i = (long long)b * kBlock + t;
  const int dg = (keys[i] >> shift) & (d - 1);
  const unsigned peers = __match_any_sync(0xffffffffu, dg);
  const int rank = __popc(peers & ((1u << lane) - 1u)) + 1;
  if (lane == __ffs(peers) - 1) warp_count[w][dg] = __popc(peers);
  __syncthreads();

  int before = 0;
  for (int k = 0; k < w; ++k) before += warp_count[k][dg];
  local[i] = before + rank;
  if (t < d) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += warp_count[k][t];
    hist[(long long)t * nb + b] = total;
  }
}

}  // namespace

// Plain C entry point: one block per 128 keys (n / 128 of them) on
// ``stream``; allocates nothing and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue when n is not a multiple of 128 or bits
// is outside 1..7). ``local`` is (n,) int32, ``hist`` (2^bits, n / 128)
// int32; every element of both is written.
extern "C" int radix_rank_launch(const void* keys, int n, int shift, int bits,
                                 void* local, void* hist, void* stream) {
  if (n % kBlock || bits < 1 || bits > 7 || shift < 0 || shift > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = n / kBlock;
  if (nb > 0) {
    radix_rank_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(
        (const int*)keys, nb, shift, 1 << bits, (int*)local, (int*)hist);
  }
  return (int)cudaGetLastError();
}
