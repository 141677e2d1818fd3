// density_gated16 — the reuse substep's SPH density and 16-wide hit
// counts over a carried 16-particle candidate table, computed only on the
// (query subgroup, candidate tile) panels that the build substep flagged.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_density_gated16
// (kernel _density_kernel_gated16; flags _emit_hit_flags_from_hq).
//
// Computes, for query block b and query i = b*128 + t in subgroup
// g = t/32, the density and hit counts of density_c16.cu at hit_sub 16
// (rho_i at row i; hits[b*4 + g, k] = pairs with r^2 < h^2 between
// subgroup g and slot k), but only over the tiles t (slots 8t .. 8t+7)
// whose bit (t % 8)*4 + g of mask[b, t / 8] is set. The mask is the
// build substep's dilated tile counts (pairs within (1 + slack) h)
// packed by pack_tile_nibbles. While the carried table's staleness guard
// holds (no particle moved more than slack*h/2 since the build), a
// cleared panel holds no pair with r < h: every term it would add is
// exactly +0 and its hit counts are 0. So the outputs equal the ungated
// kernel's bit for bit: the same terms are added in the same slot order
// (sph::density_add, one explicit fma a pair).
//
// What bounds it on an H100: fp32 pair arithmetic over the flagged
// panels (about 16 operations a pair) and the gathered candidate loads
// of the tiles that some subgroup needs.
//
// Design: one thread block of 128 threads per query block, warp g =
// subgroup g. The block walks the table one tile (8 slots, 128
// particles) at a time. A tile whose four bits are all clear is skipped
// by the whole block (the test is uniform, so __syncthreads stays
// uniform). Otherwise the block stages it in shared memory with one
// 16-byte load a thread, and each warp whose bit is set sums it, with a
// pair count per candidate by __ballot_sync + __popc; a warp whose bit
// is clear waits at the barrier.

#include "sph_pair.cuh"

namespace {

using sph::kBlock;
constexpr int kSub = 16;               // particles per candidate subblock
constexpr int kStage = kBlock / kSub;  // slots per tile
constexpr int kGroups = 4;             // query subgroups (mask bits a tile)
constexpr int kTilesPerWord = 32 / kGroups;

__global__ void __launch_bounds__(kBlock)
density_gated16_kernel(const float4* __restrict__ pos4,
                       const int* __restrict__ cand,
                       const int* __restrict__ count,
                       const int* __restrict__ mask, int cap, int words,
                       float h2, float poly6, float mass, float fluid_density,
                       float* __restrict__ density, int* __restrict__ hits) {
  __shared__ float4 stage[kBlock];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const float4 q = pos4[(long long)b * kBlock + t];
  const int n = count[b];
  const int* row = cand + (long long)b * cap;
  const int* mask_row = mask + (long long)b * words;
  int* hit_row = hits + ((long long)b * kGroups + g) * cap;

  float sum = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStage) {
    const int tile = k0 / kStage;
    const unsigned nib = ((unsigned)mask_row[tile / kTilesPerWord] >>
                          ((tile % kTilesPerWord) * kGroups)) & 15u;
    if (nib == 0u) continue;  // no subgroup needs this tile
    const int k = k0 + t / kSub;
    if (k < n) stage[t] = pos4[(long long)row[k] * kSub + (t % kSub)];
    __syncthreads();
    if ((nib >> g) & 1u) {  // uniform across the warp
      const int ns = min(kStage, n - k0);
      for (int s = 0; s < ns; ++s) {
        int cnt = 0;
#pragma unroll
        for (int p = 0; p < kSub; ++p) {
          const float4 c = stage[s * kSub + p];
          const float r2 = sph::pair_r2(q.x, q.y, q.z, c.x, c.y, c.z);
          sum = sph::density_add(sum, r2, h2, poly6, c.w);
          cnt += __popc(__ballot_sync(0xffffffffu, r2 < h2));
        }
        if (lane == 0) hit_row[k0 + s] = cnt;
      }
    }
    __syncthreads();
  }
  density[(long long)b * kBlock + t] = q.w > 0.f ? mass * sum : fluid_density;
}

}  // namespace

// Plain C entry point: launches one block per query block (nb of them)
// on ``stream``, allocates nothing, and returns cudaGetLastError() (0 on
// success). ``mask`` is (nb, words) int32 with words >= ceil(cap/64).
// ``hits`` ((nb*4, cap) int32) must be zeroed by the caller: slots of
// skipped panels and slots at or past count[b] are not written.
extern "C" int density_gated16_launch(const void* pos4, const void* cand,
                                      const void* count, const void* mask,
                                      int nb, int cap, int words, float h2,
                                      float poly6, float mass,
                                      float fluid_density, void* density,
                                      void* hits, void* stream) {
  if (nb > 0) {
    density_gated16_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)pos4, (const int*)cand, (const int*)count,
        (const int*)mask, cap, words, h2, poly6, mass, fluid_density,
        (float*)density, (int*)hits);
  }
  return (int)cudaGetLastError();
}
