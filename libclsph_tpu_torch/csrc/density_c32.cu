// density_c32 — SPH density and hit counts over 32-particle candidate
// lists, the tables of the q-granular path.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_density_nl
// at c16=False (kernel _density_kernel; tile _tile_from_raw; pair math
// neighbor.py _density_core_rowout; flags _emit_hit_flags) with
// hit_groups G = 4 (tier 1 of the q32 path) and G = 1 (q128, and
// tier 2 of the q path), hit_sub 32; and at G = 4, hit_sub 16 (tier 1
// of the 16-wide force pass over 32-wide tables).
//
// Computes, for list row b (query block qb = qblock[b], or b without a
// map) and every query particle i = qb*128 + t:
//   rho_i = m * sum_j real_j * poly6 * max(h^2 - r_ij^2, 0)^3
// over the particles j = cand[b, k]*32 + l, k < count[b], l < 32, self
// included; non-real queries get the rest density. rho_i is written at
// row b*128 + t. The hit counts are the JAX kernel's:
//   G = 4: hits[b*4 + g, k] = pairs with r^2 < h^2 between query
//          subgroup g (rows g*32 .. g*32+31) and slot k; at hit_sub 16
//          hits[b*4 + g, 2k + e] counts those with half e of slot k
//          (particles e*16 .. e*16+15);
//   G = 1: hits[b, k] = particles of slot k within h of some query of
//          the block (the lanes hit by any query row).
//
// What bounds it on an H100: fp32 pair arithmetic (about 20 operations
// per pair) over the 32-wide subblocks, which hold more pairs outside
// the support than the 16-wide ones, and the gathered candidate loads
// (the 16-byte position pack, 16 MB at 1M particles, stays in L2).
//
// Design: one thread block of 128 threads (one query each) per list row;
// the block stages four slots (128 particles) at a time in shared memory
// with one coalesced 16-byte load per thread, and every thread reads
// them as broadcasts. Warp g is query subgroup g: for G = 4 a pair count
// per candidate particle is one __ballot_sync + __popc. For G = 1 each
// warp folds its ballots into a 32-bit mask of the slot's particles it
// hit; the four warps' masks are ORed through shared memory and counted
// with one __popc. (G, hit_sub) are template parameters of the one
// kernel. r^2 is rounded without FMA contraction, so the hits equal the
// plain version's exactly.

#include "sph_pair.cuh"

namespace {

using sph::kBlock;
constexpr int kWarps = kBlock / 32;
constexpr int kSub = 32;               // particles per candidate subblock
constexpr int kStage = kBlock / kSub;  // slots staged per round

template <int G, int HIT_SUB>
__global__ void __launch_bounds__(kBlock)
density_c32_kernel(const float4* __restrict__ pos4,
                   const int* __restrict__ cand, const int* __restrict__ count,
                   const int* __restrict__ qblock, int cap, float h2,
                   float poly6, float mass, float fluid_density,
                   float* __restrict__ density, int* __restrict__ hits) {
  static_assert(G == 4 || HIT_SUB == kSub, "G = 1 counts whole slots");
  constexpr int kRuns = kSub / HIT_SUB;  // hit columns a slot
  __shared__ float4 stage[kBlock];
  __shared__ unsigned hit_mask[kWarps][kStage];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long qb = qblock ? qblock[b] : b;
  const float4 q = pos4[qb * kBlock + t];
  const int n = count[b];
  const int* row = cand + (long long)b * cap;

  float sum = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStage) {
    const int k = k0 + t / kSub;
    if (k < n) stage[t] = pos4[(long long)row[k] * kSub + lane];
    __syncthreads();
    const int ns = min(kStage, n - k0);
    for (int s = 0; s < ns; ++s) {
      unsigned mask = 0u;
#pragma unroll
      for (int e = 0; e < kRuns; ++e) {
        int cnt = 0;
#pragma unroll 8
        for (int p = 0; p < HIT_SUB; ++p) {
          const float4 c = stage[s * kSub + e * HIT_SUB + p];
          const float r2 = sph::pair_r2(q.x, q.y, q.z, c.x, c.y, c.z);
          sum = sph::density_add(sum, r2, h2, poly6, c.w);
          const unsigned ballot = __ballot_sync(0xffffffffu, r2 < h2);
          if (G == 4) {
            cnt += __popc(ballot);
          } else {
            mask |= (ballot != 0u ? 1u : 0u) << p;
          }
        }
        if (G == 4 && lane == 0) {
          hits[((long long)b * 4 + g) * (kRuns * cap) + kRuns * (k0 + s) + e] = cnt;
        }
      }
      if (G == 1 && lane == 0) hit_mask[g][s] = mask;
    }
    __syncthreads();
    if (G == 1 && t < ns) {
      const unsigned m =
          hit_mask[0][t] | hit_mask[1][t] | hit_mask[2][t] | hit_mask[3][t];
      hits[(long long)b * cap + k0 + t] = __popc(m);
    }
  }
  density[(long long)b * kBlock + t] = q.w > 0.f ? mass * sum : fluid_density;
}

}  // namespace

// Plain C entry point: (``groups``, ``hit_sub``) = (4, 32), (1, 32) or
// (4, 16) picks the instantiation; launches one block per list row (nq
// of them) on ``stream``, allocates nothing, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for another
// pair). ``qblock`` may be null. ``hits`` ((nq*groups, cap*32/hit_sub)
// int32) must be zeroed by the caller: slots at or past count[b] are not
// written.
extern "C" int density_c32_launch(const void* pos4, const void* cand,
                                  const void* count, const void* qblock,
                                  int nq, int cap, int groups, int hit_sub,
                                  float h2, float poly6, float mass,
                                  float fluid_density, void* density,
                                  void* hits, void* stream) {
  decltype(&density_c32_kernel<4, 32>) kernel;
  if (groups == 4 && hit_sub == 32) {
    kernel = density_c32_kernel<4, 32>;
  } else if (groups == 1 && hit_sub == 32) {
    kernel = density_c32_kernel<1, 32>;
  } else if (groups == 4 && hit_sub == 16) {
    kernel = density_c32_kernel<4, 16>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)pos4, (const int*)cand, (const int*)count,
        (const int*)qblock, cap, h2, poly6, mass, fluid_density,
        (float*)density, (int*)hits);
  }
  return (int)cudaGetLastError();
}
