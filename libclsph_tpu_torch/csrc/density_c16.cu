// density_c16 — SPH density and hit counts over 16-particle candidate
// lists: the main path's tables and those of the 16-wide force path.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_density_nl
// (kernel _density_kernel; pair math neighbor.py _density_core_rowout;
// flags _emit_hit_flags) at c16=True, hit_groups=4, in three modes:
// hit_sub 8 (the main path), hit_sub 16 (the 16-wide force pass), and
// hit_sub 16 with the dilated per-tile counts of hit2_h (the build
// substep of the gated reuse density, fused_density_gated16).
//
// Computes, for list row b (query block qb = qblock[b], or b without a
// map) and every query particle i = qb*128 + t:
//   rho_i = m * sum_j real_j * poly6 * max(h^2 - r_ij^2, 0)^3
// over the particles j of the row's candidate subblocks
// cand[b, k] (particles cand*16 .. cand*16+15, k < count[b]), self
// included; non-real queries get the rest density. rho_i is written at
// row b*128 + t. With query subgroup g (rows g*32 .. g*32+31) it counts
// the pairs with r^2 < h^2
//   HIT_SUB = 8:  between subgroup g and half e of slot k, at
//                 hits[b*4 + g, 2k + e];
//   HIT_SUB = 16: between subgroup g and slot k, at hits[b*4 + g, k];
// and, with TILES, the pairs with r^2 < h2_dil = hit2_h^2 between
// subgroup g and tile t (slots 8t .. 8t+7) at tiles[b*4 + g, t],
// ntiles = ceil(cap / 8) columns.
//
// What bounds it on an H100: fp32 pair arithmetic (about 16 operations
// per pair) and the gathered candidate loads. The position pack is
// 16 bytes a particle (16 MB at 1M particles), so it stays in the
// 50 MB L2 and the gathers mostly hit there.
//
// Design: one thread block per list row, one thread per query;
// warp g is query subgroup g, so a pair count per candidate particle is
// one __ballot_sync + __popc and the hit counts need no shared-memory
// reduction. The block stages 8 candidate slots (128 particles: one
// tile) at a time in shared memory with one coalesced 16-byte load per
// thread; every thread then reads them as broadcasts. The modes are
// template parameters of the one kernel. r^2 is rounded as
// (dx*dx + dy*dy) + dz*dz without FMA contraction, so the r < h
// decisions equal the plain PyTorch version's exactly.

#include "sph_pair.cuh"

namespace {

using sph::kBlock;
constexpr int kSub = 16;               // particles per candidate subblock
constexpr int kStage = kBlock / kSub;  // slots staged per round (a tile)

template <int HIT_SUB, bool TILES>
__global__ void __launch_bounds__(kBlock)
density_c16_kernel(const float4* __restrict__ pos4,
                   const int* __restrict__ cand, const int* __restrict__ count,
                   const int* __restrict__ qblock, int cap, float h2,
                   float h2_dil, float poly6, float mass, float fluid_density,
                   float* __restrict__ density, int* __restrict__ hits,
                   int* __restrict__ tiles) {
  constexpr int kRuns = kSub / HIT_SUB;  // hit columns a slot
  __shared__ float4 stage[kBlock];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long qb = qblock ? qblock[b] : b;
  const float4 q = pos4[qb * kBlock + t];
  const int n = count[b];
  const int* row = cand + (long long)b * cap;
  const long long list = (long long)b * 4 + g;
  int* hit_row = hits + list * kRuns * cap;
  int* tile_row = TILES ? tiles + list * ((cap + kStage - 1) / kStage) : nullptr;

  float sum = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStage) {
    const int k = k0 + t / kSub;
    if (k < n) stage[t] = pos4[(long long)row[k] * kSub + (t % kSub)];
    __syncthreads();
    const int ns = min(kStage, n - k0);
    int dilated = 0;
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int e = 0; e < kRuns; ++e) {
        int cnt = 0;
#pragma unroll
        for (int p = 0; p < HIT_SUB; ++p) {
          const float4 c = stage[s * kSub + e * HIT_SUB + p];
          const float r2 = sph::pair_r2(q.x, q.y, q.z, c.x, c.y, c.z);
          sum = sph::density_add(sum, r2, h2, poly6, c.w);
          cnt += __popc(__ballot_sync(0xffffffffu, r2 < h2));
          if (TILES) dilated += __popc(__ballot_sync(0xffffffffu, r2 < h2_dil));
        }
        if (lane == 0) hit_row[kRuns * (k0 + s) + e] = cnt;
      }
    }
    if (TILES && lane == 0) tile_row[k0 / kStage] = dilated;
    __syncthreads();
  }
  density[(long long)b * kBlock + t] = q.w > 0.f ? mass * sum : fluid_density;
}

}  // namespace

// Plain C entry point: ``hit_sub`` 8 or 16 and ``tiles`` (null: no tile
// counts; else (nq*4, ceil(cap/8)) int32, needs hit_sub 16) pick the
// instantiation; launches one block per list row (nq of them) on
// ``stream``, allocates nothing, and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for another mode). ``qblock`` may be
// null (row b is query block b). ``hits`` ((nq*4, cap*16/hit_sub)) and
// ``tiles`` must be zeroed by the caller: slots and tiles at or past
// count[b] are not written.
extern "C" int density_c16_launch(const void* pos4, const void* cand,
                                  const void* count, const void* qblock,
                                  int nq, int cap, int hit_sub, float h2,
                                  float h2_dil, float poly6, float mass,
                                  float fluid_density, void* density,
                                  void* hits, void* tiles, void* stream) {
  decltype(&density_c16_kernel<8, false>) kernel;
  if (hit_sub == 8 && !tiles) {
    kernel = density_c16_kernel<8, false>;
  } else if (hit_sub == 16 && !tiles) {
    kernel = density_c16_kernel<16, false>;
  } else if (hit_sub == 16) {
    kernel = density_c16_kernel<16, true>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)pos4, (const int*)cand, (const int*)count,
        (const int*)qblock, cap, h2, h2_dil, poly6, mass, fluid_density,
        (float*)density, (int*)hits, (int*)tiles);
  }
  return (int)cudaGetLastError();
}
