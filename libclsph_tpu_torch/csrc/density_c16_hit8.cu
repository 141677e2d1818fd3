// density_c16_hit8 — SPH density and per-(query subgroup, half-slot)
// hit counts over 16-particle candidate lists.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_density_nl
// (kernel _density_kernel; pair math neighbor.py _density_core_rowout;
// flags _emit_hit_flags) at c16=True, hit_sub=8, hit_groups=4.
//
// Computes, for every query particle i of a 128-particle Morton block b:
//   rho_i = m * sum_j real_j * poly6 * max(h^2 - r_ij^2, 0)^3
// over the particles j of the block's candidate subblocks
// cand[b, k] (particles cand*16 .. cand*16+15, k < count[b]), self
// included; non-real queries get the rest density. It also counts, for
// query subgroup g (rows g*32 .. g*32+31) and half e of slot k, the
// pairs with r^2 < h^2: hits[b*4 + g, 2k + e].
//
// What bounds it on an H100: fp32 pair arithmetic (about 20 operations
// per pair) and the gathered candidate loads. The position pack is
// 16 bytes a particle (16 MB at 1M particles), so it stays in the
// 50 MB L2 and the gathers mostly hit there.
//
// Design: one thread block per query block, one thread per query;
// warp g is query subgroup g, so a pair count per candidate particle is
// one __ballot_sync + __popc and the hit counts need no shared-memory
// reduction. The block stages 8 candidate slots (128 particles) at a
// time in shared memory with one coalesced 16-byte load per thread;
// every thread then reads them as broadcasts. r^2 is rounded as
// (dx*dx + dy*dy) + dz*dz without FMA contraction, so the r < h
// decisions equal the plain PyTorch version's exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;            // queries per block (Morton block)
constexpr int kSub = 16;               // particles per candidate subblock
constexpr int kStage = kBlock / kSub;  // slots staged per round

__device__ __forceinline__ float pair_r2(float4 q, float4 c) {
  const float dx = q.x - c.x;
  const float dy = q.y - c.y;
  const float dz = q.z - c.z;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kBlock)
density_c16_hit8_kernel(const float4* __restrict__ pos4,
                        const int* __restrict__ cand,
                        const int* __restrict__ count, int cap, float h2,
                        float poly6, float mass, float fluid_density,
                        float* __restrict__ density, int* __restrict__ hits) {
  __shared__ float4 stage[kBlock];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long i = (long long)b * kBlock + t;
  const float4 q = pos4[i];
  const int n = count[b];
  const int* row = cand + (long long)b * cap;
  int* hit_row = hits + ((long long)b * 4 + g) * (2LL * cap);

  float sum = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStage) {
    const int k = k0 + t / kSub;
    if (k < n) stage[t] = pos4[(long long)row[k] * kSub + (t % kSub)];
    __syncthreads();
    const int ns = min(kStage, n - k0);
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int cnt = 0;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float4 c = stage[s * kSub + e * 8 + p];
          const float r2 = pair_r2(q, c);
          const float tt = fmaxf(h2 - r2, 0.f);
          sum += (poly6 * c.w) * (tt * tt * tt);
          cnt += __popc(__ballot_sync(0xffffffffu, r2 < h2));
        }
        if (lane == 0) hit_row[2 * (k0 + s) + e] = cnt;
      }
    }
    __syncthreads();
  }
  density[i] = q.w > 0.f ? mass * sum : fluid_density;
}

}  // namespace

// Plain C entry point: launches on ``stream``, allocates nothing, and
// returns cudaGetLastError() (0 on success). ``hits`` must be zeroed by
// the caller: slots at or past count[b] are not written.
extern "C" int density_c16_hit8_launch(const void* pos4, const void* cand,
                                       const void* count, int nb, int cap,
                                       float h2, float poly6, float mass,
                                       float fluid_density, void* density,
                                       void* hits, void* stream) {
  if (nb > 0) {
    density_c16_hit8_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)pos4, (const int*)cand, (const int*)count, cap, h2,
        poly6, mass, fluid_density, (float*)density, (int*)hits);
  }
  return (int)cudaGetLastError();
}
