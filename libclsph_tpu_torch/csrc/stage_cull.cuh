// stage_cull.cuh — staging and culling helpers shared by the density body
// (density_warp.cuh) and the force kernels (forces_c32.cu): cp.async
// copies into shared memory, and the boxes of runs of kRun candidates
// whose distance to a query subgroup's box decides, warp-uniformly,
// whether a (subgroup, run) panel can hold a pair inside the support.

#pragma once

#include <cuda_runtime.h>

namespace sph {

constexpr int kRun = 8;  // candidates of a culled run (a panel is subgroup x run)

// A box gap this far below h^2 still holds no pair with r^2 < h^2: the
// margin covers the rounding of r^2 (sph::pair_r2) and of the gap.
constexpr float kBoxMargin = 1.0001f;
// In the identity mode the reach grows by kIdErr * (|q|^2 + |c|^2) over
// the two boxes (box_norm2), a bound of the identity's rounding error
// (sph_pair.cuh): 2^-19.
constexpr float kIdErr = 1.9073486328125e-6f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all of this thread's copy groups but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Min and max of a box over xor-groups of kWidth lanes.
template <int kWidth>
__device__ __forceinline__ void box_reduce(float3& lo, float3& hi) {
#pragma unroll
  for (int off = 1; off < kWidth; off <<= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, off));
    lo.y = fminf(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, off));
    lo.z = fminf(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, off));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, off));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, off));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, off));
  }
}

// Squared gap between two boxes, 0 where they overlap.
__device__ __forceinline__ float box_gap2(float3 alo, float3 ahi, float4 blo,
                                          float4 bhi) {
  const float gx = fmaxf(fmaxf(alo.x - bhi.x, blo.x - ahi.x), 0.f);
  const float gy = fmaxf(fmaxf(alo.y - bhi.y, blo.y - ahi.y), 0.f);
  const float gz = fmaxf(fmaxf(alo.z - bhi.z, blo.z - ahi.z), 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// A bound of |p|^2 over the box [lo, hi]: the sum over the axes of the
// larger of lo^2 and hi^2 (inf for an empty box at infinity).
__device__ __forceinline__ float box_norm2(float3 lo, float3 hi) {
  return fmaxf(lo.x * lo.x, hi.x * hi.x) + fmaxf(lo.y * lo.y, hi.y * hi.y) +
         fmaxf(lo.z * lo.z, hi.z * hi.z);
}

}  // namespace sph
