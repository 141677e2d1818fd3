// density_c32 — SPH density and hit counts over 32-particle candidate
// lists: the tables of the q-granular path, of tier 2 and of the asm
// variant, and the block tables of the row, fine and asym variants
// expanded to 32-particle subblocks.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_density_nl
// at c16=False (kernel _density_kernel; tile _tile_from_raw; pair math
// neighbor.py _density_core_rowout; flags _emit_hit_flags) with
// hit_groups G = 4 (tier 1 of the q32 path) and G = 1 (q128, tier 2 of
// the q path, and fused_density_asm at :2048), hit_sub 32; at G = 4,
// hit_sub 16 (tier 1 of the 16-wide force pass over 32-wide tables);
// and, densities only, libclsph_tpu/ops/pallas/neighbor.py
// fused_density (:319, the row and fine variants) and
// neighbor_asym.py fused_density (:156) over whole candidate blocks.
//
// Computes (density_warp.cuh at kSub 32), for list row b and its query
// block's 128 queries, the densities over the row's 32-wide candidate
// subblocks, and the hit counts of the JAX kernel:
//   G = 4: hits[b*4 + g, k] = pairs with r^2 < h^2 between query
//          subgroup g (rows g*32 .. g*32+31) and slot k; at hit_sub 16
//          hits[b*4 + g, 2k + e] counts those with half e of slot k
//          (particles e*16 .. e*16+15);
//   G = 1: hits[b, k] = particles of slot k within h of some query of
//          the block;
//   G = 0: none (the densities of the block variants).
// On finer query blocks (nl_query_rows 64 or 32, block_size 64, and the
// asm variant at 32 rows) a list row serves R = 64 or 32 queries,
// qb*R .. qb*R + R-1, and G is 1 or 0 (density_c32_rows_launch).
//
// What bounds it on an H100: instruction issue, as density_c16.cu sets
// out: the pairs of the panels that pass the box test are computed at
// density_c16's rate (on the 1M cube lattice's q32 tables 0.78e9 pairs
// in 0.62 ms of device time, PERF.md). The 32-wide subblocks, and most
// of all the block tables, hold a larger share of pairs outside the
// support than the 16-wide ones (36 % and 14 % of their panels pass the
// box test there, against 47 %), so the cull skips more. Registers 72
// (71 densities only), 18,432 bytes of shared memory a thread block; the
// gathered slots are 512 contiguous bytes of the 16-byte position pack,
// which stays in the 50 MB L2.
//
// Design: density_warp.cuh (one warp a list row, four queries a lane,
// cp.async double-buffered tiles of 4 slots, (subgroup, 8-candidate)
// panels culled by their boxes). G = 4 counts are per-lane counters
// reduced once a column; G = 1 ORs each lane's four queries' tests into
// a bit a candidate, ORs the lanes with __reduce_or_sync once a slot and
// counts the slot's 32 bits with __popc; G = 0 counts nothing. Each
// query sums its candidates in ascending slot and particle order, as
// the earlier thread-a-query form of this kernel did, so the densities
// equal its bits.
//
// Each mode also runs in the identity mode (density_c32_mxu_launch and
// density_c32_rows_mxu_launch; fused_density_nl and fused_density_asm at
// r2_mxu=True, density_warp.cuh's kMxu): r^2 by sph::pair_r2_id on the
// centred pack. The block variants' densities-only calls never take it
// (the JAX package runs them in the direct form).

#include "density_warp.cuh"

namespace {

template <bool kMxu>
int launch_c32(const void* pos4, const void* cand, const void* count,
               const void* qblock, int nq, int cap, int groups, int hit_sub,
               float h2, float poly6, float mass, float fluid_density,
               void* density, void* hits, void* stream) {
  using sph::Hits;
  constexpr int R = sph::kBlock;
  decltype(&sph::density_rows_kernel<32, 32, Hits::kSubgroup, false, R, kMxu>) kernel;
  if (groups == 4 && hit_sub == 32) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kSubgroup, false, R, kMxu>;
  } else if (groups == 4 && hit_sub == 16) {
    kernel = sph::density_rows_kernel<32, 16, Hits::kSubgroup, false, R, kMxu>;
  } else if (groups == 1 && hit_sub == 32) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kBlock, false, R, kMxu>;
  } else if (groups == 0 && hit_sub == 32) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kNone, false, R, kMxu>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return sph::launch_density_rows(kernel, pos4, cand, count, qblock, nq, cap, h2,
                                  0.f, poly6, mass, fluid_density, density, hits,
                                  nullptr, stream);
}

template <bool kMxu>
int launch_c32_rows(const void* pos4, const void* cand, const void* count,
                    const void* qblock, int nq, int cap, int groups, int rows,
                    float h2, float poly6, float mass, float fluid_density,
                    void* density, void* hits, void* stream) {
  using sph::Hits;
  decltype(&sph::density_rows_kernel<32, 32, Hits::kBlock, false, 64, kMxu>) kernel;
  if (groups == 1 && rows == 64) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kBlock, false, 64, kMxu>;
  } else if (groups == 1 && rows == 32) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kBlock, false, 32, kMxu>;
  } else if (groups == 0 && rows == 64) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kNone, false, 64, kMxu>;
  } else if (groups == 0 && rows == 32) {
    kernel = sph::density_rows_kernel<32, 32, Hits::kNone, false, 32, kMxu>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return sph::launch_density_rows(kernel, pos4, cand, count, qblock, nq, cap, h2,
                                  0.f, poly6, mass, fluid_density, density, hits,
                                  nullptr, stream);
}

}  // namespace

// Plain C entry point: (``groups``, ``hit_sub``) = (4, 32), (1, 32),
// (4, 16) or (0, 32) (densities only; ``hits`` is not read) picks the
// instantiation; launches one warp per list row (nq of them, four a
// block) on ``stream``, allocates nothing, and returns
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
  return launch_c32<false>(pos4, cand, count, qblock, nq, cap, groups, hit_sub, h2,
                           poly6, mass, fluid_density, density, hits, stream);
}

// Plain C entry point of the finer query blocks: ``rows`` (32 or 64, the
// queries a list row serves, qb*rows .. qb*rows + rows-1) and ``groups``
// (1: block counts, 0: densities only) pick the instantiation; otherwise
// as density_c32_launch at hit_sub 32 (``hits`` (nq*groups, cap) int32
// zeroed by the caller; cudaErrorInvalidValue for another pair).
extern "C" int density_c32_rows_launch(const void* pos4, const void* cand,
                                       const void* count, const void* qblock,
                                       int nq, int cap, int groups, int rows,
                                       float h2, float poly6, float mass,
                                       float fluid_density, void* density,
                                       void* hits, void* stream) {
  return launch_c32_rows<false>(pos4, cand, count, qblock, nq, cap, groups, rows, h2,
                                poly6, mass, fluid_density, density, hits, stream);
}

// The identity mode's entry points (fused_density_nl and
// fused_density_asm at r2_mxu=True), as the two above (``pos4`` centred
// on the domain).
extern "C" int density_c32_mxu_launch(const void* pos4, const void* cand,
                                      const void* count, const void* qblock,
                                      int nq, int cap, int groups, int hit_sub,
                                      float h2, float poly6, float mass,
                                      float fluid_density, void* density,
                                      void* hits, void* stream) {
  return launch_c32<true>(pos4, cand, count, qblock, nq, cap, groups, hit_sub, h2,
                          poly6, mass, fluid_density, density, hits, stream);
}

extern "C" int density_c32_rows_mxu_launch(const void* pos4, const void* cand,
                                           const void* count, const void* qblock,
                                           int nq, int cap, int groups, int rows,
                                           float h2, float poly6, float mass,
                                           float fluid_density, void* density,
                                           void* hits, void* stream) {
  return launch_c32_rows<true>(pos4, cand, count, qblock, nq, cap, groups, rows, h2,
                               poly6, mass, fluid_density, density, hits, stream);
}
