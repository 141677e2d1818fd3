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
// Computes (density_warp.cuh at kSub 16), for list row b and its query
// block's 128 queries, the densities over the row's 16-wide candidate
// subblocks and, with query subgroup g (rows g*32 .. g*32+31), the pairs
// with r^2 < h^2
//   HIT_SUB = 8:  between subgroup g and half e of slot k, at
//                 hits[b*4 + g, 2k + e];
//   HIT_SUB = 16: between subgroup g and slot k, at hits[b*4 + g, k];
// and, with the tile counts, the pairs with r^2 < h2_dil = hit2_h^2
// between subgroup g and tile t (slots 8t .. 8t+7) at tiles[b*4 + g, t],
// ntiles = ceil(cap / 8) columns.
//
// What bounds it on an H100: instruction issue. A pair costs 15.1
// lane-instructions in SASS (r^2 without contraction 8, r^2 - h^2, the
// clamp, the cube 2, the fma, the hit count, and a shared load; 17 with
// the dilated count), and the card issues at most one warp-instruction
// a clock on each of its 528 schedulers, while its fp32 count is 16
// operations a pair at 67 TFLOP/s (an fma as two). So the
// kernel saves issue slots by skipping pairs: on the cube lattice's
// main-path tables about half of the (subgroup, 8 candidates) panels
// lie farther than h from their queries (PERF.md gives the shares).
// Registers (ptxas -v, sm_90a): 72 in each mode, 8 bytes spilled with
// the dilated counts; 18,432 bytes of shared memory a block. The
// position pack is 16 bytes a particle (16 MB at 1M particles); it stays
// in the 50 MB L2, and each gathered slot is 256 contiguous bytes.
//
// Design: density_warp.cuh (one warp a list row, four queries a lane,
// cp.async double-buffered tiles of 8 slots, panels of (subgroup, 8
// candidates) culled by their boxes, per-lane counters reduced once a
// column). Each query sums its candidates in ascending slot and particle
// order, so the densities equal density_gated16's bit for bit.
//
// Each mode also runs in the identity mode (density_c16_mxu_launch;
// fused_density_nl at r2_mxu=True, density_warp.cuh's kMxu): r^2 by
// sph::pair_r2_id on the centred pack.

#include "density_warp.cuh"

namespace {

template <bool kMxu>
int launch_c16(const void* pos4, const void* cand, const void* count,
               const void* qblock, int nq, int cap, int hit_sub, float h2,
               float h2_dil, float poly6, float mass, float fluid_density,
               void* density, void* hits, void* tiles, void* stream) {
  using sph::Hits;
  decltype(&sph::density_rows_kernel<16, 8, Hits::kSubgroup, false, sph::kBlock, kMxu>)
      kernel;
  if (hit_sub == 8 && !tiles) {
    kernel = sph::density_rows_kernel<16, 8, Hits::kSubgroup, false, sph::kBlock, kMxu>;
  } else if (hit_sub == 16 && !tiles) {
    kernel = sph::density_rows_kernel<16, 16, Hits::kSubgroup, false, sph::kBlock, kMxu>;
  } else if (hit_sub == 16) {
    kernel =
        sph::density_rows_kernel<16, 16, Hits::kSubgroupTiles, false, sph::kBlock, kMxu>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return sph::launch_density_rows(kernel, pos4, cand, count, qblock, nq, cap, h2,
                                  h2_dil, poly6, mass, fluid_density, density,
                                  hits, tiles, stream);
}

}  // namespace

// Plain C entry point: ``hit_sub`` 8 or 16 and ``tiles`` (null: no tile
// counts; else (nq*4, ceil(cap/8)) int32, needs hit_sub 16) pick the
// instantiation; launches one warp per list row (nq of them, four a
// block) on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for another mode). ``qblock`` may
// be null (row b is query block b). ``hits`` ((nq*4, cap*16/hit_sub))
// and ``tiles`` must be zeroed by the caller: slots and tiles at or past
// count[b] are not written.
extern "C" int density_c16_launch(const void* pos4, const void* cand,
                                  const void* count, const void* qblock,
                                  int nq, int cap, int hit_sub, float h2,
                                  float h2_dil, float poly6, float mass,
                                  float fluid_density, void* density,
                                  void* hits, void* tiles, void* stream) {
  return launch_c16<false>(pos4, cand, count, qblock, nq, cap, hit_sub, h2, h2_dil,
                           poly6, mass, fluid_density, density, hits, tiles, stream);
}

// The identity mode's entry point (fused_density_nl at r2_mxu=True), as
// density_c16_launch (``pos4`` centred on the domain).
extern "C" int density_c16_mxu_launch(const void* pos4, const void* cand,
                                      const void* count, const void* qblock,
                                      int nq, int cap, int hit_sub, float h2,
                                      float h2_dil, float poly6, float mass,
                                      float fluid_density, void* density,
                                      void* hits, void* tiles, void* stream) {
  return launch_c16<true>(pos4, cand, count, qblock, nq, cap, hit_sub, h2, h2_dil,
                          poly6, mass, fluid_density, density, hits, tiles, stream);
}
