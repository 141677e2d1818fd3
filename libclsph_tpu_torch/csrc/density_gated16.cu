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
// kernel's bit for bit: the same terms are added in the same slot order.
//
// What bounds it on an H100: instruction issue, as density_c16.cu sets
// out, over the panels that both the mask and the box test pass, and the
// gathered candidate loads of the tiles that some subgroup needs.
//
// Design: density_warp.cuh at kSub 16, hit_sub 16, subgroup counts, in
// its gated mode (one warp a list row, four queries a lane, cp.async
// double-buffered tiles of 8 slots, (subgroup, 8-candidate) panels culled
// by their boxes). The warp finds the next tile whose mask nibble is set
// from the mask words (the same for every lane) and stages only those
// tiles, loading their slot ids one flagged tile ahead; the nibble is
// ANDed into the live-panel bits of every run of the tile, and the tile's
// hit columns are written as density_c16 writes them (0 for a subgroup
// the gate clears). Each query sums its candidates in ascending slot and
// particle order, so the densities equal density_c16's bit for bit.

#include "density_warp.cuh"

// Plain C entry point: launches one warp per query block (nb of them,
// four a thread block) on ``stream``, allocates nothing, and returns
// cudaGetLastError() (0 on success). ``mask`` is (nb, words) int32 with
// words >= ceil(cap/64). ``hits`` ((nb*4, cap) int32) must be zeroed by
// the caller: slots of unflagged tiles and slots at or past count[b] are
// not written.
extern "C" int density_gated16_launch(const void* pos4, const void* cand,
                                      const void* count, const void* mask,
                                      int nb, int cap, int words, float h2,
                                      float poly6, float mass,
                                      float fluid_density, void* density,
                                      void* hits, void* stream) {
  return sph::launch_density_rows(
      sph::density_rows_kernel<16, 16, sph::Hits::kSubgroup, true>, pos4, cand, count,
      nullptr, nb, cap, h2, 0.f, poly6, mass, fluid_density, density, hits, nullptr,
      stream, mask, words);
}
