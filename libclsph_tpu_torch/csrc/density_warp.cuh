// density_warp.cuh — the warp-per-list-row SPH density kernel shared by
// density_c16.cu (16-particle candidate subblocks) and density_c32.cu
// (32-particle subblocks). Each of those files states what its modes
// compute, which JAX function they replace and what bounds them; this
// header holds the one kernel body, templated on the subblock width
// kSub, the width of a hit column HIT_SUB, what it counts (Hits) and
// whether a mask gates its tiles (kGate, density_gated16.cu).
//
// Computes, for list row b (query block qb = qblock[b], or b without a
// map) and every query particle i = qb*R + t of the R = kRows rows a list
// serves (128, or 64 and 32 on finer query blocks):
//   rho_i = m * sum_j real_j * poly6 * max(h^2 - r_ij^2, 0)^3
// over the particles j of the row's candidate subblocks cand[b, k]
// (particles cand*kSub .. cand*kSub + kSub-1, k < count[b]), self
// included; non-real queries get the rest density. rho_i is written at
// row b*R + t. With query subgroup g (rows g*32 .. g*32+31) it counts
//   Hits::kSubgroup: the pairs with r^2 < h^2 between subgroup g and run
//     e of HIT_SUB particles of slot k, at hits[b*4 + g, k*kSub/HIT_SUB
//     + e];
//   Hits::kSubgroupTiles: those, and the pairs with r^2 < h2_dil between
//     subgroup g and tile t (slots 8t .. 8t+7, kSub 16) at
//     tiles[b*4 + g, t], ntiles = ceil(cap / 8) columns;
//   Hits::kBlock: the particles of slot k within h of some query of the
//     block, at hits[b, k] (HIT_SUB = kSub);
//   Hits::kNone: nothing (densities only; hits and tiles are not read).
// The subgroup modes and the gate need R = 128; the block mode and kNone
// run at every R.
// With kGate (kSub 16, HIT_SUB 16, Hits::kSubgroup) only the panels of
// (subgroup g, tile t) whose bit (t % 8)*4 + g of mask[b, t / 8] is set
// are summed and counted: tiles with no bit set are skipped, and the
// hit columns of a summed tile read 0 for a subgroup whose bit is clear.
//
// Design: one warp per list row, four rows a thread block, no block
// barrier. Each lane holds R/32 queries, one of each subgroup (at R = 128
// lane l holds queries l, 32 + l, 64 + l, 96 + l). The warp stages one
// tile (128 particles: 8 slots of 16 or 4 of 32) a round with cp.async
// into one of two shared buffers while it sums the other; on arrival each
// lane forms w_j = poly6 * real_j for its own copies (once a candidate)
// and the bounding box of each run of 8 candidates is reduced by
// shuffles. A subgroup's box is reduced once a row (at R < 128 the
// missing subgroups get an empty box, and their bits are never read).
// Each lane tests two of the tile's 64 (run, subgroup) panels box against
// box, and a ballot
// gives the warp one bit a panel: a panel whose boxes lie farther apart
// than h (h_dil with tile counts), with a 1e-4 margin over the rounding
// of r^2 and of the gap, holds no pair inside the support, so every pair
// it holds would add exactly +0 to the sums and nothing to the counts,
// and the warp skips it (the branch is uniform); the gate's nibble is
// ANDed into those bits, and the pipeline walks only the flagged tiles
// (next_flagged, uniform across the warp). In the other panels a
// shared load of a candidate is a broadcast, r^2 < h^2 is the sign bit of
// r^2 - h^2, which the clamp reuses (max(-(r^2 - h^2), 0) is
// max(h^2 - r^2, 0) up to the sign of a zero, so the single fma adds the
// bits sph::density_add adds). Subgroup counts are per-lane counters
// reduced once a hit column by __reduce_add_sync and written once a tile
// with one store a subgroup; the block mode ORs each lane's four queries'
// tests into a bit a candidate, __reduce_or_sync ORs the lanes once a
// slot, and a __popc of the slot's bits is its count. Each query sums its
// candidates in ascending slot and particle order, so the densities do
// not depend on the mode, the width of the tile or the panels skipped;
// r^2 is rounded as (dx*dx + dy*dy) + dz*dz without FMA contraction
// (sph::pair_r2), so the counts equal the plain PyTorch version's
// exactly.
//
// kMxu (the identity mode, sph_pair.cuh; not with the gate, which JAX
// runs in the direct form only) takes r^2 by sph::pair_r2_id: each lane
// forms its queries' -2q and |q|^2 once a row, and each candidate's
// |c|^2 once a tile beside w_j, into a shared array of its own; a
// panel's reach grows by sph::kIdErr * (|q|^2 + |c|^2) over the
// subgroup's box and the run's (box_norm2; the run's bound rides in its
// box's spare w), so a culled panel still holds no pair whose identity
// r^2 is below h^2 (h2_dil with tile counts).

#pragma once

#include <math_constants.h>

#include "sph_pair.cuh"
#include "stage_cull.cuh"

namespace sph {

enum class Hits { kSubgroup, kSubgroupTiles, kBlock, kNone };

constexpr int kRowsPerBlock = 4;  // list rows (warps) a thread block
constexpr int kStagedPerLane = kBlock / 32;  // particles a lane stages per tile
constexpr int kTileSlots16 = 8;   // slots of a dilated-count tile (kSub 16)

// Issue the copies of one tile into ``dst``: lanes 0 .. 128/kSub - 1
// hold its slot ids in ``ids``, ``live`` slots are live (more than a
// tile: all); particle p = m*32 + lane of the tile is particle p % kSub
// of slot p / kSub.
template <int kSub>
__device__ __forceinline__ void stage_tile(float4* dst, const float4* pos4,
                                           int ids, int live, int lane) {
#pragma unroll
  for (int m = 0; m < kStagedPerLane; ++m) {
    const int s = m * (32 / kSub) + lane / kSub;
    const int id = __shfl_sync(0xffffffffu, ids, s);
    if (s < live) {
      cp_async16(dst + m * 32 + lane, pos4 + (long long)id * kSub + lane % kSub);
    }
  }
}

// The first tile at or after ``t`` (and before ``nt``) whose nibble of the
// gate mask row is set (bit (t % 8)*4 + g of word t / 8 flags subgroup g),
// or nt. Every lane reads the same words, so the result is warp-uniform.
__device__ __forceinline__ int next_flagged(const int* mask_row, int t, int nt) {
  while (t < nt) {
    const unsigned word = (unsigned)mask_row[t / 8] >> ((t % 8) * 4);
    unsigned any = word | (word >> 1);  // bit 4j: nibble j (tile t + j) is set
    any = (any | (any >> 2)) & 0x11111111u;
    if (any) return min(t + (__ffs(any) - 1) / 4, nt);
    t = (t / 8 + 1) * 8;
  }
  return nt;
}

template <int kSub, int HIT_SUB, Hits kHits, bool kGate = false, int kRows = kBlock,
          bool kMxu = false>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
density_rows_kernel(const float4* __restrict__ pos4,
                    const int* __restrict__ cand, const int* __restrict__ count,
                    const int* __restrict__ qblock, int nq, int cap, float h2,
                    float h2_dil, float poly6, float mass, float fluid_density,
                    float* __restrict__ density, int* __restrict__ hits,
                    int* __restrict__ tiles, const int* __restrict__ mask,
                    int words) {
  constexpr int kWarps = kRowsPerBlock;
  constexpr int kQ = kRows / 32;  // queries a lane holds, one a subgroup
  constexpr int kTile = kBlock / kSub;     // slots staged per round
  constexpr int kSlotRuns = kSub / kRun;   // pair-loop steps a slot
  constexpr bool kTiles = kHits == Hits::kSubgroupTiles;
  constexpr bool kCounts = kHits == Hits::kSubgroup || kTiles;
  constexpr bool kAny = kHits == Hits::kBlock;
  constexpr int kRuns = kSub / HIT_SUB;    // subgroup hit columns a slot
  constexpr int kSteps = HIT_SUB / kRun;   // pair-loop steps a hit column
  static_assert(kSub % HIT_SUB == 0 && HIT_SUB % kRun == 0, "hit columns");
  static_assert(!kTiles || kSub * kTileSlots16 == kBlock, "tile counts: kSub 16");
  static_assert(!kAny || HIT_SUB == kSub, "the block mode counts whole slots");
  static_assert(!kGate || (kSub * kTileSlots16 == kBlock && HIT_SUB == kSub &&
                           kHits == Hits::kSubgroup), "the gate: kSub 16, subgroup counts");
  static_assert(kRows == kBlock || ((kRows == 32 || kRows == 64) && !kGate &&
                                    (kAny || kHits == Hits::kNone)),
                "finer query blocks: 32 or 64 rows, block counts or none");
  static_assert(!(kGate && kMxu), "the gate runs the direct form");
  __shared__ float4 stage[kWarps][2][kBlock];
  __shared__ float4 run_box[kWarps][kBlock / kRun][2];  // lo, hi of each run
  // kMxu: |c|^2 of each staged candidate, beside stage
  __shared__ float cnorm[kMxu ? kWarps : 1][2][kMxu ? kBlock : 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= nq) return;  // warps are independent: no block barrier follows
  const long long qb = qblock ? qblock[b] : b;
  const float4* qrow = pos4 + qb * kRows + lane;
  float qx[kQ], qy[kQ], qz[kQ], sum[kQ];
  IdQuery idq[kQ];  // kMxu
  unsigned cnt[kQ], dil[kQ];
  int mine[kQ];  // lane c keeps column c of the tile's counts
  float3 qlo, qhi;  // the box of subgroup lane % 4
  if constexpr (kQ < 4) {  // an empty box where the row has no such subgroup
    qlo = make_float3(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    qhi = make_float3(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
  }
#pragma unroll
  for (int g = 0; g < kQ; ++g) {
    const float4 q = qrow[g * 32];
    qx[g] = q.x;
    qy[g] = q.y;
    qz[g] = q.z;
    if constexpr (kMxu) idq[g] = id_query(q.x, q.y, q.z);
    sum[g] = 0.f;
    cnt[g] = 0u;
    dil[g] = 0u;
    mine[g] = 0;
    float3 lo = make_float3(q.x, q.y, q.z), hi = lo;
    box_reduce<32>(lo, hi);
    if (g == (lane & 3)) {
      qlo = lo;
      qhi = hi;
    }
  }
  unsigned slot_bits = 0u;  // kAny: bit of each candidate of the slot hit
  // a (subgroup, run) panel whose boxes lie this far apart holds no pair
  // with r^2 below h^2 (nor h2_dil with tile counts)
  const float reach2 = (kTiles ? fmaxf(h2, h2_dil) : h2) * kBoxMargin;
  const float qnorm = kMxu ? box_norm2(qlo, qhi) : 0.f;  // subgroup lane % 4's bound
  const int n = count[b];
  const int* row = cand + (long long)b * cap;
  const long long ncol = kAny ? cap : (long long)kRuns * cap;
  // subgroup counts: row b*4 + g at + g*ncol; block counts: row b
  int* hit_row = kCounts || kAny ? hits + (long long)b * (kAny ? 1 : kQ) * ncol : nullptr;
  const int ntiles = (cap + kTile - 1) / kTile;
  int* tile_row = kTiles ? tiles + (long long)b * kQ * ntiles : nullptr;

  // Sum staged tile t (slots k0 .. k0 + kTile - 1) from ``cur``; ``gate``
  // holds the tile's mask nibble in each of its eight nibbles (all ones
  // without the gate).
  auto sum_tile = [&](float4* cur, int k0, int t, unsigned gate) {
    const int ns = min(kTile, n - k0);
    float* cn = nullptr;
    if constexpr (kMxu) cn = cnorm[w][cur == stage[w][0] ? 0 : 1];
#pragma unroll
    for (int m = 0; m < kStagedPerLane; ++m) {
      // the lane's own copies: w_j = poly6 * real_j (and |c|^2), and the
      // box of the run of 8 each lies in (the boxes of runs past the live
      // slots are never read)
      const int p = m * 32 + lane;
      const float4 c = cur[p];
      if (p < ns * kSub) cur[p].w = poly6 * c.w;
      if constexpr (kMxu) cn[p] = norm2(c.x, c.y, c.z);
      float3 lo = make_float3(c.x, c.y, c.z), hi = lo;
      box_reduce<kRun>(lo, hi);
      if ((lane & (kRun - 1)) == 0) {
        run_box[w][p / kRun][0] =
            make_float4(lo.x, lo.y, lo.z, kMxu ? box_norm2(lo, hi) : 0.f);
        run_box[w][p / kRun][1] = make_float4(hi.x, hi.y, hi.z, 0.f);
      }
    }
    __syncwarp();
    // bit 4r + g of live[r / 8]: run r may hold a pair of subgroup g
    // within reach (and the gate flags subgroup g); lane l tests (run
    // l / 4 + 8h, subgroup l % 4)
    unsigned live[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half * 8 + (lane >> 2);
      const float4 rlo = run_box[w][r][0];
      const float reach = kMxu ? reach2 + kIdErr * (qnorm + rlo.w) : reach2;
      live[half] = __ballot_sync(0xffffffffu,
                                 box_gap2(qlo, qhi, rlo, run_box[w][r][1]) < reach);
      if (kGate) live[half] &= gate;
    }
#pragma unroll 1
    for (int j = 0; j < ns * kSlotRuns; ++j) {
      const unsigned panels = ((j < 8 ? live[0] : live[1]) >> (4 * (j & 7))) & 15u;
      unsigned any = 0u;  // kAny: bit p, candidate p of the run is hit
#pragma unroll
      for (int g = 0; g < kQ; ++g) {
        if (!((panels >> g) & 1u)) continue;  // every pair adds +0 and no hit
#pragma unroll
        for (int p = 0; p < kRun; ++p) {
          const float4 c = cur[j * kRun + p];
          const float r2 = kMxu ? pair_r2_id(idq[g], c.x, c.y, c.z, cn[j * kRun + p])
                                : pair_r2(qx[g], qy[g], qz[g], c.x, c.y, c.z);
          const float e = r2 - h2;  // -(h^2 - r^2) exactly; negative iff r^2 < h^2
          const float tt = fmaxf(-e, 0.f);
          sum[g] = __fmaf_rn(c.w, (tt * tt) * tt, sum[g]);
          if (kCounts) cnt[g] += __float_as_uint(e) >> 31;
          if (kTiles) dil[g] += __float_as_uint(r2 - h2_dil) >> 31;
          if (kAny) any |= (__float_as_uint(e) >> 31) << p;
        }
      }
      if (kCounts && (j + 1) % kSteps == 0) {  // a hit column is complete
        const int col = j / kSteps;
#pragma unroll
        for (int g = 0; g < kQ; ++g) {
          const int v = (int)__reduce_add_sync(0xffffffffu, cnt[g]);
          if (lane == col) mine[g] = v;
          cnt[g] = 0u;
        }
      }
      if (kAny) {
        slot_bits |= any << (kRun * (j % kSlotRuns));
        if ((j + 1) % kSlotRuns == 0) {  // a slot is complete
          const unsigned v = __reduce_or_sync(0xffffffffu, slot_bits);
          if (lane == j / kSlotRuns) mine[0] = __popc(v);
          slot_bits = 0u;
        }
      }
    }
    if (kCounts && lane < ns * kRuns) {
#pragma unroll
      for (int g = 0; g < kQ; ++g) hit_row[g * ncol + k0 * kRuns + lane] = mine[g];
    }
    if (kAny && lane < ns) hit_row[k0 + lane] = mine[0];
    if (kTiles) {
#pragma unroll
      for (int g = 0; g < kQ; ++g) {
        const int v = (int)__reduce_add_sync(0xffffffffu, dil[g]);
        if (lane == 0) tile_row[g * ntiles + t] = v;
        dil[g] = 0u;
      }
    }
    __syncwarp();  // the buffers are refilled next round
  };

  if constexpr (!kGate) {
    // software pipeline: tile t+1 is in flight while tile t is summed, and
    // the slot ids of tile t+2 are loaded meanwhile
    int ids = lane < min(n, kTile) ? row[lane] : 0;
    stage_tile<kSub>(stage[w][0], pos4, ids, n, lane);
    cp_async_commit();
    ids = lane < min(n - kTile, kTile) ? row[kTile + lane] : 0;
    for (int k0 = 0, t = 0; k0 < n; k0 += kTile, ++t) {
      float4* cur = stage[w][t & 1];
      const int next = k0 + kTile;
      if (next < n) stage_tile<kSub>(stage[w][(t + 1) & 1], pos4, ids, n - next, lane);
      cp_async_commit();
      ids = lane < min(n - next - kTile, kTile) ? row[next + kTile + lane] : 0;
      cp_async_wait_prior();
      sum_tile(cur, k0, t, ~0u);
    }
  } else {
    // the same pipeline over the flagged tiles only: a tile whose nibble
    // is 0 is neither staged nor are its slot ids loaded, and its hit
    // columns keep the caller's zeros
    const int* mask_row = mask + (long long)b * words;
    const int nt = (n + kTile - 1) / kTile;
    auto ids_of = [&](int t) {
      return t < nt && lane < min(n - t * kTile, kTile) ? row[t * kTile + lane] : 0;
    };
    int t = next_flagged(mask_row, 0, nt);
    int ids = ids_of(t);
    if (t < nt) stage_tile<kSub>(stage[w][0], pos4, ids, n - t * kTile, lane);
    cp_async_commit();
    int t1 = t < nt ? next_flagged(mask_row, t + 1, nt) : nt;
    ids = ids_of(t1);
    for (int u = 0; t < nt; ++u) {
      float4* cur = stage[w][u & 1];
      if (t1 < nt) stage_tile<kSub>(stage[w][(u + 1) & 1], pos4, ids, n - t1 * kTile, lane);
      cp_async_commit();
      const int t2 = t1 < nt ? next_flagged(mask_row, t1 + 1, nt) : nt;
      ids = ids_of(t2);
      const unsigned nib = ((unsigned)mask_row[t / 8] >> ((t % 8) * 4)) & 15u;
      cp_async_wait_prior();
      sum_tile(cur, t * kTile, t, nib * 0x11111111u);
      t = t1;
      t1 = t2;
    }
  }
  float* out = density + (long long)b * kRows + lane;
#pragma unroll
  for (int g = 0; g < kQ; ++g) {
    out[g * 32] = qrow[g * 32].w > 0.f ? mass * sum[g] : fluid_density;
  }
}

// Launch ``kernel`` (a density_rows_kernel instantiation) over nq list
// rows, four a thread block, on ``stream``; returns cudaGetLastError().
// ``mask`` ((nq, words) int32) is read by the gated instantiation only.
template <typename Kernel>
int launch_density_rows(Kernel kernel, const void* pos4, const void* cand,
                        const void* count, const void* qblock, int nq, int cap,
                        float h2, float h2_dil, float poly6, float mass,
                        float fluid_density, void* density, void* hits,
                        void* tiles, void* stream, const void* mask = nullptr,
                        int words = 0) {
  if (nq > 0) {
    kernel<<<(nq + kRowsPerBlock - 1) / kRowsPerBlock, kRowsPerBlock * 32, 0,
             (cudaStream_t)stream>>>(
        (const float4*)pos4, (const int*)cand, (const int*)count,
        (const int*)qblock, nq, cap, h2, h2_dil, poly6, mass, fluid_density,
        (float*)density, (int*)hits, (int*)tiles, (const int*)mask, words);
  }
  return (int)cudaGetLastError();
}

}  // namespace sph
