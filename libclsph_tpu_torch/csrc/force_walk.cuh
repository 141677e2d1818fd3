// force_walk.cuh — the pair loop shared by the force kernels
// (forces_q32.cu, forces_c32.cu): one warp's 32 queries, one a lane,
// against a round of kRound candidates staged in shared memory.
//
// A staged candidate is three float4: (x, y, z, id as int bits),
// (vx, vy, vz, pm) and (mr, visc * mr, |c|^2 in the identity mode, -),
// visc * mr formed once a candidate. force_round runs the round in two phases: (a) each lane
// tests its query against the staged candidates and shifts the sign bit
// of r^2 - h^2 into a bitmask, a bit a candidate; (b) each lane walks its
// own set bits in ascending candidate order (__clz, clear the bit) and
// adds the terms of those pairs only (sph::ForceSums::add_inside). A warp
// pays the largest popcount over its lanes, not the round's width. With
// kCull, phase (a) tests only the runs of kRun candidates whose bit of
// ``runs`` is set (bit r: candidates r*kRun .. r*kRun + kRun-1); the
// caller clears a run's bit only where no pair of it lies inside the
// support (its box lies beyond h of the warp's queries), so the walk
// adds the same pairs in the same order either way. Phase (a) alone is
// round_hits, which the stream kernel's test mode (forces_stream.cu) runs
// without phase (b). With kMxu (the identity mode, sph_pair.cuh) both
// phases take r^2 by pair_r2_id from the query's IdQuery and the staged
// |c|^2 (the third float4's z; a dead candidate stages (0, 0, 0) with
// |c|^2 = inf, so its r^2 is inf), the directions stay x_i - x_j, and
// add_inside drops the pressure term of equal ids.

#pragma once

#include "sph_pair.cuh"
#include "stage_cull.cuh"

namespace sph {

constexpr int kRound = 128;              // candidates a round
constexpr int kRoundWords = kRound / 32;  // hit-mask words a lane
constexpr int kWordRuns = 32 / kRun;      // culled runs a hit-mask word

// (a) this lane's pairs inside the support: bit 31 - c % 32 of word
// c / 32 of ``hit`` (the sign bit of r^2 - h^2, shifted in candidate by
// candidate); returns their number.
template <bool kCull, bool kMxu = false>
__device__ __forceinline__ int round_hits(const ForceConsts& k, float4 qa,
                                          float4 (*st)[3], unsigned runs,
                                          unsigned (&hit)[kRoundWords],
                                          IdQuery idq = IdQuery{}) {
  int left = 0;
#pragma unroll
  for (int m = 0; m < kRoundWords; ++m) {
    unsigned bits = 0u;
    if constexpr (kCull) {
#pragma unroll
      for (int r = 0; r < kWordRuns; ++r) {
        if ((runs >> (m * kWordRuns + r)) & 1u) {  // uniform across the warp
#pragma unroll
          for (int c = 0; c < kRun; ++c) {
            const int e = m * 32 + r * kRun + c;
            const float4 p = st[e][0];
            const float r2 = kMxu ? pair_r2_id(idq, p.x, p.y, p.z, st[e][2].z)
                                  : pair_r2(qa.x, qa.y, qa.z, p.x, p.y, p.z);
            bits = __funnelshift_l(__float_as_uint(r2 - k.h2), bits, 1);
          }
        } else {
          bits <<= kRun;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float4 p = st[m * 32 + c][0];
        const float r2 = kMxu ? pair_r2_id(idq, p.x, p.y, p.z, st[m * 32 + c][2].z)
                              : pair_r2(qa.x, qa.y, qa.z, p.x, p.y, p.z);
        bits = __funnelshift_l(__float_as_uint(r2 - k.h2), bits, 1);
      }
    }
    hit[m] = bits;
    left += __popc(bits);
  }
  return left;
}

template <bool kCull, bool kMxu = false>
__device__ __forceinline__ void force_round(const ForceConsts& k, float4 qa, float4 qv,
                                            int qi, float4 (*st)[3],
                                            unsigned runs, ForceSums& s,
                                            IdQuery idq = IdQuery{}) {
  unsigned hit[kRoundWords];
  int left = round_hits<kCull, kMxu>(k, qa, st, runs, hit, idq);

  // (b) the terms of this lane's own hits, in ascending candidate order
  int base = 0;
  for (; left > 0; --left) {
    while (hit[0] == 0u) {  // the lowest word is spent: shift the next down
#pragma unroll
      for (int m = 0; m + 1 < kRoundWords; ++m) hit[m] = hit[m + 1];
      hit[kRoundWords - 1] = 0u;
      base += 32;
    }
    const int z = __clz(hit[0]);
    hit[0] ^= 0x80000000u >> z;
    const float4* cj = st[base + z];
    const float4 p = cj[0];
    const float4 v = cj[1];
    const float4 ms = cj[2];
    const float dx = qa.x - p.x;
    const float dy = qa.y - p.y;
    const float dz = qa.z - p.z;
    const float r2 = kMxu ? pair_r2_id(idq, p.x, p.y, p.z, ms.z)
                          : __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                      __fmul_rn(dz, dz));
    s.add_inside<kMxu>(k, qa, qv, qi, dx, dy, dz, r2, v.x, v.y, v.z, v.w, ms.x, ms.y,
                       __float_as_int(p.w));
  }
}

}  // namespace sph
