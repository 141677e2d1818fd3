// forces_q32 — SPH internal forces over per-subgroup hit lists of 8-, 16-
// or 32-particle candidate runs, with the force combine fused into the
// epilogue. One source, three instantiations by the run width kSub:
//
//   kSub = 8:  forces_q32_c8, replaces libclsph_tpu/ops/pallas/
//     neighbor_nl.py fused_forces_nl32_c8 (kernel _forces_kernel_q32x4_c8);
//   kSub = 16: forces_q32_c16, replaces neighbor_nl.py
//     fused_forces_nl32_c16 (kernels _forces_kernel_q32x4_c16 and
//     _forces_kernel_q32_c16, the 'x4' and 'q32' grid layouts of one
//     computation);
//   kSub = 32: forces_q32_c32, replaces neighbor_nl.py fused_forces_nl32
//     (kernel _forces_kernel_q32);
//
// all with the pair sums _forces_pair_q32, the finalize
// _forces_finalize_q32 and the combine _combine_forces.
//
// Computes, for list row b (query block qb = qblock[b], or b without a
// map) and query i = qb*128 + t in subgroup g = t/32 (list row b*4 + g),
// over the particles j = cand[row, k]*kSub + l, k < count[row], l < kSub:
//   P = sum a_ij (x_i - x_j) + sum_{j != i, r < eps} (pm_i + pm_j) spiky
//   V = sum visc mr_j (h - r) (v_j - v_i)
//   N = sum pgrad mr_j t^2 (x_i - x_j),   t = h^2 - r^2
//   L = sum (7 plap/pgrad g_ij - 4 h^2 plap mr_j t)
// with a_ij = (pm_i + pm_j) spiky (h - r)^2 / r, pm = m p / rho^2 and
// mr = m / rho (both 0 on padding particles), then
//   a_i = (-rho_i P + mu V + ST) / rho_i + gravity,
// ST = -sigma L N / |N| where |N| exceeds the threshold, rho guarded
// to 1 where it is 0, and a_i = 0 on padding rows; written at row
// b*128 + t. The query-block map lets the two-tier path run gathered
// heavy blocks against the full particle arrays.
//
// What bounds it on an H100: instruction issue, and how much of it a
// warp spends on pairs outside the support. An entry is in a subgroup's
// list when some pair of its (32 queries x kSub particles) panel hits,
// so only a few percent of a list's pairs lie inside the support, yet
// with one query a lane and the candidate broadcast nearly every
// candidate has some lane inside: a warp that runs the pair terms
// whenever any lane needs them runs them for nearly every candidate. In
// SASS the test of a candidate costs each lane 11 instructions (a shared
// load, r^2 8, r^2 - h^2, a funnel shift), staging about 2, and a pair
// inside the support 73 (its terms 36 with a MUFU rsqrt, the reloads,
// the bit walk), which the warp pays at its largest per-lane count of
// the round; a wider round brings that count closer to the mean (PERF.md
// gives both). The table's bound counts 9 operations for every pair and
// 42 more for each pair inside the support. Registers (ptxas -v,
// sm_90a): 61 at kSub 8 and 16, 64 at 32, no spills; 24,576 bytes of
// shared memory a block.
//
// Design: one thread block per list row block, warp g = query subgroup g
// walking its own list with no block barrier (the lists differ in
// length). Each round the warp stages kRound = 128 candidates in its
// own slice of shared memory (two 16-byte loads a candidate, one
// candidate a lane per pass) as 48 bytes: position and id, velocity and
// pm, and mr with visc * mr (formed once a candidate). Then
// sph::force_round (force_walk.cuh, shared with forces_q128_c32, here
// without its box cull): (a) each lane tests its query against every
// staged candidate and shifts the sign bit of r^2 - h^2 into a bitmask,
// a bit a candidate; (b) each lane walks its own set bits in ascending
// candidate order (__clz, clear the bit) and adds the terms of those
// pairs only. The warp pays the largest popcount over its lanes, not
// the round's width. Each query adds its
// in-support candidates in ascending order with the arithmetic of
// sph::ForceSums::add (add_inside, whose fused multiply-adds are spelt
// out), so a candidate-at-a-time kernel gets the same bits.
// Self-exclusion compares int32 particle ids (cand * kSub + lane), so
// there is no float-id range limit, and a table of exchanged ids needs
// no second kernel.
//
// The identity mode (kMxu; forces_q32_mxu_launch) replaces the same JAX
// kernels at r2_mxu=True: r^2 by sph::pair_r2_id on the centred pack,
// the query's -2q and |q|^2 formed once a thread and each candidate's
// |c|^2 once at staging (in the staged layout's spare slot, so phase (a)
// reads one more shared word a candidate), pressure dropped between
// equal ids (force_walk.cuh). In source a candidate's test is then 7
// roundings and a clamp against the direct form's 8, and one more shared
// load.

#include <math_constants.h>

#include "force_walk.cuh"

namespace {

using sph::kBlock;
using sph::kRound;  // candidates a warp stages per round
constexpr int kWarps = kBlock / 32;
constexpr int kWords = kRound / 32;   // staging passes a round

template <int kSub, bool kMxu = false>
__global__ void __launch_bounds__(kBlock)
forces_q32_kernel(const float4* __restrict__ f8,
                  const float* __restrict__ density,
                  const unsigned char* __restrict__ real,
                  const int* __restrict__ cand, const int* __restrict__ count,
                  const int* __restrict__ qblock, int cap, sph::ForceConsts k,
                  float* __restrict__ accel) {
  static_assert(kRound % kSub == 0, "a round holds whole runs");
  // per candidate: x y z and the id (int bits); vx vy vz pm; mr, visc * mr
  __shared__ float4 stage[kWarps][kRound][3];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long qb = qblock ? qblock[blockIdx.x] : blockIdx.x;
  const long long i = qb * kBlock + t;
  const float4 qa = f8[2 * i];      // x y z vx
  const float4 qv = f8[2 * i + 1];  // vy vz pm mr
  const long long row = (long long)blockIdx.x * kWarps + g;
  const int n = count[row];
  const int* list = cand + row * cap;
  float4 (*const st)[3] = stage[g];
  const sph::IdQuery idq = kMxu ? sph::id_query(qa.x, qa.y, qa.z) : sph::IdQuery{};

  sph::ForceSums s;
  for (int k0 = 0; k0 < n; k0 += kRound / kSub) {
    __syncwarp();  // the previous round's reads are done
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      const int c = m * 32 + lane;
      const int slot = k0 + c / kSub;
      // a dead candidate sits at infinity: r^2 = inf fails the test (in
      // the identity mode at the origin with |c|^2 = inf)
      const float dead = kMxu ? 0.f : CUDART_INF_F;
      float4 p = make_float4(dead, dead, dead, __int_as_float(-1));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 ms = kMxu ? make_float4(0.f, 0.f, CUDART_INF_F, 0.f) : v;
      if (slot < n) {
        const long long jid = (long long)list[slot] * kSub + (c % kSub);
        const float4 a = f8[2 * jid];
        const float4 b = f8[2 * jid + 1];
        p = make_float4(a.x, a.y, a.z, __int_as_float((int)jid));
        v = make_float4(a.w, b.x, b.y, b.z);
        ms = make_float4(b.w, k.visc * b.w, kMxu ? sph::norm2(a.x, a.y, a.z) : 0.f, 0.f);
      }
      st[c][0] = p;
      st[c][1] = v;
      st[c][2] = ms;
    }
    __syncwarp();
    sph::force_round<false, kMxu>(k, qa, qv, (int)i, st, 0u, s, idq);
  }

  float a[3] = {0.f, 0.f, 0.f};
  if (real[i]) s.combine(k, density[i], a);
  const long long o = (long long)blockIdx.x * kBlock + t;
  accel[3 * o] = a[0];
  accel[3 * o + 1] = a[1];
  accel[3 * o + 2] = a[2];
}

}  // namespace

namespace {

template <bool kMxu>
int launch_q32(const void* f8, const void* density, const void* real, const void* cand,
               const void* count, const void* qblock, int nq, int cap, int sub,
               const sph::ForceConsts& k, void* accel, void* stream) {
  decltype(&forces_q32_kernel<8, kMxu>) kernel;
  if (sub == 8) {
    kernel = forces_q32_kernel<8, kMxu>;
  } else if (sub == 16) {
    kernel = forces_q32_kernel<16, kMxu>;
  } else if (sub == 32) {
    kernel = forces_q32_kernel<32, kMxu>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const int*)cand, (const int*)count, (const int*)qblock, cap, k,
        (float*)accel);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point: ``sub`` 8, 16 or 32 picks the instantiation;
// launches one block per list row block (nq of them) on ``stream``,
// allocates nothing, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for another ``sub``). ``qblock`` may be null
// (row block b is query block b).
extern "C" int forces_q32_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, int sub, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  return launch_q32<false>(f8, density, real, cand, count, qblock, nq, cap, sub, k,
                           accel, stream);
}

// The identity mode's entry point, as forces_q32_launch (``f8`` centred
// on the domain).
extern "C" int forces_q32_mxu_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, int sub, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  return launch_q32<true>(f8, density, real, cand, count, qblock, nq, cap, sub, k,
                          accel, stream);
}
