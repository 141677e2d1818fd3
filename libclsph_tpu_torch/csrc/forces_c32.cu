// forces_c32 — SPH internal forces over 32-particle candidate lists
// shared by a whole 128-row query block, with the force combine fused
// into the epilogue (forces_q128_c32).
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py fused_forces_nl
// (kernel _forces_kernel, pair sums neighbor.py _forces_core_rowout) with
// _combine_forces fused in; on the block tables of the row, fine and asym
// variants also libclsph_tpu/ops/pallas/neighbor.py fused_forces (q_div 1
// and 4) and neighbor_asym.py fused_forces. One list per 128-row query
// block, lists (nq, cap). For list row b the queries are i = qb*128 + t
// with qb = qblock[b] (b without a map); the candidates are
// j = cand[b, k]*32 + l, k < count[b], l < 32, in the full f8 pack. The
// sums and the combine are those of forces_q32.cu (csrc/sph_pair.cuh);
// a_i is written at row b*128 + t. Self-exclusion compares global int32
// ids, so gathered query blocks (the two-tier path) exclude the right
// pair. On finer query blocks (nl_query_rows 64 or 32, block_size 64, the
// asm variant at 32 rows, fused_forces_nl and fused_forces_asm at those
// query widths) a list serves R = 64 or 32 rows: queries qb*R + t, a_i
// at row b*R + t (forces_c32_rows_launch; the 128-row kernel is the same
// template at R = 128).
//
// What bounds it on an H100: instruction issue, and how much of it goes
// to pairs outside the support. A list of the whole block admits many
// more such pairs than the per-subgroup lists of forces_q32: on the
// expanded block tables of the 1M cube lattice 0.3 % of the pairs of a
// list lie inside the support, and 6.8 % of the (subgroup, 8
// candidates) panels hold one and 14.4 % pass the box test below
// (PERF.md). The pair terms cost about 45 operations and a MUFU rsqrt;
// the support test of a pair costs a lane 11 instructions in SASS, and
// staging and boxing a tile costs each warp a fixed share whatever the
// cull leaves. Registers (ptxas -v, sm_90a): 59, no spills; 19,456 bytes
// of shared memory a block.
//
// Design: one thread block per list row, warp g = query subgroup g
// (queries g*32 .. g*32+31, one a lane) against the row's shared list,
// one 128-particle tile (4 slots) a round. Thread t copies particle t % 32
// of slot t / 32 of the next tile (of slots g, g + R/32, ... at R < 128)
// with cp.async (the f8 pack's 32 bytes)
// into one of three shared buffers while the block sums the current one;
// on arrival it rewrites its own candidate into force_walk.cuh's staged
// layout (id, visc * mr formed once a candidate) and the box of each run
// of 8 candidates is reduced by shuffles. One barrier a tile makes the
// tile and its run boxes visible to all four warps (three buffers: a
// buffer is refilled only two barriers after its last read); a copy of
// every tile for each warp, with no barrier, measured 1.6-3.3x slower
// (4x the staging work, half the blocks an SM). Each warp tests its
// subgroup's box (reduced once a row) against the tile's 16 run boxes, a
// lane a run, and a ballot gives it one bit a run: a run whose box lies
// beyond h of the subgroup's, with density_warp.cuh's 1e-4 margin over
// the rounding of r^2 and of the gap, holds no pair inside the support,
// and ForceSums::add adds only such pairs, so skipping it is exact.
// sph::force_round (shared with forces_q32) then tests only the runs
// that pass and walks each lane's own in-support candidates in
// ascending order through sph::ForceSums::add_inside: the same pairs, in
// the same order, with the same arithmetic as the earlier thread-a-query
// form of this kernel, so the accelerations keep its bits.
//
// The identity mode (kMxu; forces_c32_mxu_launch and
// forces_c32_rows_mxu_launch) replaces the same JAX kernels at
// r2_mxu=True, fused_forces_asm included: r^2 by sph::pair_r2_id on the
// centred pack (|c|^2 formed at staging, force_walk.cuh). The identity's
// error can exceed the box test's 1e-4 margin, so a run's reach grows by
// sph::kIdErr * (|q|^2 + |c|^2) over the subgroup's box and the run's
// (box_norm2; the run's bound rides in its box's spare w): a run culled
// then still holds no pair whose identity r^2 is below h^2.

#include <math_constants.h>

#include "force_walk.cuh"

namespace {

using sph::kBlock;
using sph::kRound;
using sph::kRun;
constexpr int kSub = 32;                    // particles per candidate subblock
constexpr int kTileSlots = kRound / kSub;   // slots a tile
constexpr int kTileRuns = kRound / kRun;    // culled runs a tile
constexpr int kBufs = 3;                    // staged tiles in shared memory

template <int kRows>
__device__ __forceinline__ void write_accel(const sph::ForceSums& s,
                                            const sph::ForceConsts& k,
                                            const float* density,
                                            const unsigned char* real, long long i,
                                            float* accel) {
  float a[3] = {0.f, 0.f, 0.f};
  if (real[i]) s.combine(k, density[i], a);
  const long long o = (long long)blockIdx.x * kRows + threadIdx.x;
  accel[3 * o] = a[0];
  accel[3 * o + 1] = a[1];
  accel[3 * o + 2] = a[2];
}

// Rewrite a staged candidate from the f8 pack's (x y z vx, vy vz pm mr)
// into the staged layout of force_walk.cuh (|c|^2 too with kMxu);
// returns its position.
template <bool kMxu>
__device__ __forceinline__ float3 stage_layout(float4* c, int jid, float visc) {
  const float4 a = c[0];
  const float4 b = c[1];
  c[0] = make_float4(a.x, a.y, a.z, __int_as_float(jid));
  c[1] = make_float4(a.w, b.x, b.y, b.z);
  c[2] = make_float4(b.w, visc * b.w, kMxu ? sph::norm2(a.x, a.y, a.z) : 0.f, 0.f);
  return make_float3(a.x, a.y, a.z);
}

// kRows queries a list (128, 64 or 32), one a thread; each thread stages
// particle `lane` of kPer = 4 / (kRows / 32) slots of every tile: slots
// k0 + g + m * kWarps, at stage[.][t + m * kRows].
template <int kRows, bool kMxu = false>
__global__ void __launch_bounds__(kRows)
forces_rows_c32_kernel(const float4* __restrict__ f8,
                       const float* __restrict__ density,
                       const unsigned char* __restrict__ real,
                       const int* __restrict__ cand, const int* __restrict__ count,
                       const int* __restrict__ qblock, int cap, sph::ForceConsts k,
                       float* __restrict__ accel) {
  constexpr int kWarps = kRows / 32;
  constexpr int kPer = kTileSlots / kWarps;  // slots a thread stages a tile
  static_assert(kPer * kWarps == kTileSlots, "32, 64 or 128 rows");
  __shared__ float4 stage[kBufs][kRound][3];
  __shared__ float4 run_box[2][kTileRuns][2];  // lo, hi of each run
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long qb = qblock ? qblock[blockIdx.x] : blockIdx.x;
  const long long i = qb * kRows + t;
  const float4 qa = f8[2 * i];      // x y z vx
  const float4 qv = f8[2 * i + 1];  // vy vz pm mr
  const int n = count[blockIdx.x];
  const int* list = cand + (long long)blockIdx.x * cap;
  float3 qlo = make_float3(qa.x, qa.y, qa.z), qhi = qlo;  // the subgroup's box
  sph::box_reduce<32>(qlo, qhi);
  const float reach2 = k.h2 * sph::kBoxMargin;
  const sph::IdQuery idq = kMxu ? sph::id_query(qa.x, qa.y, qa.z) : sph::IdQuery{};
  const float qnorm = kMxu ? sph::box_norm2(qlo, qhi) : 0.f;  // the subgroup's bound

  // the slot ids are loaded a tile ahead of their copies
  int id0[kPer], id1[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int slot = g + m * kWarps;
    id0[m] = slot < n ? list[slot] : 0;
    if (slot < n) {
      const float4* src = f8 + 2 * ((long long)id0[m] * kSub + lane);
      sph::cp_async16(&stage[0][t + m * kRows][0], src);
      sph::cp_async16(&stage[0][t + m * kRows][1], src + 1);
    }
  }
  sph::cp_async_commit();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int slot = kTileSlots + g + m * kWarps;
    id1[m] = slot < n ? list[slot] : 0;
  }

  sph::ForceSums s;
  for (int k0 = 0, u = 0; k0 < n; k0 += kTileSlots, ++u) {
    int id2[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int slot1 = k0 + kTileSlots + g + m * kWarps;
      if (slot1 < n) {
        float4* dst = stage[(u + 1) % kBufs][t + m * kRows];
        const float4* src = f8 + 2 * ((long long)id1[m] * kSub + lane);
        sph::cp_async16(&dst[0], src);
        sph::cp_async16(&dst[1], src + 1);
      }
    }
    sph::cp_async_commit();
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int slot2 = k0 + 2 * kTileSlots + g + m * kWarps;
      id2[m] = slot2 < n ? list[slot2] : 0;
    }
    sph::cp_async_wait_prior();
    float4 (*cur)[3] = stage[u % kBufs];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int p = t + m * kRows;  // particle `lane` of slot g + m * kWarps
      // a dead slot's runs get an empty box at infinity: always culled
      float3 lo = make_float3(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
      if (k0 + g + m * kWarps < n) {
        lo = stage_layout<kMxu>(cur[p], id0[m] * kSub + lane, k.visc);
      }
      float3 hi = lo;
      sph::box_reduce<kRun>(lo, hi);
      if ((lane & (kRun - 1)) == 0) {
        run_box[u & 1][p / kRun][0] =
            make_float4(lo.x, lo.y, lo.z, kMxu ? sph::box_norm2(lo, hi) : 0.f);
        run_box[u & 1][p / kRun][1] = make_float4(hi.x, hi.y, hi.z, 0.f);
      }
    }
    __syncthreads();
    // bit r: run r of the tile may hold a pair of this subgroup inside
    // the support (lane l tests run l % 16)
    const int r = lane & (kTileRuns - 1);
    const float4 rlo = run_box[u & 1][r][0];
    const float reach = kMxu ? reach2 + sph::kIdErr * (qnorm + rlo.w) : reach2;
    const unsigned runs =
        __ballot_sync(0xffffffffu,
                      sph::box_gap2(qlo, qhi, rlo, run_box[u & 1][r][1]) < reach) &
        ((1u << kTileRuns) - 1u);
    if (runs) sph::force_round<true, kMxu>(k, qa, qv, (int)i, cur, runs, s, idq);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      id0[m] = id1[m];
      id1[m] = id2[m];
    }
  }
  write_accel<kRows>(s, k, density, real, i, accel);
}

template <int kRows, bool kMxu>
int launch_rows(const void* f8, const void* density, const void* real,
                const void* cand, const void* count, const void* qblock, int nq,
                int cap, const sph::ForceConsts& k, void* accel, void* stream) {
  if (nq > 0) {
    forces_rows_c32_kernel<kRows, kMxu><<<nq, kRows, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const int*)cand, (const int*)count, (const int*)qblock, cap, k,
        (float*)accel);
  }
  return (int)cudaGetLastError();
}

template <bool kMxu>
int launch_any_rows(const void* f8, const void* density, const void* real,
                    const void* cand, const void* count, const void* qblock, int nq,
                    int cap, int rows, const sph::ForceConsts& k, void* accel,
                    void* stream) {
  if (rows == kBlock) {
    return launch_rows<kBlock, kMxu>(f8, density, real, cand, count, qblock, nq, cap, k,
                                     accel, stream);
  }
  if (rows == 64) {
    return launch_rows<64, kMxu>(f8, density, real, cand, count, qblock, nq, cap, k,
                                 accel, stream);
  }
  if (rows == 32) {
    return launch_rows<32, kMxu>(f8, density, real, cand, count, qblock, nq, cap, k,
                                 accel, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point: launches one block per list row (nq of them) on
// ``stream``, allocates nothing, and returns cudaGetLastError() (0 on
// success). ``qblock`` may be null.
extern "C" int forces_c32_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  return launch_any_rows<false>(f8, density, real, cand, count, qblock, nq, cap, kBlock,
                              k, accel, stream);
}

// Plain C entry point of the finer query blocks: ``rows`` (32 or 64) is
// the queries a list row serves (qb*rows .. qb*rows + rows-1, written at
// row b*rows + t); one block of ``rows`` threads per list row; otherwise
// as forces_c32_launch (cudaErrorInvalidValue for another ``rows``).
extern "C" int forces_c32_rows_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, int rows, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  if (rows == kBlock) return (int)cudaErrorInvalidValue;
  return launch_any_rows<false>(f8, density, real, cand, count, qblock, nq, cap, rows,
                              k, accel, stream);
}

// The identity mode's entry points, as the two above (``f8`` centred on
// the domain).
extern "C" int forces_c32_mxu_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  return launch_any_rows<true>(f8, density, real, cand, count, qblock, nq, cap, kBlock,
                              k, accel, stream);
}

extern "C" int forces_c32_rows_mxu_launch(
    const void* f8, const void* density, const void* real, const void* cand,
    const void* count, const void* qblock, int nq, int cap, int rows, float h,
    float h2, float eps2, float spiky, float visc, float pgrad, float lap7,
    float lap4, float mu, float st_threshold, float sigma, float gx, float gy,
    float gz, void* accel, void* stream) {
  const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                           lap4, mu, st_threshold, sigma, gx,    gy,   gz};
  if (rows == kBlock) return (int)cudaErrorInvalidValue;
  return launch_any_rows<true>(f8, density, real, cand, count, qblock, nq, cap, rows,
                              k, accel, stream);
}
