// forces_stream — forces_q128_c32's sums over a candidate stream gathered
// beforehand (gather_stream.cu) instead of fetched by id from the f8 pack.
//
// Replaces: the Pallas kernels that sum fused_forces_nl's ten per-query
// sums (libclsph_tpu/ops/pallas/neighbor.py _forces_core_rowout,
// neighbor_nl.py:706-762) over a pre-gathered stream:
// experiments/force_kernel_bisect.py call_forces (its gather_raw stream of
// the hit-compacted q128 lists, with a zero-count control) and
// experiments/nl_kernel_variants.py forces_flat2d_tps, forces_tile3d,
// forces_flat2d_mxu and forces_flat2d_mxu2 (tile streams of the aabb
// lists). Their dot modes, MXU reductions and tile-step widths are TPU
// layout: here the sums are fp32 FMAs in the one order that
// sph::ForceSums::add_inside fixes.
//
// For list row b (queries i = b*128 + t; no query-block map) the
// candidates are the records (b*cap + k)*32 + l, k < min(count[b], cap),
// l < 32, of a 32-wide stream; the stream holds dead slots (position at
// +inf) where the table had them. Five modes, one template:
//   sums   (staged, cull): the ten raw sums of each query, (nq*128, 10)
//          float32: P + sing (x, y, z), V, N, L (sph_pair.cuh);
//   accel  (staged, cull): the combine fused in, (nq*128, 3); the same
//          pairs in the same order as forces_q128_c32 on the same lists,
//          so the same bits;
//   planes (planes layout, cull): as sums, fed from the ten planes;
//   nocull (staged, no cull): as sums, every staged candidate tested;
//   test   (staged, cull): the pair terms compiled out; each query writes
//          the int32 count of its staged candidates with r^2 - h^2 < 0
//          (r^2 without FMA); the cull drops no such pair, so the count
//          is the plain one.
//
// What bounds it on an H100: as forces_c32.cu, instruction issue on the
// pair tests and terms; the modes split that time into the feed (the
// fused kernel against sums), the support test (test against a
// zero-count launch) and the pair terms (sums against test). The stream
// itself is bytes: 48 a live candidate (40 in planes), read once.
//
// Design: forces_c32.cu's, at 128 rows: one thread block a list row,
// warp g = query subgroup g, one 128-candidate tile (4 slots) a round in
// three shared buffers, run boxes of 8 candidates by shuffles, a ballot
// cull, and sph::force_round (force_walk.cuh). Only the feed differs:
// thread t copies record t of the tile (slot t / 32, particle t % 32),
// which is contiguous in the stream, with cp.async (three 16-byte copies,
// or ten 4-byte copies from the planes) straight into the staged layout;
// a slot past the count is written at +inf after the wait instead.

#include <math_constants.h>

#include "force_walk.cuh"

namespace {

using sph::kBlock;
using sph::kRound;
using sph::kRun;
constexpr int kSub = 32;                   // particles a slot
constexpr int kTileSlots = kRound / kSub;  // slots a tile
constexpr int kTileRuns = kRound / kRun;   // culled runs a tile
constexpr int kBufs = 3;                   // staged tiles in shared memory
constexpr int kPlanes = 10;                // fields of the planes layout

enum Out { kSums = 0, kAccel = 1, kTest = 2 };

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Copy record e of the stream into staged slot ``dst``.
template <bool kPlaneLayout>
__device__ __forceinline__ void stage_record(float4* dst, const float* stream,
                                             long long e, long long plane) {
  if constexpr (kPlaneLayout) {
    float* d = &dst[0].x;
    // plane q -> float q of the staged record but for its two pad floats
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) cp_async4(d + q, stream + q * plane + e);
  } else {
    const float4* src = reinterpret_cast<const float4*>(stream) + 3 * e;
    sph::cp_async16(&dst[0], src);
    sph::cp_async16(&dst[1], src + 1);
    sph::cp_async16(&dst[2], src + 2);
  }
}

template <bool kPlaneLayout, bool kCull, int kOut>
__global__ void __launch_bounds__(kBlock)
forces_stream_kernel(const float4* __restrict__ f8, const float* __restrict__ density,
                     const unsigned char* __restrict__ real,
                     const float* __restrict__ stream, const int* __restrict__ count,
                     int cap, long long plane, sph::ForceConsts k, void* __restrict__ out) {
  __shared__ float4 stage[kBufs][kRound][3];
  __shared__ float4 run_box[2][kTileRuns][2];  // lo, hi of each run
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long i = (long long)blockIdx.x * kBlock + t;
  const float4 qa = f8[2 * i];      // x y z vx
  const float4 qv = f8[2 * i + 1];  // vy vz pm mr
  const int n = min(count[blockIdx.x], cap);
  // record t of tile u of this row: slot u*4 + g, particle lane
  const long long rec0 = (long long)blockIdx.x * cap * kSub + t;
  float3 qlo = make_float3(qa.x, qa.y, qa.z), qhi = qlo;  // the subgroup's box
  sph::box_reduce<32>(qlo, qhi);
  const float reach2 = k.h2 * sph::kBoxMargin;

  if (g < n) stage_record<kPlaneLayout>(stage[0][t], stream, rec0, plane);
  sph::cp_async_commit();

  sph::ForceSums s;
  int tested = 0;  // kTest: this query's staged candidates inside the support
  for (int k0 = 0, u = 0; k0 < n; k0 += kTileSlots, ++u) {
    if (k0 + kTileSlots + g < n) {
      stage_record<kPlaneLayout>(stage[(u + 1) % kBufs][t], stream,
                                 rec0 + (long long)(k0 + kTileSlots) * kSub, plane);
    }
    sph::cp_async_commit();
    sph::cp_async_wait_prior();
    float4 (*cur)[3] = stage[u % kBufs];
    const bool live = k0 + g < n;
    if (!live) {  // past the count: a dead candidate at infinity
      cur[t][0] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, __int_as_float(-1));
    }
    unsigned runs = (1u << kTileRuns) - 1u;
    if constexpr (kCull) {
      // a dead slot's runs get an empty box at infinity: always culled
      float3 lo = make_float3(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
      if (live) lo = make_float3(cur[t][0].x, cur[t][0].y, cur[t][0].z);
      float3 hi = lo;
      sph::box_reduce<kRun>(lo, hi);
      if ((lane & (kRun - 1)) == 0) {
        run_box[u & 1][t / kRun][0] = make_float4(lo.x, lo.y, lo.z, 0.f);
        run_box[u & 1][t / kRun][1] = make_float4(hi.x, hi.y, hi.z, 0.f);
      }
    }
    __syncthreads();
    if constexpr (kCull) {
      // bit r: run r of the tile may hold a pair of this subgroup inside
      // the support (lane l tests run l % 16)
      const int r = lane & (kTileRuns - 1);
      runs = __ballot_sync(0xffffffffu, sph::box_gap2(qlo, qhi, run_box[u & 1][r][0],
                                                      run_box[u & 1][r][1]) < reach2) &
             ((1u << kTileRuns) - 1u);
    }
    if constexpr (kOut == kTest) {
      unsigned hit[sph::kRoundWords];
      if (runs) tested += sph::round_hits<kCull>(k, qa, cur, runs, hit);
    } else {
      if (runs) sph::force_round<kCull>(k, qa, qv, (int)i, cur, runs, s);
    }
  }

  if constexpr (kOut == kTest) {
    static_cast<int*>(out)[i] = tested;
  } else if constexpr (kOut == kAccel) {
    float a[3] = {0.f, 0.f, 0.f};
    if (real[i]) s.combine(k, density[i], a);
    float* o = static_cast<float*>(out) + 3 * i;
    o[0] = a[0];
    o[1] = a[1];
    o[2] = a[2];
  } else {
    float* o = static_cast<float*>(out) + 10 * i;
    o[0] = s.px + s.sing;
    o[1] = s.py + s.sing;
    o[2] = s.pz + s.sing;
    o[3] = s.vx;
    o[4] = s.vy;
    o[5] = s.vz;
    o[6] = s.nx;
    o[7] = s.ny;
    o[8] = s.nz;
    o[9] = s.lap;
  }
}

}  // namespace

// Plain C entry point: ``mode`` 0 sums, 1 accel, 2 planes, 3 nocull, 4
// test (see above) over the 32-wide stream ``stream`` of nq list rows of
// ``cap`` slots (staged records, or 10 planes of nq*cap*32 floats in mode
// 2); ``f8`` the queries' pack, ``density`` and ``real`` read in mode 1
// only; ``out`` (nq*128, 10) float32, (nq*128, 3) float32 or (nq*128,)
// int32. One block per list row on ``stream_``; allocates nothing and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for
// another mode).
extern "C" int forces_stream_launch(
    const void* f8, const void* density, const void* real, const void* stream,
    const void* count, int nq, int cap, int mode, float h, float h2, float eps2,
    float spiky, float visc, float pgrad, float lap7, float lap4, float mu,
    float st_threshold, float sigma, float gx, float gy, float gz, void* out,
    void* stream_) {
  decltype(&forces_stream_kernel<false, true, kSums>) kernel;
  switch (mode) {
    case 0: kernel = forces_stream_kernel<false, true, kSums>; break;
    case 1: kernel = forces_stream_kernel<false, true, kAccel>; break;
    case 2: kernel = forces_stream_kernel<true, true, kSums>; break;
    case 3: kernel = forces_stream_kernel<false, false, kSums>; break;
    case 4: kernel = forces_stream_kernel<false, true, kTest>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                             lap4, mu, st_threshold, sigma, gx,    gy,   gz};
    kernel<<<nq, kBlock, 0, (cudaStream_t)stream_>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const float*)stream, (const int*)count, cap, (long long)nq * cap * kSub, k, out);
  }
  return (int)cudaGetLastError();
}
