// forces_c32 — SPH internal forces over 32-particle candidate lists
// shared by a whole 128-row query block, with the force combine fused
// into the epilogue (forces_q128_c32).
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py fused_forces_nl
// (kernel _forces_kernel, pair sums neighbor.py _forces_core_rowout) with
// _combine_forces fused in. One list per 128-row query block, lists
// (nq, cap). For list row b the queries are i = qb*128 + t with
// qb = qblock[b] (b without a map); the candidates are
// j = cand[b, k]*32 + l, k < count[b], l < 32, in the full f8 pack. The
// sums and the combine are those of forces_q32.cu (csrc/sph_pair.cuh);
// a_i is written at row b*128 + t. Self-exclusion compares global int32
// ids, so gathered query blocks (the two-tier path) exclude the right
// pair.
//
// What bounds it on an H100: fp32 pair arithmetic (about 45 operations
// and one reciprocal square root per pair inside the support). A list
// of the whole block admits more pairs outside the support than the
// per-subgroup lists of forces_q32, and those cost the r^2 test only.
//
// Design: one thread block of 128 threads (one query each) per list row.
// The block stages the list's candidates in shared memory 128 at a time
// (four subblocks), one particle a thread (two 16-byte loads), behind
// __syncthreads, and every thread then reads them as broadcasts.

#include "sph_pair.cuh"

namespace {

using sph::kBlock;
constexpr int kSub = 32;  // particles per candidate subblock

__global__ void __launch_bounds__(kBlock)
forces_q128_c32_kernel(const float4* __restrict__ f8,
                       const float* __restrict__ density,
                       const unsigned char* __restrict__ real,
                       const int* __restrict__ cand, const int* __restrict__ count,
                       const int* __restrict__ qblock, int cap, sph::ForceConsts k,
                       float* __restrict__ accel) {
  __shared__ float4 stage[kBlock][2];
  __shared__ int stage_id[kBlock];
  const int t = threadIdx.x;
  const long long qb = qblock ? qblock[blockIdx.x] : blockIdx.x;
  const long long i = qb * kBlock + t;
  const float4 qa = f8[2 * i];      // x y z vx
  const float4 qv = f8[2 * i + 1];  // vy vz pm mr
  const int n = count[blockIdx.x];
  const int* list = cand + (long long)blockIdx.x * cap;

  sph::ForceSums s;
  for (int k0 = 0; k0 < n; k0 += kBlock / kSub) {
    const int slot = k0 + t / kSub;
    long long jid = -1;
    float4 ca = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cb = ca;
    if (slot < n) {
      jid = (long long)list[slot] * kSub + (t % kSub);
      ca = f8[2 * jid];
      cb = f8[2 * jid + 1];
    }
    __syncthreads();
    stage[t][0] = ca;
    stage[t][1] = cb;
    stage_id[t] = (int)jid;
    __syncthreads();
    const int m = min(kBlock, (n - k0) * kSub);
    for (int c = 0; c < m; ++c) {
      s.add(k, qa, qv, (int)i, stage[c][0], stage[c][1], stage_id[c]);
    }
  }

  float a[3] = {0.f, 0.f, 0.f};
  if (real[i]) s.combine(k, density[i], a);
  const long long o = (long long)blockIdx.x * kBlock + t;
  accel[3 * o] = a[0];
  accel[3 * o + 1] = a[1];
  accel[3 * o + 2] = a[2];
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
  if (nq > 0) {
    const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                             lap4, mu, st_threshold, sigma, gx,    gy,   gz};
    forces_q128_c32_kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const int*)cand, (const int*)count, (const int*)qblock, cap, k,
        (float*)accel);
  }
  return (int)cudaGetLastError();
}
