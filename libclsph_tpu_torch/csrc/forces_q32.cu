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
// What bounds it on an H100: fp32 pair arithmetic (about 45 operations
// and one reciprocal square root per pair inside the support) and the
// gathered candidate loads, 32 bytes a particle (32 MB at 1M, in L2).
// Wider runs admit more pairs outside the support; those cost the r^2
// test only.
//
// Design: one thread block per list row block, warp g = query subgroup g
// walking its own hit list. Lists differ in length, so the loop has no
// __syncthreads: each warp stages the next 32 candidates (32/kSub runs,
// one particle a lane, two 16-byte loads) in its own slice of shared
// memory behind __syncwarp, then every lane reads them as broadcasts
// (three shared loads a candidate; broadcasting the nine fields with
// __shfl_sync instead measured 0.75 ms against 0.59 ms on the 1M
// lattice's 8-wide tables, H100 SXM at 700 W). Self-exclusion compares
// int32 particle ids (cand * kSub + lane), so there is no float-id range
// limit, and a table of exchanged ids needs no second kernel.

#include "sph_pair.cuh"

namespace {

using sph::kBlock;
constexpr int kWarps = kBlock / 32;

template <int kSub>
__global__ void __launch_bounds__(kBlock)
forces_q32_kernel(const float4* __restrict__ f8,
                  const float* __restrict__ density,
                  const unsigned char* __restrict__ real,
                  const int* __restrict__ cand, const int* __restrict__ count,
                  const int* __restrict__ qblock, int cap, sph::ForceConsts k,
                  float* __restrict__ accel) {
  __shared__ float4 stage[kWarps][32][2];
  __shared__ int stage_id[kWarps][32];
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

  sph::ForceSums s;
  for (int k0 = 0; k0 < n; k0 += 32 / kSub) {
    const int slot = k0 + lane / kSub;
    long long jid = -1;
    float4 ca = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cb = ca;
    if (slot < n) {
      jid = (long long)list[slot] * kSub + (lane % kSub);
      ca = f8[2 * jid];
      cb = f8[2 * jid + 1];
    }
    __syncwarp();
    stage[g][lane][0] = ca;
    stage[g][lane][1] = cb;
    stage_id[g][lane] = (int)jid;
    __syncwarp();
    const int m = min(32, (n - k0) * kSub);
    for (int c = 0; c < m; ++c) {
      s.add(k, qa, qv, (int)i, stage[g][c][0], stage[g][c][1], stage_id[g][c]);
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
  decltype(&forces_q32_kernel<8>) kernel;
  if (sub == 8) {
    kernel = forces_q32_kernel<8>;
  } else if (sub == 16) {
    kernel = forces_q32_kernel<16>;
  } else if (sub == 32) {
    kernel = forces_q32_kernel<32>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    const sph::ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                             lap4, mu, st_threshold, sigma, gx,    gy,   gz};
    kernel<<<nq, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const int*)cand, (const int*)count, (const int*)qblock, cap, k,
        (float*)accel);
  }
  return (int)cudaGetLastError();
}
