// forces_q32_c8 — SPH internal forces over per-subgroup 8-particle
// hit lists, with the force combine fused into the epilogue.
//
// Replaces: libclsph_tpu/ops/pallas/neighbor_nl.py, fused_forces_nl32_c8
// (kernel _forces_kernel_q32x4_c8; pair sums _forces_pair_q32; finalize
// _forces_finalize_q32; combine _combine_forces).
//
// Computes, for query i in subgroup g of block b (list row b*4 + g),
// over the particles j = cand8[row, k]*8 + l, k < count8[row], l < 8:
//   P = sum a_ij (x_i - x_j) + sum_{j != i, r < eps} (pm_i + pm_j) spiky
//   V = sum visc mr_j (h - r) (v_j - v_i)
//   N = sum pgrad mr_j t^2 (x_i - x_j),   t = h^2 - r^2
//   L = sum (7 plap/pgrad g_ij - 4 h^2 plap mr_j t)
// with a_ij = (pm_i + pm_j) spiky (h - r)^2 / r, pm = m p / rho^2 and
// mr = m / rho (both 0 on padding particles), then
//   a_i = (-rho_i P + mu V + ST) / rho_i + gravity,
// ST = -sigma L N / |N| where |N| exceeds the threshold, rho guarded
// to 1 where it is 0, and a_i = 0 on padding rows.
//
// What bounds it on an H100: fp32 pair arithmetic (about 45 operations
// and one reciprocal square root per pair inside the support) and the
// gathered candidate loads, 32 bytes a particle (32 MB at 1M, in L2).
//
// Design: one thread block per query block, warp g = query subgroup g
// walking its own hit list. Lists differ in length, so the loop has no
// __syncthreads: each warp stages the next four 8-runs (32 particles,
// one particle a lane, two 16-byte loads) in its own slice of shared
// memory behind __syncwarp, then every lane reads them as broadcasts
// (three shared loads a candidate; broadcasting the nine fields with
// __shfl_sync instead measured 0.75 ms against 0.59 ms on the 1M
// lattice's tables, H100 SXM at 700 W). Sums are taken directly as a_ij (x_i - x_j); the x_i * sum(a) -
// sum(a x_j) form of the TPU kernel exists only for its matrix unit.
// Self-exclusion compares int32 particle ids (cand8 * 8 + lane), so
// there is no float-id range limit. r^2 is rounded without FMA
// contraction so the r < h decisions equal the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // queries per block (Morton block)
constexpr int kWarps = kBlock / 32;
constexpr int kSub = 8;      // particles per candidate run

struct ForceConsts {
  float h, h2, eps2, spiky, visc, pgrad, lap7, lap4;
  float mu, st_threshold, sigma, gx, gy, gz;
};

__global__ void __launch_bounds__(kBlock)
forces_q32_c8_kernel(const float4* __restrict__ f8,
                     const float* __restrict__ density,
                     const unsigned char* __restrict__ real,
                     const int* __restrict__ cand8,
                     const int* __restrict__ count8, int cap, ForceConsts k,
                     float* __restrict__ accel) {
  __shared__ float4 stage[kWarps][32][2];
  __shared__ int stage_id[kWarps][32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;
  const long long i = (long long)blockIdx.x * kBlock + t;
  const float4 qa = f8[2 * i];      // x y z vx
  const float4 qb = f8[2 * i + 1];  // vy vz pm mr
  const long long row = (long long)blockIdx.x * kWarps + g;
  const int n = count8[row];
  const int* list = cand8 + row * cap;

  float px = 0.f, py = 0.f, pz = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  float nx = 0.f, ny = 0.f, nz = 0.f, lap = 0.f, sing = 0.f;
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
      const float4 a = stage[g][c][0];
      const float4 b = stage[g][c][1];
      const float dx = qa.x - a.x;
      const float dy = qa.y - a.y;
      const float dz = qa.z - a.z;
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (r2 < k.h2) {
        const bool near0 = r2 < k.eps2;
        const float inv_r = near0 ? 0.f : rsqrtf(r2);
        const float r = r2 * inv_r;
        const float hr = fmaxf(k.h - r, 0.f);
        const float tt = fmaxf(k.h2 - r2, 0.f);
        const float mr = b.w;
        const float bv = (k.visc * mr) * hr;
        const float u = mr * tt;
        const float pc = b.z + qb.z;
        const float as = pc * ((k.spiky * (hr * hr)) * inv_r);
        const float gg = (k.pgrad * u) * tt;
        px += as * dx;
        py += as * dy;
        pz += as * dz;
        vx += bv * (a.w - qa.w);
        vy += bv * (b.x - qb.x);
        vz += bv * (b.y - qb.y);
        nx += gg * dx;
        ny += gg * dy;
        nz += gg * dz;
        lap += k.lap7 * gg - k.lap4 * u;
        if (near0 && stage_id[g][c] != (int)i) sing += pc * k.spiky;
      }
    }
  }

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (real[i]) {
    px += sing;
    py += sing;
    pz += sing;
    float rho = density[i];
    rho = rho > 0.f ? rho : 1.f;
    float tx = -rho * px + vx * k.mu;
    float ty = -rho * py + vy * k.mu;
    float tz = -rho * pz + vz * k.mu;
    const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
    if (nlen > k.st_threshold) {
      const float s = -k.sigma * lap;
      tx += (s * nx) / nlen;
      ty += (s * ny) / nlen;
      tz += (s * nz) / nlen;
    }
    ax = tx / rho + k.gx;
    ay = ty / rho + k.gy;
    az = tz / rho + k.gz;
  }
  accel[3 * i] = ax;
  accel[3 * i + 1] = ay;
  accel[3 * i + 2] = az;
}

}  // namespace

// Plain C entry point: launches on ``stream``, allocates nothing, and
// returns cudaGetLastError() (0 on success).
extern "C" int forces_q32_c8_launch(
    const void* f8, const void* density, const void* real, const void* cand8,
    const void* count8, int nb, int cap, float h, float h2, float eps2,
    float spiky, float visc, float pgrad, float lap7, float lap4, float mu,
    float st_threshold, float sigma, float gx, float gy, float gz,
    void* accel, void* stream) {
  if (nb > 0) {
    const ForceConsts k{h,  h2,           eps2,  spiky, visc, pgrad, lap7,
                        lap4, mu, st_threshold, sigma, gx,    gy,   gz};
    forces_q32_c8_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const float*)density, (const unsigned char*)real,
        (const int*)cand8, (const int*)count8, cap, k, (float*)accel);
  }
  return (int)cudaGetLastError();
}
