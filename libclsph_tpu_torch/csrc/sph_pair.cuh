// sph_pair.cuh — pair arithmetic shared by the port's density and force
// kernels (csrc/density_*.cu, csrc/forces_*.cu).
//
// Every kernel rounds r^2 as (dx*dx + dy*dy) + dz*dz without FMA
// contraction, so its r < h decisions (hit counts, the support cutoff)
// equal the plain PyTorch versions' exactly. The force pair terms and the
// epilogue are those of libclsph_tpu/ops/pallas/neighbor.py
// _forces_core_rowout and neighbor_nl.py _combine_forces, with the
// pressure sum taken directly as a_ij (x_i - x_j) (the x_i * sum(a) -
// sum(a x_j) form of the TPU kernels exists only for its matrix unit).

#pragma once

#include <cuda_runtime.h>

namespace sph {

constexpr int kBlock = 128;  // queries per Morton block

struct ForceConsts {
  float h, h2, eps2, spiky, visc, pgrad, lap7, lap4;
  float mu, st_threshold, sigma, gx, gy, gz;
};

__device__ __forceinline__ float pair_r2(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// sum + poly6 * real_j * max(h^2 - r^2, 0)^3 as one explicit fma, so two
// kernels that add the same pairs in the same order get the same bits
// (the gated density against the ungated one); a pair with r >= h adds
// exactly +0.
__device__ __forceinline__ float density_add(float sum, float r2, float h2,
                                             float poly6, float real) {
  const float tt = fmaxf(h2 - r2, 0.f);
  return __fmaf_rn(poly6 * real, (tt * tt) * tt, sum);
}

// Raw force sums of one query over its candidates (forces.cl:14-111).
struct ForceSums {
  float px = 0.f, py = 0.f, pz = 0.f;  // pressure
  float vx = 0.f, vy = 0.f, vz = 0.f;  // viscosity
  float nx = 0.f, ny = 0.f, nz = 0.f;  // colour-field normal
  float lap = 0.f;                     // colour-field laplacian
  float sing = 0.f;                    // spiky r -> 0 splat (distinct pairs)

  // Query (qa = x y z vx, qb = vy vz pm mr, global id qi) against
  // candidate (a, b, global id cj); f8 pack layout.
  __device__ __forceinline__ void add(const ForceConsts& k, float4 qa,
                                      float4 qb, int qi, float4 a, float4 b,
                                      int cj) {
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
      if (near0 && cj != qi) sing += pc * k.spiky;
    }
  }

  // a = (-rho P + mu V + ST) / rho + g, rho guarded to 1 where it is 0;
  // ST = -sigma L N / |N| above the threshold (_combine_forces).
  __device__ __forceinline__ void combine(const ForceConsts& k, float rho,
                                          float* out) const {
    rho = rho > 0.f ? rho : 1.f;
    float tx = -rho * (px + sing) + vx * k.mu;
    float ty = -rho * (py + sing) + vy * k.mu;
    float tz = -rho * (pz + sing) + vz * k.mu;
    const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
    if (nlen > k.st_threshold) {
      const float s = -k.sigma * lap;
      tx += (s * nx) / nlen;
      ty += (s * ny) / nlen;
      tz += (s * nz) / nlen;
    }
    out[0] = tx / rho + k.gx;
    out[1] = ty / rho + k.gy;
    out[2] = tz / rho + k.gz;
  }
};

}  // namespace sph
