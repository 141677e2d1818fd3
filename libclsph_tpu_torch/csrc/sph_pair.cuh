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
// They spell out each fused multiply-add, so every kernel that includes
// them rounds alike, whatever the compiler would contract where it
// inlines them (left to it, |N|^2 came out as fma(nx, nx, ny*ny) in one
// kernel and fma(ny, ny, nx*nx) in another).
//
// The identity mode (StepConfig.pair_r2 = "mxu"; the JAX kernels'
// r2_mxu, neighbor.py _r2_mxu) takes r^2 = |q|^2 + |c|^2 - 2 q.c on
// coordinates centred on the domain, as pair_r2_id: the K = 5 dot
// [-2q, |q|^2, 1] . [c, 1, |c|^2] summed term by term in that order,
// each product and sum rounded once, clamped at 0 by fmaxf (a NaN, from
// two rows at the 1e32 sentinel, becomes 0). The plain PyTorch versions
// (ops/kernels/density.py pair_r2_identity) take the same steps, so the
// mode's decisions equal theirs too. Against the exact r^2 its error is
// below 12 u (|q|^2 + |c|^2), u = 2^-24: 3 u from the two norms, u from
// the three products, 8 u from the four sums (each partial is below
// 2 (|q|^2 + |c|^2)). The box culls add more than twice that to their
// reach: kIdErr (|q|^2 + |c|^2), kIdErr = 2^-19 (stage_cull.cuh).

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

// |p|^2 as (x*x + y*y) + z*z, each product and sum rounded once.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// A query of the identity mode: -2q (exact) and |q|^2.
struct IdQuery {
  float mx = 0.f, my = 0.f, mz = 0.f, n = 0.f;
};

__device__ __forceinline__ IdQuery id_query(float x, float y, float z) {
  IdQuery q;
  q.mx = __fmul_rn(-2.f, x);
  q.my = __fmul_rn(-2.f, y);
  q.mz = __fmul_rn(-2.f, z);
  q.n = norm2(x, y, z);
  return q;
}

// r^2 of the identity mode against candidate (cx, cy, cz) with
// cn = norm2(cx, cy, cz).
__device__ __forceinline__ float pair_r2_id(const IdQuery& q, float cx, float cy,
                                            float cz, float cn) {
  float s = __fmul_rn(q.mx, cx);
  s = __fadd_rn(s, __fmul_rn(q.my, cy));
  s = __fadd_rn(s, __fmul_rn(q.mz, cz));
  s = __fadd_rn(s, q.n);
  s = __fadd_rn(s, cn);
  return fmaxf(s, 0.f);
}

// The MUFU reciprocal square root of a normal float, the value rsqrtf
// returns there, without rsqrtf's scaling of subnormal inputs (the force
// sums take it only for r^2 >= eps^2, a normal float).
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
      add_inside(k, qa, qb, qi, dx, dy, dz, r2, a.w, b.x, b.y, b.z, b.w,
                 k.visc * b.w, cj);
    }
  }

  // The terms of one pair inside the support (r2 < h^2): d = x_i - x_j,
  // the candidate's velocity (cvx, cvy, cvz), pm, mr and vmr = visc * mr
  // (the same product wherever it is formed, so forces_q32's staged
  // factor and add()'s give the same bits). kMxu: r2 is the identity
  // mode's, and a pair of equal ids adds no pressure term (its r2 need
  // not be 0 there, so the r -> 0 guard would not zero it; neighbor_nl.py
  // _forces_pair_q32's gid test).
  template <bool kMxu = false>
  __device__ __forceinline__ void add_inside(const ForceConsts& k, float4 qa,
                                             float4 qb, int qi, float dx,
                                             float dy, float dz, float r2,
                                             float cvx, float cvy, float cvz,
                                             float pm, float mr, float vmr,
                                             int cj) {
    const bool near0 = r2 < k.eps2;
    const float inv_r = near0 ? 0.f : rsqrt_normal(r2);
    const float hr = fmaxf(__fmaf_rn(-r2, inv_r, k.h), 0.f);  // h - r
    const float tt = fmaxf(k.h2 - r2, 0.f);
    const float bv = vmr * hr;
    const float u = mr * tt;
    float pc = pm + qb.z;
    if (kMxu && cj == qi) pc = 0.f;
    const float as = pc * ((k.spiky * (hr * hr)) * inv_r);
    const float gg = (k.pgrad * u) * tt;
    px = __fmaf_rn(as, dx, px);
    py = __fmaf_rn(as, dy, py);
    pz = __fmaf_rn(as, dz, pz);
    vx = __fmaf_rn(bv, cvx - qa.w, vx);
    vy = __fmaf_rn(bv, cvy - qb.x, vy);
    vz = __fmaf_rn(bv, cvz - qb.y, vz);
    nx = __fmaf_rn(gg, dx, nx);
    ny = __fmaf_rn(gg, dy, ny);
    nz = __fmaf_rn(gg, dz, nz);
    lap += __fmaf_rn(k.lap7, gg, -(k.lap4 * u));
    if (near0 && cj != qi) sing = __fmaf_rn(pc, k.spiky, sing);
  }

  // a = (-rho P + mu V + ST) / rho + g, rho guarded to 1 where it is 0;
  // ST = -sigma L N / |N| above the threshold (_combine_forces).
  __device__ __forceinline__ void combine(const ForceConsts& k, float rho,
                                          float* out) const {
    rho = rho > 0.f ? rho : 1.f;
    float tx = __fmaf_rn(vx, k.mu, -rho * (px + sing));
    float ty = __fmaf_rn(vy, k.mu, -rho * (py + sing));
    float tz = __fmaf_rn(vz, k.mu, -rho * (pz + sing));
    const float nlen = sqrtf(__fmaf_rn(nz, nz, __fmaf_rn(ny, ny, nx * nx)));
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
