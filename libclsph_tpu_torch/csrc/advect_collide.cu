// advect_collide — the substep's advection, mesh collision response and
// next time step, one launch an advance: for each particle the leapfrog
// update, the signed-distance-field response and the half-step velocity
// reconstruction, and over all of them the two maxima and the adaptive dt.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses it. On the card it replaces the plain PyTorch chain of
// ops/integrate.py (advect, reconstruct_velocities, compute_time_step)
// and ops/collisions.py (handle_collisions), about 280 elementwise,
// gather and reduction launches an advance (engine/step.py's ``advect``
// stage), and gives the same bits:
//   v+ = v_inter + a dt, x+ = x + v+ dt (advection.cl:6-18);
//   the last face box that holds x+ (collisionsv2.cl:253-261), its DF
//   cell clipped to [0, size-2], the trilinear distance d, the normal from
//   the cell's faces, and below CONTACT_DISTANCE the restitution response
//   (collisionsv2.cl:9-22, 249-336, speed floored at 1e-12);
//   v = (v_inter + v+) / 2, the new intermediate velocity v+;
//   dt_next = (sqrt(2 a_max h + v_max^2) - v_max) / (2 a_max), a_max
//   floored at 1e-12, clamped to [dt_min, dt_max] (computeTimeStep), from
//   max |v|^2 and max |a|^2 over all particles, NaN winning as in
//   torch.amax.
// Every float operation is the plain chain's, rounded where it rounds:
// explicit round-to-nearest intrinsics, so that nvcc contracts no
// multiply-add. A 3-vector's sum or norm adds its terms as PyTorch's
// reduction over a row of three does on the card, (t0 + t2) + t1.
//
// What bounds it on an H100: bytes. Each particle reads 36 bytes
// (x, v_inter, a) and one 32-byte corner row where it lies in a face box,
// and writes 36 (x, v, v_inter): at 1M about 0.03 ms at 3.35 TB/s.
//
// Design: one thread a particle, 256 a block. The face boxes are staged
// in shared memory in chunks of kFaceChunk from the highest index down,
// and each thread scans them downwards and stops at the first box that
// holds it, so the last holding face costs what the scene's box count
// costs and a block leaves the scan once all its particles have a face.
// The time step: each block reduces its maxima as unsigned bits (squares
// are never negative, and a NaN is given the largest bits, so it wins),
// thread 0 adds them with atomicMax to a 3-word device scratch and takes
// a ticket; the block that takes the last ticket reads and clears the
// scratch and writes dt_next, so dt never leaves the device.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFaceChunk = 512;  // face boxes staged at a time (12 KB)
constexpr float kContact = 0.02f;  // CONTACT_DISTANCE (collisionsv2.cl:294)
constexpr float kTiny = 1e-12f;  // the speed and a_max floors
constexpr unsigned kNaNBits = 0x7fffffffu;  // above every finite or infinite square

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.sum over a row of three on the card: (t0 + t2) + t1
__device__ __forceinline__ float sum3(float t0, float t1, float t2) {
  return add(add(t0, t2), t1);
}

__device__ __forceinline__ float sq3(const float* v) {
  return sum3(mul(v[0], v[0]), mul(v[1], v[1]), mul(v[2], v[2]));
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// weigthedAverage (collisionsv2.cl:140-142)
__device__ __forceinline__ float wavg(float xq, float x1, float x2, float f1, float f2) {
  const float w = sub(x2, x1);
  return add(mul(dvd(sub(x2, xq), w), f1), mul(dvd(sub(xq, x1), w), f2));
}

__device__ __forceinline__ float bilerp(float xq, float yq, float xmin, float ymin,
                                        float xmax, float ymax, float f00, float f01,
                                        float f10, float f11) {
  return wavg(yq, ymin, ymax, wavg(xq, xmin, xmax, f00, f10),
              wavg(xq, xmin, xmax, f01, f11));
}

__device__ __forceinline__ unsigned max_key(float sq) {
  return isnan(sq) ? kNaNBits : __float_as_uint(sq);
}

// The response of a particle at p with velocity nv in face f's box
// (collisionsv2.cl:262-336); p and nv are updated where it collides.
__device__ __forceinline__ void respond(float* p, float* nv, int f, float dt,
                                        float restitution,
                                        const float* __restrict__ bb_min,
                                        const float* __restrict__ bb_max,
                                        const int* __restrict__ bb_size,
                                        const int* __restrict__ bb_offset,
                                        const float* __restrict__ corner8) {
  float lo[3], side[3], base[3];
  int size[3], cell[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = __ldg(bb_min + 3 * f + k);
    size[k] = __ldg(bb_size + 3 * f + k);
    side[k] = dvd(sub(__ldg(bb_max + 3 * f + k), lo[k]),
                  fmaxf(sub((float)size[k], 1.f), 1.f));
    // toward zero, as .to(torch.int32); then clipped to [0, size - 2]
    cell[k] = min(max(__float2int_rz(dvd(sub(p[k], lo[k]), side[k])), 0), size[k] - 2);
    base[k] = add(mul((float)cell[k], side[k]), lo[k]);
  }
  const int sx = size[0], sz = size[2];
  const int idx0 = __ldg(bb_offset + f) + cell[1] * sx * sz + sx * cell[2] + cell[0];
  const float4* row = reinterpret_cast<const float4*>(corner8 + 8ll * idx0);
  const float4 c0 = __ldg(row), c1 = __ldg(row + 1);
  const float d000 = c0.x, d001 = c0.y, d010 = c0.z, d011 = c0.w;
  const float d100 = c1.x, d101 = c1.y, d110 = c1.z, d111 = c1.w;
  const float bx = base[0], by = base[1], bz = base[2];
  const float ex = add(bx, side[0]), ey = add(by, side[1]), ez = add(bz, side[2]);
  const float px = p[0], py = p[1], pz = p[2];

  const float facedown = bilerp(px, pz, bx, bz, ex, ez, d000, d001, d100, d101);
  const float faceup = bilerp(px, pz, bx, bz, ex, ez, d010, d011, d110, d111);
  const float d = wavg(py, by, ey, facedown, faceup);
  if (!(d < kContact)) return;

  const float faceright = bilerp(py, pz, by, bz, ey, ez, d100, d101, d110, d111);
  const float faceleft = bilerp(py, pz, by, bz, ey, ez, d000, d001, d010, d011);
  const float faceback = bilerp(px, py, bx, by, ex, ey, d000, d010, d100, d110);
  const float facefront = bilerp(px, py, bx, by, ex, ey, d001, d011, d101, d111);
  float nrm[3] = {sub(faceright, faceleft), sub(faceup, facedown), sub(facefront, faceback)};
  const float nlen = __fsqrt_rn(sq3(nrm));
  const float den = nlen > 0.f ? nlen : 1.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) nrm[k] = dvd(nrm[k], den);

  const float absd = fabsf(d);
  const float speed = __fsqrt_rn(sq3(nv));
  const float coef = add(dvd(mul(absd, restitution), mul(dt, clamp_min(speed, kTiny))), 1.f);
  const float cv = mul(coef, sum3(mul(nv[0], nrm[0]), mul(nv[1], nrm[1]), mul(nv[2], nrm[2])));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = add(p[k], mul(absd, nrm[k]));
    nv[k] = sub(nv[k], mul(cv, nrm[k]));
  }
}

template <bool kScene, bool kTimeStep>
__global__ void __launch_bounds__(kThreads)
advect_collide_kernel(const float* __restrict__ x, const float* __restrict__ vi,
                      const float* __restrict__ acc, const float* __restrict__ dt_in, int n,
                      const float* __restrict__ bb_min, const float* __restrict__ bb_max,
                      const int* __restrict__ bb_size, const int* __restrict__ bb_offset,
                      const float* __restrict__ corner8, int faces, float restitution,
                      float h, float dt_min, float dt_max, float* __restrict__ x_out,
                      float* __restrict__ v_out, float* __restrict__ vi_out,
                      float* __restrict__ dt_out, unsigned* __restrict__ scratch) {
  extern __shared__ float boxes[];  // a chunk's box minima, then its maxima
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float dt = __ldg(dt_in);
  float p[3] = {0.f, 0.f, 0.f}, w[3] = {0.f, 0.f, 0.f}, a[3] = {0.f, 0.f, 0.f}, nv[3];
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = __ldg(x + 3ll * i + k);
      w[k] = __ldg(vi + 3ll * i + k);
      a[k] = __ldg(acc + 3ll * i + k);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nv[k] = add(w[k], mul(a[k], dt));
    p[k] = add(p[k], mul(nv[k], dt));
  }

  if constexpr (kScene) {
    // the last face box holding p: chunks from the top, each scanned down
    const int chunk = min(faces, kFaceChunk);
    float* hi_s = boxes + 3 * chunk;
    int face = -1;
    for (int top = faces; top > 0; top -= chunk) {
      const int first = max(top - chunk, 0);
      const int m = top - first;
      __syncthreads();  // the previous chunk's reads are done
      for (int j = threadIdx.x; j < 3 * m; j += kThreads) {
        boxes[j] = __ldg(bb_min + 3 * first + j);
        hi_s[j] = __ldg(bb_max + 3 * first + j);
      }
      __syncthreads();
      if (live && face < 0) {
        for (int f = m - 1; f >= 0; --f) {
          const float* lo = boxes + 3 * f;
          const float* hi = hi_s + 3 * f;
          if (p[0] <= hi[0] && p[0] >= lo[0] && p[1] <= hi[1] && p[1] >= lo[1] &&
              p[2] <= hi[2] && p[2] >= lo[2]) {
            face = first + f;
            break;
          }
        }
      }
      if (__syncthreads_and(face >= 0 || !live)) break;
    }
    if (face >= 0) {
      respond(p, nv, face, dt, restitution, bb_min, bb_max, bb_size, bb_offset, corner8);
    }
  }

  float v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = mul(add(w[k], nv[k]), 0.5f);
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x_out[3ll * i + k] = p[k];
      v_out[3ll * i + k] = v[k];
      vi_out[3ll * i + k] = nv[k];
    }
  }

  if constexpr (kTimeStep) {
    __shared__ unsigned warp_v[kWarps], warp_a[kWarps];
    unsigned kv = live ? max_key(sq3(v)) : 0u;
    unsigned ka = live ? max_key(sq3(a)) : 0u;
    kv = __reduce_max_sync(0xffffffffu, kv);
    ka = __reduce_max_sync(0xffffffffu, ka);
    if ((threadIdx.x & 31) == 0) {
      warp_v[threadIdx.x >> 5] = kv;
      warp_a[threadIdx.x >> 5] = ka;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < kWarps; ++k) {
        kv = max(kv, warp_v[k]);
        ka = max(ka, warp_a[k]);
      }
      atomicMax(scratch, kv);
      atomicMax(scratch + 1, ka);
      __threadfence();
      if (atomicAdd(scratch + 2, 1u) == gridDim.x - 1) {  // the last block
        __threadfence();
        const float mv2 = __uint_as_float(atomicExch(scratch, 0u));
        const float ma2 = __uint_as_float(atomicExch(scratch + 1, 0u));
        atomicExch(scratch + 2, 0u);
        const float max_vel = __fsqrt_rn(mv2);
        const float two_a = mul(2.f, clamp_min(__fsqrt_rn(ma2), kTiny));
        float next = dvd(sub(__fsqrt_rn(add(mul(two_a, h), mv2)), max_vel), two_a);
        if (!isnan(next)) next = fminf(fmaxf(next, dt_min), dt_max);
        *dt_out = next;
      }
    }
  }
}

template <bool kScene, bool kTimeStep>
cudaError_t launch(int blocks, size_t smem, cudaStream_t s, const float* x, const float* vi,
                   const float* acc, const float* dt, int n, const float* bb_min,
                   const float* bb_max, const int* bb_size, const int* bb_offset,
                   const float* corner8, int faces, float restitution, float h,
                   float dt_min, float dt_max, float* x_out, float* v_out, float* vi_out,
                   float* dt_out, unsigned* scratch) {
  advect_collide_kernel<kScene, kTimeStep><<<blocks, kThreads, smem, s>>>(
      x, vi, acc, dt, n, bb_min, bb_max, bb_size, bb_offset, corner8, faces, restitution,
      h, dt_min, dt_max, x_out, v_out, vi_out, dt_out, scratch);
  return cudaGetLastError();
}

}  // namespace

// x, vi, acc: (n, 3) float32; dt: one float32 on the device. faces 0: no
// scene (free flight), the scene pointers unused; else the scene's face
// boxes (faces, 3) float32, sizes (faces, 3) int32, offsets (faces,)
// int32 and corner table (G, 8) float32 (16-byte aligned). dt_out null:
// no time step (scratch unused); else dt_out one float32 and scratch 3
// unsigned words, zero before the launch and left zero by it. Outputs
// x_out, v_out, vi_out (n, 3) float32. Returns the launch's CUDA status.
extern "C" int advect_collide_launch(const void* x, const void* vi, const void* acc,
                                     const void* dt, int n, const void* bb_min,
                                     const void* bb_max, const void* bb_size,
                                     const void* bb_offset, const void* corner8, int faces,
                                     float restitution, float h, float dt_min, float dt_max,
                                     void* x_out, void* v_out, void* vi_out, void* dt_out,
                                     void* scratch, void* stream) {
  if (n < 0 || faces < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // at least one block, so that the time step is written
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  const size_t smem = faces > 0 ? sizeof(float) * 6 * (faces < kFaceChunk ? faces : kFaceChunk)
                                : 0;
  auto args = [&](auto fn) {
    return fn(blocks, smem, s, (const float*)x, (const float*)vi, (const float*)acc,
              (const float*)dt, n, (const float*)bb_min, (const float*)bb_max,
              (const int*)bb_size, (const int*)bb_offset, (const float*)corner8, faces,
              restitution, h, dt_min, dt_max, (float*)x_out, (float*)v_out, (float*)vi_out,
              (float*)dt_out, (unsigned*)scratch);
  };
  cudaError_t e;
  if (faces > 0) {
    e = dt_out ? args(launch<true, true>) : args(launch<true, false>);
  } else {
    e = dt_out ? args(launch<false, true>) : args(launch<false, false>);
  }
  return (int)e;
}
