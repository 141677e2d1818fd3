// gather_stream — the candidate stream of a list table, gathered ahead of
// the force sums: for every slot of every list row, the records of the
// slot's ``sub`` particles (sub 8, 16 or 32), in slot order.
//
// Replaces: the feed of libclsph_tpu/ops/pallas/neighbor_nl.py's force
// kernels, gather_raw (the row gather of pack rows ahead of the kernel)
// together with the in-kernel tile assembly _tile_from_raw (32-wide,
// 4x4 block transpose) and _tile_from_raw16 (16-wide, 8x8), the Pallas
// kernel of tests/test_nl_layout.py:52, and the pre-gathered streams of
// experiments/force_kernel_bisect.py and nl_kernel_variants.py.
//
// Record e = (row * cap + k) * sub + l is particle j = cand[row, k]*sub + l
// of slot k. Two layouts:
//   staged: three float4 a record, the record that forces_q32.cu and
//     forces_c32.cu stage in shared memory (force_walk.cuh):
//     (x, y, z, j as int bits), (vx, vy, vz, pm), (mr, visc * mr, 0, 0),
//     visc * mr one round-to-nearest multiply, as the kernels form it;
//   planes: the same ten fields as ten planes of rows * cap * sub floats,
//     x y z j vx vy vz pm mr visc*mr (the field-major tiles of the TPU
//     kernels, _tile_from_raw's output order but for the id).
// A dead slot (k >= count[row], or an id outside the pack, as the
// REFINE_SENTINEL 2^30 is) gets position +inf, id -1 and zeros: a
// position at infinity fails every support test and every box test.
//
// What bounds it on an H100: bytes. Each record reads its particle's 32
// bytes of the f8 pack (x y z vx | vy vz pm mr) and writes 48 (40 in
// planes); at 1M the stream passes 2^31 bytes, so every offset is 64-bit.
//
// Design: one thread a record, a grid-stride loop over the records;
// neighbouring threads read neighbouring particles of a slot (two 16-byte
// loads) and write neighbouring records (three 16-byte stores, or one
// 4-byte store a plane, coalesced across the warp).

#include <math_constants.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 10;
constexpr long long kMaxBlocks = 1 << 20;

template <bool kPlaneLayout>
__global__ void __launch_bounds__(kThreads)
gather_stream_kernel(const float4* __restrict__ f8, const int* __restrict__ cand,
                     const int* __restrict__ count, long long records, int cap, int sub,
                     int nsub, float visc, void* __restrict__ out) {
  const long long per_row = (long long)cap * sub;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < records;
       e += (long long)gridDim.x * kThreads) {
    const long long row = e / per_row;
    const int k = (int)((e - row * per_row) / sub);
    const int l = (int)(e % sub);
    const int id = cand[row * cap + k];
    const bool live = k < count[row] && id >= 0 && id < nsub;
    float4 p = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, __int_as_float(-1));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ms = v;
    if (live) {
      const long long j = (long long)id * sub + l;
      const float4 a = f8[2 * j];      // x y z vx
      const float4 b = f8[2 * j + 1];  // vy vz pm mr
      p = make_float4(a.x, a.y, a.z, __int_as_float((int)j));
      v = make_float4(a.w, b.x, b.y, b.z);
      ms = make_float4(b.w, __fmul_rn(visc, b.w), 0.f, 0.f);
    }
    if constexpr (kPlaneLayout) {
      float* planes = static_cast<float*>(out);
      const float f[kPlanes] = {p.x, p.y, p.z, p.w, v.x, v.y, v.z, v.w, ms.x, ms.y};
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) planes[q * records + e] = f[q];
    } else {
      float4* rec = static_cast<float4*>(out) + 3 * e;
      rec[0] = p;
      rec[1] = v;
      rec[2] = ms;
    }
  }
}

}  // namespace

// Plain C entry point: gathers the ``rows`` x ``cap`` slots of ``cand``
// (int32, dead after ``count``) at ``sub`` particles a slot from the f8
// pack of ``np`` particles into ``out`` (staged: rows*cap*sub*3 float4;
// ``planes`` != 0: 10 planes of rows*cap*sub floats) on ``stream``;
// allocates nothing and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a ``sub`` other than 8, 16 or 32).
extern "C" int gather_stream_launch(const void* f8, const void* cand, const void* count,
                                    int rows, int cap, int sub, int planes, int np,
                                    float visc, void* out, void* stream) {
  if (sub != 8 && sub != 16 && sub != 32) return (int)cudaErrorInvalidValue;
  const long long records = (long long)rows * cap * sub;
  if (records > 0) {
    long long blocks = (records + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    decltype(&gather_stream_kernel<false>) kernel = gather_stream_kernel<false>;
    if (planes) kernel = gather_stream_kernel<true>;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const int*)cand, (const int*)count, records, cap, sub,
        np / sub, visc, out);
  }
  return (int)cudaGetLastError();
}
