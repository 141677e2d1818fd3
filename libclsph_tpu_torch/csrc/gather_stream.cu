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
// Design: a warp takes 32 consecutive records a round, whole slots of
// ``sub`` records (a slot is a warp, half of one or a quarter), in a
// grid-stride loop over the rounds. The first lane of each slot reads the
// slot's id and count and decides its liveness once, a 32-bit division
// for the row, and hands them to the slot's lanes by a shuffle. Lane l
// reads particle l of its slot (two 16-byte loads, neighbouring lanes on
// neighbouring particles). Staged: the warp writes its 32 records to a
// 1.5 KB patch of shared memory (48-byte stride, no bank conflict) and
// stores the patch, contiguous in the stream, with lane-contiguous
// 16-byte streaming stores (three 512-byte warp stores). Planes: one
// 4-byte store a field, coalesced across the warp.

#include <math_constants.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 10;
constexpr long long kMaxBlocks = 1 << 20;

template <bool kPlaneLayout>
__global__ void __launch_bounds__(kThreads)
gather_stream_kernel(const float4* __restrict__ f8, const int* __restrict__ cand,
                     const int* __restrict__ count, long long records, int cap,
                     int sub_shift, int nsub, float visc, void* __restrict__ out) {
  __shared__ float4 patch[kWarps][32 * 3];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int sub = 1 << sub_shift;
  const int leader = lane & ~(sub - 1);  // the slot's first lane
  const long long rounds = (records + 31) / 32;
  for (long long r = (long long)blockIdx.x * kWarps + w; r < rounds;
       r += (long long)gridDim.x * kWarps) {
    const long long e = r * 32 + lane;
    int id = -1;
    int live = 0;
    if (lane == leader && e < records) {
      const int slot = (int)(e >> sub_shift);  // row * cap + k
      const int row = slot / cap;
      id = cand[slot];
      live = slot - row * cap < count[row] && id >= 0 && id < nsub;
    }
    id = __shfl_sync(0xffffffffu, id, leader);
    live = __shfl_sync(0xffffffffu, live, leader);
    float4 p = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, __int_as_float(-1));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ms = v;
    if (live) {
      const long long j = (long long)id * sub + (lane & (sub - 1));
      const float4 a = f8[2 * j];      // x y z vx
      const float4 b = f8[2 * j + 1];  // vy vz pm mr
      p = make_float4(a.x, a.y, a.z, __int_as_float((int)j));
      v = make_float4(a.w, b.x, b.y, b.z);
      ms = make_float4(b.w, __fmul_rn(visc, b.w), 0.f, 0.f);
    }
    if constexpr (kPlaneLayout) {
      if (e < records) {
        float* planes = static_cast<float*>(out);
        const float f[kPlanes] = {p.x, p.y, p.z, p.w, v.x, v.y, v.z, v.w, ms.x, ms.y};
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) planes[q * records + e] = f[q];
      }
    } else {
      float4* mine = patch[w];
      mine[3 * lane] = p;
      mine[3 * lane + 1] = v;
      mine[3 * lane + 2] = ms;
      __syncwarp();
      float4* dst = static_cast<float4*>(out) + 3 * (r * 32);
      const long long left = 3 * (records - r * 32);  // float4s of this round in the stream
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int q = c * 32 + lane;
        if (q < left) __stcs(dst + q, mine[q]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C entry point: gathers the ``rows`` x ``cap`` slots of ``cand``
// (int32, dead after ``count``) at ``sub`` particles a slot from the f8
// pack of ``np`` particles into ``out`` (staged: rows*cap*sub*3 float4;
// ``planes`` != 0: 10 planes of rows*cap*sub floats) on ``stream``;
// allocates nothing and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a ``sub`` other than 8, 16 or 32, or for
// rows * cap slots past the int32 range).
extern "C" int gather_stream_launch(const void* f8, const void* cand, const void* count,
                                    int rows, int cap, int sub, int planes, int np,
                                    float visc, void* out, void* stream) {
  if (sub != 8 && sub != 16 && sub != 32) return (int)cudaErrorInvalidValue;
  if ((long long)rows * cap > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int sub_shift = sub == 8 ? 3 : sub == 16 ? 4 : 5;
  const long long records = (long long)rows * cap * sub;
  if (records > 0) {
    long long blocks = ((records + 31) / 32 + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    decltype(&gather_stream_kernel<false>) kernel = gather_stream_kernel<false>;
    if (planes) kernel = gather_stream_kernel<true>;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)f8, (const int*)cand, (const int*)count, records, cap, sub_shift,
        np / sub, visc, out);
  }
  return (int)cudaGetLastError();
}
