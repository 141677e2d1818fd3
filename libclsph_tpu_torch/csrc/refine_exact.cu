// refine_exact — the rebuild's exact refine of block candidate lists to
// subblock lists, one launch a rebuild: for each query row and each live
// slot of its block list, whether each subblock of the candidate block
// holds a particle within reach of one of the row's split boxes, written
// as the keys table that the row sort compacts.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA
// (libclsph_tpu/ops/tiles.py:509-628, refine_candidates_exact). On the
// card it replaces the plain path of ops/tiles.py (refine_exact_gather,
// refine_exact_test): a gathered (rows, M, B, 3) position stream, built
// in chunks, and about ten elementwise passes over it for each split box,
// some 320 launches a rebuild. It gives the same table, id for id:
//   deficit = clamp(max(lo - p, p - hi), 0, 1e6) on each axis (NaN
//   propagates, as torch.maximum and torch.clamp keep it);
//   d2 = (dx*dx + dy*dy) + dz*dz, each product and sum rounded, so that
//   nvcc contracts no multiply-add;
//   a particle is in reach iff d2 <= h2_cut for some box, h2_cut the
//   float32 of 1.01 h^2 formed on the host; a subblock survives iff one
//   of its particles is in reach.
// keys (nb_q, sub * M) int32, column s * M + k (subblock s of slot k,
// subblock-major as the plain path lays it): cand * sub + s where it
// survives, REFINE_SENTINEL for every other slot, k >= count included;
// counts (nb_q,) int32 the survivors of each row.
//
// What bounds it on an H100: neither bytes nor operations at the sizes the
// engine runs. The inputs that must cross device memory are the sorted
// positions (12 MB at 1M, which the 50 MB L2 holds), the lists and boxes,
// and the keys written (24 MB at 1M, 96 slots); the tests are about 12
// operations each, for each particle of each live slot and each box.
//
// Design: one block of kWarps warps a query row; the row's boxes sit in
// registers. The warps take the row's live slots in turn, and a warp
// reads its candidate block's B positions once, coalesced (a lane a
// particle, B / 32 of them a lane), from L2. The lanes that hold one
// subblock vote with a ballot, so a warp knows each subblock's verdict
// without shared memory. Lanes 0..sub-1 write the slot's sub keys; the
// dead slots are written with the sentinel by the whole block beforehand.
// The positions are read with their strides: the sharded step passes a
// strided view of a 4-wide table.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBoxes = 4;  // split boxes a row (tiles.SPLIT_BOXES)
constexpr int kSentinel = 1 << 30;  // tiles.REFINE_SENTINEL
constexpr float kFar = 1.0e6f;  // the deficit's clamp: sentinels stay finite

// torch.maximum: NaN if either side is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// torch.clamp(v, 0, kFar) in two passes, as the plain path takes it
__device__ __forceinline__ float clamp_deficit(float v) {
  if (isnan(v)) return v;
  return fminf(fmaxf(v, 0.f), kFar);
}

__device__ __forceinline__ float deficit(float lo, float hi, float p) {
  return clamp_deficit(max_nan(__fsub_rn(lo, p), __fsub_rn(p, hi)));
}

// kIters = B / 32 particles a lane; kW particles a subblock (16 or 32)
template <int kIters, int kW>
__global__ void __launch_bounds__(kThreads)
refine_exact_kernel(const int* __restrict__ cand, const int* __restrict__ count,
                    const float* __restrict__ qlo, const float* __restrict__ qhi,
                    const float* __restrict__ pos, long long block_stride,
                    long long particle_stride, long long coord_stride, int m, int n_boxes,
                    float h2_cut, int* __restrict__ keys, int* __restrict__ counts) {
  constexpr int kSub = 32 * kIters / kW;  // subblocks a block
  constexpr int kPerVote = 32 / kW;  // subblocks a ballot covers
  constexpr unsigned kLaneMask = kW == 32 ? 0xffffffffu : (1u << kW) - 1u;
  __shared__ int total;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) total = 0;

  float lo[kMaxBoxes][3] = {}, hi[kMaxBoxes][3] = {};
#pragma unroll
  for (int s = 0; s < kMaxBoxes; ++s) {
    if (s < n_boxes) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long at = 3ll * n_boxes * row + 3 * s + c;
        lo[s][c] = __ldg(qlo + at);
        hi[s][c] = __ldg(qhi + at);
      }
    }
  }
  const int live = max(0, min(__ldg(count + row), m));
  int* krow = keys + (long long)row * kSub * m;
  for (int s = 0; s < kSub; ++s) {
    for (int k = live + threadIdx.x; k < m; k += kThreads) krow[(long long)s * m + k] = kSentinel;
  }
  __syncthreads();  // total is zero

  int found = 0;
  for (int k = warp; k < live; k += kWarps) {
    const int c = __ldg(cand + (long long)row * m + k);
    const float* pb = pos + (long long)c * block_stride;
    float px[kIters], py[kIters], pz[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const float* pp = pb + (long long)(32 * it + lane) * particle_stride;
      px[it] = __ldg(pp);
      py[it] = __ldg(pp + coord_stride);
      pz[it] = __ldg(pp + 2 * coord_stride);
    }
    unsigned ok = 0;  // bit s: subblock s survives
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      bool in = false;
#pragma unroll
      for (int s = 0; s < kMaxBoxes; ++s) {
        if (s < n_boxes) {
          const float dx = deficit(lo[s][0], hi[s][0], px[it]);
          const float dy = deficit(lo[s][1], hi[s][1], py[it]);
          const float dz = deficit(lo[s][2], hi[s][2], pz[it]);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          in |= d2 <= h2_cut;
        }
      }
      const unsigned vote = __ballot_sync(0xffffffffu, in);
#pragma unroll
      for (int q = 0; q < kPerVote; ++q) {
        ok |= (unsigned)(((vote >> (q * kW)) & kLaneMask) != 0u) << (kPerVote * it + q);
      }
    }
    if (lane < kSub) {
      krow[(long long)lane * m + k] = (ok >> lane) & 1u ? c * kSub + lane : kSentinel;
    }
    found += __popc(ok);
  }
  if (lane == 0 && found) atomicAdd(&total, found);
  __syncthreads();
  if (threadIdx.x == 0) counts[row] = total;
}

template <int kIters, int kW>
cudaError_t launch(int rows, cudaStream_t s, const int* cand, const int* count,
                   const float* qlo, const float* qhi, const float* pos, long long block_stride,
                   long long particle_stride, long long coord_stride, int m, int n_boxes,
                   float h2_cut, int* keys, int* counts) {
  refine_exact_kernel<kIters, kW><<<rows, kThreads, 0, s>>>(
      cand, count, qlo, qhi, pos, block_stride, particle_stride, coord_stride, m, n_boxes,
      h2_cut, keys, counts);
  return cudaGetLastError();
}

}  // namespace

// cand (rows, m) int32 and count (rows,) int32: the block lists; qlo, qhi
// (rows, n_boxes, 3) float32 contiguous, 1 <= n_boxes <= 4; pos: the
// candidate blocks' sorted positions, element (block, particle, axis) at
// block * block_stride + particle * particle_stride + axis * coord_stride
// floats; b particles a block (64, 128 or 256) in sub subblocks of 16 or
// 32; h2_cut the float32 threshold. Writes keys (rows, sub * m) int32 and
// counts (rows,) int32. Returns the launch's CUDA status.
extern "C" int refine_exact_launch(const void* cand, const void* count, const void* qlo,
                                   const void* qhi, const void* pos, long long block_stride,
                                   long long particle_stride, long long coord_stride, int rows,
                                   int m, int b, int sub, int n_boxes, float h2_cut,
                                   void* keys, void* counts, void* stream) {
  if (rows < 0 || m < 0 || n_boxes < 1 || n_boxes > kMaxBoxes || sub <= 0 || b % sub) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto fn) {
    return fn(rows, s, (const int*)cand, (const int*)count, (const float*)qlo,
              (const float*)qhi, (const float*)pos, block_stride, particle_stride,
              coord_stride, m, n_boxes, h2_cut, (int*)keys, (int*)counts);
  };
  const int w = b / sub;
  cudaError_t e = cudaErrorInvalidValue;
  if (b == 64) {
    if (w == 16) e = args(launch<2, 16>);
    if (w == 32) e = args(launch<2, 32>);
  } else if (b == 128) {
    if (w == 16) e = args(launch<4, 16>);
    if (w == 32) e = args(launch<4, 32>);
  } else if (b == 256) {
    if (w == 16) e = args(launch<8, 16>);
    if (w == 32) e = args(launch<8, 32>);
  }
  return (int)e;
}
