// radix_sort — a stable LSD radix sort of (int32 key, int32 value) pairs
// by the low num_bits bits of the key, every pass on the card: one
// histogram kernel for all passes, then one kernel a pass, all launched
// from one C entry point.
//
// Replaces: libclsph_tpu/ops/radix_sort.py _rank_hist_kernel (the rank
// and histogram stage, through the pallas_call of _radix_pass_fused) and
// the XLA glue of its passes (_radix_pass_fused, radix_sort_key_val):
// the cumsum of the digit-major histogram table, the offset gather and
// the two scatters of the keys and values (or, with apply="gather", the
// inverse-permutation scatter and two gathers).
//
// Computes, for keys and values (n,) int32, n < 2^30: the keys ordered by
// key & (2^num_bits - 1), ties in index order, each value moved with its
// key. For keys below 2^num_bits that is the stable sort, equal bit for
// bit to torch.sort(stable=True) and lax.sort_key_val. Pass p sorts by
// the digit (key >> shift) & (d - 1), shift = p * bits_per_pass, d =
// 2^bits <= 128, bits = min(bits_per_pass, num_bits - shift).
//
// What bounds it on an H100: bytes. A pass has to read and write every
// key and value once, 16 bytes a key: 6 passes of 1M keys are 0.029 ms
// at 3.35 TB/s. This design moves those 16 bytes a pass, plus 4 bytes a
// key once for the histograms, in one launch a pass; at 1M keys a pass
// is one wave of 123 blocks, and its time is the latency of a block's
// loads, ranks, look-back and stores (about 9 us, PERF.md), not the
// bytes. Each pass kernel is launched with programmatic dependent launch,
// so its blocks start while the kernel before it drains.
//
// Design (the one-sweep form); the last tile of each kernel is ragged and
// no key is padded.
// 1. Histogram, once, over tiles of 2048 keys, 256 threads a block: each
//    block counts its tile's digits of every pass in shared memory (a
//    thread's 8 consecutive keys, read with 16-byte loads, add each run
//    of equal digits with one shared atomic) and adds the nonzero counts
//    to the global counts[pass][digit]. Counts are integers, so the
//    order of the adds does not matter.
// 2. A pass, over tiles of kTile = 8192 keys, 1024 threads (32 warps) a
//    block, a tile's keys and values reordered in 64 KB of dynamic shared
//    memory: a block takes the next tile in index order from an atomic
//    counter, so every earlier tile has a running block. Warp w takes its
//    keys w*256 .. w*256+255 in eight coalesced rounds of 32; in each
//    round __match_any_sync groups the lanes of equal digits, and a key's
//    rank is the warp's count of its digit so far plus the peers on lower
//    lanes (the lowest peer then adds the group to the count, one writer
//    an address). Exclusive prefixes of the warp counts over the warps
//    and of the tile's counts over the digits turn ranks into positions
//    in the tile ordered by digit, stable by index. The tile's count of
//    each digit is published at once (status[digit, tile], a flag and
//    the count in one word); then warp k looks back for digit k over
//    the earlier tiles' words, 32 tiles a step, summing counts back to
//    the nearest tile that has published its inclusive count, and
//    publishes the tile's own. The tile's first position of digit k is
//    the exclusive scan of counts[pass] at k plus that sum. The tiles
//    are large so that the chains of look-backs stay short: every block
//    of a wave publishes at about the same time. The tile is reordered in
//    shared memory and written out in index order, key j of digit k to
//    (first position of k) + j - (the tile's first position of digit k):
//    runs of consecutive addresses.
// A three-kernel form (upsweep, a one-block scan and a downsweep a pass)
// measured 0.22 ms at 1M keys against torch.sort's 0.11 on the H100: its
// 18 launches and the one-block scan set the time; this form at 2048-key
// tiles spent 8 us a pass in look-back chains, and without dependent
// launch it measured 0.11-0.13 ms (PERF.md). Keys and values ping-pong
// between the output and one scratch buffer, the parity chosen so that
// the last pass writes the output. With gather, the passes carry each
// key's index in the input instead of its value (the first pass makes
// the indices), and a last kernel gathers the values once: equal
// results.

#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;  // keys a thread
// the histogram: tiles of 2048 keys, 256 threads
constexpr int kHistThreads = 256;
constexpr int kHistTile = kHistThreads * kItems;
// a pass: tiles of 8192 keys, 1024 threads (32 warps, one a digit)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kWarpKeys = kTile / kWarps;
constexpr int kMaxDigits = 128;
constexpr int kMaxPasses = 31;
constexpr unsigned kFull = 0xffffffffu;
// a status word: a flag in the top two bits, a count below 2^30
constexpr unsigned kAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kInclusive = 2u << 30;  // this and every earlier tile's
constexpr unsigned kPublished = kAggregate | kInclusive;
constexpr unsigned kCountMask = kAggregate - 1u;
// the tile's keys and values, reordered by digit
constexpr int kTileBytes = 2 * kTile * sizeof(int);

__device__ __forceinline__ int digit_of(int key, int shift, int d) {
  return (key >> shift) & (d - 1);
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has started (``allow_next``); it waits
// for that kernel's completion and memory (``wait_previous``) before it
// reads what that kernel wrote. Without the attribute both are no-ops.
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Status words are read and written whole and at once by other blocks
// (volatile: never cached in a register or L1).
__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Exclusive prefix sum of one int a thread over the thread block (a
// multiple of 32 threads, at most 1024); every thread of the block calls
// it; ``warp_sums`` is 32 shared ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = w ? warp_sums[w - 1] : 0;
  __syncthreads();  // warp_sums may be written again at once
  return before + x - v;
}

// The sum of one digit's counts over the tiles before ``tile``: the warp
// reads the status words of 32 earlier tiles at a time, nearest first,
// waits until each is published, and stops at the nearest that holds an
// inclusive count.
__device__ unsigned look_back(const unsigned* row, int tile, int lane) {
  unsigned sum = 0u;
  for (int j = tile - 1; j >= 0; j -= 32) {
    const int i = j - lane;
    unsigned s = i >= 0 ? load_status(row + i) : kInclusive;  // before tile 0: 0
    while (__any_sync(kFull, (s & kPublished) == 0u)) {
      if ((s & kPublished) == 0u) s = load_status(row + i);
    }
    const unsigned inclusive = __ballot_sync(kFull, (s & kInclusive) != 0u);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    sum += __reduce_add_sync(kFull, lane <= stop ? (s & kCountMask) : 0u);
    if (inclusive) break;
  }
  return sum;
}

__global__ void __launch_bounds__(kHistThreads)
radix_histogram(const int* __restrict__ keys, long long n, int num_bits,
                int bits_per_pass, int passes, unsigned* __restrict__ counts) {
  __shared__ unsigned tile_counts[kMaxPasses * kMaxDigits];
  const int t = threadIdx.x;
  allow_next();
  for (int i = t; i < passes * kMaxDigits; i += kHistThreads) tile_counts[i] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kHistTile;
  const int valid = (int)min((long long)kHistTile, n - base);
  const int first = t * kItems;  // the thread's 8 consecutive keys
  int key[kItems];
  if (valid == kHistTile) {
    const int4* quads = reinterpret_cast<const int4*>(keys + base + first);
#pragma unroll
    for (int r = 0; r < kItems / 4; ++r) {
      const int4 q = quads[r];
      key[4 * r] = q.x;
      key[4 * r + 1] = q.y;
      key[4 * r + 2] = q.z;
      key[4 * r + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) key[i] = first + i < valid ? keys[base + first + i] : 0;
  }
  const int mine = max(0, min(kItems, valid - first));
  for (int p = 0; p < passes; ++p) {
    const int shift = p * bits_per_pass;
    const int d = 1 << min(bits_per_pass, num_bits - shift);
    unsigned* row = tile_counts + p * kMaxDigits;
    int prev = -1, run = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < mine) {
        const int dg = digit_of(key[i], shift, d);
        if (dg != prev) {
          if (run) atomicAdd(row + prev, (unsigned)run);
          prev = dg;
          run = 0;
        }
        ++run;
      }
    }
    if (run) atomicAdd(row + prev, (unsigned)run);
  }
  __syncthreads();
  for (int i = t; i < passes * kMaxDigits; i += kHistThreads) {
    if (tile_counts[i]) atomicAdd(counts + i, tile_counts[i]);
  }
}

// kIota: the values are the keys' indices in ``keys_in`` (the first pass
// of a gather sort); ``vals_in`` is not read.
template <bool kIota>
__global__ void __launch_bounds__(kThreads)
radix_pass(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
           long long n, int shift, int d, int ntiles,
           const unsigned* __restrict__ counts, unsigned* __restrict__ status,
           unsigned* __restrict__ next_tile, int* __restrict__ keys_out,
           int* __restrict__ vals_out) {
  // digit d: the lanes past the end, ordered behind every key
  __shared__ int warp_counts[kWarps][kMaxDigits + 1];
  __shared__ int digit_start[kMaxDigits + 1];
  __shared__ int tile_count[kMaxDigits];
  __shared__ int global_start[kMaxDigits];
  __shared__ int warp_sums[32];
  __shared__ int tile_shared;
  extern __shared__ int tile_kv[];  // kTileBytes: the keys, then the values
  int* tile_keys = tile_kv;
  int* tile_vals = tile_kv + kTile;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  allow_next();
  if (t == 0) tile_shared = (int)atomicAdd(next_tile, 1u);
  for (int i = t; i < kWarps * (kMaxDigits + 1); i += kThreads) {
    (&warp_counts[0][0])[i] = 0;
  }
  wait_previous();  // the previous pass's keys and values, the counts
  __syncthreads();
  const int tile = tile_shared;
  const long long base = (long long)tile * kTile;
  const int valid = (int)min((long long)kTile, n - base);
  const unsigned below = (1u << lane) - 1u;
  int key[kItems], val[kItems], dg[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = w * kWarpKeys + k * 32 + lane;
    const bool in = i < valid;
    key[k] = in ? keys_in[base + i] : 0;
    val[k] = kIota ? (int)(base + i) : (in ? vals_in[base + i] : 0);
    dg[k] = in ? digit_of(key[k], shift, d) : d;
    const unsigned peers = __match_any_sync(kFull, dg[k]);
    const int before = warp_counts[w][dg[k]];
    rank[k] = before + __popc(peers & below);
    __syncwarp();  // every peer has read the count
    if (lane == __ffs(peers) - 1) warp_counts[w][dg[k]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per digit: the warps' counts become their exclusive prefix; the
  // tile's count is published for the later tiles at once
  int count = 0;
  if (t <= d) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_counts[k][t];
      warp_counts[k][t] = count;
      count += c;
    }
  }
  if (t < d) {
    tile_count[t] = count;
    store_status(status + (long long)t * ntiles + tile,
                 (tile ? kAggregate : kInclusive) | (unsigned)count);
  }
  const int start = block_exclusive_scan(count, warp_sums);
  if (t <= d) digit_start[t] = start;
  const int digit_base = block_exclusive_scan(t < d ? (int)counts[t] : 0, warp_sums);
  if (t < d) global_start[t] = digit_base;
  __syncthreads();
  if (tile) {
    for (int k = w; k < d; k += kWarps) {
      unsigned* row = status + (long long)k * ntiles;
      const unsigned before = look_back(row, tile, lane);
      if (lane == 0) {
        store_status(row + tile, kInclusive | (before + (unsigned)tile_count[k]));
        global_start[k] += (int)before;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pos = digit_start[dg[k]] + warp_counts[w][dg[k]] + rank[k];
    tile_keys[pos] = key[k];
    tile_vals[pos] = val[k];
  }
  __syncthreads();
  for (int j = t; j < valid; j += kThreads) {
    const int kk = tile_keys[j];
    const int g = digit_of(kk, shift, d);
    const long long dest = (long long)global_start[g] + (j - digit_start[g]);
    keys_out[dest] = kk;
    vals_out[dest] = tile_vals[j];
  }
}

__global__ void radix_gather(const int* __restrict__ vals,
                             const int* __restrict__ index, long long n,
                             int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = vals[index[i]];
}

}  // namespace

// Plain C entry point: sorts (``keys``, ``vals``) ((n,) int32, n < 2^30,
// ``keys`` 16-byte aligned; neither is written) into ``keys_out`` and
// ``vals_out`` on ``stream``, with ``keys_tmp``, ``vals_tmp`` ((n,)
// int32), ``index_tmp`` ((n,) int32, used only with ``gather``) and
// ``scratch`` as scratch: P passes (ceil(num_bits / bits_per_pass)) and
// T tiles (ceil(n / 8192)) take P*128 + P + P*2^bits_per_pass*T uint32
// words, which the entry point zeroes (counts, tile counters, status).
// Launches a memset, the histogram kernel, one kernel a pass (each with
// programmatic dependent launch) and one gather kernel with ``gather``;
// allocates nothing, and returns the
// first launch error (0 on success; cudaErrorInvalidValue for num_bits
// outside 1..31, bits_per_pass outside 1..7 or n outside 0 .. 2^30 - 1).
extern "C" int radix_sort_launch(const void* keys, const void* vals, int n,
                                 int num_bits, int bits_per_pass, int gather,
                                 void* keys_out, void* vals_out, void* keys_tmp,
                                 void* vals_tmp, void* index_tmp, void* scratch,
                                 void* stream) {
  if (n < 0 || n >= (1 << 30) || num_bits < 1 || num_bits > 31 ||
      bits_per_pass < 1 || bits_per_pass > 7) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (n + kTile - 1) / kTile;
  const int hist_tiles = (n + kHistTile - 1) / kHistTile;
  const int passes = (num_bits + bits_per_pass - 1) / bits_per_pass;
  const long long status_words = (long long)(1 << bits_per_pass) * ntiles;
  unsigned* counts = (unsigned*)scratch;
  unsigned* next_tile = counts + passes * kMaxDigits;
  unsigned* status = next_tile + passes;
  const size_t bytes = sizeof(unsigned) * (passes * (kMaxDigits + 1) + passes * status_words);
  if (cudaError_t e = cudaMemsetAsync(scratch, 0, bytes, s)) return (int)e;
  radix_histogram<<<hist_tiles, kHistThreads, 0, s>>>((const int*)keys, n, num_bits,
                                                      bits_per_pass, passes, counts);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int* k_in = (const int*)keys;
  const int* v_in = gather ? nullptr : (const int*)vals;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * bits_per_pass;
    const int bits = bits_per_pass < num_bits - shift ? bits_per_pass : num_bits - shift;
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int* k_out = (int*)(to_out ? keys_out : keys_tmp);
    int* v_out = (int*)(gather ? (to_out ? index_tmp : vals_tmp)
                               : (to_out ? vals_out : vals_tmp));
    auto kernel = gather && p == 0 ? radix_pass<true> : radix_pass<false>;
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes)) {
      return (int)e;
    }
    // each pass's blocks start while the kernel before it drains
    cudaLaunchAttribute overlap = {};
    overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    overlap.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(ntiles);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = kTileBytes;
    config.stream = s;
    config.attrs = &overlap;
    config.numAttrs = 1;
    if (cudaError_t e = cudaLaunchKernelEx(&config, kernel, k_in, v_in, (long long)n, shift,
                                           1 << bits, ntiles, counts + p * kMaxDigits,
                                           status + p * status_words, next_tile + p, k_out,
                                           v_out)) {
      return (int)e;
    }
    k_in = k_out;
    v_in = v_out;
  }
  if (gather) {
    radix_gather<<<(n + kHistThreads - 1) / kHistThreads, kHistThreads, 0, s>>>(
        (const int*)vals, v_in, n, (int*)vals_out);
  }
  return (int)cudaGetLastError();
}
