// Bitonic merge of two sorted halves for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas TPU kernels benchmarks/pallas_bitonic_merge.py
// _mk_cross_kernel / _mk_clean_kernel, reached through bitonic_merge.  The
// N rows of a [lanes, N] uint32 array (lane stride N) hold a bitonic
// sequence, in practice [A ascending | B descending] with N/2 rows each;
// the merge leaves them in ascending order, lexicographic over the first
// `keys` lanes compared as unsigned 32-bit values, the other lanes riding
// along.  N is a power of two.  The merge is in place.
//
// The network is the bitonic merge: for s = N/2, ..., 1, rows i and i | s
// (bit s of i clear) compare-exchange, ascending everywhere.  A pair swaps
// all its lanes when the upper row is strictly less than the lower one, so
// a tie stays where it is, and each pair has one owner thread: no row is
// lost or duplicated.  Ties land in no particular order, as with the Pallas
// kernels.
//
// Bound on this card: device-memory bytes, each lane read once and written
// once (3.2 GB at 2^27 rows x 3 lanes: 0.96 ms at 3.35 TB/s).  This first
// design is the simple one.  Strides >= tile run as device-memory passes,
// one launch per stride (cross_stage), one thread per pair; the strides
// below the tile run in one pass over tiles held in shared memory
// (clean_tile), a barrier per stage.  `tile` is the largest power of two
// <= N whose lanes fit in the 227 KB a CTA may opt into (16384 rows at 3
// lanes; ops/cuda_sort.tile_rows), so the merge makes log2(N / tile) + 1
// device-memory passes: 14 at 2^27 rows x 3 lanes.  Several strides a pass,
// thread-block clusters and TMA (as csrc/block_sort.cu's cluster route
// does for kernel C) are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCrossThreads = 256;
constexpr int kCleanThreads = 1024;
constexpr int64_t kCrossBlocks = 132 * 16;  // 16 CTAs for each of the 132 SMs
constexpr int kMaxSharedBytes = 232448;     // 227 KB of opt-in shared memory

// Lexicographic a < b over the first keys lanes (lane stride `stride`),
// unsigned.  KEYS > 0 compiles the key count in; KEYS == 0 reads `keys`.
template <int KEYS, typename Idx>
__device__ __forceinline__ bool lex_less(const uint32_t* a, const uint32_t* b, int keys,
                                         Idx stride) {
  if constexpr (KEYS > 0) {
    bool lt = false, eq = true;
#pragma unroll
    for (int w = 0; w < KEYS; ++w) {
      const uint32_t x = a[w * stride];
      const uint32_t y = b[w * stride];
      lt = lt || (eq && x < y);
      eq = eq && x == y;
    }
    return lt;
  } else {
    for (int w = 0; w < keys; ++w) {
      const uint32_t x = a[w * stride];
      const uint32_t y = b[w * stride];
      if (x != y) return x < y;
    }
    return false;
  }
}

// Ascending compare-exchange of rows i < j: every lane swaps when row j is
// strictly less than row i.  LANES > 0 compiles the lane count in.
template <int LANES, int KEYS, typename Idx>
__device__ __forceinline__ void exchange(uint32_t* d, Idx i, Idx j, int lanes, int keys,
                                         Idx stride) {
  if (!lex_less<KEYS>(d + j, d + i, keys, stride)) return;
  const int n = LANES > 0 ? LANES : lanes;
#pragma unroll
  for (int l = 0; l < n; ++l) {
    const Idx o = l * stride;
    const uint32_t t = d[o + i];
    d[o + i] = d[o + j];
    d[o + j] = t;
  }
}

// Row index of pair p at stride s: p with a zero bit inserted at log2(s).
template <typename Idx>
__device__ __forceinline__ Idx pair_row(Idx p, Idx s) {
  return ((p & ~(s - 1)) << 1) | (p & (s - 1));
}

// One stage of stride s >= tile over all N rows, in device memory.  Offsets
// are 64-bit: lane x N passes 2^31 at N = 2^27 with 16 lanes.
template <int LANES, int KEYS>
__global__ void cross_stage(uint32_t* __restrict__ data, int64_t N, int lanes, int keys,
                            int64_t s) {
  const int64_t pairs = N / 2;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; p < pairs;
       p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = pair_row(p, s);
    exchange<LANES, KEYS>(data, i, i | s, lanes, keys, N);
  }
}

// Strides tile/2 .. 1 of one tile per CTA, in dynamic shared memory
// ([lanes, tile] uint32, indexed in 32 bits).  After the cross stages every
// tile is bitonic and the tiles are in order, so cleaning each tile ends
// the merge.
template <int LANES, int KEYS>
__global__ void clean_tile(uint32_t* __restrict__ data, int64_t N, int lanes, int keys,
                           int tile) {
  extern __shared__ uint32_t sm[];
  const int nl = LANES > 0 ? LANES : lanes;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int l = 0; l < nl; ++l)
    for (int t = threadIdx.x; t < tile; t += blockDim.x) sm[l * tile + t] = data[l * N + base + t];
  __syncthreads();
  for (int s = tile >> 1; s >= 1; s >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = pair_row(p, s);
      exchange<LANES, KEYS>(sm, i, i | s, lanes, keys, tile);
    }
    __syncthreads();
  }
  for (int l = 0; l < nl; ++l)
    for (int t = threadIdx.x; t < tile; t += blockDim.x) data[l * N + base + t] = sm[l * tile + t];
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

// The launch sequence for one (LANES, KEYS) instantiation: one cross_stage
// per stride from N/2 down to tile, then clean_tile.
template <int LANES, int KEYS>
cudaError_t merge(uint32_t* d, int64_t N, int lanes, int keys, int tile, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(lanes) * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      clean_tile<LANES, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t pair_blocks = (N / 2 + kCrossThreads - 1) / kCrossThreads;
  const unsigned cross_blocks =
      static_cast<unsigned>(pair_blocks < kCrossBlocks ? pair_blocks : kCrossBlocks);
  for (int64_t s = N >> 1; s >= tile; s >>= 1) {
    cross_stage<LANES, KEYS><<<cross_blocks, kCrossThreads, 0, st>>>(d, N, lanes, keys, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int threads = tile / 2 < kCleanThreads ? tile / 2 : kCleanThreads;
  clean_tile<LANES, KEYS><<<static_cast<unsigned>(N / tile), threads, smem, st>>>(
      d, N, lanes, keys, tile);
  return cudaGetLastError();
}

}  // namespace

// data: [lanes, N] int32/uint32, contiguous, a bitonic sequence of rows
// (keys first); merged in place.  1 <= keys <= lanes; N a power of two >= 2;
// tile a power of two, 2 <= tile <= N, whose lanes · tile · 4 bytes fit in
// 227 KB.  Launches on `stream` of `device`; returns the first CUDA error
// code (cudaErrorInvalidValue for arguments outside those bounds).
extern "C" int fk_bitonic_merge(void* data, int64_t N, int lanes, int keys, int tile,
                                int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (keys < 1 || keys > lanes || !pow2(N) || N < 2 || !pow2(tile) || tile < 2 || tile > N ||
      N / tile > INT32_MAX ||
      static_cast<int64_t>(lanes) * tile * static_cast<int64_t>(sizeof(uint32_t)) >
          kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* d = static_cast<uint32_t*>(data);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // split_merge_probe and resume_merge_probe merge 2 keys + 1 value; other
  // shapes take run-time lane and key counts
  switch (lanes * 32 + keys) {
    case 1 * 32 + 1: err = merge<1, 1>(d, N, lanes, keys, tile, st); break;
    case 2 * 32 + 1: err = merge<2, 1>(d, N, lanes, keys, tile, st); break;
    case 3 * 32 + 2: err = merge<3, 2>(d, N, lanes, keys, tile, st); break;
    case 4 * 32 + 3: err = merge<4, 3>(d, N, lanes, keys, tile, st); break;
    default: err = merge<0, 0>(d, N, lanes, keys, tile, st);
  }
  return static_cast<int>(err);
}
