// Bitonic block sort for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastkmer_tpu/ops/pallas_sort.py
// _mk_block_sort_kernel / _stage, reached through sort_blocks.  Every
// consecutive `block` rows of a [lanes, N] uint32 array (lane stride N) are
// sorted ascending, lexicographically over the first `keys` lanes compared
// as unsigned 32-bit values; the other lanes ride along.  N % block == 0,
// block a power of two >= 1024.  The sort is in place.
//
// The network is the standard XOR bitonic network of the Pallas kernel:
// for klev = 2, 4, ..., block and stride s = klev/2, ..., 1, rows i and
// i ^ s compare-exchange, ascending iff (i & klev) == 0 (every pair
// ascending at klev == block).  One thread owns one pair (i, i | s) and
// swaps it only when the later row's key is strictly smaller (larger, for a
// descending pair), so a key tie never swaps and no row is duplicated or
// lost.  Ties land in no particular order, as with the Pallas kernel.
//
// Bound: device-memory bytes, if each lane were read and written once (the
// Pallas kernel keeps a whole block in VMEM).  A Hopper CTA holds at most
// 227 KB of shared memory, less than a 32768-row block of 3 or more lanes,
// so a block is sorted in tiles of `tile` rows (the largest power of two
// <= block whose lanes fit, chosen by the wrapper):
//   * local_stages sorts each tile in dynamic shared memory: one load and
//     one store per lane, all stages of stride < tile in between;
//   * a stage of stride >= tile runs as global_stage, one device-memory
//     compare-exchange pass over all pairs, then local_stages finishes the
//     strides below tile.
// A 32768-row block of 3 lanes (tile 16384) takes 3 passes over the data,
// of 4 lanes (tile 8192) 6 passes.  Inside a tile the cost is instructions
// and shared-memory traffic: the lane and key counts of the compactions
// (keys + 1 or keys lanes, keys <= 4) are compiled in, so a comparison is an
// unrolled branch-free chain, and shared memory is indexed in 32 bits.
// Fewer global passes (a merge path, TMA staging), or keeping the low
// strides in registers, are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLocalThreads = 1024;
constexpr int kGlobalThreads = 256;

// Lexicographic a < b over the first keys lanes (lane stride `stride`).
// KEYS > 0 compiles the key count in: an unrolled comparison without
// branches; KEYS == 0 loops over `keys` at run time.
template <int KEYS, typename Idx>
__device__ __forceinline__ bool lex_less(const uint32_t* a, const uint32_t* b,
                                         int keys, Idx stride) {
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

// Compare-exchange rows i < j of a lane array of stride `stride`; LANES and
// KEYS > 0 are compile-time lane and key counts, 0 means run time.
template <int LANES, int KEYS, typename Idx>
__device__ __forceinline__ void exchange(uint32_t* d, Idx i, Idx j, bool ascending,
                                         int lanes, int keys, Idx stride) {
  const bool swap = ascending ? lex_less<KEYS>(d + j, d + i, keys, stride)
                              : lex_less<KEYS>(d + i, d + j, keys, stride);
  if (!swap) return;
  const int n = LANES > 0 ? LANES : lanes;
#pragma unroll
  for (int l = 0; l < n; ++l) {
    const uint32_t t = d[l * stride + i];
    d[l * stride + i] = d[l * stride + j];
    d[l * stride + j] = t;
  }
}

// Row index of pair p at stride s: p with a zero bit inserted at log2(s).
template <typename Idx>
__device__ __forceinline__ Idx pair_row(Idx p, Idx s) {
  return ((p & ~(s - 1)) << 1) | (p & (s - 1));
}

// One stage of stride s >= tile over the whole array, in device memory.
template <int LANES, int KEYS>
__global__ void global_stage(uint32_t* data, int64_t N, int lanes, int keys,
                             int64_t block, int64_t klev, int64_t s) {
  const int64_t pairs = N / 2;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < pairs; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = pair_row(p, s);
    const bool ascending = klev == block || (i & klev) == 0;
    exchange<LANES, KEYS>(data, i, i | s, ascending, lanes, keys, N);
  }
}

// Stages klev_lo..klev_hi (doubling), strides min(klev, tile)/2 .. 1, of
// one tile per CTA in dynamic shared memory ([lanes, tile] uint32, indexed
// in 32 bits).
template <int LANES, int KEYS>
__global__ void local_stages(uint32_t* data, int64_t N, int lanes, int keys,
                             int64_t block, int tile, int64_t klev_lo,
                             int64_t klev_hi) {
  extern __shared__ uint32_t sm[];
  const int nl = LANES > 0 ? LANES : lanes;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int l = 0; l < nl; ++l)
    for (int t = threadIdx.x; t < tile; t += blockDim.x)
      sm[l * tile + t] = data[l * N + base + t];
  __syncthreads();
  for (int64_t klev = klev_lo; klev <= klev_hi; klev <<= 1) {
    // within a tile (i & klev) is fixed by the tile base once klev >= tile
    const bool tile_ascending = klev == block || (base & klev) == 0;
    const int kl = klev < tile ? static_cast<int>(klev) : 0;
    for (int s = (kl ? kl : tile) >> 1; s >= 1; s >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int i = pair_row(p, s);
        const bool ascending = kl ? (klev == block || (i & kl) == 0) : tile_ascending;
        exchange<LANES, KEYS>(sm, i, i | s, ascending, lanes, keys, tile);
      }
      __syncthreads();
    }
  }
  for (int l = 0; l < nl; ++l)
    for (int t = threadIdx.x; t < tile; t += blockDim.x)
      data[l * N + base + t] = sm[l * tile + t];
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

// The launch sequence for one (LANES, KEYS) instantiation.
template <int LANES, int KEYS>
cudaError_t sort_blocks(uint32_t* d, int64_t N, int lanes, int keys, int64_t block,
                        int tile, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(lanes) * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      local_stages<LANES, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>(N / tile);
  const int local_threads = tile / 2 < kLocalThreads ? tile / 2 : kLocalThreads;
  const int64_t pair_blocks = (N / 2 + kGlobalThreads - 1) / kGlobalThreads;
  const unsigned global_blocks =
      static_cast<unsigned>(pair_blocks < 132 * 16 ? pair_blocks : 132 * 16);
  local_stages<LANES, KEYS><<<tiles, local_threads, smem, st>>>(
      d, N, lanes, keys, block, tile, 2, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int64_t klev = 2 * static_cast<int64_t>(tile); klev <= block; klev <<= 1) {
    for (int64_t s = klev >> 1; s >= tile; s >>= 1) {
      global_stage<LANES, KEYS><<<global_blocks, kGlobalThreads, 0, st>>>(
          d, N, lanes, keys, block, klev, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    local_stages<LANES, KEYS><<<tiles, local_threads, smem, st>>>(
        d, N, lanes, keys, block, tile, klev, klev);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// data: [lanes, N] int32/uint32, contiguous, sorted in place per block.
// 1 <= keys <= lanes; block a power of two >= 1024 dividing N; tile a power
// of two <= block whose lanes * tile * 4 bytes of shared memory the device
// grants.  Launches on `stream` of `device`; returns the first error code.
extern "C" int fk_sort_blocks(void* data, int64_t N, int lanes, int keys,
                              int64_t block, int tile, int device,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (keys < 1 || keys > lanes || !pow2(block) || block < 1024 ||
      N % block != 0 || !pow2(tile) || tile < 2 || tile > block ||
      N / tile > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  auto* d = static_cast<uint32_t*>(data);
  auto st = static_cast<cudaStream_t>(stream);
  // the compactions sort W key lanes and a count (W <= 4 for k <= 64, the
  // sequence lane included); other shapes take the run-time loops
  cudaError_t err;
  switch (lanes * 8 + keys) {
    case 2 * 8 + 1: err = sort_blocks<2, 1>(d, N, lanes, keys, block, tile, st); break;
    case 3 * 8 + 2: err = sort_blocks<3, 2>(d, N, lanes, keys, block, tile, st); break;
    case 4 * 8 + 3: err = sort_blocks<4, 3>(d, N, lanes, keys, block, tile, st); break;
    case 5 * 8 + 4: err = sort_blocks<5, 4>(d, N, lanes, keys, block, tile, st); break;
    case 1 * 8 + 1: err = sort_blocks<1, 1>(d, N, lanes, keys, block, tile, st); break;
    case 2 * 8 + 2: err = sort_blocks<2, 2>(d, N, lanes, keys, block, tile, st); break;
    case 3 * 8 + 3: err = sort_blocks<3, 3>(d, N, lanes, keys, block, tile, st); break;
    case 4 * 8 + 4: err = sort_blocks<4, 4>(d, N, lanes, keys, block, tile, st); break;
    default: err = sort_blocks<0, 0>(d, N, lanes, keys, block, tile, st);
  }
  return static_cast<int>(err);
}
