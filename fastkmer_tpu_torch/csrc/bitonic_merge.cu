// Merge of two sorted halves for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas TPU kernels benchmarks/pallas_bitonic_merge.py
// _mk_cross_kernel / _mk_clean_kernel, reached through bitonic_merge.  The
// N rows of a [lanes, N] uint32 array (lane stride N) are [A ascending |
// B descending], N/2 rows each; the merge writes them, in ascending order,
// to a second [lanes, N] array: lexicographic over the first `keys` lanes
// compared as unsigned 32-bit values, the other lanes riding along.  The
// contract is the output only (ascending rows, ties in any order, the same
// multiset), so the bitonic network the TPU ran is not needed here: this is
// a merge path over A and B read backwards (rev-B, ascending too), which
// needs exactly that shape, not any bitonic sequence.
//
// Bound on this card: device-memory bytes, each lane read once and written
// once (3.2 GB at 2^27 rows x 3 lanes: 0.96 ms at 3.35 TB/s).  A bitonic
// network makes one device-memory pass a stride above the shared tile (14
// at that shape); the merge path reads each row once and writes it once:
//   * partition: one thread per output tile boundary d = t * tile searches
//     the co-rank i, the rows of A among the first d rows of the output
//     (binary search over A and rev-B in device memory), into splits[t]:
//     N / tile + 1 int64 values, O((N / tile) log N) probes in all;
//   * merge: one CTA per output tile loads A[splits[t], splits[t + 1]) and
//     the matching rev-B range, every lane, into shared memory with
//     coalesced loads; each thread finds its own co-rank inside the tile,
//     merges its tile / 256 rows serially and records where each output
//     row comes from; then the CTA writes the tile's lanes, gathered from
//     shared memory, with coalesced stores.
// One tie rule everywhere: on equal keys A's row comes first (the search
// moves right past A[mid] unless rev-B's row is strictly less, and the
// serial merge takes A unless rev-B's row is strictly less), so partition
// and merge agree at tile edges and no row is lost or duplicated.  A tile
// is (lanes + 1) * 4 bytes a row (the rows and the source indices); the
// caller picks it (cuda_bitonic_merge.merge_tile) so that six CTAs fit an
// SM where they can (2048 rows at 3 lanes), so that one CTA's loads overlap
// another's merge; three CTAs of 4096 rows an SM ran slower in a trial.
// Offsets are 64-bit:
// lane x N passes 2^31 at N = 2^27 with 16 lanes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB of opt-in shared memory

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

// splits[t] = the co-rank of output row t * tile: A's rows among the first
// t * tile rows of the output.  Rev-B's row j is row N - 1 - j.
template <int KEYS>
__global__ void merge_partition(const uint32_t* __restrict__ src,
                                int64_t* __restrict__ splits, int64_t N, int keys, int tile) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t > N / tile) return;
  const int64_t h = N / 2, d = t * tile;
  int64_t lo = d > h ? d - h : 0, hi = d < h ? d : h;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    // rev-B[d - 1 - mid] is row N - d + mid
    if (lex_less<KEYS>(src + (N - d + mid), src + mid, keys, N))
      hi = mid;
    else
      lo = mid + 1;
  }
  splits[t] = lo;
}

// One output tile a CTA.  Shared memory: [lanes, tile] rows (A's range,
// then rev-B's), then tile uint32 source indices.
template <int LANES, int KEYS>
__global__ void __launch_bounds__(kThreads) merge_tile(const uint32_t* __restrict__ src,
                                                       uint32_t* __restrict__ out,
                                                       const int64_t* __restrict__ splits,
                                                       int64_t N, int lanes, int keys, int tile) {
  extern __shared__ uint32_t sm[];
  const int nl = LANES > 0 ? LANES : lanes;
  const int64_t t = blockIdx.x, d0 = t * tile;
  const int64_t a0 = splits[t];
  const int na = static_cast<int>(splits[t + 1] - a0), nb = tile - na;
  const int64_t b0 = N - 1 - (d0 - a0);  // rev-B's first row of the tile, read downwards
  const int per = tile / kThreads;
  for (int l = 0; l < nl; ++l) {
    const uint32_t* g = src + l * N;
    uint32_t* s = sm + l * tile;
#pragma unroll 4
    for (int k = 0; k < per; ++k) {
      const int r = k * kThreads + threadIdx.x;
      s[r] = r < na ? g[a0 + r] : g[b0 - (r - na)];
    }
  }
  __syncthreads();
  uint32_t* from = sm + nl * tile;
  const uint32_t* sb = sm + na;  // rev-B's rows, lane stride tile
  const int d = threadIdx.x * per;
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less<KEYS>(sb + (d - 1 - mid), sm + mid, keys, tile))
      hi = mid;
    else
      lo = mid + 1;
  }
  int i = lo, j = d - lo;
  for (int k = 0; k < per; ++k) {
    const bool take_a = j >= nb || (i < na && !lex_less<KEYS>(sb + j, sm + i, keys, tile));
    from[d + k] = take_a ? i++ : na + j++;
  }
  __syncthreads();
  for (int l = 0; l < nl; ++l) {
    uint32_t* g = out + l * N + d0;
    const uint32_t* s = sm + l * tile;
#pragma unroll 4
    for (int k = 0; k < per; ++k) {
      const int r = k * kThreads + threadIdx.x;
      g[r] = s[from[r]];
    }
  }
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

template <int LANES, int KEYS>
cudaError_t merge(const uint32_t* src, uint32_t* out, int64_t* splits, int64_t N, int lanes,
                  int keys, int tile, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(lanes + 1) * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      merge_tile<LANES, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t n_split = N / tile + 1;
  const unsigned split_blocks = static_cast<unsigned>((n_split + kThreads - 1) / kThreads);
  merge_partition<KEYS><<<split_blocks, kThreads, 0, st>>>(src, splits, N, keys, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_tile<LANES, KEYS><<<static_cast<unsigned>(N / tile), kThreads, smem, st>>>(
      src, out, splits, N, lanes, keys, tile);
  return cudaGetLastError();
}

}  // namespace

// src: [lanes, N] int32/uint32, contiguous, rows [A ascending | B
// descending] (keys first); out: another [lanes, N] array, not overlapping
// src, written with the merged rows; splits: N / tile + 1 int64 of scratch.
// 1 <= keys <= lanes; N a power of two >= 2; tile a power of two, 256 <=
// tile <= N, whose (lanes + 1) * tile * 4 bytes fit in 227 KB.  Launches
// the partition and the merge on `stream` of `device`; returns the first
// CUDA error code (cudaErrorInvalidValue for arguments outside those
// bounds).
extern "C" int fk_merge_path(const void* src, void* out, void* splits, int64_t N, int lanes,
                             int keys, int tile, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (keys < 1 || keys > lanes || !pow2(N) || N < 2 || !pow2(tile) || tile < kThreads ||
      tile > N || N / tile >= INT32_MAX ||
      static_cast<int64_t>(lanes + 1) * tile * static_cast<int64_t>(sizeof(uint32_t)) >
          kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const uint32_t*>(src);
  auto* o = static_cast<uint32_t*>(out);
  auto* sp = static_cast<int64_t*>(splits);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // the probes' shapes are compiled in (split_merge_probe and
  // resume_merge_probe merge 2 keys + 1 value); others take run-time counts
  switch (lanes * 32 + keys) {
    case 1 * 32 + 1: err = merge<1, 1>(s, o, sp, N, lanes, keys, tile, st); break;
    case 2 * 32 + 1: err = merge<2, 1>(s, o, sp, N, lanes, keys, tile, st); break;
    case 3 * 32 + 2: err = merge<3, 2>(s, o, sp, N, lanes, keys, tile, st); break;
    case 4 * 32 + 3: err = merge<4, 3>(s, o, sp, N, lanes, keys, tile, st); break;
    default: err = merge<0, 0>(s, o, sp, N, lanes, keys, tile, st);
  }
  return static_cast<int>(err);
}
