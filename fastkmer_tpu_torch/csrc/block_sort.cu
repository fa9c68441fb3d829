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
// ascending at klev == block).  A pair owned by one thread swaps both rows
// or neither (its direction decides on a strict comparison; a tie may
// swap).  A pair split between two threads is judged by both from the
// same (lower, upper) rows with the same strict comparison, and each keeps
// its own row on a tie.  So no row is duplicated or lost.  Ties land in no
// particular order, as with the Pallas kernel.
//
// Bound on this card: device-memory bytes, each lane read once and written
// once (the Pallas kernel keeps a whole block in VMEM).  What stood in the
// way: a 32768-row block of 3 lanes (384 KB) is larger than one CTA's
// 227 KB of shared memory, and a network of log2(block)(log2(block)+1)/2
// stages (120 at 32768) costs a barrier and a shared-memory round trip per
// stage when one thread owns one pair.
//
// The cluster route (cluster_sort) holds one block in the distributed
// shared memory of a thread-block cluster of `cluster` CTAs (the fewest, a
// power of two, of which two fit an SM's shared memory, else one; at most
// 8), so every row is read from device memory once and written once.  Two
// CTAs an SM let one CTA's device-memory copies overlap the other's sort.
// A one-owner compare-exchange picks its direction with one comparison and
// an XOR, not two comparisons and a select.  Each warp
// owns chunks of C = 32 R rows and holds a chunk in registers in one of two
// mappings (R rows a lane; R = 16 up to 3 lanes, 8 up to 6, else 4):
//   * mapping Y, lane ln holds rows ln R + j: strides below R run inside
//     the thread, strides R .. 16 between lanes with __shfl_xor_sync (both
//     threads of a pair see the same (lower, upper) rows, decide by the same
//     strict comparison and keep their own row on a tie);
//   * mapping X, lane ln holds rows ln + 32 j: strides 32 .. C/2 run inside
//     the thread.
// sort_chunks runs klev = 2 .. C in mapping Y with no barrier.  Each later
// klev runs its strides >= C as shared-memory passes of up to 3 strides (a
// thread loads a group of 8 rows once and runs 3 stages on them); a pass
// whose largest stride reaches past the CTA's rows touches the other CTAs'
// rows through cluster.map_shared_rank, between cluster.sync()s.  Then
// merge_chunks: strides 32 .. C/2 in mapping X, the chunk back through
// shared memory into mapping Y (a warp-private transpose), the rest there.
// Shared memory holds row r at swz(r) = r ^ (((r >> 5) & 7) << 2), which
// keeps X's scalar and Y's 16-byte chunk accesses and the passes' row runs
// free of bank conflicts.
// At 3 lanes and 32768 rows (4 CTAs of 8192 rows, R = 16): 21 of the
// network's 120 stages run in 9 shared-memory passes (two across the
// cluster), 21 between lanes and 78 inside threads.  Two key lanes compare
// as one uint64_t.  Block loads and stores are 16-byte vector accesses.
// What bounds it now is instructions: the 120 stages' compare-exchanges,
// not the one device-memory pass (PERF.md has the times).
//
// The tiled route (local_stages + global_stage) takes the shapes that no
// cluster of at most 8 CTAs holds (more than 16 lanes, or a block larger
// than 8 CTAs' shared memory): tiles of `tile` rows sorted in shared
// memory, strides >= tile as device-memory passes.  The wrapper picks the
// route from the shape alone (ops/cuda_sort.py stage_plan).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLocalThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxClusterLanes = 16;

// ---------------------------------------------------------------------------
// Tiled route.

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

// The tiled launch sequence for one (LANES, KEYS) instantiation.
template <int LANES, int KEYS>
cudaError_t sort_tiled(uint32_t* d, int64_t N, int lanes, int keys, int64_t block,
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

// ---------------------------------------------------------------------------
// Cluster route.  LANES is a compile-time bound on the lane count; KEYS > 0
// compiles the key count in (and then lanes == LANES), KEYS == 0 takes
// `lanes` <= LANES and `keys` at run time (missing lanes are zeros in the
// registers and are never stored).

// Rows each thread holds in registers during a register pass: R · LANES
// <= 48 registers of rows up to 6 lanes, 64 at 16 (more spill at 128
// registers a thread).  It depends on the lane count alone: the run-time
// instantiations bound the lanes by 3, 6 and 16.
__host__ __device__ constexpr int rows_per_thread(int lanes) {
  return lanes <= 3 ? 16 : lanes <= 6 ? 8 : 4;
}

// Threads of a CTA: 256, two CTAs an SM up to 6 lanes (128 registers a
// thread); 192 where a thread holds 48 registers of rows (3 or 6 lanes),
// which spill at 128.
__host__ __device__ constexpr int cluster_threads(int lanes) {
  return rows_per_thread(lanes) * lanes == 48 ? 192 : 256;
}

// Key lanes 2p and 2p + 1 of a row as one uint64_t (the second lane 0 past
// the last key).
template <int LANES>
__device__ __forceinline__ uint64_t key_pair(const uint32_t (&r)[LANES], int p, int keys) {
  const int q = 2 * p + 1 < LANES ? 2 * p + 1 : LANES - 1;
  const uint32_t lo = 2 * p + 1 < keys ? r[q] : 0u;
  return (static_cast<uint64_t>(r[2 * p]) << 32) | lo;
}

// Lexicographic a < b over the first `keys` lanes of two register rows.
template <int LANES>
__device__ __forceinline__ bool rows_less(const uint32_t (&a)[LANES],
                                          const uint32_t (&b)[LANES], int keys) {
  bool lt = false, eq = true;
#pragma unroll
  for (int p = 0; p < (LANES + 1) / 2; ++p) {
    if (2 * p < keys) {
      const uint64_t x = key_pair(a, p, keys);
      const uint64_t y = key_pair(b, p, keys);
      lt = lt || (eq && x < y);
      eq = eq && x == y;
    }
  }
  return lt;
}

// Shared-memory position of row r of a CTA: bits 2-4 of r XORed with bits
// 5-7, so that both register mappings below load a chunk without bank
// conflicts (mapping X as scalar rows of 32 words, mapping Y as 16-byte
// vectors), and groups of 4 rows stay contiguous for 16-byte accesses.
__device__ __forceinline__ int swz(int r) { return r ^ (((r >> 5) & 7) << 2); }

// The register mappings of a warp's chunk of C = 32 R rows: lane ln holds
// rows ln + 32 j (X: strides 32 .. C/2 inside the thread; scalar loads) or
// rows ln R + j (Y: strides 1 .. R/2 inside the thread, R .. C/2 between
// lanes; 16-byte loads of 4 rows).  v[j][l] is lane l of row j.
template <int LANES, int R, bool Y>
__device__ __forceinline__ void load_chunk(uint32_t (&v)[R][LANES], const uint32_t* sm, int rc,
                                           int lanes, int base) {
  const int ln = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    if constexpr (Y) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (l < lanes)
          t = *reinterpret_cast<const uint4*>(sm + l * rc + swz(base + ln * R + 4 * q));
        v[4 * q][l] = t.x;
        v[4 * q + 1][l] = t.y;
        v[4 * q + 2][l] = t.z;
        v[4 * q + 3][l] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j][l] = l < lanes ? sm[l * rc + swz(base + ln + 32 * j)] : 0u;
    }
  }
}

template <int LANES, int R, bool Y>
__device__ __forceinline__ void store_chunk(const uint32_t (&v)[R][LANES], uint32_t* sm, int rc,
                                            int lanes, int base) {
  const int ln = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    if (l >= lanes) continue;
    if constexpr (Y) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        *reinterpret_cast<uint4*>(sm + l * rc + swz(base + ln * R + 4 * q)) =
            make_uint4(v[4 * q][l], v[4 * q + 1][l], v[4 * q + 2][l], v[4 * q + 3][l]);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) sm[l * rc + swz(base + ln + 32 * j)] = v[j][l];
    }
  }
}

// Compare-exchange register rows a (the earlier) and b of one owner: an
// ascending pair swaps when b < a, a descending one unless b < a (a tie
// then swaps both rows, which loses none).
template <int LANES>
__device__ __forceinline__ void exchange_regs(uint32_t (&a)[LANES], uint32_t (&b)[LANES],
                                              int keys, bool desc) {
  const bool swap = rows_less<LANES>(b, a, keys) != desc;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const uint32_t x = a[l], y = b[l];
    a[l] = swap ? y : x;
    b[l] = swap ? x : y;
  }
}

// Stride SJ between register rows j and j | SJ (block index of row j:
// i0 + step j).  UNI: every pair has the direction of row i0 (klev above
// the rows' spread).
template <int LANES, int R, int SJ, bool UNI>
__device__ __forceinline__ void thread_stage(uint32_t (&v)[R][LANES], int keys, int i0, int step,
                                             int klev) {
  const bool d0 = (i0 & klev) != 0;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if ((j & SJ) == 0)
      exchange_regs<LANES>(v[j], v[j | SJ], keys, UNI ? d0 : ((i0 + step * j) & klev) != 0);
}

// The register strides SJ = R/2 .. 1 (row strides step · SJ), largest
// first; in mapping Y only those below klev.
template <int LANES, int R, bool UNI>
__device__ __forceinline__ void thread_stages(uint32_t (&v)[R][LANES], int keys, int i0,
                                              int step, int klev) {
  if constexpr (R >= 16) if (8 < klev) thread_stage<LANES, R, 8, UNI>(v, keys, i0, step, klev);
  if constexpr (R >= 8) if (4 < klev) thread_stage<LANES, R, 4, UNI>(v, keys, i0, step, klev);
  if constexpr (R >= 4) if (2 < klev) thread_stage<LANES, R, 2, UNI>(v, keys, i0, step, klev);
  thread_stage<LANES, R, 1, UNI>(v, keys, i0, step, klev);
}

// A stride between lanes ln and ln ^ mask: both threads of a pair judge the
// pair (lower row, upper row) alike and keep their own row on a tie.
template <int LANES, int R>
__device__ __forceinline__ void lane_stage(uint32_t (&v)[R][LANES], int keys, int i0, int mask,
                                           int klev) {
  const bool lower = ((threadIdx.x & 31) & mask) == 0;
  const bool asc = (i0 & klev) == 0;  // klev >= 2 R: one direction for all j
#pragma unroll
  for (int j = 0; j < R; ++j) {
    uint32_t o[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) o[l] = __shfl_xor_sync(0xffffffffu, v[j][l], mask);
    const bool swap = lower == asc ? rows_less<LANES>(o, v[j], keys)
                                   : rows_less<LANES>(v[j], o, keys);
#pragma unroll
    for (int l = 0; l < LANES; ++l) v[j][l] = swap ? o[l] : v[j][l];
    if ((j & 3) == 3) __syncwarp();  // keeps the shuffles of all j from piling up (spills)
  }
}

// klev = 2 .. C, all inside each warp's chunk, in mapping Y.  row0 is the
// block index of the CTA's row 0.
template <int LANES>
__device__ __forceinline__ void sort_chunks(uint32_t* sm, int rc, int lanes, int keys, int row0) {
  constexpr int R = rows_per_thread(LANES);
  constexpr int C = 32 * R;
  const int ln = threadIdx.x & 31;
#pragma unroll 1  // one chunk at a time: two in flight spill
  for (int c = threadIdx.x >> 5; c < rc / C; c += blockDim.x >> 5) {
    uint32_t v[R][LANES];
    load_chunk<LANES, R, true>(v, sm, rc, lanes, c * C);
    const int i0 = row0 + c * C + ln * R;
#pragma unroll 1  // unrolled, the levels' schedules overlap and spill
    for (int klev = 2; klev <= C; klev <<= 1) {
#pragma unroll 1
      for (int s = klev >> 1; s >= R; s >>= 1) lane_stage<LANES, R>(v, keys, i0, s / R, klev);
      if (klev >= R) thread_stages<LANES, R, true>(v, keys, i0, 1, klev);
      else thread_stages<LANES, R, false>(v, keys, i0, 1, klev);
    }
    store_chunk<LANES, R, true>(v, sm, rc, lanes, c * C);
  }
}

// The strides below C of one klev > C: 32 .. C/2 in mapping X, then the
// chunk goes through shared memory into mapping Y (a warp-private
// transpose) for R .. 16 (between lanes) and 1 .. R/2.
template <int LANES>
__device__ __forceinline__ void merge_chunks(uint32_t* sm, int rc, int lanes, int keys, int row0,
                                             int klev) {
  constexpr int R = rows_per_thread(LANES);
  constexpr int C = 32 * R;
  const int ln = threadIdx.x & 31;
#pragma unroll 1  // one chunk at a time: two in flight spill
  for (int c = threadIdx.x >> 5; c < rc / C; c += blockDim.x >> 5) {
    uint32_t v[R][LANES];
    load_chunk<LANES, R, false>(v, sm, rc, lanes, c * C);
    thread_stages<LANES, R, true>(v, keys, row0 + c * C + ln, 32, klev);
    store_chunk<LANES, R, false>(v, sm, rc, lanes, c * C);
    __syncwarp();
    load_chunk<LANES, R, true>(v, sm, rc, lanes, c * C);
    const int iy = row0 + c * C + ln * R;
    for (int s = 16; s >= R; s >>= 1) lane_stage<LANES, R>(v, keys, iy, s / R, klev);
    thread_stages<LANES, R, true>(v, keys, iy, 1, klev);
    store_chunk<LANES, R, true>(v, sm, rc, lanes, c * C);
    __syncwarp();
  }
}

// Strides one shared-memory pass runs: a thread holds 2^NS rows of all
// lanes, at most 40 registers (8 rows up to 5 lanes, 4 up to 10, else 2).
__host__ __device__ constexpr int pass_strides(int lanes) {
  return lanes <= 5 ? 3 : lanes <= 10 ? 2 : 1;
}

// One pass over the strides s, s/2, ..., s >> (NS-1), all >= C.  A thread
// takes groups of G = 2^NS rows that differ only in those strides' bits,
// loads them into registers, runs the NS stages and stores them back.
// Group g of the block belongs to CTA g / (rc / G): a pass whose strides
// stay below rc touches only the CTA's own shared memory; one with s >= rc
// reaches the other CTAs' rows through cluster.map_shared_rank.  Every pair
// has one owner.
template <int LANES, int NS, bool CROSS>
__device__ __forceinline__ void shared_pass(const cg::cluster_group& cluster, uint32_t* sm,
                                            int rc, int lanes, int keys, int rank, int klev,
                                            int s) {
  constexpr int G = 1 << NS;
  const int lg_rc = __ffs(rc) - 1;
  for (int t = threadIdx.x; t < rc / G; t += blockDim.x) {
    int r0 = rank * (rc / G) + t;  // zero bits inserted at the strides, lowest first
#pragma unroll
    for (int e = NS - 1; e >= 0; --e) r0 = pair_row(r0, s >> e);
    // row q of the group: bit e of q selects stride s >> (NS - 1 - e); a
    // pass within the CTA indexes its own shared memory (32-bit addresses)
    auto row_at = [&](int q) {
      int row = r0;
#pragma unroll
      for (int e = 0; e < NS; ++e)
        if ((q >> e) & 1) row |= s >> (NS - 1 - e);
      if constexpr (CROSS) {
        uint32_t* base = (row >> lg_rc) == rank ? sm : cluster.map_shared_rank(sm, row >> lg_rc);
        return base + swz(row & (rc - 1));
      } else {
        return sm + swz(row - rank * rc);
      }
    };
    uint32_t v[G][LANES];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const uint32_t* p = row_at(q);
#pragma unroll
      for (int l = 0; l < LANES; ++l) v[q][l] = l < lanes ? p[l * rc] : 0u;
    }
    const bool desc = (r0 & klev) != 0;
#pragma unroll
    for (int e = NS - 1; e >= 0; --e)  // largest stride first
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (((q >> e) & 1) == 0) exchange_regs<LANES>(v[q], v[q | (1 << e)], keys, desc);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      uint32_t* p = row_at(q);  // recomputed: no pointers held across the stages
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        if (l < lanes) p[l * rc] = v[q][l];
    }
  }
}

// One pass of up to NS strides from s down, reaching the other CTAs or not.
template <int LANES, int NS>
__device__ __forceinline__ void shared_passes(const cg::cluster_group& cluster, uint32_t* sm,
                                              int rc, int lanes, int keys, int rank, int klev,
                                              int s, int ns, bool cross) {
  if (ns == NS) {
    if (cross) shared_pass<LANES, NS, true>(cluster, sm, rc, lanes, keys, rank, klev, s);
    else shared_pass<LANES, NS, false>(cluster, sm, rc, lanes, keys, rank, klev, s);
  } else if constexpr (NS > 1) {
    shared_passes<LANES, NS - 1>(cluster, sm, rc, lanes, keys, rank, klev, s, ns, cross);
  }
}

// Copy the CTA's rows between device memory (lane stride N) and shared
// memory (row r at swz(r)), 16 bytes a thread at a time.  The device
// addresses are made opaque to the compiler, so that the final copy
// recomputes them instead of keeping the first copy's live across the sort
// (they spilled).
template <bool TO_SHARED>
__device__ __forceinline__ void copy_block(uint32_t* data, int64_t N, uint32_t* sm, int lanes,
                                           int rc) {
  asm volatile("" : "+l"(data), "+l"(N));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rc;
  for (int l = 0; l < lanes; ++l) {
    uint4* g = reinterpret_cast<uint4*>(data + l * N + base);
    uint4* s = reinterpret_cast<uint4*>(sm + l * rc);
    for (int t = threadIdx.x; t < rc / 4; t += blockDim.x) {
      if (TO_SHARED) s[swz(4 * t) / 4] = g[t];
      else g[t] = s[swz(4 * t) / 4];
    }
  }
}

// One block of `block` rows per cluster, rc = block / cluster rows per CTA.
template <int LANES, int KEYS>
__global__ void __launch_bounds__(cluster_threads(LANES), LANES <= 6 ? 2 : 1)
cluster_sort(uint32_t* __restrict__ data, int64_t N, int lanes_rt, int keys_rt, int block,
             int rc) {
  constexpr int C = 32 * rows_per_thread(LANES);
  constexpr int NS = pass_strides(LANES);
  extern __shared__ __align__(16) uint32_t cluster_sm[];
  uint32_t* sm = cluster_sm;
  const cg::cluster_group cluster = cg::this_cluster();
  const int lanes = KEYS > 0 ? LANES : lanes_rt;
  const int keys = KEYS > 0 ? KEYS : keys_rt;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = rank * rc;
  copy_block<true>(data, N, sm, lanes, rc);
  __syncthreads();
  sort_chunks<LANES>(sm, rc, lanes, keys, row0);
  bool crossed = false;  // the last pass wrote other CTAs' shared memory
#pragma unroll 1
  for (int klev = 2 * C; klev <= block; klev <<= 1) {
#pragma unroll 1
    for (int s = klev >> 1; s >= C;) {
      int ns = 1;
      while (ns < NS && (s >> ns) >= C) ++ns;
      const bool cross = s >= rc;
      if (cross || crossed) cluster.sync(); else __syncthreads();
      shared_passes<LANES, NS>(cluster, sm, rc, lanes, keys, rank, klev, s, ns, cross);
      crossed = cross;
      s >>= ns;
    }
    if (crossed) cluster.sync(); else __syncthreads();
    crossed = false;
    merge_chunks<LANES>(sm, rc, lanes, keys, row0, klev);
  }
  __syncthreads();
  copy_block<false>(data, N, sm, lanes, rc);
}

// The cluster launch for one (LANES, KEYS) instantiation.  Before the first
// launch of a configuration it asks how many such clusters the device can
// hold at once, and refuses a configuration that fits none.
template <int LANES, int KEYS>
cudaError_t sort_cluster(uint32_t* d, int64_t N, int lanes, int keys, int64_t block,
                         int cluster, int device, cudaStream_t st) {
  constexpr int R = rows_per_thread(LANES);
  const int rc = static_cast<int>(block / cluster);
  if (rc % (32 * R) != 0 || N / rc > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(lanes) * rc * sizeof(uint32_t);
  const int threads = rc / R < cluster_threads(LANES) ? rc / R : cluster_threads(LANES);
  auto* kernel = cluster_sort<LANES, KEYS>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N / rc));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int64_t checked = -1;  // the last configuration found to fit
  const int64_t key = (static_cast<int64_t>(device) << 40) |
                      (static_cast<int64_t>(smem) << 8) | cluster;
  cudaError_t err;
  if (key != checked) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel),
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    checked = key;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, d, N, lanes, keys, static_cast<int>(block), rc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// data: [lanes, N] int32/uint32, contiguous (16-byte aligned on the cluster
// route), sorted in place per block.  1 <= keys <= lanes; block a power of
// two >= 1024 dividing N.  cluster > 0 takes the cluster route with that
// many CTAs per block (a power of two <= 8, lanes <= 16, lanes · block · 4 /
// cluster bytes of shared memory per CTA); cluster == 0 the tiled route
// with `tile` rows per CTA (a power of two <= block whose lanes · tile · 4
// bytes the device grants).  Launches on `stream` of `device`; returns the
// first error code (cudaErrorInvalidConfiguration when no such cluster fits
// the device).
extern "C" int fk_sort_blocks(void* data, int64_t N, int lanes, int keys,
                              int64_t block, int tile, int cluster, int device,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (keys < 1 || keys > lanes || !pow2(block) || block < 1024 || N % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* d = static_cast<uint32_t*>(data);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster > 0) {
    if (!pow2(cluster) || cluster > kMaxCluster || lanes > kMaxClusterLanes ||
        reinterpret_cast<uintptr_t>(data) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (N == 0) return static_cast<int>(cudaSuccess);
    // the compactions sort W key lanes and a count (W <= 4 for k <= 64, the
    // sequence lane included); other shapes take run-time lane/key counts
    switch (lanes * 32 + keys) {
      case 2 * 32 + 1: err = sort_cluster<2, 1>(d, N, lanes, keys, block, cluster, device, st); break;
      case 3 * 32 + 2: err = sort_cluster<3, 2>(d, N, lanes, keys, block, cluster, device, st); break;
      case 4 * 32 + 3: err = sort_cluster<4, 3>(d, N, lanes, keys, block, cluster, device, st); break;
      case 5 * 32 + 4: err = sort_cluster<5, 4>(d, N, lanes, keys, block, cluster, device, st); break;
      default:
        if (lanes <= 3) err = sort_cluster<3, 0>(d, N, lanes, keys, block, cluster, device, st);
        else if (lanes <= 6) err = sort_cluster<6, 0>(d, N, lanes, keys, block, cluster, device, st);
        else err = sort_cluster<16, 0>(d, N, lanes, keys, block, cluster, device, st);
    }
    return static_cast<int>(err);
  }
  if (!pow2(tile) || tile < 2 || tile > block || N / tile > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  switch (lanes * 8 + keys) {
    case 2 * 8 + 1: err = sort_tiled<2, 1>(d, N, lanes, keys, block, tile, st); break;
    case 3 * 8 + 2: err = sort_tiled<3, 2>(d, N, lanes, keys, block, tile, st); break;
    case 4 * 8 + 3: err = sort_tiled<4, 3>(d, N, lanes, keys, block, tile, st); break;
    case 5 * 8 + 4: err = sort_tiled<5, 4>(d, N, lanes, keys, block, tile, st); break;
    default: err = sort_tiled<0, 0>(d, N, lanes, keys, block, tile, st);
  }
  return static_cast<int>(err);
}
