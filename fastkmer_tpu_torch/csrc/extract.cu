// Fused stage-1 extract for Hopper (sm_90a): count mode and full mode.
//
// Count mode replaces the Pallas TPU kernel fastkmer_tpu/ops/pallas_extract.py
// _mk_kernel(mode="count"), reached through extract_pallas_sentinel.  For
// every window start i < P = L - k + 1 of each row of 2-bit codes
// (0..3 bases, >= 4 invalid or padding) it writes the canonical k-mer as
// W = ceil(k / 16) big-endian 2-bit-packed uint32 words: the forward or the
// reverse-complement word tuple, whichever is lexicographically smaller.  A
// window holding any code >= 4 gets the all-ones sentinel in every word.
// With `flag` set, a trailing lane holds 0 on valid windows and all-ones on
// invalid ones (k % 16 == 0, where an all-T k-mer equals the bare sentinel).
//
// Output: W (+1) columns of one [cols, R*P] int32 buffer, index r*P + i,
// written directly in the flat layout (no [R, L] staging and slice copy).
//
// Bound: device-memory bytes.  Each position reads 1 B of codes and writes
// 4*W B of words, and the arithmetic per position is a few dozen integer
// ops.  The tiling keeps the read side at one pass: a block owns kTile
// window starts of one row and stages its kTile + k - 1 codes (the tile
// plus a k - 1 halo) in shared memory with coalesced byte loads, so the
// k-fold reuse of every base across overlapping windows hits shared
// memory, not device memory.  Writes are coalesced: neighbouring threads
// own neighbouring window starts, so each warp stores 128 contiguous bytes
// per column.  Bases past the row end are staged as invalid, which makes
// the tail mask of the Pallas kernel's circular roll unnecessary.  This
// first version still packs every word from shared memory one base at a
// time (up to k + 48 byte reads per position), so it runs on instructions
// well above the byte floor; PERF.md has its measured share of that floor.
//
// Full mode replaces _mk_kernel(mode="full"), reached through extract_pallas
// (the mesh's stage-1 extractor).  Per window start it also writes
//   sigs(i)  = min over j in [i, i+k-m] of norm(m-mer at j), where norm is
//              min(v if allowed else 4^m, rc(v) if allowed else 4^m) with
//              KMC2's allowed rule (no "AA" pair, no "ACA" prefix);
//   bins(i)  = hash_to_bucket(sigs(i), B), in [0, B) at every position;
//   valid(i) = 1 when no code >= 4 lies in [i, i+k), else 0;
// and the W canonical words at every position (meaningful where valid).
// Bases are taken as code & 3, invalid ones included, as the Pallas kernel
// does.  Output: W + 3 int32 columns of one [W + 3, R*P] buffer.
//
// Bound: the same byte stream (1 B in, 4*(W+3) B out per position) but more
// instructions: a window minimum over w = k - m + 1 norms.  Each m-mer norm
// is computed once per block, not once per window that holds it: the block
// stages the kTile + k - m norms of its tile in shared memory beside the
// kTile + k - 1 codes, then every thread takes its minimum over w staged
// norms (O(k) shared-memory reads per position instead of O(k*m) work).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // window starts per block, one per thread

// Word `wd` of the forward k-mer starting at s[0]; the last word is
// zero-padded in its low bits.
__device__ __forceinline__ uint32_t fwd_word(const uint8_t* s, int k, int wd) {
  uint32_t v = 0;
  const int base = 16 * wd;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int p = base + j;
    v = (v << 2) | (p < k ? static_cast<uint32_t>(s[p] & 3) : 0u);
  }
  return v;
}

// Word `wd` of the reverse complement: position p holds comp(s[k-1-p]).
__device__ __forceinline__ uint32_t rc_word(const uint8_t* s, int k, int wd) {
  uint32_t v = 0;
  const int base = 16 * wd;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int p = base + j;
    v = (v << 2) | (p < k ? 3u - static_cast<uint32_t>(s[k - 1 - p] & 3) : 0u);
  }
  return v;
}

__global__ void __launch_bounds__(kTile)
extract_count_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                     int64_t tiles_per_row, int k, int W, int flag,
                     int32_t* __restrict__ out, int64_t n) {
  extern __shared__ uint8_t tile[];  // kTile + k - 1 codes
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kTile;
  const uint8_t* src = codes + row * L;
  const int span = kTile + k - 1;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int64_t c = start + j;
    tile[j] = c < L ? src[c] : static_cast<uint8_t>(4);
  }
  __syncthreads();

  const int64_t i = start + threadIdx.x;
  if (i >= P) return;
  const uint8_t* s = tile + threadIdx.x;
  int32_t* o = out + row * P + i;

  bool valid = true;
  for (int p = 0; p < k; ++p) {
    if (s[p] >= 4) {
      valid = false;
      break;
    }
  }
  if (!valid) {
    for (int c = 0; c < W + flag; ++c) o[c * n] = -1;
    return;
  }

  // orientation: the first differing word decides (palindromes keep fwd)
  bool use_rc = false;
  for (int wd = 0; wd < W; ++wd) {
    const uint32_t f = fwd_word(s, k, wd);
    const uint32_t r = rc_word(s, k, wd);
    if (f != r) {
      use_rc = r < f;
      break;
    }
  }
  for (int wd = 0; wd < W; ++wd) {
    const uint32_t v = use_rc ? rc_word(s, k, wd) : fwd_word(s, k, wd);
    o[wd * n] = static_cast<int32_t>(v);
  }
  if (flag) o[W * n] = 0;
}

// Reverse the sixteen 2-bit fields of x.
__device__ __forceinline__ uint32_t swap_fields(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

// KMC2 allowed filter (fastkmer_tpu/core/jbits.py allowed_mask).
__device__ __forceinline__ bool allowed(uint32_t v, int m) {
  const uint32_t y = v | (v >> 2);
  const uint32_t t = (y | (y >> 1)) & 0x55555555u;
  const uint32_t pairmask = 0x55555555u & ((1u << (2 * (m - 1))) - 1u);
  const bool no_aa = (t & pairmask) == pairmask;
  return m >= 3 ? no_aa && (v >> (2 * m - 6)) != 0x4u : no_aa;
}

// norm(v) = min(v if allowed else 4^m, rc(v) if allowed else 4^m), m <= 15.
__device__ __forceinline__ uint32_t norm_mmer(uint32_t v, int m) {
  const uint32_t sentinel = 1u << (2 * m);
  const uint32_t rc = swap_fields(v ^ (sentinel - 1u)) >> (32 - 2 * m);
  const uint32_t a = allowed(v, m) ? v : sentinel;
  const uint32_t b = allowed(rc, m) ? rc : sentinel;
  return a < b ? a : b;
}

// Signature -> bin (fastkmer_tpu/core/jbits.py hash_to_bucket), in [0, B).
__device__ __forceinline__ int32_t hash_to_bucket(uint32_t key, uint32_t B) {
  key = (key ^ 61u) ^ (key >> 16);
  key = key + (key << 3);
  key = key ^ (key >> 4);
  key = key * 0x27D4EB2Du;
  key = key ^ (key >> 15);
  return static_cast<int32_t>((key & 0x7FFFFFFFu) % B);
}

__global__ void __launch_bounds__(kTile)
extract_full_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                    int64_t tiles_per_row, int k, int m, uint32_t B, int W,
                    int32_t* __restrict__ out, int64_t n) {
  // kTile + k - m m-mer norms, then kTile + k - 1 codes
  extern __shared__ uint32_t staged[];
  const int n_norms = kTile + k - m;
  uint32_t* norms = staged;
  uint8_t* tile = reinterpret_cast<uint8_t*>(staged + n_norms);
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kTile;
  const uint8_t* src = codes + row * L;
  const int span = kTile + k - 1;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int64_t c = start + j;
    tile[j] = c < L ? src[c] : static_cast<uint8_t>(4);
  }
  __syncthreads();
  // each m-mer's norm once per block; m-mers reaching past the row end
  // feed only window starts >= P, which are not written
  for (int j = threadIdx.x; j < n_norms; j += blockDim.x) {
    uint32_t v = 0;
    for (int p = 0; p < m; ++p) v = (v << 2) | (tile[j + p] & 3u);
    norms[j] = norm_mmer(v, m);
  }
  __syncthreads();

  const int64_t i = start + threadIdx.x;
  if (i >= P) return;
  const uint8_t* s = tile + threadIdx.x;
  int32_t* o = out + row * P + i;

  int32_t valid = 1;
  for (int p = 0; p < k; ++p) {
    if (s[p] >= 4) {
      valid = 0;
      break;
    }
  }
  uint32_t sig = norms[threadIdx.x];
  for (int j = 1; j <= k - m; ++j) {
    const uint32_t v = norms[threadIdx.x + j];
    sig = v < sig ? v : sig;
  }

  bool use_rc = false;
  for (int wd = 0; wd < W; ++wd) {
    const uint32_t f = fwd_word(s, k, wd);
    const uint32_t r = rc_word(s, k, wd);
    if (f != r) {
      use_rc = r < f;
      break;
    }
  }
  for (int wd = 0; wd < W; ++wd) {
    const uint32_t v = use_rc ? rc_word(s, k, wd) : fwd_word(s, k, wd);
    o[wd * n] = static_cast<int32_t>(v);
  }
  o[W * n] = hash_to_bucket(sig, B);
  o[(W + 1) * n] = static_cast<int32_t>(sig);
  o[(W + 2) * n] = valid;
}

}  // namespace

// codes: [R, L] uint8, contiguous.  out: [W + flag, R * (L - k + 1)] int32.
// Launches on `stream` of `device` and returns the launch's error code
// (cudaGetLastError(), 0 on success).
extern "C" int fk_extract_count(const void* codes, int64_t R, int64_t L, int k,
                                int flag, void* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int W = (k + 15) / 16;
  const int64_t P = L - k + 1;
  if (R <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles_per_row = (P + kTile - 1) / kTile;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTile + k - 1);
  extract_count_kernel<<<static_cast<unsigned>(blocks), kTile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, P, tiles_per_row, k, W, flag,
      static_cast<int32_t*>(out), R * P);
  return static_cast<int>(cudaGetLastError());
}

// codes: [R, L] uint8, contiguous.  out: [W + 3, R * (L - k + 1)] int32
// (W word columns, bins, sigs, valid).  4 <= m <= 15, m < k, B >= 1.
// Launches on `stream` of `device` and returns the launch's error code.
extern "C" int fk_extract_full(const void* codes, int64_t R, int64_t L, int k,
                               int m, int B, void* out, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (m < 1 || m > 15 || m >= k || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (k + 15) / 16;
  const int64_t P = L - k + 1;
  if (R <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles_per_row = (P + kTile - 1) / kTile;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(kTile + k - m) +
                      static_cast<size_t>(kTile + k - 1);
  extract_full_kernel<<<static_cast<unsigned>(blocks), kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, P, tiles_per_row, k, m,
      static_cast<uint32_t>(B), W, static_cast<int32_t*>(out), R * P);
  return static_cast<int>(cudaGetLastError());
}
