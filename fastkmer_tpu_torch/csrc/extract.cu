// Count-mode fused stage-1 extract for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastkmer_tpu/ops/pallas_extract.py
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
