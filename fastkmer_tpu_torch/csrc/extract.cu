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
// does.  Output: W + 2 int32 columns of one [W + 2, R*P] buffer (words,
// bins, sigs) and `valid` as one byte per position in its own buffer.
//
// Bound: device-memory bytes, 1 B in and 4*(W+2) + 1 B out per position.
// What stood in the way was instructions: one thread per window start
// scanned k staged codes for validity and k - m + 1 staged norms for the
// window minimum, and packed every word of both orientations from 16 byte
// reads, twice; a 256-start tile carried a k - 1 halo.  The design makes
// the per-position work O(W):
//   * a block stages kFullStarts = 1024 window starts plus the halo, and
//     packs the forward 16-mer fw[j] and its reverse complement rw[j] once
//     per staged position (a rolling pack, one byte read each); word w of
//     the forward k-mer at i is fw[i + 16w] (the last one masked), of the
//     reverse complement rw[i + k - 16(w+1)] (the last one from rw[i]);
//   * validity in O(1): an exclusive block prefix count of codes >= 4,
//     valid(i) = cnt[i + k] == cnt[i];
//   * norms in O(1): the m-mer at j is fw[j] >> (32 - 2m);
//   * the window minimum in O(1) per start (van Herk / Gil-Werman): prefix
//     and suffix minima over segments of w = k - m + 1 norms, then
//     min(suf[i], pre[i + w - 1]);
//   * each thread takes starts t, t + 256, ..., so every warp stores 128
//     contiguous bytes per int32 column (32 per valid byte).

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

// Full mode: one block per kFullStarts window starts of one row, kFullThreads
// threads, each taking starts t, t + kFullThreads, ... (coalesced stores).
constexpr int kFullStarts = 1024;
constexpr int kFullThreads = 256;
constexpr int kFullWarps = kFullThreads / 32;

// Shared-memory layout of a full-mode block, in 32-bit words, then bytes.
// nF = kFullStarts + k - 1 packed 16-mers, nN = kFullStarts + k - m norms,
// nK = kFullStarts + k + 1 prefix counts, nC = kFullStarts + k + 14 codes.
struct FullLayout {
  int nF, nN, nK, nC;
  __host__ __device__ FullLayout(int k, int m)
      : nF(kFullStarts + k - 1), nN(kFullStarts + k - m), nK(kFullStarts + k + 1),
        nC(kFullStarts + k + 14) {}
  __host__ __device__ size_t words() const { return 2 * nF + 3 * nN + nK + kFullWarps; }
  __host__ __device__ size_t bytes() const { return 4 * words() + nC; }
};

__global__ void __launch_bounds__(kFullThreads)
extract_full_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                    int64_t tiles_per_row, int k, int m, uint32_t B, int W,
                    int32_t* __restrict__ out, uint8_t* __restrict__ valid_out,
                    int64_t n) {
  extern __shared__ uint32_t full_sm[];
  const FullLayout lay(k, m);
  uint32_t* fw = full_sm;        // fw[j]: bases j..j+15, first base high
  uint32_t* rw = fw + lay.nF;    // rw[j]: reverse complement of fw[j]
  uint32_t* nrm = rw + lay.nF;   // nrm[j]: norm of the m-mer at j
  uint32_t* pre = nrm + lay.nN;  // van Herk prefix minima of nrm per segment
  uint32_t* suf = pre + lay.nN;  // ... and suffix minima
  uint32_t* cnt = suf + lay.nN;  // cnt[j]: invalid codes in [0, j)
  uint32_t* wsum = cnt + lay.nK; // per-warp totals of the scan
  uint8_t* code = reinterpret_cast<uint8_t*>(wsum + kFullWarps);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kFullStarts;
  const uint8_t* src = codes + row * L;
  for (int j = tid; j < lay.nC; j += kFullThreads) {
    const int64_t c = start + j;
    code[j] = c < L ? src[c] : static_cast<uint8_t>(4);  // past the row: invalid
  }
  __syncthreads();

  // packed 16-mers, each thread over one run of positions (a rolling pack)
  {
    const int per = (lay.nF + kFullThreads - 1) / kFullThreads;
    const int j0 = tid * per;
    const int j1 = j0 + per < lay.nF ? j0 + per : lay.nF;
    uint32_t f = 0, r = 0;
    if (j0 < j1) {
      for (int p = j0; p < j0 + 15; ++p) {
        const uint32_t b = code[p] & 3u;
        f = (f << 2) | b;
        r = (r >> 2) | ((3u - b) << 30);
      }
    }
    for (int j = j0; j < j1; ++j) {
      const uint32_t b = code[j + 15] & 3u;
      f = (f << 2) | b;
      r = (r >> 2) | ((3u - b) << 30);
      fw[j] = f;
      rw[j] = r;
    }
  }
  // prefix counts of invalid codes: per-thread run sums, a block scan
  {
    const int nk = lay.nK - 1;  // codes counted
    const int per = (nk + kFullThreads - 1) / kFullThreads;
    const int j0 = tid * per;
    const int j1 = j0 + per < nk ? j0 + per : nk;
    uint32_t own = 0;
    for (int j = j0; j < j1; ++j) own += code[j] >= 4;
    uint32_t inc = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
      if ((tid & 31) >= d) inc += y;
    }
    if ((tid & 31) == 31) wsum[tid >> 5] = inc;
    __syncthreads();
    uint32_t run = inc - own;
    for (int w = 0; w < (tid >> 5); ++w) run += wsum[w];
    if (tid == 0) cnt[0] = 0;
    for (int j = j0; j < j1; ++j) {
      run += code[j] >= 4;
      cnt[j + 1] = run;
    }
  }
  __syncthreads();

  // m-mer norms from the packed 16-mers (m <= 15)
  for (int j = tid; j < lay.nN; j += kFullThreads) nrm[j] = norm_mmer(fw[j] >> (32 - 2 * m), m);
  __syncthreads();

  // van Herk / Gil-Werman: segments of w norms; task 2g scans segment g
  // forward, task 2g + 1 backward
  const int w = k - m + 1;
  const int nseg = (lay.nN + w - 1) / w;
  for (int q = tid; q < 2 * nseg; q += kFullThreads) {
    const int g0 = (q >> 1) * w;
    const int g1 = g0 + w < lay.nN ? g0 + w : lay.nN;
    if ((q & 1) == 0) {
      uint32_t run = nrm[g0];
      pre[g0] = run;
      for (int j = g0 + 1; j < g1; ++j) {
        run = min(run, nrm[j]);
        pre[j] = run;
      }
    } else {
      uint32_t run = nrm[g1 - 1];
      suf[g1 - 1] = run;
      for (int j = g1 - 2; j >= g0; --j) {
        run = min(run, nrm[j]);
        suf[j] = run;
      }
    }
  }
  __syncthreads();

  const int rem = k - 16 * (W - 1);  // bases in the last word, in [1, 16]
  const uint32_t last_mask = 0xFFFFFFFFu << (32 - 2 * rem);
  const uint32_t rc_low = rem < 16 ? (1u << (2 * rem)) - 1u : 0xFFFFFFFFu;
  for (int li = tid; li < kFullStarts; li += kFullThreads) {
    const int64_t i = start + li;
    if (i >= P) break;
    const int64_t o = row * P + i;
    // word wd of the forward k-mer, and of its reverse complement
    auto fword = [&](int wd) {
      const uint32_t v = fw[li + 16 * wd];
      return wd == W - 1 ? v & last_mask : v;
    };
    auto rword = [&](int wd) {
      if (wd < W - 1 || rem == 16) return rw[li + k - 16 * (wd + 1)];
      return (rw[li] & rc_low) << (32 - 2 * rem);
    };
    bool use_rc = false;  // the first differing word decides (palindromes keep fwd)
    for (int wd = 0; wd < W; ++wd) {
      const uint32_t f = fword(wd), r = rword(wd);
      if (f != r) {
        use_rc = r < f;
        break;
      }
    }
    for (int wd = 0; wd < W; ++wd)
      out[wd * n + o] = static_cast<int32_t>(use_rc ? rword(wd) : fword(wd));
    const uint32_t sig = min(suf[li], pre[li + w - 1]);
    out[W * n + o] = hash_to_bucket(sig, B);
    out[(W + 1) * n + o] = static_cast<int32_t>(sig);
    valid_out[o] = cnt[li + k] == cnt[li];
  }
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

// codes: [R, L] uint8, contiguous.  out: [W + 2, R * (L - k + 1)] int32
// (W word columns, bins, sigs); valid: [R * (L - k + 1)] uint8 (0 or 1).
// 4 <= m <= 15, m < k <= 256, B >= 1.  Launches on `stream` of `device` and
// returns the launch's error code.
extern "C" int fk_extract_full(const void* codes, int64_t R, int64_t L, int k,
                               int m, int B, void* out, void* valid, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (m < 1 || m > 15 || m >= k || k > 256 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (k + 15) / 16;
  const int64_t P = L - k + 1;
  if (R <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles_per_row = (P + kFullStarts - 1) / kFullStarts;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FullLayout(k, m).bytes();  // under 48 KB for k <= 256
  extract_full_kernel<<<static_cast<unsigned>(blocks), kFullThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, P, tiles_per_row, k, m,
      static_cast<uint32_t>(B), W, static_cast<int32_t*>(out),
      static_cast<uint8_t*>(valid), R * P);
  return static_cast<int>(cudaGetLastError());
}
