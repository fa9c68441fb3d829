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
// Output: W (+1) columns of one [cols, R*P] int32 buffer, index r*P + i,
// written directly in the flat layout (no [R, L] staging and slice copy).
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
// Bound: device-memory bytes.  Count mode reads 1 B and writes 4*(W + flag)
// B per position (0.0448 ms at [4096, 4096] k=28 on an H100 at 3.35 TB/s);
// full mode writes 4*(W + 2) + 1 B.  What stands in the way is instructions:
// one thread per window start that scans k staged codes for validity and
// packs every word of both orientations from 16 byte reads does about 90
// shared-memory byte reads per position at k=28.  Both kernels therefore
// share one staged tile (StagedTile) and one word pick (KmerWords) that
// make the per-position work O(W):
//   * a block owns a tile of window starts of one row and stages its codes
//     with a k + 14 halo (code 4 past the row end, which makes the tail
//     mask of the Pallas kernel's circular roll unnecessary);
//   * it packs the forward 16-mer fw[j] and its reverse complement rw[j]
//     once per staged position, each thread over one run of positions (a
//     rolling pack, one byte read each); word w of the forward k-mer at i
//     is fw[i + 16w] (the last one masked), of the reverse complement
//     rw[i + k - 16(w+1)] (the last one from rw[i]);
//   * validity in O(1): an exclusive block prefix count of codes >= 4,
//     valid(i) = cnt[i + k] == cnt[i];
//   * up to four words (k <= 64) stay in registers from the orientation
//     test to the stores; count mode unrolls the loop over a block's starts
//     for each word count; both kernels keep to 32 registers a thread, so
//     eight blocks share an SM;
//   * each thread takes starts t, t + 256, ..., so every warp stores 128
//     contiguous bytes per int32 column (32 per valid byte).
// Full mode adds, on a tile of 1024 starts:
//   * norms in O(1): the m-mer at j is fw[j] >> (32 - 2m);
//   * the window minimum in O(1) per start (van Herk / Gil-Werman): prefix
//     and suffix minima over segments of w = k - m + 1 norms, then
//     min(suf[i], pre[i + w - 1]).
//
// Measured at [4096, 4096] on an NVIDIA H100 80GB HBM3 at its 700.00 W
// limit (chip_smoke.py phases 3 and 3b, PERF.md): full mode built to 40
// registers ran 6-7% slower at k = 97 and 155 than its build at 32.
// Count mode's configuration: 2048 starts a block for k <= 32 (at k=28
// about a fifth faster than 1024, whose staging and barriers weigh more
// per start) and 1024 above (2048 ran a fifth slower at k=155); plain
// stores, which ran 1% faster than streaming ones (__stcs) at k=28 and
// k=155; the tile of 16-mers packed at every position, not one of 16-base
// groups taken by funnel shifts (1 B of shared memory a base, but two
// loads and a shift for each word: 10% slower at k=28, 15% at k=155).
//
// A tile needs 13*(T + k) + 42 bytes of shared memory: count mode opts in
// past 48 KB, up to the 227 KB a Hopper block can have (k <= 16853).  Past
// that the wrapper routes by k to the byte route, extract_count_bytes_kernel:
// one thread per window start of a 256-start tile holding only its
// kByteTile + k - 1 codes (under 48 KB up to the wrapper's k <= 48897),
// each word packed from 16 byte reads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of a staged block (both modes)
constexpr int kWarps = kThreads / 32;
constexpr int kStarts = 1024;  // window starts of a full-mode block

// A block's staged tile of T window starts of one row.  Shared memory, in
// order: fw and rw (nF = T + k - 1 words each), cnt (nK = T + k + 1), the
// scan's kWarps totals, `extra` words of the kernel's own, then the
// nC = T + k + 14 codes.
struct StagedTile {
  int nF, nK, nC;
  uint32_t* fw;    // fw[j]: bases j..j+15, first base high
  uint32_t* rw;    // rw[j]: reverse complement of fw[j]
  uint32_t* cnt;   // cnt[j]: invalid codes in [0, j)
  uint32_t* wsum;  // per-warp totals of the scan
  uint32_t* extra;
  uint8_t* code;

  __host__ __device__ static size_t bytes(int T, int k, int n_extra) {
    return 4 * (2 * static_cast<size_t>(T + k - 1) + (T + k + 1) + kWarps + n_extra) +
           (T + k + 14);
  }
  __device__ StagedTile(uint32_t* sm, int T, int k, int n_extra)
      : nF(T + k - 1), nK(T + k + 1), nC(T + k + 14), fw(sm), rw(fw + nF), cnt(rw + nF),
        wsum(cnt + nK), extra(wsum + kWarps),
        code(reinterpret_cast<uint8_t*>(extra + n_extra)) {}

  // Stage the codes from `start` of a row of L codes at `src`, pack fw and
  // rw, count the invalid codes; ends on a barrier.
  __device__ void stage(const uint8_t* __restrict__ src, int64_t L, int64_t start) const {
    const int tid = threadIdx.x;
    for (int j = tid; j < nC; j += kThreads) {
      const int64_t c = start + j;
      code[j] = c < L ? src[c] : static_cast<uint8_t>(4);  // past the row: invalid
    }
    __syncthreads();

    // packed 16-mers, each thread over one run of positions (a rolling pack)
    {
      const int per = (nF + kThreads - 1) / kThreads;
      const int j0 = tid * per;
      const int j1 = j0 + per < nF ? j0 + per : nF;
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
      const int nk = nK - 1;  // codes counted
      const int per = (nk + kThreads - 1) / kThreads;
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
  }

  __device__ bool valid(int li, int k) const { return cnt[li + k] == cnt[li]; }
};

// The canonical k-mer at a tile's start li, word by word, from the packed
// 16-mers; the first differing word picks the orientation (palindromes
// keep the forward words).
struct KmerWords {
  const uint32_t* fw;
  const uint32_t* rw;
  int k, W, rem;  // rem: bases in the last word, in [1, 16]
  uint32_t last_mask, rc_low;

  __device__ KmerWords(const StagedTile& t, int k_, int W_)
      : fw(t.fw), rw(t.rw), k(k_), W(W_), rem(k_ - 16 * (W_ - 1)),
        last_mask(0xFFFFFFFFu << (32 - 2 * rem)),
        rc_low(rem < 16 ? (1u << (2 * rem)) - 1u : 0xFFFFFFFFu) {}

  __device__ uint32_t fwd(int li, int wd, bool last) const {
    const uint32_t v = fw[li + 16 * wd];
    return last ? v & last_mask : v;
  }
  __device__ uint32_t rc(int li, int wd, bool last) const {
    if (!last || rem == 16) return rw[li + k - 16 * (wd + 1)];
    return (rw[li] & rc_low) << (32 - 2 * rem);
  }

  // put(wd, word) for every word of the canonical k-mer at li: held in
  // registers between the comparison and the stores for kW = 1..4 words
  // (k <= 64), read twice for any W when kW = 0.
  template <int kW, class Put>
  __device__ void words(int li, Put put) const {
    if constexpr (kW > 0) {
      uint32_t f[kW], r[kW];
#pragma unroll
      for (int wd = 0; wd < kW; ++wd) {
        f[wd] = fwd(li, wd, wd == kW - 1);
        r[wd] = rc(li, wd, wd == kW - 1);
      }
      bool flip = false;  // set last by the first differing word
#pragma unroll
      for (int wd = kW - 1; wd >= 0; --wd)
        if (f[wd] != r[wd]) flip = r[wd] < f[wd];
#pragma unroll
      for (int wd = 0; wd < kW; ++wd) put(wd, flip ? r[wd] : f[wd]);
    } else {
      bool flip = false;
      for (int wd = 0; wd < W; ++wd) {
        const uint32_t f = fwd(li, wd, wd == W - 1), r = rc(li, wd, wd == W - 1);
        if (f != r) {
          flip = r < f;
          break;
        }
      }
      for (int wd = 0; wd < W; ++wd)
        put(wd, flip ? rc(li, wd, wd == W - 1) : fwd(li, wd, wd == W - 1));
    }
  }
  // the same, W looked up at each start
  template <class Put>
  __device__ void canonical(int li, Put put) const {
    switch (W) {
      case 1: return words<1>(li, put);
      case 2: return words<2>(li, put);
      case 3: return words<3>(li, put);
      case 4: return words<4>(li, put);
      default: return words<0>(li, put);
    }
  }
};

// Count mode, the starts of a staged tile of kT, for k-mers of kW words
// (0: any).
template <int kT, int kW>
__device__ __forceinline__ void count_starts(const StagedTile& t, int k, int W, int flag,
                                             int64_t start, int64_t P,
                                             int32_t* __restrict__ row_out, int64_t n) {
  const KmerWords kw(t, k, W);
#pragma unroll
  for (int li = threadIdx.x; li < kT; li += kThreads) {
    if (start + li >= P) break;
    int32_t* o = row_out + start + li;
    if (!t.valid(li, k)) {
      for (int c = 0; c < W + flag; ++c) o[c * n] = -1;
      continue;
    }
    kw.words<kW>(li, [&](int wd, uint32_t v) { o[wd * n] = static_cast<int32_t>(v); });
    if (flag) o[W * n] = 0;
  }
}

// Count mode: one block per kT window starts of one row.
template <int kT>
__global__ void __launch_bounds__(kThreads, 8)
extract_count_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                     int64_t tiles_per_row, int k, int W, int flag,
                     int32_t* __restrict__ out, int64_t n) {
  extern __shared__ uint32_t count_sm[];
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kT;
  const StagedTile t(count_sm, kT, k, 0);
  t.stage(codes + row * L, L, start);
  int32_t* row_out = out + row * P;
  switch (W) {
    case 1: return count_starts<kT, 1>(t, k, W, flag, start, P, row_out, n);
    case 2: return count_starts<kT, 2>(t, k, W, flag, start, P, row_out, n);
    case 3: return count_starts<kT, 3>(t, k, W, flag, start, P, row_out, n);
    case 4: return count_starts<kT, 4>(t, k, W, flag, start, P, row_out, n);
    default: return count_starts<kT, 0>(t, k, W, flag, start, P, row_out, n);
  }
}

// The byte route (k past a staged tile's shared memory): one thread per
// window start of a kByteTile-start tile.
constexpr int kByteTile = 256;

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

__global__ void __launch_bounds__(kByteTile)
extract_count_bytes_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                           int64_t tiles_per_row, int k, int W, int flag,
                           int32_t* __restrict__ out, int64_t n) {
  extern __shared__ uint8_t tile[];  // kByteTile + k - 1 codes
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kByteTile;
  const uint8_t* src = codes + row * L;
  const int span = kByteTile + k - 1;
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

// Full mode: one block per kStarts window starts of one row, eight blocks
// an SM.  Its own shared words: norms, prefix and suffix minima,
// nN = kStarts + k - m each.
__global__ void __launch_bounds__(kThreads, 8)
extract_full_kernel(const uint8_t* __restrict__ codes, int64_t L, int64_t P,
                    int64_t tiles_per_row, int k, int m, uint32_t B, int W,
                    int32_t* __restrict__ out, uint8_t* __restrict__ valid_out,
                    int64_t n) {
  extern __shared__ uint32_t full_sm[];
  const int nN = kStarts + k - m;
  const StagedTile t(full_sm, kStarts, k, 3 * nN);
  uint32_t* nrm = t.extra;  // nrm[j]: norm of the m-mer at j
  uint32_t* pre = nrm + nN; // van Herk prefix minima of nrm per segment
  uint32_t* suf = pre + nN; // ... and suffix minima
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t start = (blockIdx.x % tiles_per_row) * kStarts;
  t.stage(codes + row * L, L, start);

  // m-mer norms from the packed 16-mers (m <= 15)
  for (int j = tid; j < nN; j += kThreads) nrm[j] = norm_mmer(t.fw[j] >> (32 - 2 * m), m);
  __syncthreads();

  // van Herk / Gil-Werman: segments of w norms; task 2g scans segment g
  // forward, task 2g + 1 backward
  const int w = k - m + 1;
  const int nseg = (nN + w - 1) / w;
  for (int q = tid; q < 2 * nseg; q += kThreads) {
    const int g0 = (q >> 1) * w;
    const int g1 = g0 + w < nN ? g0 + w : nN;
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

  const KmerWords kw(t, k, W);
  for (int li = tid; li < kStarts; li += kThreads) {
    const int64_t i = start + li;
    if (i >= P) break;
    const int64_t o = row * P + i;
    kw.canonical(li, [&](int wd, uint32_t v) { out[wd * n + o] = static_cast<int32_t>(v); });
    const uint32_t sig = min(suf[li], pre[li + w - 1]);
    out[W * n + o] = hash_to_bucket(sig, B);
    out[(W + 1) * n + o] = static_cast<int32_t>(sig);
    valid_out[o] = t.valid(li, k);
  }
}

// Count mode's staged kernel at kT starts a block.
template <int kT>
cudaError_t launch_count(const uint8_t* codes, int64_t R, int64_t L, int k, int flag,
                         int32_t* out, cudaStream_t stream) {
  const int W = (k + 15) / 16;
  const int64_t P = L - k + 1;
  const int64_t tiles_per_row = (P + kT - 1) / kT;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = StagedTile::bytes(kT, k, 0);
  if (smem > 48 * 1024) {  // opt in to more than the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        extract_count_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  extract_count_kernel<kT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      codes, L, P, tiles_per_row, k, W, flag, out, R * P);
  return cudaGetLastError();
}

}  // namespace

// codes: [R, L] uint8, contiguous.  out: [W + flag, R * (L - k + 1)] int32.
// The staged route: 2048 starts a block for k <= 32, else 1024; its shared
// memory must fit the device's opt-in limit (k <= 16853).  Launches on
// `stream` of `device` and returns the launch's error code
// (cudaGetLastError(), 0 on success).
extern "C" int fk_extract_count(const void* codes, int64_t R, int64_t L, int k,
                                int flag, void* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (R <= 0 || L - k + 1 <= 0) return static_cast<int>(cudaSuccess);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = k <= 32 ? launch_count<2 * kStarts>(c, R, L, k, flag, o, s)
                                : launch_count<kStarts>(c, R, L, k, flag, o, s);
  return static_cast<int>(e);
}

// The byte route, same arguments and outputs: kByteTile + k - 1 bytes of
// shared memory a block, k <= 48897.
extern "C" int fk_extract_count_bytes(const void* codes, int64_t R, int64_t L, int k,
                                      int flag, void* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int W = (k + 15) / 16;
  const int64_t P = L - k + 1;
  if (R <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles_per_row = (P + kByteTile - 1) / kByteTile;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kByteTile + k - 1);
  extract_count_bytes_kernel<<<static_cast<unsigned>(blocks), kByteTile, smem,
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
  const int64_t tiles_per_row = (P + kStarts - 1) / kStarts;
  const int64_t blocks = R * tiles_per_row;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // under 48 KB for k <= 256
  const size_t smem = StagedTile::bytes(kStarts, k, 3 * (kStarts + k - m));
  extract_full_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, P, tiles_per_row, k, m,
      static_cast<uint32_t>(B), W, static_cast<int32_t*>(out),
      static_cast<uint8_t*>(valid), R * P);
  return static_cast<int>(cudaGetLastError());
}
