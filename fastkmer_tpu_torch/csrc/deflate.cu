// Deflate of counts.npz's members on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes counts.npz with
// np.savez_compressed, one zlib thread on the host, and the port's host
// path deflates in blocks on every core (output/npz.py).  Both leave the
// card idle while the host compresses 134 MB at some 10-95 MB/s a core;
// this kernel takes the write's deflate onto the card.  The stream it
// writes, rule for rule, is the one output/cuda_deflate.py documents and
// whose plain version it holds byte for byte: segments of kSeg input bytes,
// each one dynamic block (or stored blocks, where shorter) that may match
// into the kWin bytes before it and ends on a byte.
//
// Bound on this card: device-memory bytes, the piece read once (hashes and
// matches come from L1/L2) and the compressed bytes written once, some
// 0.06 ms for the 134 MB of the benchmark's table at 3.35 TB/s.  What keeps
// it far from that is that LZ77 and the parse are serial by nature; the
// design spreads them:
//
// * chain_kernel, one CTA a 64 KiB range of a member: prev[x], the
//   distance to the latest earlier position of x's hash (within kWin), is
//   a serial scan over positions.  The kWin bytes before the range only
//   need each hash's latest position, a max, so the CTA's threads insert
//   them into a 128 KB head table in shared memory order-free
//   (atomicMax).  Then one warp scans the range 32 positions a step, each
//   lane's hashes loaded kAhead steps ahead so that a step waits on shared
//   memory alone: __match_any_sync finds the lanes of a step that share a
//   hash, so a lane's predecessor is the nearest lower lane of its group
//   or, for the lowest, the table, and the highest lane of each group
//   writes the table.
// * encode_kernel, one CTA of kOwners threads a segment: the lazy parse is
//   a chain p -> next(p) through the segment, serial too.  Each thread owns
//   kSub bytes and walks the chain from its first byte as if a token
//   started there, marking token starts in a bitmap.  Then, in rounds, a
//   thread whose entry (the exit of the thread before it) differs from the
//   one it walked from walks again from the true entry until its new path
//   meets the old one, clearing the old marks it passes; two walks that
//   meet go on alike, so a round's walks are short, and the rounds end when
//   no entry changes: the marks are then exactly the sequential parse's.
//   Matches are found where a walk needs them (find: a chain walk over
//   prev with 4-byte compares) and each taken match is kept in memo for
//   the passes after the parse.  Then, from the marks: histograms (shared
//   atomics), the Huffman codes (ranks in parallel, the tree on one
//   thread), each thread's token bits, their prefix sum, and the packing:
//   each thread writes its tokens' bits at its offset, whole words owned by
//   one thread as plain stores and the two words it shares with its
//   neighbours with atomicOr.  The segment's CRC-32 is each thread's bytes'
//   CRC, combined in order.
// * gather_kernel, one CTA a segment: its offset is the sum of the sizes
//   before it; it copies its bytes there; CTA 0 folds the segments' CRCs
//   into their members' running CRCs.
//
// One launch of the three takes a piece: up to a fixed number of segments
// of one or more members (a table of segments and of chain ranges), so the
// card's scratch is bounded and the members' segments share its SMs.
//
// The output depends on the member's bytes alone: no atomics decide an
// order (the shared-memory atomics are sums, maxes or disjoint ORs), and
// the segment size, hash, chain limit and lazy rule are constants.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 1 << 16;          // input bytes a segment
constexpr int kWin = 1 << 15;          // the farthest a match reaches back
constexpr int kHashSize = 1 << 15;     // hash values
constexpr int kChain = 16;             // candidates a match search walks
constexpr int kLazy = 32;              // a match this long is taken at once
constexpr int kTooFar = 4096;          // a 3-byte match farther back is none
constexpr int kMaxMatch = 258;
constexpr int kStoredMax = 65535;      // bytes a stored block holds
constexpr int kOwners = 128;           // threads of a segment's CTA
constexpr int kSub = kSeg / kOwners;   // bytes a thread owns in the parse
constexpr int kOutStride = kSeg + 64;  // bytes of output a segment may take
constexpr int kGather = 256;           // threads of a gather CTA
constexpr int kChainThreads = 256;     // threads of a chain CTA (one warp scans)
constexpr int kAhead = 8;              // hashes a lane loads ahead in the chain scan
constexpr uint32_t kPoly = 0xedb88320u;

__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                   11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The 4 bytes at i, little-endian; the buffer is 4-byte aligned and has 8
// readable bytes past its end.
__device__ __forceinline__ uint32_t load4(const uint8_t* buf, int64_t i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (i >> 2);
  return __funnelshift_r(__ldg(w), __ldg(w + 1), static_cast<int>(i & 3) * 8);
}

__device__ __forceinline__ uint32_t hash3(const uint8_t* buf, int64_t x) {
  const uint32_t v = load4(buf, x);
  return (((v & 0xff) << 10) ^ (((v >> 8) & 0xff) << 5) ^ ((v >> 16) & 0xff)) & (kHashSize - 1);
}

__device__ __forceinline__ int lcode(int n) {
  if (n == kMaxMatch) return 28;
  const int x = n - 3;
  if (x < 8) return x;
  const int top = 31 - __clz(x);
  return 4 * (top - 1) + ((x >> (top - 2)) & 3);
}
__device__ __forceinline__ int lbase(int c) {
  return c == 28 ? kMaxMatch : c < 8 ? c + 3 : 3 + ((4 + (c & 3)) << ((c >> 2) - 1));
}
__device__ __forceinline__ int lext(int c) { return c < 8 || c == 28 ? 0 : (c >> 2) - 1; }
__device__ __forceinline__ int dcode(int d) {
  const int x = d - 1;
  if (x < 4) return x;
  const int top = 31 - __clz(x);
  return 2 * top + ((x >> (top - 1)) & 1);
}
__device__ __forceinline__ int dbase(int c) {
  return c < 4 ? c + 1 : 1 + ((2 + (c & 1)) << ((c >> 1) - 1));
}
__device__ __forceinline__ int dext(int c) { return c < 4 ? 0 : (c >> 1) - 1; }

// a * b modulo CRC-32's polynomial, reflected (zlib's multmodp)
__device__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = b & 1 ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// x^(8 n) modulo the polynomial
__device__ uint32_t xpow8n(int64_t n) {
  uint32_t p = 1u << 31, sq = 1u << 23;
  while (n) {
    if (n & 1) p = multmodp(sq, p);
    sq = multmodp(sq, sq);
    n >>= 1;
  }
  return p;
}

// --- chains ------------------------------------------------------------------

// Ranges: a 64 KiB block [a, b) of a member's bytes in the buffer, whose
// hashes stop at hi (the member's bytes there end) and whose inserts start
// no lower than lo (the member's first byte there).
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const uint8_t* __restrict__ buf, const int64_t* __restrict__ ranges, int nranges,
             uint16_t* __restrict__ prev) {
  extern __shared__ uint32_t head[];  // a hash's latest position - ins + 1; 0: none
  const int tid = threadIdx.x, lane = tid & 31, r = blockIdx.x;
  const int64_t a = ranges[r], b = ranges[nranges + r];
  const int64_t lo = ranges[2 * nranges + r], hi = ranges[3 * nranges + r];
  const int64_t ins = a - kWin > lo ? a - kWin : lo;
  for (int i = tid; i < kHashSize; i += kChainThreads) head[i] = 0;
  __syncthreads();
  // the kWin bytes before the range: only each hash's latest position
  // matters, and a max is order-free
  for (int64_t x0 = ins + tid; x0 < a; x0 += kChainThreads * kAhead) {
    uint32_t h[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int64_t x = x0 + j * kChainThreads;
      h[j] = x < a && x + 3 <= hi ? hash3(buf, x) : kHashSize;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (h[j] < kHashSize)
        atomicMax(&head[h[j]], static_cast<uint32_t>(x0 + j * kChainThreads - ins + 1));
  }
  __syncthreads();
  if (tid >= 32) return;
  // the range, 32 positions a step in order; each lane's hashes are loaded
  // kAhead steps at a time, so the steps wait on shared memory alone
  for (int64_t base = a; base < b; base += 32 * kAhead) {
    uint32_t hs[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int64_t x = base + 32 * j + lane;
      hs[j] = x < b && x + 3 <= hi ? hash3(buf, x) : kHashSize + lane;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int64_t x = base + 32 * j + lane;
      const uint32_t h = hs[j];
      const bool ok = h < kHashSize;
      const uint32_t group = __match_any_sync(0xffffffffu, h);
      if (ok) {
        const uint32_t lower = group & ((1u << lane) - 1);
        int64_t d = 0;
        if (lower) {
          d = lane - (31 - __clz(lower));
        } else if (head[h]) {
          d = x - (ins + head[h] - 1);
        }
        prev[x] = static_cast<uint16_t>(d <= kWin ? d : 0);
      } else if (x < b) {
        prev[x] = 0;
      }
      __syncwarp();
      if (ok && lane == 31 - __clz(group)) head[h] = static_cast<uint32_t>(x - ins + 1);
      __syncwarp();
    }
  }
}

// --- the parse ---------------------------------------------------------------

struct Segment {
  const uint8_t* buf;
  const uint16_t* prev;
  uint32_t* memo;  // (length << 16 | distance) of each match taken, by position
  int64_t s, e;
};

__device__ int match_len(const uint8_t* buf, int64_t q, int64_t p, int most) {
  int n = 0;
  while (n < most) {
    const uint32_t x = load4(buf, q + n) ^ load4(buf, p + n);
    if (x) return min(n + ((__ffs(x) - 1) >> 3), most);
    n += 4;
  }
  return most;
}

// (length << 16 | distance) of the match at p, 0 for none
__device__ uint32_t find(const Segment& g, int64_t p) {
  const int most = static_cast<int>(min64(kMaxMatch, g.e - p));
  if (most < 3) return 0;
  uint32_t d = __ldg(g.prev + p);
  if (!d) return 0;
  int64_t q = p - d;
  int best = 0;
  int64_t dist = 0;
  for (int c = 0; c < kChain; ++c) {
    d = __ldg(g.prev + q);  // loaded beside the bytes at q, not after them
    const int n = match_len(g.buf, q, p, most);
    if (n > best) {
      best = n;
      dist = p - q;
      if (best >= most) break;
    }
    if (!d) break;
    q -= d;
    if (p - q > kWin) break;
  }
  if (best < 3 || (best == 3 && dist > kTooFar)) return 0;
  return (static_cast<uint32_t>(best) << 16) | static_cast<uint32_t>(dist);
}

// A thread's walks through its bytes [ra, rb) of the segment (positions
// relative to its start), marking token starts in the shared bitmap.
struct Walker {
  Segment g;
  uint32_t* bits;
  int ra, rb;
  int64_t ahead = -1;  // the position find ran at last for the lazy look
  uint32_t ahead_m = 0;

  __device__ int64_t next(int64_t p) {
    const uint32_t m = p == ahead ? ahead_m : find(g, p);
    const int n = static_cast<int>(m >> 16);
    if (n < 3) return p + 1;
    if (n < kLazy && p + 1 < g.e) {
      ahead = p + 1;
      ahead_m = find(g, p + 1);
      if (static_cast<int>(ahead_m >> 16) > n) return p + 1;
    }
    g.memo[p] = m;
    return p + n;
  }
  __device__ int next_set(int r) const {  // first mark in [r, rb), else rb
    if (r >= rb) return rb;
    int w = r >> 5;
    uint32_t word = bits[w] & (~0u << (r & 31));
    for (;;) {
      if (word) {
        const int at = (w << 5) + __ffs(word) - 1;
        return at < rb ? at : rb;
      }
      if (++w << 5 >= rb) return rb;
      word = bits[w];
    }
  }
  __device__ void set(int r) { bits[r >> 5] |= 1u << (r & 31); }
  __device__ void clear(int r) { bits[r >> 5] &= ~(1u << (r & 31)); }

  // Walk from entry n; the marks in [ra, rb) are the walk from the last
  // entry, whose exit was `exit`.  Returns the new exit.
  __device__ int walk(int n, int exit) {
    int o = next_set(ra);
    for (;;) {
      if (n >= rb) {
        for (; o < rb; o = next_set(o + 1)) clear(o);
        return n;
      }
      if (o < n) {
        clear(o);
        o = next_set(o + 1);
      } else if (o == n) {
        return exit;
      } else {
        set(n);
        n = static_cast<int>(next(g.s + n) - g.s);
      }
    }
  }
};

// Canonical codes of `len`, bit-reversed for LSB-first packing.
__device__ void canonical(const uint8_t* len, int n, uint16_t* code) {
  int count[16] = {0};
  for (int i = 0; i < n; ++i) ++count[len[i]];
  count[0] = 0;
  int nxt[16], c = 0;
  for (int b = 1; b < 16; ++b) {
    c = (c + count[b - 1]) << 1;
    nxt[b] = c;
  }
  for (int i = 0; i < n; ++i)
    if (len[i]) code[i] = static_cast<uint16_t>(__brev(nxt[len[i]]++) >> (32 - len[i]));
}

// Code lengths (at most `limit` bits) for the n frequencies f; every thread
// of the CTA calls it.  order, w (2n) and parent (2n) are scratch.
// Inlined, its pointers stay in shared memory's address space: thread 0's
// serial loops here lie on every CTA's critical path.
__device__ void huffman(const uint32_t* f, int n, int limit, uint8_t* len, uint16_t* order,
                        uint32_t* w, uint16_t* parent) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    len[i] = 0;
    const uint32_t fi = f[i];
    if (fi) {
      int r = 0;
      for (int j = 0; j < n; ++j) {
        const uint32_t fj = f[j];
        r += fj && (fj < fi || (fj == fi && j < i));
      }
      order[r] = static_cast<uint16_t>(i);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i) m += f[i] != 0;
    if (m < 2) {  // two codes of one bit: the used symbol and the lowest unused
      int have = m;
      if (m == 1) len[order[0]] = 1;
      for (int i = 0; i < n && have < 2; ++i)
        if (!f[i]) {
          len[i] = 1;
          ++have;
        }
    } else {
      for (int i = 0; i < m; ++i) w[i] = f[order[i]];
      int leaf = 0, node = m, made = m;
      for (int k = 0; k < m - 1; ++k) {
        int x[2];
        for (int t = 0; t < 2; ++t)
          x[t] = leaf < m && (node >= made || w[leaf] <= w[node]) ? leaf++ : node++;
        w[made] = w[x[0]] + w[x[1]];
        parent[x[0]] = parent[x[1]] = static_cast<uint16_t>(made);
        ++made;
      }
      w[2 * m - 2] = 0;  // depths, from the root down
      for (int i = 2 * m - 3; i >= 0; --i) w[i] = w[parent[i]] + 1;
      int count[16] = {0};
      for (int i = 0; i < m; ++i) ++count[min(static_cast<int>(w[i]), limit)];
      uint32_t total = 0;
      for (int b = 1; b <= limit; ++b) total += static_cast<uint32_t>(count[b]) << (limit - b);
      while (total != (1u << limit)) {
        --count[limit];
        for (int b = limit - 1; b > 0; --b)
          if (count[b]) {
            --count[b];
            count[b + 1] += 2;
            break;
          }
        --total;
      }
      int j = 0;
      for (int b = limit; b >= 1; --b)
        for (int c = 0; c < count[b]; ++c) len[order[j++]] = static_cast<uint8_t>(b);
    }
  }
  __syncthreads();
}

// LSB-first bits into 32-bit words from bit `at`: the first word and the
// last are shared with the neighbouring writers (atomicOr), the words
// between are this writer's alone.
struct BitOut {
  uint32_t* out;
  int64_t word;
  uint64_t acc;
  int n;
  bool first;

  __device__ void init(uint32_t* o, int64_t at) {
    out = o;
    word = at >> 5;
    n = static_cast<int>(at & 31);
    acc = 0;
    first = true;
  }
  __device__ void put(uint32_t v, int nb) {
    acc |= static_cast<uint64_t>(v) << n;
    n += nb;
    if (n >= 32) {
      if (first) {
        atomicOr(out + word, static_cast<uint32_t>(acc));
        first = false;
      } else {
        out[word] = static_cast<uint32_t>(acc);
      }
      ++word;
      acc >>= 32;
      n -= 32;
    }
  }
  __device__ void finish() {
    if (n) atomicOr(out + word, static_cast<uint32_t>(acc));
  }
};

struct Codes {
  uint8_t ll[288], dl[32], cl[20];
  uint16_t lc[288], dc[32], cc[20];
};

__device__ __forceinline__ uint32_t token_bits(const Codes& k, const Segment& g, int64_t p,
                                               bool literal) {
  if (literal) return k.ll[__ldg(g.buf + p)];
  const uint32_t m = g.memo[p];
  const int lc = lcode(m >> 16), dc = dcode(m & 0xffff);
  return k.ll[257 + lc] + lext(lc) + k.dl[dc] + dext(dc);
}

__global__ void __launch_bounds__(kOwners)
encode_kernel(const uint8_t* __restrict__ buf, const uint16_t* __restrict__ prev,
              const int64_t* __restrict__ segs, int nseg, uint32_t* __restrict__ memo,
              uint8_t* __restrict__ out, uint32_t* __restrict__ meta) {
  __shared__ uint32_t bits[kSeg / 32];
  __shared__ uint32_t lf[288], df[32], cf[20];
  __shared__ Codes k;
  __shared__ uint16_t order[288], parent[576];
  __shared__ uint32_t w[576];
  __shared__ uint8_t rle_sym[320], rle_extra[320];
  __shared__ int exits[kOwners];
  __shared__ uint32_t crcs[kOwners], table[256];
  __shared__ uint64_t starts[kOwners];
  __shared__ int hlit, hdist, hclen, nrle, stored;
  __shared__ int64_t nbytes;

  const int tid = threadIdx.x, i = blockIdx.x;
  const int64_t s = segs[i], e = segs[nseg + i];
  const int n = static_cast<int>(e - s);
  const bool last = segs[2 * nseg + i] != 0;
  uint8_t* o8 = out + static_cast<int64_t>(i) * kOutStride;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(o8);

  for (int j = tid; j < kOutStride / 16; j += kOwners)
    reinterpret_cast<uint4*>(o8)[j] = make_uint4(0, 0, 0, 0);
  for (int j = tid; j < kSeg / 32; j += kOwners) bits[j] = 0;
  for (int j = tid; j < 288; j += kOwners) lf[j] = j == 256;  // the end of block, once
  if (tid < 32) df[tid] = 0;
  if (tid < 20) cf[tid] = 0;
  for (int j = tid; j < 256; j += kOwners) {
    uint32_t c = j;
    for (int b = 0; b < 8; ++b) c = c & 1 ? (c >> 1) ^ kPoly : c >> 1;
    table[j] = c;
  }
  __syncthreads();

  const int ra = min(tid * kSub, n), rb = min(ra + kSub, n);
  {  // this thread's bytes' CRC
    uint32_t c = 0xffffffffu;
    const uint8_t* p = buf + s + ra;
    int j = 0;
    for (; j + 16 <= rb - ra; j += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + j));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      for (int q = 0; q < 4; ++q)
        for (int b = 0; b < 4; ++b) c = table[(c ^ (words[q] >> (8 * b))) & 0xff] ^ (c >> 8);
    }
    for (; j < rb - ra; ++j) c = table[(c ^ __ldg(p + j)) & 0xff] ^ (c >> 8);
    crcs[tid] = ~c;
  }

  Walker wk{Segment{buf, prev, memo, s, e}, bits, ra, rb};
  // round 0 walks from the thread's first byte; each later round from the
  // exit of the thread before, where that moved (one call site, so the
  // walk is compiled once)
  int entry = -1, exit = 0, want = ra;
  for (;;) {
    if (want != entry) {
      exit = wk.walk(want, exit);
      entry = want;
    }
    exits[tid] = exit;
    __syncthreads();
    want = tid ? exits[tid - 1] : 0;
    if (!__syncthreads_or(want != entry)) break;
  }

  auto literal = [&](int r) { return r + 1 >= n || ((bits[(r + 1) >> 5] >> ((r + 1) & 31)) & 1); };
  for (int r = wk.next_set(ra); r < rb; r = wk.next_set(r + 1)) {
    if (literal(r)) {
      atomicAdd(&lf[__ldg(buf + s + r)], 1u);
    } else {
      const uint32_t m = memo[s + r];
      atomicAdd(&lf[257 + lcode(m >> 16)], 1u);
      atomicAdd(&df[dcode(m & 0xffff)], 1u);
    }
  }
  __syncthreads();
  huffman(lf, 286, 15, k.ll, order, w, parent);
  huffman(df, 30, 15, k.dl, order, w, parent);
  if (tid == 0) {  // the code lengths, run-length coded as one sequence
    int hl = 286, hd = 30;
    while (hl > 257 && !k.ll[hl - 1]) --hl;
    while (hd > 1 && !k.dl[hd - 1]) --hd;
    int m = 0;
    for (int j = 0; j < hl + hd;) {
      const int v = j < hl ? k.ll[j] : k.dl[j - hl];
      int r = 1;
      while (j + r < hl + hd && (j + r < hl ? k.ll[j + r] : k.dl[j + r - hl]) == v) ++r;
      j += r;
      if (v == 0) {
        for (; r >= 11; ) {
          const int t = min(r, 138);
          rle_sym[m] = 18, rle_extra[m++] = static_cast<uint8_t>(t - 11);
          r -= t;
        }
        if (r >= 3) {
          rle_sym[m] = 17, rle_extra[m++] = static_cast<uint8_t>(r - 3);
          r = 0;
        }
        for (; r > 0; --r) rle_sym[m] = 0, rle_extra[m++] = 0;
      } else {
        rle_sym[m] = static_cast<uint8_t>(v), rle_extra[m++] = 0;
        for (--r; r >= 3; ) {
          const int t = min(r, 6);
          rle_sym[m] = 16, rle_extra[m++] = static_cast<uint8_t>(t - 3);
          r -= t;
        }
        for (; r > 0; --r) rle_sym[m] = static_cast<uint8_t>(v), rle_extra[m++] = 0;
      }
    }
    for (int j = 0; j < m; ++j) ++cf[rle_sym[j]];
    hlit = hl, hdist = hd, nrle = m;
  }
  __syncthreads();
  huffman(cf, 19, 7, k.cl, order, w, parent);
  if (tid == 0) {
    int hc = 19;
    while (hc > 4 && !k.cl[kOrder[hc - 1]]) --hc;
    hclen = hc;
    uint64_t total = 17 + 3 * hc;
    for (int j = 0; j < nrle; ++j) {
      const int sym = rle_sym[j];
      total += k.cl[sym] + (sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0);
    }
    starts[0] = total;  // the header's bits
    for (int j = 0; j < 286; ++j) total += static_cast<uint64_t>(lf[j]) * k.ll[j];
    for (int c = 0; c < 29; ++c) total += static_cast<uint64_t>(lf[257 + c]) * lext(c);
    for (int c = 0; c < 30; ++c) total += static_cast<uint64_t>(df[c]) * (k.dl[c] + dext(c));
    const int64_t dyn = last ? (total + 7) / 8 : (total + 3 + 7) / 8 + 4;
    const int blocks = n ? (n + kStoredMax - 1) / kStoredMax : 1;
    stored = 5 * blocks + n < dyn;
    nbytes = stored ? 5 * blocks + n : dyn;
    canonical(k.ll, 286, k.lc);
    canonical(k.dl, 30, k.dc);
    canonical(k.cl, 19, k.cc);
  }
  __syncthreads();

  if (stored) {
    const int blocks = n ? (n + kStoredMax - 1) / kStoredMax : 1;
    for (int b = 0; b < blocks; ++b) {
      const int a = b * kStoredMax, m = min(kStoredMax, n - a);
      uint8_t* h = o8 + b * (kStoredMax + 5);
      if (tid == 0) {
        h[0] = last && b == blocks - 1;
        h[1] = m & 0xff, h[2] = m >> 8, h[3] = ~m & 0xff, h[4] = (~m >> 8) & 0xff;
      }
      for (int j = tid; j < m; j += kOwners) h[5 + j] = __ldg(buf + s + a + j);
    }
  } else {
    uint32_t mine = 0;
    for (int r = wk.next_set(ra); r < rb; r = wk.next_set(r + 1))
      mine += token_bits(k, wk.g, s + r, literal(r));
    __syncthreads();
    exits[tid] = static_cast<int>(mine);
    __syncthreads();
    if (tid == 0) {
      uint64_t at = starts[0];
      for (int j = 0; j < kOwners; ++j) {
        starts[j] = j ? at : 0;  // thread 0 writes the header first
        at += static_cast<uint32_t>(exits[j]);
      }
    }
    __syncthreads();
    BitOut bo;
    bo.init(o32, starts[tid]);
    if (tid == 0) {
      bo.put(last, 1);
      bo.put(2, 2);
      bo.put(hlit - 257, 5);
      bo.put(hdist - 1, 5);
      bo.put(hclen - 4, 4);
      for (int j = 0; j < hclen; ++j) bo.put(k.cl[kOrder[j]], 3);
      for (int j = 0; j < nrle; ++j) {
        const int sym = rle_sym[j];
        bo.put(k.cc[sym], k.cl[sym]);
        if (sym >= 16) bo.put(rle_extra[j], sym == 16 ? 2 : sym == 17 ? 3 : 7);
      }
    }
    for (int r = wk.next_set(ra); r < rb; r = wk.next_set(r + 1)) {
      if (literal(r)) {
        const int b = __ldg(buf + s + r);
        bo.put(k.lc[b], k.ll[b]);
      } else {
        const uint32_t m = memo[s + r];
        const int len = m >> 16, dist = m & 0xffff;
        const int lc = lcode(len), dc = dcode(dist);
        bo.put(k.lc[257 + lc], k.ll[257 + lc]);
        bo.put(len - lbase(lc), lext(lc));
        bo.put(k.dc[dc], k.dl[dc]);
        bo.put(dist - dbase(dc), dext(dc));
      }
    }
    if (tid == kOwners - 1) bo.put(k.lc[256], k.ll[256]);
    bo.finish();
    __syncthreads();
    if (tid == 0 && !last) {  // the sync flush's LEN 0, NLEN 0xffff; its header bits are 0
      o8[nbytes - 2] = 0xff;
      o8[nbytes - 1] = 0xff;
    }
  }

  if (tid == 0) {
    const uint32_t whole = xpow8n(kSub);
    uint32_t c = 0;
    for (int j = 0; j < kOwners; ++j) {
      const int len = min(n, (j + 1) * kSub) - min(n, j * kSub);
      if (len) c = multmodp(len == kSub ? whole : xpow8n(len), c) ^ crcs[j];
    }
    meta[i] = static_cast<uint32_t>(nbytes);
    meta[nseg + i] = c;
    meta[2 * nseg + i] = stored;
  }
}

// --- gather ------------------------------------------------------------------

// Segment i's bytes to dst at the sum of the sizes before it; CTA 0 folds
// the segments' CRCs into their members' running CRCs (state: a member's
// CRC-32, stored segments and segments, 3 int64 a member).
__global__ void __launch_bounds__(kGather)
gather_kernel(const uint8_t* __restrict__ out, const uint32_t* __restrict__ meta,
              const int64_t* __restrict__ segs, int nseg, uint8_t* __restrict__ dst,
              int64_t* __restrict__ state) {
  __shared__ uint64_t sums[kGather];
  const int tid = threadIdx.x, i = blockIdx.x;
  uint64_t part = 0;
  for (int j = tid; j < i; j += kGather) part += meta[j];
  sums[tid] = part;
  __syncthreads();
  for (int half = kGather / 2; half > 0; half >>= 1) {
    if (tid < half) sums[tid] += sums[tid + half];
    __syncthreads();
  }
  const uint64_t off = sums[0];
  const uint32_t nb = meta[i];
  const uint8_t* src = out + static_cast<int64_t>(i) * kOutStride;
  for (uint32_t j = tid; j < nb; j += kGather) dst[off + j] = src[j];
  if (tid == 0 && i == 0) {
    const uint32_t whole = xpow8n(kSeg);
    for (int j = 0; j < nseg; ++j) {
      int64_t* st = state + 3 * segs[3 * nseg + j];
      const int64_t len = segs[nseg + j] - segs[j];
      st[0] = multmodp(len == kSeg ? whole : xpow8n(len), static_cast<uint32_t>(st[0])) ^
              meta[nseg + j];
      st[1] += meta[2 * nseg + j];
      st[2] += 1;
    }
  }
}

}  // namespace

// One piece: nseg segments of one or more members, whose bytes (each
// member's from kWin before its first segment of the piece, or from its
// start) lie in buf (nbuf bytes, 16-byte aligned, each member's first
// segment too, and 8 readable bytes past the end).  ranges (4 x nranges
// int64: a, b, lo, hi) are the chain kernel's 64 KiB blocks; segs (4 x nseg
// int64: start, end, last, member) the segments in stream order.  Scratch:
// prev (nbuf uint16), memo (nbuf uint32), out (nseg * kOutStride bytes),
// meta (3 * nseg uint32: each segment's bytes, CRC-32 and stored flag).
// The piece's deflate bytes land in dst in segment order; state (3 int64 a
// member, zeroed before a member's first piece) gathers each member's
// CRC-32, stored segments and segments.  Launches on `stream`; returns the
// launch's CUDA error.
extern "C" int fk_deflate_piece(const void* buf, int64_t nbuf, const void* ranges, int nranges,
                                const void* segs, int nseg, void* prev, void* memo, void* out,
                                void* meta, void* dst, void* state, void* stream) {
  if (nbuf < 0 || nranges < 0 || nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint8_t*>(buf);
  const auto* sg = static_cast<const int64_t*>(segs);
  auto* pv = static_cast<uint16_t*>(prev);
  auto* m = static_cast<uint32_t*>(meta);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kHashSize * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nranges > 0) {
    chain_kernel<<<nranges, kChainThreads, kHashSize * 4, st>>>(
        b, static_cast<const int64_t*>(ranges), nranges, pv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  encode_kernel<<<nseg, kOwners, 0, st>>>(b, pv, sg, nseg, static_cast<uint32_t*>(memo),
                                           static_cast<uint8_t*>(out), m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<nseg, kGather, 0, st>>>(static_cast<const uint8_t*>(out), m, sg, nseg,
                                           static_cast<uint8_t*>(dst),
                                           static_cast<int64_t*>(state));
  return static_cast<int>(cudaGetLastError());
}
