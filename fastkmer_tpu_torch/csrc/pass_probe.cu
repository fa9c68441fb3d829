// Device-memory pass probes for Hopper (sm_90a): kernel E.
//
// Replaces the Pallas TPU kernels benchmarks/pallas_probe.py copy_kernel
// and tr_kernel.  Both read two uint32 lanes of n values and write each
// value + 1 (wrapping, as uint32 does) into two new lanes.
//
// Bound on this card: device-memory bytes, each lane read once and written
// once (268,435,456 B at n = 2^24: 0.0801 ms at 3.35 TB/s).  What keeps a
// streaming pass from that rate is the bytes in flight: 3.35 TB/s times a
// microsecond of latency is about 25 KB an SM.
//
// * copy_pass (registers): each thread issues all four 16-byte loads of a
//   step (two a lane, __ldcs: the 268 MB pass streams through the 50 MB
//   L2) before its first store (__stcs).  One CTA of 256 threads a step of
//   8 KB a lane, as many CTAs as steps: the block scheduler evens the SMs'
//   loads out to the last step, which a grid of whole waves striding over
//   the steps did not (it ended a few percent slower in a trial).  Loads
//   through shared memory (cp.async.bulk a step, one mbarrier a stage)
//   ran 3% slower than these register loads on the card, so the copy keeps
//   the registers.
// * transpose_pass: views each lane as [n/128, 128] rows and each 128 x 128
//   tile as one work item (the lane <-> row swap a bitonic low pass
//   performs).  Persistent CTAs, one an SM, walk the items of both lanes;
//   a tile of a CTA goes through three 64 KB shared buffers:
//     load   cp.async 16-byte copies of the tile's rows into X[k & 1], two
//            tiles ahead, so the next tile streams in while this one is
//            touched and stored;
//     T      warp w takes column blocks J of 4 x 4 values (lane I: block
//            (I, J), four 16-byte reads down the column), transposes each
//            block in registers, adds 1, and writes it to Y as block (J, I):
//            Y holds the transposed tile, touched;
//     S      warp w takes row blocks L (lane q: Y's block (q, L), four
//            16-byte reads down a column of Y), transposes back in
//            registers and stores rows 4L..4L+3 of the tile, a whole 512-byte
//            row a store instruction (__stcs).
//   Every block crosses between warps in Y, so the exchange is real.  Two
//   CTA barriers a tile: one after the load (X visible, S of the previous
//   tile done with Y), one after T (Y complete, X[k & 1] free to refill).
//   Shared layout: 16-byte chunk q of row r lies at chunk q ^ ((r >> 2) & 7)
//   of the row (swizzle below; fastkmer_tpu_torch/benchmarks/cuda_probe.py
//   has the same function and the accesses, tested on the CPU).  Each
//   quarter warp of a 16-byte access (the eight lanes a shared-memory phase
//   serves) then reaches eight different 16-byte bank groups, whether its
//   lanes walk a row (load) or a column of blocks (T, S): 4 phases an
//   access, the least 512 bytes need.
// n is a multiple of 2^14 (the Pallas copy's chunk, 128 tiles' rows).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kChunks = kTile / 4;                // 16-byte chunks a tile row
constexpr int kTileChunks = kTile * kChunks;      // 4096 uint4 a tile
constexpr int kThreads = 256;                     // copy CTAs
constexpr int kUnroll = 2;                        // 16-byte loads a lane a thread
constexpr int64_t kStep = kThreads * kUnroll;     // uint4 a lane a copy_pass CTA
constexpr int kTrThreads = 512;
constexpr size_t kTrBytes = 3 * kTileChunks * sizeof(uint4);           // 192 KB
constexpr int64_t kChunk = 1 << 14;

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
}

__global__ void __launch_bounds__(kThreads) copy_pass(const uint4* __restrict__ a,
                                                      const uint4* __restrict__ b,
                                                      uint4* __restrict__ oa,
                                                      uint4* __restrict__ ob) {
  const int64_t base = blockIdx.x * kStep + threadIdx.x;
  uint4 x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    x[u] = __ldcs(a + base + u * kThreads);
    y[u] = __ldcs(b + base + u * kThreads);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    __stcs(oa + base + u * kThreads, plus_one(x[u]));
    __stcs(ob + base + u * kThreads, plus_one(y[u]));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared uint4 index of 16-byte chunk q (values 4q..4q+3) of tile row r.
__device__ __forceinline__ int swizzle(int r, int q) { return r * kChunks + (q ^ ((r >> 2) & 7)); }

__device__ __forceinline__ void tile_load(uint4* x, const uint4* src, int tid) {
#pragma unroll
  for (int k = 0; k < kTileChunks / kTrThreads; ++k) {
    const int e = k * kTrThreads + tid;  // row e / 32, chunk e % 32: a quarter warp a row
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(x + swizzle(e / kChunks, e % kChunks))),
                 "l"(src + e)
                 : "memory");
  }
}

__global__ void __launch_bounds__(kTrThreads, 1) transpose_pass(const uint4* __restrict__ a,
                                                                const uint4* __restrict__ b,
                                                                uint4* __restrict__ oa,
                                                                uint4* __restrict__ ob,
                                                                int64_t tiles) {
  extern __shared__ uint4 sm[];  // X[0], X[1], Y: kTileChunks each
  uint4* const Y = sm + 2 * kTileChunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t items = 2 * tiles;  // the tiles of lane a, then those of lane b
  auto src = [&](int64_t item) {
    return item < tiles ? a + item * kTileChunks : b + (item - tiles) * kTileChunks;
  };
  for (int k = 0; k < 2; ++k) {
    const int64_t item = blockIdx.x + k * static_cast<int64_t>(gridDim.x);
    if (item < items) tile_load(sm + k * kTileChunks, src(item), tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int k = 0;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x, k ^= 1) {
    uint4* const X = sm + k * kTileChunks;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // X loaded by every thread; S of the last tile done with Y
    // T: lane I reads block (I, J) down column block J, writes block (J, I)
    for (int J = warp; J < kChunks; J += kTrThreads / 32) {
      uint32_t m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = X[swizzle(4 * lane + i, J)];
        m[i][0] = v.x, m[i][1] = v.y, m[i][2] = v.z, m[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the touch, on the transposed tile
        Y[swizzle(4 * J + j, lane)] =
            make_uint4(m[0][j] + 1u, m[1][j] + 1u, m[2][j] + 1u, m[3][j] + 1u);
    }
    __syncthreads();  // Y complete; X free
    const int64_t refill = item + 2 * static_cast<int64_t>(gridDim.x);
    if (refill < items) tile_load(X, src(refill), tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // S: lane q reads Y's block (q, L) and stores chunk q of rows 4L..4L+3
    uint4* const out = item < tiles ? oa + item * kTileChunks : ob + (item - tiles) * kTileChunks;
    for (int L = warp; L < kChunks; L += kTrThreads / 32) {
      uint32_t m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = Y[swizzle(4 * lane + i, L)];
        m[i][0] = v.x, m[i][1] = v.y, m[i][2] = v.z, m[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        __stcs(out + (4 * L + j) * kChunks + lane, make_uint4(m[0][j], m[1][j], m[2][j], m[3][j]));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t check_args(const void* a, const void* b, const void* oa, const void* ob, int64_t n,
                       int device, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || n % kChunk != 0 || !aligned16(a) || !aligned16(b) || !aligned16(oa) ||
      !aligned16(ob))
    return cudaErrorInvalidValue;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

unsigned waves(int64_t work, int sms, int per_sm) {
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  return static_cast<unsigned>(work < full ? work : full);
}

}  // namespace

// a, b: n uint32 each (16-byte aligned); oa, ob: n each, written with
// a + 1 and b + 1.  n a positive multiple of 2^14.  Launches on `stream` of
// `device`; returns the first CUDA error code.
extern "C" int fk_pass_copy(const void* a, const void* b, void* oa, void* ob, int64_t n,
                            int device, void* stream) {
  int sms = 0;
  cudaError_t err = check_args(a, b, oa, ob, n, device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_pass<<<static_cast<unsigned>(n / 4 / kStep), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), static_cast<uint4*>(oa),
      static_cast<uint4*>(ob));
  return static_cast<int>(cudaGetLastError());
}

// The same result through transpose_pass: persistent CTAs, one an SM.
extern "C" int fk_pass_transpose(const void* a, const void* b, void* oa, void* ob, int64_t n,
                                 int device, void* stream) {
  int sms = 0;
  cudaError_t err = check_args(a, b, oa, ob, n, device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(transpose_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTrBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = n / (kTile * kTile);
  transpose_pass<<<waves(2 * tiles, sms, 1), kTrThreads, kTrBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), static_cast<uint4*>(oa),
      static_cast<uint4*>(ob), tiles);
  return static_cast<int>(cudaGetLastError());
}
