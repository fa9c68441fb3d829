// Device-memory pass probes for Hopper (sm_90a): kernel E.
//
// Replaces the Pallas TPU kernels benchmarks/pallas_probe.py copy_kernel
// and tr_kernel.  Both read two uint32 lanes of n values and write each
// value + 1 (wrapping, as uint32 does) into two new lanes:
//   * copy_pass streams the lanes, 16-byte loads and stores in a
//     grid-stride loop;
//   * transpose_pass views each lane as [n/128, 128] rows and each 128 x 128
//     tile of it as one CTA's work: the tile is transposed into shared
//     memory, touched (+1) there, and transposed back on the way out (the
//     lane <-> row swap a bitonic low pass performs).  A row of the shared
//     tile is padded to 129 words, so both the transposed stores and the
//     transposed loads of a warp fall in 32 different banks.  One tile is
//     66,048 bytes, above the 48 KB a CTA gets without opting in; the
//     launch opts into that much dynamic shared memory, and blockIdx.y
//     picks the lane.
//
// Bound on this card: device-memory bytes, each lane read once and written
// once (268,435,456 B at n = 2^24: 0.0801 ms at 3.35 TB/s).  The two probes
// move the same bytes, so they differ only by what the transpose costs.
// n is a multiple of 2^14 (the Pallas copy's chunk, 128 tiles' rows).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kPitch = kTile + 1;
constexpr int kThreads = 256;
constexpr int64_t kCopyBlocks = 132 * 16;  // 16 CTAs for each of the 132 SMs
constexpr int64_t kChunk = 1 << 14;
constexpr size_t kTileBytes = static_cast<size_t>(kTile) * kPitch * sizeof(uint32_t);

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
}

__global__ void copy_pass(const uint4* __restrict__ a, const uint4* __restrict__ b,
                          uint4* __restrict__ oa, uint4* __restrict__ ob, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint4 x = a[i];
    const uint4 y = b[i];
    oa[i] = plus_one(x);
    ob[i] = plus_one(y);
  }
}

__global__ void transpose_pass(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ oa, uint32_t* __restrict__ ob) {
  extern __shared__ uint32_t t[];  // [kTile][kPitch]: t[c][r] = tile[r][c]
  const uint32_t* in = blockIdx.y ? b : a;
  uint32_t* out = blockIdx.y ? ob : oa;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x)
    t[(e % kTile) * kPitch + e / kTile] = in[base + e];  // row-major in, transposed
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x)
    t[(e / kTile) * kPitch + e % kTile] += 1u;  // the touch, in transposed order
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x)
    out[base + e] = t[(e % kTile) * kPitch + e / kTile];  // transposed back
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t check_args(const void* a, const void* b, const void* oa, const void* ob, int64_t n,
                       int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  if (n <= 0 || n % kChunk != 0 || !aligned16(a) || !aligned16(b) || !aligned16(oa) ||
      !aligned16(ob))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// a, b: n uint32 each (16-byte aligned); oa, ob: n each, written with
// a + 1 and b + 1.  n a positive multiple of 2^14.  Launches on `stream` of
// `device`; returns the first CUDA error code.
extern "C" int fk_pass_copy(const void* a, const void* b, void* oa, void* ob, int64_t n,
                            int device, void* stream) {
  cudaError_t err = check_args(a, b, oa, ob, n, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = n / 4;
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < kCopyBlocks ? want : kCopyBlocks);
  copy_pass<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), static_cast<uint4*>(oa),
      static_cast<uint4*>(ob), n4);
  return static_cast<int>(cudaGetLastError());
}

// The same result through transpose_pass: one CTA per 128 x 128 tile of
// each lane.
extern "C" int fk_pass_transpose(const void* a, const void* b, void* oa, void* ob, int64_t n,
                                 int device, void* stream) {
  cudaError_t err = check_args(a, b, oa, ob, n, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(transpose_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTileBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n / (kTile * kTile)), 2);
  transpose_pass<<<grid, kThreads, kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(oa), static_cast<uint32_t*>(ob));
  return static_cast<int>(cudaGetLastError());
}
