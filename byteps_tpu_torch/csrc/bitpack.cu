// Sign-bit pack and unpack for Hopper (sm_90a).
//
// Two kernels, one per Pallas kernel of byteps_tpu/ops/compressor/bitpack.py:
//
//   sign_pack    replaces _pack_kernel    (:83-92)
//   sign_unpack  replaces _unpack_kernel  (:95-104)
//
// Wire format (the JAX package's, bit for bit): an n-element row packs into
// words_len(n) = tiles * 128 uint32 words, where element i sets bit
// (i / 128) % 32 of word (i / 4096) * 128 + i % 128 iff x[i] < 0.  Elements
// at i >= n (the ragged end of the last tile, and the whole tiles that the
// round-to-8 rule adds above 32 tiles) count as +0: bit 0.  Unpack maps
// bit 0 to +1.0f and bit 1 to -1.0f and writes only i < n.
//
// Layout: x and out are contiguous [rows, n] float32, words contiguous
// [rows, words_len(n)].  The main path packs one row (a bucket) and unpacks
// either one row or the W gathered payloads of a world in one launch.
//
// Design.  The TPU kernels view the zero-padded input as (S, 32, 128) and
// reduce over the sublane axis, so that no lane crosses.  Here one thread
// owns one word (tile t, lane l) and walks the 32 rows of its tile at a
// stride of 128 floats: at each step the 32 threads of a warp touch 32
// neighbouring floats, one 128-byte line, so every load and store is
// coalesced.  The loop is unrolled, so a thread has its 32 loads in flight
// at once.  No padded copy of the input is made: the bound check i < n
// inside the kernel stands in for the JAX package's zero padding.  The
// test is x < 0.0f, never the sign bit: -0.0f and NaN of either sign give
// bit 0, as the Pallas kernel's (x < 0) does.
//
// What bounds them on the H100.  Pack reads 4n bytes and writes n / 8
// (rounded up to whole tiles); unpack reads n / 8 and writes 4n.  For the
// flagship's 4 MiB bucket (n = 1,048,576) that is 4,325,376 bytes, 1.29 us
// at 3.35 TB/s: less than the few microseconds a launch costs, so at the
// main path's bucket size these kernels are bound by launch overhead, not
// by memory.  A grid-stride loop caps the grid for large inputs.
//
// Each entry point returns cudaGetLastError() after its launch, so a
// refused launch surfaces in the caller and never passes silently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                 // words per tile
constexpr int kRows = 32;                   // bits per word: rows of a tile
constexpr long long kTile = kLanes * kRows; // elements per tile
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // 32 blocks per SM, then stride

__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                 long long rows, long long n, long long wl) {
  const long long total = rows * wl;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < total; g += stride) {
    const long long row = g / wl;
    const long long w = g - row * wl;
    const long long base = (w / kLanes) * kTile + (w % kLanes);
    const float* xr = x + row * n;
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + (long long)r * kLanes;
      v[r] = i < n ? __ldg(xr + i) : 0.0f;
    }
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      bits |= (v[r] < 0.0f ? 1u : 0u) << r;
    }
    words[g] = bits;
  }
}

__global__ void __launch_bounds__(kThreads)
sign_unpack_kernel(const uint32_t* __restrict__ words, float* __restrict__ out,
                   long long rows, long long n, long long wl) {
  const long long total = rows * wl;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < total; g += stride) {
    const long long row = g / wl;
    const long long w = g - row * wl;
    const long long base = (w / kLanes) * kTile + (w % kLanes);
    const uint32_t bits = __ldg(words + g);
    float* orow = out + row * n;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + (long long)r * kLanes;
      if (i < n) orow[i] = 1.0f - 2.0f * (float)((bits >> r) & 1u);
    }
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// x [rows, n] float32 -> words [rows, wl] (uint32 bits), wl = words_len(n).
int bps_sign_pack(const void* x, void* words, long long rows, long long n,
                  long long wl, void* stream) {
  const long long total = rows * wl;
  if (total <= 0) return 0;
  sign_pack_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint32_t*)words, rows, n, wl);
  return (int)cudaGetLastError();
}

// words [rows, wl] (uint32 bits) -> out [rows, n] float32 of +-1.0f.
int bps_sign_unpack(const void* words, void* out, long long rows, long long n,
                    long long wl, void* stream) {
  const long long total = rows * wl;
  if (total <= 0) return 0;
  sign_unpack_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (float*)out, rows, n, wl);
  return (int)cudaGetLastError();
}

const char* bps_bitpack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
