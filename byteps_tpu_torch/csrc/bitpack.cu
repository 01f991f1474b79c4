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
// Pack.  The TPU kernels view the zero-padded input as (S, 32, 128) and
// reduce over the sublane axis, so that no lane crosses.  Here one thread
// owns one word (tile t, lane l) and walks the 32 rows of its tile at a
// stride of 128 floats: at each step the 32 threads of a warp touch 32
// neighbouring floats, one 128-byte line, so every load is coalesced.  The
// loop is unrolled, so a thread has its 32 loads in flight at once.  No
// padded copy of the input is made: the bound check i < n inside the
// kernel stands in for the JAX package's zero padding.  The test is
// x < 0.0f, never the sign bit: -0.0f and NaN of either sign give bit 0, as
// the Pallas kernel's (x < 0) does.
//
// What bounds them on the H100.  Pack reads 4n bytes and writes n / 8
// (rounded up to whole tiles); unpack reads n / 8 and writes 4n.  For the
// flagship's 4 MiB bucket (n = 1,048,576) that is 4,325,376 bytes, 1.29 us
// at 3.35 TB/s, which is about the time a launch takes to fill the card:
// at this size the kernels are bound by how fast the first bytes start to
// move and how many are in flight, not by the bandwidth itself.
//
// Unpack.  A thread loads four neighbouring words (lanes 4g..4g+3 of a
// tile) with one 16-byte load and, for each of 8 rows r of the tile,
// stores one float4 of elements t * 4096 + r * 128 + 4g..4g+3, which are
// contiguous: a warp (the tile's 32 lane groups) writes 512 B a store
// instruction, where the first design (a thread a word, 32 scalar stores)
// wrote 128 B.  Blocks of 64 threads, the row on the grid's y axis: at
// n = 1,048,576 a row is 512 blocks, so every SM gets several, where the
// first design's 128 blocks of 256 left four SMs idle; a thread finds its
// words with divisions by constants only.  A float4 store needs its output
// address 16-byte aligned and all of its elements below n: a row base of a
// batched unpack is not aligned when n % 4 != 0, and the last tile of a
// row may be ragged, so those pieces take scalar stores.  It did not leave
// the launch floor: at n = 1,048,576 it runs as fast as PyTorch's fill_ of
// the same 4 MiB and as the first design, within the noise of one run
// (PERF.md, "sign_unpack designs", measured by scripts/sign_unpack_sweep.py
// with R = 1, 2, 4 rows a thread and a TMA bulk-store variant beside it).
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

__device__ __forceinline__ float sign_of(uint32_t bits, int r) {
  return 1.0f - 2.0f * (float)((bits >> r) & 1u);
}

// Words [4g, 4g + 4) of a tile's 128 at `w`: one 16-byte load when the
// address allows it.
__device__ __forceinline__ uint4 load_words4(const uint32_t* w) {
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(w));
  return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
}

// Row r's four signs of lanes 4g..4g+3.
__device__ __forceinline__ float4 signs4(const uint4& b, int r) {
  return make_float4(sign_of(b.x, r), sign_of(b.y, r), sign_of(b.z, r),
                     sign_of(b.w, r));
}

// Store the four signs of elements i..i+3 of a row of n at `orow`: one
// float4 when they are all below n and the address is 16-byte aligned,
// else one scalar store for each element below n.
__device__ __forceinline__ void store_signs4(float* orow, long long i,
                                             long long n, const float4& s) {
  float* p = orow + i;
  if (i + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = s;
    return;
  }
  if (i < n) p[0] = s.x;
  if (i + 1 < n) p[1] = s.y;
  if (i + 2 < n) p[2] = s.z;
  if (i + 3 < n) p[3] = s.w;
}

constexpr int kGroups = kLanes / 4;     // lane groups of a tile: one warp
constexpr int kUnpackRows = 8;          // rows of a tile a thread stores
constexpr int kRowBlocks = kRows / kUnpackRows;
constexpr int kUnpackThreads = 64;
constexpr long long kMaxGridY = 65535;

// Grid (x: a row's threads, y: rows, striding when there are more than
// the grid's y limit).  Thread g of a row stores rows 8b..8b+7 (b = g / 32
// % 4) of lanes 4l..4l+3 (l = g % 32) of tile g / 128, a warp one tile.
__global__ void __launch_bounds__(kUnpackThreads)
sign_unpack_kernel(const uint32_t* __restrict__ words,
                   float* __restrict__ out, long long rows, long long n,
                   long long wl, unsigned tiles) {
  const unsigned g = blockIdx.x * kUnpackThreads + threadIdx.x;
  const unsigned t = g / (kGroups * kRowBlocks);
  if (t >= tiles) return;
  const unsigned rb = g / kGroups % kRowBlocks;
  const unsigned lg = g % kGroups;
  const long long i0 = (long long)t * kTile + 4 * lg;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint4 bits =
        load_words4(words + row * wl + (long long)t * kLanes + 4 * lg);
    float* orow = out + row * n;
#pragma unroll
    for (int j = 0; j < kUnpackRows; ++j) {
      const int r = rb * kUnpackRows + j;
      store_signs4(orow, i0 + (long long)r * kLanes, n, signs4(bits, r));
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
  if (rows <= 0 || wl <= 0) return 0;
  const long long tiles = wl / kLanes;
  const long long threads = tiles * kRowBlocks * kGroups;
  if (threads >= (1LL << 32))
    return (int)cudaErrorInvalidValue;      // a row's 32-bit thread index
  const unsigned blocks =
      (unsigned)((threads + kUnpackThreads - 1) / kUnpackThreads);
  const unsigned grid_y = (unsigned)(rows < kMaxGridY ? rows : kMaxGridY);
  sign_unpack_kernel<<<dim3(blocks, grid_y), kUnpackThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (float*)out, rows, n, wl, (unsigned)tiles);
  return (int)cudaGetLastError();
}

const char* bps_bitpack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
