// The sign_unpack designs that byteps_tpu_torch/csrc/bitpack.cu does not
// ship, for scripts/sign_unpack_sweep.py to time beside the shipped one:
//   "word"  one thread a word, 32 scalar 4-byte stores (the first design);
//   "r1", "r2", "r4"  the shipped design (16-byte word loads, one float4
//           store per row) with R = 1, 2 or 4 rows a thread, not 8;
//   "bulk"  half a tile (16 rows, 8 KiB of output) unpacked into shared
//           memory and written with one TMA bulk copy
//           (cp.async.bulk.global.shared::cta).
// Same wire format and output as the shipped kernel, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;
constexpr long long kTile = kLanes * kRows;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

// "word": one thread a word, 32 scalar stores.
__global__ void __launch_bounds__(kThreads)
sign_unpack_word_kernel(const uint32_t* __restrict__ words,
                        float* __restrict__ out, long long rows, long long n,
                        long long wl) {
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
constexpr int kUnpackThreads = 64;

// Designs "r1".."r8": grid (x: the row's threads, y: row).  Thread g of a
// row stores rows bR..bR+R-1 (b = g / 32 % (32 / R)) of lanes 4l..4l+3
// (l = g % 32) of tile g / (32 * 32 / R), a warp one tile; the indices are
// divisions by constants, so the first load issues at once.
template <int R>
__global__ void __launch_bounds__(kUnpackThreads)
sign_unpack_vec_kernel(const uint32_t* __restrict__ words,
                       float* __restrict__ out, long long n, long long wl,
                       unsigned tiles) {
  constexpr unsigned kBlocks = kRows / R;    // row blocks of a tile
  const unsigned g = blockIdx.x * kUnpackThreads + threadIdx.x;
  const unsigned t = g / (kGroups * kBlocks);
  if (t >= tiles) return;
  const unsigned rb = g / kGroups % kBlocks;
  const unsigned lg = g % kGroups;
  const uint4 bits =
      load_words4(words + blockIdx.y * wl + t * kLanes + 4 * lg);
  float* orow = out + blockIdx.y * n;
  const long long i0 = (long long)t * kTile + 4 * lg;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = rb * R + j;
    store_signs4(orow, i0 + (long long)r * kLanes, n, signs4(bits, r));
  }
}

constexpr int kBulkRows = 16;                       // rows of a chunk
constexpr int kBulkThreads = 128;
constexpr int kBulkElems = kBulkRows * kLanes;      // 2,048 floats, 8 KiB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Design "bulk": grid (x: the row's chunks, y: row); a chunk is half a
// tile, 16 rows of 128 signs, contiguous in the output.  Thread (w, l)
// makes rows 4w..4w+3 of lanes 4l..4l+3 in shared memory; one thread
// copies the chunk out with one bulk copy and waits until the copy has
// read shared memory before the block ends.  A chunk that is ragged or not
// 16-byte aligned is stored from registers instead.
__global__ void __launch_bounds__(kBulkThreads)
sign_unpack_bulk_kernel(const uint32_t* __restrict__ words,
                        float* __restrict__ out, long long n, long long wl) {
  __shared__ __align__(128) float buf[kBulkElems];
  constexpr int kHalves = kRows / kBulkRows;
  const unsigned t = blockIdx.x / kHalves;
  const int half = blockIdx.x % kHalves;
  const int lg = threadIdx.x % kGroups;
  const int r0 = (threadIdx.x / kGroups) * 4;   // first of 4 rows in chunk
  const uint4 bits =
      load_words4(words + blockIdx.y * wl + t * kLanes + 4 * lg);
  float* orow = out + blockIdx.y * n;
  const long long start = (long long)t * kTile + half * kBulkElems;
  float* dst = orow + start;
  if (start + kBulkElems > n || (reinterpret_cast<uintptr_t>(dst) & 15)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + j;
      store_signs4(orow, start + (long long)r * kLanes + 4 * lg, n,
                   signs4(bits, half * kBulkRows + r));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + j;
    *reinterpret_cast<float4*>(buf + r * kLanes + 4 * lg) =
        signs4(bits, half * kBulkRows + r);
  }
  // Make the generic-proxy writes visible to the bulk copy (async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        ::"l"(dst), "r"(smem_addr(buf)), "r"(kBulkElems * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <int R>
void launch_vec(const uint32_t* words, float* out, long long rows,
                long long n, long long wl, cudaStream_t stream) {
  const long long tiles = wl / kLanes;
  const long long threads = tiles * (kRows / R) * kGroups;
  const unsigned blocks =
      (unsigned)((threads + kUnpackThreads - 1) / kUnpackThreads);
  sign_unpack_vec_kernel<R>
      <<<dim3(blocks, (unsigned)rows), kUnpackThreads, 0, stream>>>(
          words, out, n, wl, (unsigned)tiles);
}

}  // namespace

extern "C" {

// design: 0 "word", 1 "r1", 2 "r2", 3 "r4", 4 "bulk"; rows <= 65,535.
int sweep_sign_unpack(const void* words, void* out, long long rows,
                      long long n, long long wl, int design, void* stream) {
  const uint32_t* w = (const uint32_t*)words;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || wl <= 0) return 0;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  switch (design) {
    case 0:
      sign_unpack_word_kernel<<<grid_for(rows * wl), kThreads, 0, s>>>(
          w, o, rows, n, wl);
      break;
    case 1: launch_vec<1>(w, o, rows, n, wl, s); break;
    case 2: launch_vec<2>(w, o, rows, n, wl, s); break;
    case 3: launch_vec<4>(w, o, rows, n, wl, s); break;
    case 4:
      sign_unpack_bulk_kernel<<<dim3((unsigned)(wl / kLanes * 2),
                                     (unsigned)rows),
                                kBulkThreads, 0, s>>>(w, o, n, wl);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
