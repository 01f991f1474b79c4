// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, in two
// families, as in byteps_tpu/ops/flash_attention.py.
//
// K/V-resident family (the JAX package's choice while 2*S*D fits its VMEM
// budget), one kernel per Pallas kernel:
//
//   flash_fwd      replaces _fwd_kernel_res  (:142-165)
//   flash_bwd_dq   replaces _dq_kernel_res   (:168-189), plus the
//                  delta = rowsum(dO * O) pre-pass that the JAX version
//                  leaves to XLA (_bwd, :357-359)
//   flash_bwd_dkv  replaces _dkv_kernel_res  (:192-215)
//
// Streaming family (long S).  The TPU kernels run a 3-D grid with the
// contraction axis innermost and carry (m, l, acc), dQ or dK/dV in VMEM
// scratch from one grid step to the next.  Blocks on the GPU run in no
// order, so the contraction axis is cut into splits of `split` tiles, each
// split is a grid axis, its float32 partial goes to a workspace, and a
// second pass merges the partials in a fixed order (no atomics: two calls
// give identical bits).  The caller picks the split from S (at least 64
// tiles, at most 8 splits): a CTA walks one split, and each workspace
// holds at most 8 partials of the output, at any S.
//
//   flash_fwd_str      replaces _fwd_kernel_str (:221-247): partial
//                      (m, l, acc) per (q tile, k split), then a merge
//                      that rescales by exp(m_j - M) and writes O, LSE
//   flash_bwd_dq_str   replaces _dq_kernel_str  (:250-272): the delta
//                      pre-pass once, partial dQ per (q tile, k split),
//                      then a sum over the splits
//   flash_bwd_dkv_str  replaces _dkv_kernel_str (:275-302): partial dK
//                      and dV per (k tile, q split), then sums
//
// Under causal masking a (q tile, k split) pair whose first key lies after
// the tile's last query is dead: its CTA exits at once, writes nothing,
// and the merge reads only the live splits of each row tile (never the
// uninitialised workspace).  Splits are whole tiles, so every live row
// sees the first key of every live split and its partial max is finite.
//
// Layout: q, k, v, o, dO are contiguous [BH, S, D] in float32, bfloat16 or
// float16; lse and delta are contiguous [BH, S] float32; the workspaces are
// float32, [splits, BH, S, D] (acc, dQ, dK, dV) or [splits, BH, S] (m, l),
// indexed in size_t.  BH is at most 65,535 a launch (gridDim.y or z): the
// Python wrappers cut a larger B*H into contiguous slices, one launch each.
//
// Head dims.  The kernels are instantiated at D = 16, 32, 64, 128 and 256,
// and the wide kernels (below) take any multiple of 128 above 256 at run
// time.  The JAX kernels take any D (their VMEM blocks are whole rows); the
// caller zero-pads D up to the next head dim the kernels take, which leaves
// Q K^T unchanged, and slices the outputs back
// (ops/flash_attention.py::_pad_head_dim).
//
// What bounds them on the H100.  At the flagship shape (BH = 128, S = 512,
// D = 64, bf16, causal) each resident kernel moves 34-51 MB, about 10-15 us
// at 3.35 TB/s, and does 4-9 GFLOP, about 4-9 us at the bf16 tensor-core
// peak: the bound is the bytes.  At the long shape (BH = 16, S = 32768)
// the same functions do 2.2-4.4 TFLOP on 25-38 MB: the bound is the
// operations, 2.2-4.5 ms.  The design keeps every intermediate the TPU
// kernels keep out of HBM out of device memory too: the [S, S] logits and
// probabilities only ever exist as one 64 x 64 tile in registers and
// shared memory, and the backward recomputes them from the saved
// log-sum-exp.  The streaming partials add (D + 2) floats per row and
// split, which is small beside the operations.
//
// In bf16 and float16 every kernel (fwd_mma_tiles, dq_mma_tiles,
// dkv_mma_tiles, templated on the 16-bit type) runs its products on the
// tensor cores: mma.sync m16n8k16, bf16 x bf16 or f16 x f16 -> float32,
// four warps of 16 rows each, tiles in padded 16-bit shared memory read by
// ldmatrix, the streamed tiles double-buffered through cp.async.  The
// first products (Q K^T, and dO V^T, or K Q^T and V dO^T in dK/dV) take
// the 16-bit inputs, which the tensor cores multiply exactly.  P and dS are
// float32 in registers, as the reference keeps them: its Pallas kernels
// compute in float32 throughout.  Rounded once to bf16 before the second
// products (P V, dS K, P^T dO, dS^T Q), over a 4,096-key contraction they
// miss the plain version by 14 to about 100 bf16 steps.  So each enters as
// a pair, hi = bf16(x) and lo = bf16(x - hi), two MMAs into one float32
// accumulator: 16 significant bits, within one bf16 step of the plain
// version (tests/test_torch_port_flash_tc.py emulates this arithmetic).
// The pair leaves up to 2^-18 |x|, which matters where the backward's
// elements are large (attention on a few keys: |dS| near 10 at S = 64):
// there dQ, dK and dV missed the gate by up to 1.3x over 67M elements.  So
// the bf16 backward adds a third term, lo2 = bf16(x - hi - lo), wherever a
// warp's block of P^T, dS or dS^T holds a large element (|P| >= 2^-5,
// |dS| >= 1; one warp vote, then a second product pass in mma_xb_bwd).
// The thresholds are set from the recipe's emulation so that the unrounded
// error stays below half the gate (where a rounded output can be off by one
// step at most) with room, at S = 64 and dO 16 times larger, over seeds
// (PERF.md).  At long S few blocks hold such elements; the vote and the
// pass cost the backward a few per cent (PERF.md, §6).
// float16 rounds 8 times finer but would still miss the gate, so it keeps
// the pair (22 bits).  Its exponent range is narrow: below 2^-14 its steps
// are absolute, and the backward's probabilities (about 1/S each) and dS
// fall there at long S; above 65,504 it overflows.  So the float16
// backward multiplies each row of P^T, dS and dS^T by a power of two that
// brings the row's largest element just below 2^15 before the split, and
// divides it out of the accumulator at the end (scale_rows); at
// [16, 32768, 64] without it dQ, dK and dV missed the one-step gate by up
// to 1.3x.  The forward's P is relative to the running max and needs no
// scale.  The pair makes the tensor-core work 6 FLOPs per visible (q, k)
// pair and head-dim element in the forward, against the function's 4, and
// 20 against 14 in the backward.  mma.sync reaches only part of the card's
// bf16 peak, which wants wgmma.
//
// The float32 kernels, forward and backward, run on the tensor cores at
// every head dim, each operand split into two TF32 parts (3xTF32):
// single-pass TF32 keeps 10 mantissa bits, too few for the float32 tests'
// 1e-5 of the largest element.  At D <= 128 one CTA holds all of D; at
// D = 256 and above the D / 128 slices of a tile run as a thread-block
// cluster (see "the float32 backward on the tensor cores" and "the float32
// forward on the tensor cores" below).
//
// Tiling.  The TPU kernels take one q block of up to 512 rows and keep K/V
// whole in VMEM.  A 512 x 512 float32 logits tile does not fit in 227 KB of
// shared memory, so these kernels pick their own tiles: 64 q rows by 64 k
// rows.  The float32 tile loops and the 16-bit forward above D = 256 run
// 256 threads, eight warps (see their sections).  The other 16-bit
// tensor-core loops run 128 threads, each warp
// owning 16 rows and its accumulators in the MMA layout; dK/dV takes the q
// tile 32 columns at a time at D = 64 and 16 at D = 128, so that its two
// D-wide accumulators leave room in the registers.  At D = 256 one warp's
// O or dQ accumulator alone would be 128 registers a lane, and dK with dV
// 256, so every 16-bit kernel runs twice over its tiles, once for each
// 128-column half of its outputs (out_cols), recomputing the first
// products and the softmax: 8 tensor-core FLOPs per pair and head-dim element in the
// forward instead of 6, 28 instead of 20 in the backward.  Causal masking
// skips tiles above the diagonal (the loop bound) and masks inside the
// diagonal tile, with global positions, as _causal_mask does.  Both
// families run the same tile loops: the resident kernels over the whole
// range, the streaming ones over a split.  Within a split the tiles are
// walked in a fixed order, with no atomics.
//
// delta_sum: delta = rowsum(dO * O) is summed in float64 (the products of
// float32 values are exact there) and rounded once to float32, here and
// in the plain versions.  The sum cancels: a float32 sum of it misses the
// float64 value by up to 2.7x the 1e-5 relative gate at D = 1024 (1.1x at
// D = 384), in the plain version as in the kernels, so two float32 sums in
// different orders could not be held to that gate against each other.
//
// Each entry point returns cudaGetLastError() after each launch (or the
// error of the attribute call before it), so a refused launch surfaces in
// the caller and never passes silently.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kTile = 64;              // rows of a q tile and of a k tile
constexpr int kLanes = 4;              // threads that share one tile row
constexpr int kThreads = kTile * kLanes;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Sum (or max) over the four consecutive lanes that share a tile row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ double row_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// ---------------------------------------------------------------------------
// Streaming family.  Grid (tiles, splits, BH); `split` is in tiles.  The
// partials of split j for row `row` of head `bh` sit at index
// (j * BH + bh) * S + row of the workspace (times D for the vectors).
// ---------------------------------------------------------------------------
__device__ __forceinline__ size_t ws_row(int split_idx, int bh, int num_bh,
                                         int seq, int row) {
  return ((size_t)split_idx * num_bh + bh) * seq + row;
}

// The k splits [j0, j1) holding the keys that the queries of row tile
// `qt` see (upper == 0: dQ, the forward), or the q splits holding the
// queries that see the keys of row tile `qt` (upper == 1: dK/dV).
__device__ __forceinline__ void live_splits(int qt, int nsplit, int split,
                                            int causal, int upper, int& j0,
                                            int& j1) {
  j0 = 0;
  j1 = nsplit;
  if (causal) {
    if (upper) j0 = qt / split;
    else j1 = min(nsplit, qt / split + 1);
  }
}

// Merge of the forward partials: M = max_j m_j, L = sum_j exp(m_j - M) l_j,
// O = sum_j exp(m_j - M) acc_j / L, LSE = M + log L, j in increasing order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_str_merge_kernel(const float* __restrict__ m_ws,
                               const float* __restrict__ l_ws,
                               const float* __restrict__ acc_ws,
                               T* __restrict__ o, float* __restrict__ lse,
                               int seq, int nsplit, int split, int causal) {
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const int row = qt * kTile + r;
  int j0, j1;
  live_splits(qt, nsplit, split, causal, 0, j0, j1);

  float mx = -INFINITY;
  for (int j = j0; j < j1; ++j)
    mx = fmaxf(mx, m_ws[ws_row(j, bh, gridDim.y, seq, row)]);
  float l = 0.f;
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const size_t at = ws_row(j, bh, gridDim.y, seq, row);
    const float w = expf(m_ws[at] - mx);
    l += w * l_ws[at];
    const float* arow = acc_ws + at * D;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) acc[i] += w * arow[c + kLanes * i];
  }
  const size_t at0 = (size_t)bh * seq + row;
  T* orow = o + at0 * D;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) orow[c + kLanes * i] = from_f32<T>(acc[i] / l);
  if (c == 0) lse[at0] = mx + logf(l);
}

// delta = rowsum(dO * O), once per backward pass, for every split.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int seq) {
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const size_t at0 = (size_t)blockIdx.y * seq + blockIdx.x * kTile + r;
  const T* orow = o + at0 * D;
  const T* drow = dout + at0 * D;
  double dsum = 0.0;   // float64: see delta_sum
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i)
    dsum += (double)to_f32(drow[c + kLanes * i]) *
            (double)to_f32(orow[c + kLanes * i]);
  const float dl = (float)row_sum(dsum);
  if (c == 0) delta[at0] = dl;
}

// out = scale * (sum of the live splits' partials), splits in increasing
// order, for dQ (upper == 0) or for dK and dV (upper == 1).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_sum_splits_kernel(const float* __restrict__ ws, T* __restrict__ out,
                            int seq, int nsplit, int split, float scale,
                            int causal, int upper) {
  const int t = blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const int row = t * kTile + r;
  int j0, j1;
  live_splits(t, nsplit, split, causal, upper, j0, j1);
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const float* arow = ws + ws_row(j, bh, gridDim.y, seq, row) * D;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) acc[i] += arow[c + kLanes * i];
  }
  T* orow = out + ((size_t)bh * seq + row) * D;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) orow[c + kLanes * i] = from_f32<T>(scale * acc[i]);
}

// ---------------------------------------------------------------------------
// The 16-bit backward on the tensor cores: dQ and dK/dV with
// mma.sync.m16n8k16 (bf16 x bf16 or f16 x f16 -> float32), templated on the
// 16-bit type T16.  A CTA of four warps owns a 64-row tile; warp w owns its
// rows 16w..16w+15 and keeps its products' accumulators in registers in the
// MMA layout: for n8 block n, element e of lane l sits at row l/4 (+8 for
// e >= 2), column 8n + 2(l%4) + (e&1).  Tiles live in shared memory as
// 16-bit rows of D + 8 (16-byte aligned and free of bank conflicts for
// ldmatrix); the streamed tiles come in by cp.async, double-buffered, tile
// t+1 loading while tile t multiplies.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

// CTAs an SM each tensor-core kernel is compiled for (__launch_bounds__'s
// second argument).  Without it ptxas sometimes spilled a few bytes to
// reach one more CTA an SM (at 80, 96 or 128 registers); with 1 everywhere
// it let the D = 64 kernels grow past their occupancy (dQ from 128 to 194
// registers).  So: at D = 64 (the main paths) the occupancy each kernel
// reaches without it (4, 4, 3); 2 at D = 128 (3 made the forward spill at
// its 168-register cap); 1 elsewhere (D <= 32, where occupancy is ample;
// D = 256, whose shared memory allows one CTA an SM).
constexpr int kFwdCtas = 0, kDqCtas = 1, kDkvCtas = 2;
template <int kKernel>
__host__ __device__ constexpr int mma_ctas(int d) {
  if (d == 64) return kKernel == kDkvCtas ? 3 : 4;
  if (d == 128) return 2;
  return 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every group but the newest (the prefetch just issued).
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l receives row l/4, columns 2(l%4), +1 of each (of each
// transposed matrix with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 float32, a and b in T16.
template <typename T16>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T16, bf16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t bits16(bf16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits16(__half x) {
  return __half_as_ushort(x);
}

template <typename T16>
__device__ __forceinline__ T16 unbits16(uint32_t b);
template <>
__device__ __forceinline__ bf16 unbits16<bf16>(uint32_t b) {
  return __ushort_as_bfloat16((unsigned short)b);
}
template <>
__device__ __forceinline__ __half unbits16<__half>(uint32_t b) {
  return __ushort_as_half((unsigned short)b);
}

// x0, x1 (neighbouring columns) as hi = T16(x), lo = T16(x - hi), each
// packed two to a register: the pair carries 16 significant bits of x in
// bf16 (where one bf16 carries 8), 22 in float16.
template <typename T16>
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const T16 h0 = from_f32<T16>(x0);
  const T16 h1 = from_f32<T16>(x1);
  hi = bits16(h0) | (bits16(h1) << 16);
  lo = bits16(from_f32<T16>(x0 - to_f32(h0))) |
       (bits16(from_f32<T16>(x1 - to_f32(h1))) << 16);
}

// The third terms T16(x - hi - lo) of x0, x1, packed as split16 packs.
template <typename T16>
__device__ __forceinline__ uint32_t residue16(float x0, float x1,
                                              uint32_t hi, uint32_t lo) {
  const float r0 = x0 - to_f32(unbits16<T16>(hi & 0xffffu)) -
                   to_f32(unbits16<T16>(lo & 0xffffu));
  const float r1 = x1 - to_f32(unbits16<T16>(hi >> 16)) -
                   to_f32(unbits16<T16>(lo >> 16));
  return bits16(from_f32<T16>(r0)) | (bits16(from_f32<T16>(r1)) << 16);
}

// Copy the contiguous [kTile, D] 16-bit tile at `src` into shared rows of
// D + 8, 16 bytes a copy.
template <int D, typename T16>
__device__ __forceinline__ void tile_async(T16* dst, const T16* src) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    cp_async16(dst + r * (D + 8) + c * 8, src + (size_t)r * D + c * 8);
  }
}
// The kTile floats at `src` (a tile's LSE or delta).
__device__ __forceinline__ void rows_async(float* dst, const float* src) {
  if (threadIdx.x < kTile / 4)
    cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x);
}

// acc[n] += A B^T over D for the warp: A is 16 rows at `a`, B is 8 * NB
// rows at `b`, both [rows][D + 8] T16 (S = Q K^T, dP = dO V^T, and their
// transposes K Q^T, V dO^T).
template <typename T16, int D, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const T16* a,
                                        const T16* b, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816<T16>(acc[2 * n2], af, bf[0], bf[1]);
      mma16816<T16>(acc[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// Elements of a backward A operand from these magnitudes on make the warp
// take three 16-bit terms (see mma_xb_split): P^T (at most 1, with dO in
// dV's sum) from 2^-5, dS and dS^T from 1.  Measured in the recipe's
// emulation (tests/test_torch_port_flash_tc.py), dO 16 times larger: dV's
// unrounded error reaches 0.62-0.93 of the gate at S = 64 with 2^-3 over
// five seeds, and 0.60 at S = 4,096 with an attention sink with 2^-4;
// 2^-5 holds both at or below 0.33.  dQ and dK sit at their float32 floor
// with dS's threshold anywhere from 2^-4 to 1.
constexpr float kRefineP = 0.03125f;
constexpr float kRefineDs = 1.f;

// acc[n] += X B for the warp: X is 16 x 16KS float32 in accumulator layout
// (P, dS or their transposes), B is 16KS rows at `b` ([rows][D + 8] T16,
// contracted along its rows, read through ldmatrix.trans), of which the DC
// columns from `b` on are taken.  An accumulator block pair 2kk, 2kk+1 is
// the A fragment of k step kk as it stands in registers; each value enters
// as its hi/lo pair, two MMAs into the same float32 accumulator (with
// kResidue, only the third term lo2 = T16(x - hi - lo) instead).  The pair
// leaves up to 2^-18 |x| in bf16; the three terms 2^-27 |x|.
template <typename T16, int D, int DC, int KS, bool kResidue = false>
__device__ __forceinline__ void mma_xb_split(float (&acc)[DC / 8][4],
                                             const float (&x)[2 * KS][4],
                                             const T16* b, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t hi[4], lo[4];
    split16<T16>(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split16<T16>(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split16<T16>(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split16<T16>(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
    if constexpr (kResidue) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hi[i] = residue16<T16>(x[2 * kk + i / 2][2 * (i % 2)],
                               x[2 * kk + i / 2][2 * (i % 2) + 1], hi[i],
                               lo[i]);
    }
#pragma unroll
    for (int n2 = 0; n2 < DC / 16; ++n2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                        n2 * 16 + (lane >> 4) * 8);
      mma16816<T16>(acc[2 * n2], hi, bf[0], bf[1]);
      if constexpr (!kResidue) mma16816<T16>(acc[2 * n2], lo, bf[0], bf[1]);
      mma16816<T16>(acc[2 * n2 + 1], hi, bf[2], bf[3]);
      if constexpr (!kResidue)
        mma16816<T16>(acc[2 * n2 + 1], lo, bf[2], bf[3]);
    }
  }
}

// Whether any lane of the warp holds an element of x with |x| >= from.
template <int NB>
__device__ __forceinline__ bool warp_any_from(const float (&x)[NB][4],
                                              float from) {
  float big = 0.f;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) big = fmaxf(big, fabsf(x[n][e]));
  return __any_sync(0xffffffffu, big >= from);
}

// acc += X B as mma_xb_split, X the backward's P^T, dS or dS^T; in bf16,
// when one element of the warp's X reaches `from` (one vote), a second
// pass adds the third terms.  The pair's loop is the same code either way,
// and the pass after it keeps its registers to itself.
template <typename T16, int D, int DC, int KS>
__device__ __forceinline__ void mma_xb_bwd(float (&acc)[DC / 8][4],
                                           const float (&x)[2 * KS][4],
                                           const T16* b, int lane,
                                           float from) {
  mma_xb_split<T16, D, DC, KS>(acc, x, b, lane);
  if constexpr (std::is_same<T16, bf16>::value) {
    if (warp_any_from(x, from))
      mma_xb_split<T16, D, DC, KS, true>(acc, x, b, lane);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write the warp's rows of DC columns of a [kTile, ld] tile at `out` (row
// stride ld), times `scale`: 16-bit outputs, or float32 partials of a
// workspace.
template <int DC, typename Out>
__device__ __forceinline__ void store_rows_ld(Out* out, int ld,
                                              const float (&acc)[DC / 8][4],
                                              float scale) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = n * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(out + (row + 8 * h) * ld + col, scale * acc[n][2 * h],
             scale * acc[n][2 * h + 1]);
  }
}
// The same with the row stride D of an instantiated head dim.
template <int DC, int D, typename Out>
__device__ __forceinline__ void store_rows(Out* out,
                                           const float (&acc)[DC / 8][4],
                                           float scale) {
  store_rows_ld<DC>(out, D, acc, scale);
}

// Shared memory of both loops: six [kTile][D + 8] 16-bit tiles (the fixed
// q or k tile's two, and two buffers of the two streamed ones), then LSE
// and delta rows as float32 (one tile's in dQ, two buffers' in dK/dV).
template <int D>
constexpr size_t mma_smem() {
  return 6 * kTile * (D + 8) * sizeof(uint16_t) + 4 * kTile * sizeof(float);
}
template <int D>
__device__ __forceinline__ float* mma_rows(unsigned char* smem) {
  return reinterpret_cast<float*>(smem +
                                  6 * kTile * (D + 8) * sizeof(uint16_t));
}

// Output columns a pass of the tensor-core loops computes: all of D up to
// D = 128.  At D = 256 one warp's O or dQ accumulator alone would be 128
// registers a lane (dK and dV together 256), so the kernels make two
// passes over the tiles, one for each 128-column half of the outputs,
// recomputing the first products (and the softmax) in each.
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}

// float16 only.  The backward's A operands are normalized probabilities
// (P = exp(s - lse), about 1/S each at long S) and dS = P (dP - delta):
// most lie below float16's smallest normal number (2^-14), where its steps
// are absolute (2^-24) and the hi/lo pair keeps only a few bits.  So each
// row r of x (the warp's 16 rows in accumulator layout) is multiplied by a
// power of two cs[r] before it is split, as large as keeps the row's
// largest element below 2^15 (never above 2^24), and the accumulator rows
// carry the same factor.  cs only falls: when a later tile needs a smaller
// one, the accumulator rows are rescaled, exactly, like the softmax's
// running max.  The caller divides cs out at the end.
constexpr float kRowScaleMax = 16777216.f;   // 2^24

template <int NB, int DC>
__device__ __forceinline__ void scale_rows(float (&x)[NB][4],
                                           float (&acc)[DC / 8][4],
                                           float (&cs)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(x[n][e]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = row_max(mx[h]);
    if (mx[h] > 0.f) {
      // mx < 2^ex from its exponent bits (subnormal mx: ex = -126), and
      // c = 2^min(15 - ex, 24), built from its bits too.
      const int ex = (int)((__float_as_uint(mx[h]) >> 23) & 0xffu) - 126;
      const float c = __uint_as_float((uint32_t)(127 + min(15 - ex, 24))
                                      << 23);
      if (c < cs[h]) {
        const float r = c / cs[h];
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          acc[n][2 * h] *= r;
          acc[n][2 * h + 1] *= r;
        }
        cs[h] = c;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] *= cs[e >> 1];
}

// acc rows divided by their row scales cs (exact: powers of two).
template <int DC>
__device__ __forceinline__ void unscale_rows(float (&acc)[DC / 8][4],
                                             const float (&cs)[2]) {
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= cs[e >> 1];
}

template <typename T16>
__host__ __device__ constexpr bool kScaleRows() {
  return std::is_same<T16, __half>::value;
}

// Columns [col0, col0 + DC) of dQ of the q tile `qt` over the k tiles
// [kt0, kt1) on the tensor cores: S = Q K^T, dP = dO V^T, P = exp(scale S -
// lse), dS = P (dP - delta) in registers, acc += dS K (the caller scales
// by sm_scale; in float16 acc comes back unscaled from its row scales).
// `rows` holds the tile's LSE then delta, written by the caller before the
// call.
template <typename T16, int D, int DC>
__device__ __forceinline__ void dq_mma_tiles(unsigned char* smem,
                                             const T16* q, const T16* k,
                                             const T16* v, const T16* dout,
                                             int qt, int kt0, int kt1,
                                             int causal, float scale,
                                             int col0,
                                             float (&acc)[DC / 8][4]) {
  constexpr int ld = D + 8;
  constexpr int tile = kTile * ld;
  // Keys a step takes: the whole tile, or 32 at D = 256, where two 64-key
  // S and dP blocks beside the accumulator would crowd the registers.
  constexpr int NK = D > 128 ? 32 : kTile;
  float cs[2] = {kRowScaleMax, kRowScaleMax};
  T16* qs = reinterpret_cast<T16*>(smem);
  T16* dos = qs + tile;
  T16* ks = dos + tile;          // [2][tile]
  T16* vs = ks + 2 * tile;       // [2][tile]
  const float* rows = mma_rows<D>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  tile_async<D>(qs, q + (size_t)qt * kTile * D);
  tile_async<D>(dos, dout + (size_t)qt * kTile * D);
  tile_async<D>(ks, k + (size_t)kt0 * kTile * D);
  tile_async<D>(vs, v + (size_t)kt0 * kTile * D);
  cp_async_commit();

  const int r0 = 16 * warp + (lane >> 2);  // this lane's rows r0, r0 + 8
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      tile_async<D>(ks + (buf ^ 1) * tile, k + (size_t)(kt + 1) * kTile * D);
      tile_async<D>(vs + (buf ^ 1) * tile, v + (size_t)(kt + 1) * kTile * D);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and the q tile, LSE, delta) visible to all

#pragma unroll
    for (int c = 0; c < kTile / NK; ++c) {
      const T16* kc = ks + buf * tile + c * NK * ld;
      float s[NK / 8][4], dp[NK / 8][4];
      zero(s);
      zero(dp);
      mma_abt<T16, D, NK / 8>(s, qs + 16 * warp * ld, kc, lane);
      mma_abt<T16, D, NK / 8>(dp, dos + 16 * warp * ld,
                              vs + buf * tile + c * NK * ld, lane);
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int row = qt * kTile + r;                          // query
          const int col = kt * kTile + c * NK + n * 8 + 2 * (lane & 3) +
                          (e & 1);                                 // key
          const float p = causal && col > row
                              ? 0.f
                              : expf(scale * s[n][e] - rows[r]);
          dp[n][e] = p * (dp[n][e] - rows[kTile + r]);
        }
      if constexpr (kScaleRows<T16>()) scale_rows<NK / 8, DC>(dp, acc, cs);
      mma_xb_bwd<T16, D, DC, NK / 16>(acc, dp, kc + col0, lane, kRefineDs);
    }
    __syncthreads();  // every warp is done with buffer `buf` before refill
  }
  if constexpr (kScaleRows<T16>()) unscale_rows<DC>(acc, cs);
}

// Columns [col0, col0 + DC) of dK/dV of the k tile `kt` over the q tiles
// [qt0, qt1) on the tensor cores: S^T = K Q^T and dP^T = V dO^T with the k
// rows as the M dimension, so P^T and dS^T come out as the A fragments of
// dV += P^T dO and dK += dS^T Q (the caller scales dK; float16 scales the
// rows of P^T and dS^T, see scale_rows).  The q
// tile is taken NQ columns at a time, one chunk after the other: 32 at
// D = 64 (134 registers, three CTAs an SM; 64 columns take 176 registers,
// two CTAs, and 20% more time on an H100), 16 at D = 128 and 256 (where the
// two DC-wide accumulators fill most of the registers; 32 columns spill)
// and at D = 16 and 32 (where ptxas settled on 96 or 128 registers and
// spilled a few bytes with 32 or 64).
template <typename T16, int D, int DC>
__device__ __forceinline__ void dkv_mma_tiles(
    unsigned char* smem, const T16* q, const T16* k, const T16* v,
    const T16* dout, const float* lse, const float* delta, int kt, int qt0,
    int qt1, int causal, float scale, int col0, float (&dk)[DC / 8][4],
    float (&dv)[DC / 8][4]) {
  constexpr int ld = D + 8;
  constexpr int tile = kTile * ld;
  constexpr int NQ = D == 64 ? 32 : 16;
  float cs_v[2] = {kRowScaleMax, kRowScaleMax};
  float cs_k[2] = {kRowScaleMax, kRowScaleMax};
  T16* ks = reinterpret_cast<T16*>(smem);
  T16* vs = ks + tile;
  T16* qs = vs + tile;           // [2][tile]
  T16* dos = qs + 2 * tile;      // [2][tile]
  float* rows = mma_rows<D>(smem);  // [2][lse, delta]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  tile_async<D>(ks, k + (size_t)kt * kTile * D);
  tile_async<D>(vs, v + (size_t)kt * kTile * D);
  tile_async<D>(qs, q + (size_t)qt0 * kTile * D);
  tile_async<D>(dos, dout + (size_t)qt0 * kTile * D);
  rows_async(rows, lse + (size_t)qt0 * kTile);
  rows_async(rows + kTile, delta + (size_t)qt0 * kTile);
  cp_async_commit();

  const int krow = kt * kTile + 16 * warp + (lane >> 2);  // key, +8 for e >= 2
  for (int qt = qt0; qt < qt1; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < qt1) {
      const size_t next = (size_t)(qt + 1) * kTile;
      tile_async<D>(qs + (buf ^ 1) * tile, q + next * D);
      tile_async<D>(dos + (buf ^ 1) * tile, dout + next * D);
      rows_async(rows + (buf ^ 1) * 2 * kTile, lse + next);
      rows_async(rows + (buf ^ 1) * 2 * kTile + kTile, delta + next);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const T16* qb = qs + buf * tile;
    const T16* db = dos + buf * tile;
    const float* lse_b = rows + buf * 2 * kTile;
#pragma unroll 1
    for (int c = 0; c < kTile / NQ; ++c) {
      float st[NQ / 8][4], dpt[NQ / 8][4];
      zero(st);
      zero(dpt);
      mma_abt<T16, D, NQ / 8>(st, ks + 16 * warp * ld, qb + c * NQ * ld,
                              lane);
      mma_abt<T16, D, NQ / 8>(dpt, vs + 16 * warp * ld, db + c * NQ * ld,
                              lane);
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c * NQ + n * 8 + 2 * (lane & 3) + (e & 1);  // q in tile
          const int key = krow + (e >> 1) * 8;
          const float p = causal && key > qt * kTile + j
                              ? 0.f
                              : expf(scale * st[n][e] - lse_b[j]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - lse_b[kTile + j]);
        }
      if constexpr (kScaleRows<T16>()) {
        scale_rows<NQ / 8, DC>(st, dv, cs_v);
        scale_rows<NQ / 8, DC>(dpt, dk, cs_k);
      }
      mma_xb_bwd<T16, D, DC, NQ / 16>(dv, st, db + c * NQ * ld + col0, lane,
                                      kRefineP);
      mma_xb_bwd<T16, D, DC, NQ / 16>(dk, dpt, qb + c * NQ * ld + col0, lane,
                                      kRefineDs);
    }
    __syncthreads();
  }
  if constexpr (kScaleRows<T16>()) {
    unscale_rows<DC>(dv, cs_v);
    unscale_rows<DC>(dk, cs_k);
  }
}

// Resident dQ: delta for the tile's rows first, written out for the dK/dV
// kernel, two threads a row.
template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kDqCtas>(D))
    flash_bwd_dq_mma_kernel(const T16* __restrict__ q,
                            const T16* __restrict__ k,
                            const T16* __restrict__ v,
                            const T16* __restrict__ o,
                            const T16* __restrict__ dout,
                            const float* __restrict__ lse,
                            T16* __restrict__ dq, float* __restrict__ delta,
                            int seq, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  float* rows = mma_rows<D>(mma_smem_buf);
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * D;
  {
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const size_t at = base + (size_t)(qt * kTile + r) * D + half * (D / 2);
    double dsum = 0.0;   // float64: see delta_sum
#pragma unroll 8
    for (int i = 0; i < D / 2; ++i)
      dsum += (double)to_f32(dout[at + i]) * (double)to_f32(o[at + i]);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    const float dl = (float)dsum;
    if (!half) {
      const size_t row = (size_t)bh * seq + qt * kTile + r;
      delta[row] = dl;
      rows[r] = lse[row];
      rows[kTile + r] = dl;
    }
  }
  constexpr int DC = out_cols<D>();
#pragma unroll
  for (int col0 = 0; col0 < D; col0 += DC) {
    float acc[DC / 8][4];
    zero(acc);
    dq_mma_tiles<T16, D, DC>(mma_smem_buf, q + base, k + base, v + base,
                             dout + base, qt, 0,
                             causal ? qt + 1 : seq / kTile, causal, scale,
                             col0, acc);
    store_rows<DC, D>(dq + base + (size_t)qt * kTile * D + col0, acc,
                      scale);
  }
}

// dK/dV of the k tile over [qt0, qt1), out_cols<D>() columns a pass; each
// pass's dK and dV columns go to `dk_out`, `dv_out` (row stride D), dK
// times `dk_scale`.
template <typename T16, int D, typename Out>
__device__ __forceinline__ void dkv_passes(
    unsigned char* smem, const T16* q, const T16* k, const T16* v,
    const T16* dout, const float* lse, const float* delta, int kt, int qt0,
    int qt1, int causal, float scale, float dk_scale, Out* dk_out,
    Out* dv_out) {
  constexpr int DC = out_cols<D>();
#pragma unroll
  for (int col0 = 0; col0 < D; col0 += DC) {
    float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
    zero(dk_acc);
    zero(dv_acc);
    dkv_mma_tiles<T16, D, DC>(smem, q, k, v, dout, lse, delta, kt, qt0, qt1,
                              causal, scale, col0, dk_acc, dv_acc);
    store_rows<DC, D>(dk_out + col0, dk_acc, dk_scale);
    store_rows<DC, D>(dv_out + col0, dv_acc, 1.f);
  }
}

template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kDkvCtas>(D))
    flash_bwd_dkv_mma_kernel(const T16* __restrict__ q,
                             const T16* __restrict__ k,
                             const T16* __restrict__ v,
                             const T16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T16* __restrict__ dk, T16* __restrict__ dv,
                             int seq, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * D;
  const size_t at = base + (size_t)kt * kTile * D;
  dkv_passes<T16, D>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                     lse + (size_t)bh * seq, delta + (size_t)bh * seq, kt,
                     causal ? kt : 0, seq / kTile, causal, scale, scale,
                     dk + at, dv + at);
}

// Streaming dQ: grid (tiles, splits, BH) as flash_bwd_dq_str_kernel.
template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kDqCtas>(D))
    flash_bwd_dq_str_mma_kernel(const T16* __restrict__ q,
                                const T16* __restrict__ k,
                                const T16* __restrict__ v,
                                const T16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq_ws, int seq, int split,
                                float scale, int causal) {
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - blockIdx.x;
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  const int kt0 = sp * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;

  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  float* rows = mma_rows<D>(mma_smem_buf);
  const size_t base = (size_t)bh * seq * D;
  if (threadIdx.x < kTile) {
    const size_t row = (size_t)bh * seq + qt * kTile + threadIdx.x;
    rows[threadIdx.x] = lse[row];
    rows[kTile + threadIdx.x] = delta[row];
  }
  constexpr int DC = out_cols<D>();
#pragma unroll
  for (int col0 = 0; col0 < D; col0 += DC) {
    float acc[DC / 8][4];
    zero(acc);
    dq_mma_tiles<T16, D, DC>(mma_smem_buf, q + base, k + base, v + base,
                             dout + base, qt, kt0, kt1, causal, scale, col0,
                             acc);
    store_rows<DC, D>(
        dq_ws + ws_row(sp, bh, gridDim.z, seq, qt * kTile) * D + col0, acc,
        1.f);
  }
}

template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kDkvCtas>(D))
    flash_bwd_dkv_str_mma_kernel(const T16* __restrict__ q,
                                 const T16* __restrict__ k,
                                 const T16* __restrict__ v,
                                 const T16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk_ws,
                                 float* __restrict__ dv_ws, int seq,
                                 int split, float scale, int causal) {
  const int num_t = seq / kTile;
  const int kt = blockIdx.x;
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  int qt0 = sp * split;
  const int qt1 = min(qt0 + split, num_t);
  if (causal) qt0 = max(qt0, kt);
  if (qt0 >= qt1) return;

  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  const size_t base = (size_t)bh * seq * D;
  const size_t at = ws_row(sp, bh, gridDim.z, seq, kt * kTile) * D;
  dkv_passes<T16, D>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                     lse + (size_t)bh * seq, delta + (size_t)bh * seq, kt,
                     qt0, qt1, causal, scale, 1.f, dk_ws + at, dv_ws + at);
}

// ---------------------------------------------------------------------------
// The 16-bit forward on the tensor cores, in the backward's layout: four
// warps of 16 rows own a 64-row q tile; S = Q K^T and O += P V run on
// mma.sync, the online softmax of _online_step in registers.
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the forward: the q tile, then two buffers each of the K
// and V tiles, [kTile][D + 8] 16-bit.
template <int D>
constexpr size_t fwd_mma_smem() {
  return 5 * kTile * (D + 8) * sizeof(uint16_t);
}

// Online softmax of the q tile `qt` over the k tiles [kt0, kt1): S = Q K^T
// from the 16-bit inputs (exact products, float32 sums), times scale in
// float32; P and the running max m and sum l of the lane's rows r0 and
// r0 + 8 (lane / 4 of the warp's 16), the max kept in units of log2 so
// that exp2f takes the exponentials; acc = alpha acc + P V[:, col0:col0 +
// DC], P entering as its hi/lo pair and V read by ldmatrix.trans, with no
// shared-memory round trip.  Every row sees the first key of the range
// (kt0 <= qt), so m is finite after the first tile.  Two passes over other
// columns compute the same m and l.
template <typename T16, int D, int DC>
__device__ __forceinline__ void fwd_mma_tiles(unsigned char* smem,
                                              const T16* q, const T16* k,
                                              const T16* v, int qt, int kt0,
                                              int kt1, int causal,
                                              float scale, int col0,
                                              float (&m2)[2], float (&l)[2],
                                              float (&acc)[DC / 8][4]) {
  constexpr int ld = D + 8;
  constexpr int tile = kTile * ld;
  T16* qs = reinterpret_cast<T16*>(smem);
  T16* ks = qs + tile;           // [2][tile]
  T16* vs = ks + 2 * tile;       // [2][tile]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale2 = scale * kLog2e;

  tile_async<D>(qs, q + (size_t)qt * kTile * D);
  tile_async<D>(ks, k + (size_t)kt0 * kTile * D);
  tile_async<D>(vs, v + (size_t)kt0 * kTile * D);
  cp_async_commit();

  m2[0] = m2[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  zero(acc);
  const int r0 = 16 * warp + (lane >> 2);  // this lane's rows r0, r0 + 8
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      tile_async<D>(ks + (buf ^ 1) * tile, k + (size_t)(kt + 1) * kTile * D);
      tile_async<D>(vs + (buf ^ 1) * tile, v + (size_t)(kt + 1) * kTile * D);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and the q tile) visible to all

    float s[8][4];
    zero(s);
    mma_abt<T16, D, 8>(s, qs + 16 * warp * ld, ks + buf * tile, lane);
    const bool diag = causal && kt == qt;
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + (e & 1);  // key in tile
        s[n][e] = diag && col > r0 + 8 * (e >> 1) ? -INFINITY
                                                  : scale2 * s[n][e];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = row_max(mx[h]);
      alpha[h] = exp2f(m2[h] - mx[h]);
      m2[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum(rs[h]);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_xb_split<T16, D, DC, 4>(acc, s, vs + buf * tile + col0, lane);
    __syncthreads();  // every warp is done with buffer `buf` before refill
  }
}

// Resident forward: O = acc / l, LSE = m + log l.  The longest rows (under
// causal masking) first.
template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kFwdCtas>(D))
    flash_fwd_mma_kernel(const T16* __restrict__ q,
                         const T16* __restrict__ k,
                         const T16* __restrict__ v, T16* __restrict__ o,
                         float* __restrict__ lse, int seq, float scale,
                         int causal) {
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  constexpr int DC = out_cols<D>();
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * D;
  float m2[2], l[2];
#pragma unroll
  for (int col0 = 0; col0 < D; col0 += DC) {
    float acc[DC / 8][4];
    fwd_mma_tiles<T16, D, DC>(mma_smem_buf, q + base, k + base, v + base,
                              qt, 0, causal ? qt + 1 : num_t, causal, scale,
                              col0, m2, l, acc);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] /= l[e >> 1];
    store_rows<DC, D>(o + base + (size_t)qt * kTile * D + col0, acc, 1.f);
  }
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    const size_t row = (size_t)bh * seq + qt * kTile + 16 * (threadIdx.x >> 5)
                       + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[row + 8 * h] = m2[h] * kLn2 + logf(l[h]);
  }
}

// Streaming forward: grid (tiles, splits, BH), one split a CTA; the
// same float32 (m, l, acc) partials, m in natural units, for
// flash_fwd_str_merge_kernel.
template <typename T16, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_ctas<kFwdCtas>(D))
    flash_fwd_str_mma_kernel(const T16* __restrict__ q,
                             const T16* __restrict__ k,
                             const T16* __restrict__ v,
                             float* __restrict__ m_ws,
                             float* __restrict__ l_ws,
                             float* __restrict__ acc_ws, int seq, int split,
                             float scale, int causal) {
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - blockIdx.x;  // causal: the longest rows first
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  const int kt0 = sp * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;  // dead pair: every key after every query

  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  constexpr int DC = out_cols<D>();
  const size_t base = (size_t)bh * seq * D;
  const size_t at = ws_row(sp, bh, gridDim.z, seq, qt * kTile);
  float m2[2], l[2];
#pragma unroll
  for (int col0 = 0; col0 < D; col0 += DC) {
    float acc[DC / 8][4];
    fwd_mma_tiles<T16, D, DC>(mma_smem_buf, q + base, k + base, v + base,
                              qt, kt0, kt1, causal, scale, col0, m2, l, acc);
    store_rows<DC, D>(acc_ws + at * D + col0, acc, 1.f);
  }
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    const size_t row = at + 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_ws[row + 8 * h] = m2[h] * kLn2;
      l_ws[row + 8 * h] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256 ("wide" kernels).  The caller zero-pads D to a
// multiple of kWide = 128 (ops/flash_attention.py::kernel_head_dim), and
// the kernels take D at run time.  A 64 x D tile of Q (or dO) no longer
// fits in registers, nor six such tiles in shared memory (6 x 64 x 520
// bf16 is 399 KB at D = 512).  So each 16-bit backward kernel walks D in
// 128-column chunks twice over:
//
//   - the first products (S = Q K^T and dP = dO V^T, or their transposes
//     in dK/dV) accumulate over every chunk of D, one 64 x 128 chunk of
//     each operand staged in shared memory at a time;
//   - each CTA owns one 128-column slice of its outputs (an output pass):
//     dQ at columns col0..col0+127, or in dK/dV either dV's or dK's slice
//     (dV needs only P, dK also dP).  The ceil(D / 128) passes of a tile
//     run as neighbouring CTAs of the grid, each recomputing the first
//     products and P, as the D = 256 kernels' two passes do in one CTA.
//
// Registers then hold one 128-column accumulator, 32-key (32-query)
// blocks of S and dP, and a zeroed partial for each chunk's products
// (mma_abt_chunk).  Shared memory holds at most five 64 x 136 16-bit
// chunks (87 KB), whatever D.  The 16-bit kernels keep every piece of the
// D <= 256 kernels' arithmetic: exact 16-bit first products with float32
// sums, P and dS entering the second products as hi/lo pairs, bf16's third
// term where a warp's block holds |P| >= 2^-5 or |dS| >= 1, float16's
// per-row power-of-two scale.  The 16-bit forward, and the float32 forward
// and backward (in 3xTF32), compute S (and dP) once per tile pair in a
// cluster of CTAs (their own sections below).
// ---------------------------------------------------------------------------
constexpr int kWide = 128;              // columns of an output pass
constexpr int kWideLd = kWide + 8;      // shared row of a 16-bit chunk
constexpr int kWideTile = kTile * kWideLd;

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the [R, kWide] chunk at `src` (row stride d) into shared rows of
// kWideLd, 16 bytes a copy, by the NT threads of the CTA.
template <int R = kTile, int NT = kMmaThreads, typename T16>
__device__ __forceinline__ void chunk_async(T16* dst, const T16* src, int d) {
  constexpr int kPieces = kWide / 8;
  for (int i = threadIdx.x; i < R * kPieces; i += NT) {
    const int r = i / kPieces;
    const int c = i - r * kPieces;
    cp_async16(dst + r * kWideLd + c * 8, src + (size_t)r * d + c * 8);
  }
}

// Shared memory of a wide tensor-core kernel: `n` chunks, then two rows of
// kTile floats (LSE and delta).
__host__ __device__ constexpr size_t wide_mma_smem(int n) {
  return n * kWideTile * sizeof(uint16_t) + 2 * kTile * sizeof(float);
}
__device__ __forceinline__ float* wide_rows(unsigned char* smem, int n) {
  return reinterpret_cast<float*>(smem + n * kWideTile * sizeof(uint16_t));
}

// acc[n] += A B^T over one kWide-column chunk, through a zeroed partial:
// the tensor cores' float32 accumulation truncates, and its error grows
// with the number of k steps summed into one accumulator (at D = 1024,
// float16 dQ missed its gate by 1.5x in rows where dP - delta cancels);
// a chunk's 8 steps go into the partial, and the partials add with
// float32's round to nearest.
template <typename T16, int NB>
__device__ __forceinline__ void mma_abt_chunk(float (&acc)[NB][4],
                                              const T16* a, const T16* b,
                                              int lane) {
  float part[NB][4];
  zero(part);
  mma_abt<T16, kWide, NB>(part, a, b, lane);
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// rowsum(a * b) over d elements for the calling warp (delta of the wide
// kernels): each lane sums every 32nd element, then a shuffle tree, in
// float64 as every delta here (see delta_sum at the top).
template <typename T>
__device__ __forceinline__ float warp_row_dot(const T* a, const T* b,
                                              int d) {
  double s = 0.0;
  for (int i = threadIdx.x & 31; i < d; i += 32)
    s += (double)to_f32(a[i]) * (double)to_f32(b[i]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return (float)s;
}

// Grid x of a wide launch: the tiles times the passes, a tile's passes
// side by side.
__device__ __forceinline__ void wide_block(int npass, int& tile, int& pass) {
  tile = blockIdx.x / npass;
  pass = blockIdx.x - tile * npass;
}

// Columns [col0, col0 + kWide) of dQ at a wide D: dq_mma_tiles with S and
// dP summed over the chunks of D, each k tile taken in two halves of 32
// keys (the chunk partials need the registers a 64-key block would);
// `rows` (LSE, then delta) written by the caller.
template <typename T16>
__device__ __forceinline__ void dq_wide_tiles(
    unsigned char* smem, const T16* q, const T16* k, const T16* v,
    const T16* dout, int d, int qt, int kt0, int kt1, int causal,
    float scale, int col0, float (&acc)[kWide / 8][4]) {
  constexpr int NK = kTile / 2;  // keys a half takes
  T16* qs = reinterpret_cast<T16*>(smem);
  T16* dos = qs + kWideTile;
  T16* ks = dos + kWideTile;     // NK rows
  T16* vs = ks + kWideTile;      // NK rows
  T16* ko = vs + kWideTile;      // K's output columns, the whole tile
  const float* rows = wide_rows(smem, 5);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nch = d / kWide;
  float cs[2] = {kRowScaleMax, kRowScaleMax};
  const int r0 = 16 * warp + (lane >> 2);
  for (int kt = kt0; kt < kt1; ++kt) {
    for (int h = 0; h < 2; ++h) {
      float s[NK / 8][4], dp[NK / 8][4];
      zero(s);
      zero(dp);
      for (int c = 0; c < nch; ++c) {
        __syncthreads();
        const size_t qo = (size_t)qt * kTile * d + c * kWide;
        const size_t ko0 = ((size_t)kt * kTile + h * NK) * d + c * kWide;
        chunk_async(qs, q + qo, d);
        chunk_async(dos, dout + qo, d);
        chunk_async<NK>(ks, k + ko0, d);
        chunk_async<NK>(vs, v + ko0, d);
        if (h == 0 && c == nch - 1)
          chunk_async(ko, k + (size_t)kt * kTile * d + col0, d);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        mma_abt_chunk<T16, NK / 8>(s, qs + 16 * warp * kWideLd, ks, lane);
        mma_abt_chunk<T16, NK / 8>(dp, dos + 16 * warp * kWideLd, vs, lane);
      }
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int row = qt * kTile + r;                            // query
          const int col = kt * kTile + h * NK + n * 8 + 2 * (lane & 3) +
                          (e & 1);                                   // key
          const float p = causal && col > row
                              ? 0.f
                              : expf(scale * s[n][e] - rows[r]);
          dp[n][e] = p * (dp[n][e] - rows[kTile + r]);
        }
      if constexpr (kScaleRows<T16>()) scale_rows<NK / 8, kWide>(dp, acc, cs);
      mma_xb_bwd<T16, kWide, kWide, NK / 16>(acc, dp, ko + h * NK * kWideLd,
                                             lane, kRefineDs);
    }
  }
  if constexpr (kScaleRows<T16>()) unscale_rows<kWide>(acc, cs);
}

template <typename T16>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dq_wide_mma_kernel(const T16* __restrict__ q,
                                 const T16* __restrict__ k,
                                 const T16* __restrict__ v,
                                 const T16* __restrict__ o,
                                 const T16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 T16* __restrict__ dq,
                                 float* __restrict__ delta, int seq, int d,
                                 float scale, int causal) {
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  float* rows = wide_rows(mma_smem_buf, 5);
  int qt, pass;
  wide_block(d / kWide, qt, pass);
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * d;
  // delta = rowsum(dO * O) over all of D, a warp a row; every pass
  // computes it, the first writes it out.
  for (int r = threadIdx.x >> 5; r < kTile; r += kWarps) {
    const size_t at = base + (size_t)(qt * kTile + r) * d;
    const float dl = warp_row_dot(dout + at, o + at, d);
    if ((threadIdx.x & 31) == 0) {
      const size_t row = (size_t)bh * seq + qt * kTile + r;
      if (pass == 0) delta[row] = dl;
      rows[r] = lse[row];
      rows[kTile + r] = dl;
    }
  }
  const int col0 = pass * kWide;
  float acc[kWide / 8][4];
  zero(acc);
  dq_wide_tiles<T16>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                     d, qt, 0, causal ? qt + 1 : seq / kTile, causal, scale,
                     col0, acc);
  store_rows_ld<kWide>(dq + base + (size_t)qt * kTile * d + col0, d, acc,
                       scale);
}

template <typename T16>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dq_str_wide_mma_kernel(const T16* __restrict__ q,
                                     const T16* __restrict__ k,
                                     const T16* __restrict__ v,
                                     const T16* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dq_ws, int seq,
                                     int d, int split, float scale,
                                     int causal) {
  const int num_t = seq / kTile;
  int t, pass;
  wide_block(d / kWide, t, pass);
  const int qt = num_t - 1 - t;
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  const int kt0 = sp * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;

  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  float* rows = wide_rows(mma_smem_buf, 5);
  const size_t base = (size_t)bh * seq * d;
  if (threadIdx.x < kTile) {
    const size_t row = (size_t)bh * seq + qt * kTile + threadIdx.x;
    rows[threadIdx.x] = lse[row];
    rows[kTile + threadIdx.x] = delta[row];
  }
  const int col0 = pass * kWide;
  float acc[kWide / 8][4];
  zero(acc);
  dq_wide_tiles<T16>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                     d, qt, kt0, kt1, causal, scale, col0, acc);
  store_rows_ld<kWide>(
      dq_ws + ws_row(sp, bh, gridDim.z, seq, qt * kTile) * d + col0, d, acc,
      1.f);
}

// One output pass of dK/dV of the k tile `kt` at a wide D over the q tiles
// [qt0, qt1): dV's columns [col0, col0 + kWide) from P^T dO, or (dk) dK's
// from dS^T Q, S^T = K Q^T and dP^T = V dO^T summed over the chunks of D,
// each q tile in two halves of 32 queries (as dq_wide_tiles halves its
// keys).  The dV pass needs no dP.
template <typename T16>
__device__ __forceinline__ void dkv_wide_tiles(
    unsigned char* smem, const T16* q, const T16* k, const T16* v,
    const T16* dout, const float* lse, const float* delta, int d, int kt,
    int qt0, int qt1, int causal, float scale, bool dk, int col0,
    float (&acc)[kWide / 8][4]) {
  constexpr int NQ = kTile / 2;  // queries a half takes
  T16* ks = reinterpret_cast<T16*>(smem);
  T16* qs = ks + kWideTile;      // NQ rows
  T16* vs = qs + kWideTile;
  T16* dos = vs + kWideTile;     // NQ rows
  T16* xo = dos + kWideTile;     // NQ rows of Q's (dK) or dO's (dV) columns
  float* rows = wide_rows(smem, 5);  // the q tile's LSE, then delta
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nch = d / kWide;
  float cs[2] = {kRowScaleMax, kRowScaleMax};
  const int krow = kt * kTile + 16 * warp + (lane >> 2);  // key, +8 for e >= 2
  for (int qt = qt0; qt < qt1; ++qt) {
    for (int h = 0; h < 2; ++h) {
      float st[NQ / 8][4], dpt[NQ / 8][4];
      zero(st);
      zero(dpt);
      for (int c = 0; c < nch; ++c) {
        __syncthreads();
        const size_t ko0 = (size_t)kt * kTile * d + c * kWide;
        const size_t qo = ((size_t)qt * kTile + h * NQ) * d;
        chunk_async(ks, k + ko0, d);
        chunk_async<NQ>(qs, q + qo + c * kWide, d);
        if (dk) {
          chunk_async(vs, v + ko0, d);
          chunk_async<NQ>(dos, dout + qo + c * kWide, d);
        }
        if (c == nch - 1) {
          chunk_async<NQ>(xo, (dk ? q : dout) + qo + col0, d);
          if (h == 0) {
            rows_async(rows, lse + (size_t)qt * kTile);
            rows_async(rows + kTile, delta + (size_t)qt * kTile);
          }
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        mma_abt_chunk<T16, NQ / 8>(st, ks + 16 * warp * kWideLd, qs, lane);
        if (dk)
          mma_abt_chunk<T16, NQ / 8>(dpt, vs + 16 * warp * kWideLd, dos,
                                     lane);
      }
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = h * NQ + n * 8 + 2 * (lane & 3) + (e & 1);  // query
          const int key = krow + (e >> 1) * 8;
          const float p = causal && key > qt * kTile + j
                              ? 0.f
                              : expf(scale * st[n][e] - rows[j]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - rows[kTile + j]);
        }
      if (dk) {
        if constexpr (kScaleRows<T16>())
          scale_rows<NQ / 8, kWide>(dpt, acc, cs);
        mma_xb_bwd<T16, kWide, kWide, NQ / 16>(acc, dpt, xo, lane,
                                               kRefineDs);
      } else {
        if constexpr (kScaleRows<T16>())
          scale_rows<NQ / 8, kWide>(st, acc, cs);
        mma_xb_bwd<T16, kWide, kWide, NQ / 16>(acc, st, xo, lane, kRefineP);
      }
    }
  }
  if constexpr (kScaleRows<T16>()) unscale_rows<kWide>(acc, cs);
}

// dK/dV at a wide D: grid x is the k tiles times 2 * D / kWide passes, the
// first D / kWide of a tile dV's slices, the rest dK's.
template <typename T16>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkv_wide_mma_kernel(const T16* __restrict__ q,
                                  const T16* __restrict__ k,
                                  const T16* __restrict__ v,
                                  const T16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  T16* __restrict__ dk, T16* __restrict__ dv,
                                  int seq, int d, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  const int npass = d / kWide;
  int kt, pass;
  wide_block(2 * npass, kt, pass);
  const bool is_dk = pass >= npass;
  const int col0 = (is_dk ? pass - npass : pass) * kWide;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * d;
  float acc[kWide / 8][4];
  zero(acc);
  dkv_wide_tiles<T16>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                      lse + (size_t)bh * seq, delta + (size_t)bh * seq, d, kt,
                      causal ? kt : 0, seq / kTile, causal, scale, is_dk,
                      col0, acc);
  store_rows_ld<kWide>((is_dk ? dk : dv) + base + (size_t)kt * kTile * d +
                           col0,
                       d, acc, is_dk ? scale : 1.f);
}

template <typename T16>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkv_str_wide_mma_kernel(const T16* __restrict__ q,
                                      const T16* __restrict__ k,
                                      const T16* __restrict__ v,
                                      const T16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      float* __restrict__ dk_ws,
                                      float* __restrict__ dv_ws, int seq,
                                      int d, int split, float scale,
                                      int causal) {
  const int num_t = seq / kTile;
  const int npass = d / kWide;
  int kt, pass;
  wide_block(2 * npass, kt, pass);
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  int qt0 = sp * split;
  const int qt1 = min(qt0 + split, num_t);
  if (causal) qt0 = max(qt0, kt);
  if (qt0 >= qt1) return;  // dead pair: every query before every key

  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  const bool is_dk = pass >= npass;
  const int col0 = (is_dk ? pass - npass : pass) * kWide;
  const size_t base = (size_t)bh * seq * d;
  float acc[kWide / 8][4];
  zero(acc);
  dkv_wide_tiles<T16>(mma_smem_buf, q + base, k + base, v + base, dout + base,
                      lse + (size_t)bh * seq, delta + (size_t)bh * seq, d, kt,
                      qt0, qt1, causal, scale, is_dk, col0, acc);
  const size_t at = ws_row(sp, bh, gridDim.z, seq, kt * kTile) * d + col0;
  store_rows_ld<kWide>((is_dk ? dk_ws : dv_ws) + at, d, acc, 1.f);
}

// ---- the float32 backward on the tensor cores: 3xTF32 --------------------
// flash_bwd_dq_tc_kernel<D>, flash_bwd_dq_str_tc_kernel<D>,
// flash_bwd_dkv_tc_kernel<D> and flash_bwd_dkv_str_tc_kernel<D> (D = 16,
// 32, 64 and 128) and flash_bwd_dq_wide_kernel, flash_bwd_dq_str_wide_kernel,
// flash_bwd_dkv_wide_kernel and flash_bwd_dkv_str_wide_kernel (D = 256 and
// above) replace the TPU kernels _dq_kernel_res (:168), _dq_kernel_str
// (:250), _dkv_kernel_res (:192) and _dkv_kernel_str (:275) of
// byteps_tpu/ops/flash_attention.py in float32.  What bounds them is the
// products: 6 (dQ) and 8 (dK/dV) FLOPs per visible (q, k) pair and
// head-dim element, 0.039 and 0.052 ms at the 3xTF32 ceiling (below) for
// [128, 512, 64] causal against about 0.03 ms of bytes, 0.23 and 0.31 ms
// for [128, 512, 384].
//
// Both run the same tile loops (dq_tiles_f32, dkv_tiles_f32), templated on
// the slice width W, the columns of Q, K, V and dO a CTA holds, and on
// kCluster.  At D <= 128, W = D and one CTA holds all of D: its own S and
// dP are the whole sums, and it turns them into P and dS in its registers
// (tile_pds) with no exchange rows and no cluster.  From D = 256, W = 128
// and the slices meet in a cluster:
//
// One output slice a CTA, as in the 16-bit wide backward, would have every
// slice recompute S = Q K^T and dP = dO V^T over all of D: about 3.9x the
// function's products at D = 512.  Here the n = D / 128 slices of a tile
// run as one thread-block cluster of n CTAs (at most 8, the portable size),
// and each CTA contracts S and dP over its own 128 columns only: a partial.
// The partials meet in distributed shared memory.  Row r of the 64 x 64
// tile pair belongs to rank r / R (R = ceil(64 / n)): each CTA pushes its
// partial rows to their owners, the owner adds the n partials in rank order
// 0..n-1 (so no row has two sums that differ in the last bit), computes
// P = exp(scale S - LSE) and dS = P (dP - delta) for its rows, and pushes
// them to every CTA of the cluster; two cluster barriers a tile pair (where
// every CTA summing all n partials itself would read n x 32 KB of the
// others' memory a pair, and compute P and dS n times).  Each
// CTA then applies dS (and P) to its own 128 columns: dQ += dS K, or
// dV += P^T dO and dK += dS^T Q in one CTA.  The products issued are the
// function's, each operand column is read by one CTA, and the exchange
// moves about (n - 1) / n of 48 KB (dQ) or 64 KB (dK/dV) a CTA and pair.
// Above 8 slices a CTA takes ceil(n / 8) of them: its partial sums its
// slices in ascending order, and it runs the tile loop once for each slice
// it outputs, so there is no limit on D.
//
// The products run on the tensor cores at float32 accuracy: each operand x
// enters mma.sync m16n8k8 (TF32 in, float32 sums) as hi = tf32(x) and
// lo = tf32(x - hi), rounded to nearest (tf32_rna), and a product takes
// lo hi + hi lo + hi hi (lo lo dropped): about 22 significant bits, where
// one TF32 rounding keeps 11 and misses the float32 gates
// (tests/test_torch_port_flash_f32tc.py emulates both).  The tensor cores
// truncate their float32 sums, so every 16 elements of a contraction (two
// k steps, six MMAs) go into a zeroed partial added in float32, where the
// 16-bit wide kernels take a 128-column chunk: with 48 MMAs into one
// accumulator the emulation reads up to 0.50 of the float32 gate, against
// 0.10 with the 16-element partials (D = 512, causal).  The
// TF32 ceiling is 495 / 3 = 165 TFLOP/s of the function's work.
//
// Eight warps; for the first products warp w takes rows 16 (w & 3) of the
// tile pair and keys 32 (w >> 2), for the second its rows and W / 2 of the
// slice's columns (one n8 block at W = 16).  The four 64 x W float32 chunks
// (the fixed tile's two, the streamed tile's two) sit in shared memory
// without padding, their columns XOR-swizzled by row (swz_w) so that the
// 16-byte loads of the first products and the 4-byte column loads of the
// second hit 32 banks; the streamed chunks come in by cp.async, each
// reloaded as soon as its last product is issued (V's during the K
// products, K's and Q's during the next pair's dP) rather than
// double-buffered: in a cluster the exchange rows and the P/dS tiles with
// the chunks make 181-200 KB a CTA (one an SM), and a second set of
// streamed chunks (64 KB) does not fit.  Without a cluster a CTA takes
// 80.5 KB (dQ) or 96.5 KB (dK/dV) at W = 64, two an SM, and 144.5 or
// 160.5 KB at W = 128.  There a second stage of the streamed chunks fits,
// but measured no faster in dQ and at W = 128, and 17% slower in dK/dV at
// W = 64, whose 128.5 KB leave one CTA an SM (scripts/flash_f32_bwd_ab.py,
// variant dbuf); one CTA an SM at W = 64 (ctas1) was 5-17% slower too.
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 256;                 // 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kSplitCtas = 8;                   // portable cluster size

// Exchange rows an owner takes in a cluster of c CTAs.
__host__ __device__ constexpr int split_rows(int c) {
  return (kTile + c - 1) / c;
}

// Shared memory of the float32 backward at slice width W: LSE and delta of
// the CTA's rows, four 64 x W chunks, in a cluster of c CTAs the S and dP
// exchange rows (c slots of R rows each), and `tiles` [kTile][kTile] tiles
// (dS; P).
template <int W, bool kCluster>
__host__ __device__ constexpr size_t f32_bwd_smem(int c, int tiles) {
  return (2 * kTile + 4 * kTile * W +
          (kCluster ? 2 * c * split_rows(c) * kTile : 0) +
          tiles * kTile * kTile) * sizeof(float);
}

// CTAs an SM the float32 kernels without a cluster (the forward and the
// backward at D <= 128) are compiled for (__launch_bounds__): two up to
// W = 64, one at W = 128.
__host__ __device__ constexpr int f32_tc_ctas(int w) {
  return w <= 64 ? 2 : 1;
}

// Float offset of (row, col) in a swizzled tile of w columns (w a multiple
// of 32): bits 3 and 4 of the column flip with rows' bits 1, and 0 ^ 2.  A
// 16-byte piece (columns 4i..4i+3) stays whole.
__device__ __forceinline__ int swz(int row, int col, int w) {
  return row * w +
         (col ^ ((((row >> 1) & 1) << 3) | ((((row >> 2) ^ row) & 1) << 4)));
}

// The same in a 64 x W chunk.  A row of W = 16 floats covers 16 banks, and
// the rows 8kk + 2t that one load of the second products reads would all
// start in bank 0: there rows 2i and 2i + 1 are swizzled as row i of a
// 32-column tile, the odd row in its columns 16..31.
template <int W>
__device__ __forceinline__ int swz_w(int row, int col) {
  static_assert(W == 16 || W == 32 || W == 64 || W == 128, "slice width");
  if constexpr (W == 16)
    return swz(row >> 1, col | (row & 1) << 4, 32);
  else
    return swz(row, col, W);
}

// Copy the [kTile, W] float32 chunk at `src` (row stride d) into a
// swizzled chunk, 16 bytes a copy.
template <int W>
__device__ __forceinline__ void chunk_f32_async(float* dst, const float* src,
                                                int d) {
  for (int i = threadIdx.x; i < kTile * W / 4; i += kTcThreads) {
    const int r = i / (W / 4);
    const int c = (i % (W / 4)) * 4;
    cp_async16(dst + swz_w<W>(r, c), src + (size_t)r * d + c);
  }
}

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x: half a step added to the magnitude's
// bits, the 13 bits below the mantissa cleared.  Two integer operations;
// the cvt instruction made the kernels 13-16% slower on an H100
// (scripts/flash_f32_wide_ab.py, variant "cvt").
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b: a 16x8 (row), b 8x8 (col), c 16x8, TF32 in, float32 sums.
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 from the operands' hi/lo parts, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma1688(c, al, bh0, bh1);
  mma1688(c, ah, bl0, bl1);
  mma1688(c, ah, bh0, bh1);
}

template <int NB>
__device__ __forceinline__ void add_to(float (&acc)[NB][4],
                                       const float (&part)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// acc[n] += A B^T over columns 16 k16.. of a swizzled chunk: A is the 16
// rows from `arow` of chunk `a`, B the 8 NB rows from `brow` of chunk `b`.
// A lane reads four adjacent columns with one 16-byte load, and an MMA k
// step takes two of them as its k = t and t + 4 (columns 4t and 4t + 1 of
// 16, then 4t + 2 and 4t + 3): the same sum in another order.  The 16
// columns' six MMAs go into a zeroed partial added to acc in float32: the
// tensor cores truncate their float32 sums, and 48 MMAs into one
// accumulator (a chunk) read five times higher in the emulation.
template <int W, int NB>
__device__ __forceinline__ void mma3_abt_step(float (&acc)[NB][4],
                                              const float* a, int arow,
                                              const float* b, int brow,
                                              int k16, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int col = 16 * k16 + 4 * t;
  const float4 x0 =
      *reinterpret_cast<const float4*>(a + swz_w<W>(arow + g, col));
  const float4 x8 =
      *reinterpret_cast<const float4*>(a + swz_w<W>(arow + g + 8, col));
  uint32_t ah[2][4], al[2][4];
  split_tf32(x0.x, ah[0][0], al[0][0]);
  split_tf32(x8.x, ah[0][1], al[0][1]);
  split_tf32(x0.y, ah[0][2], al[0][2]);
  split_tf32(x8.y, ah[0][3], al[0][3]);
  split_tf32(x0.z, ah[1][0], al[1][0]);
  split_tf32(x8.z, ah[1][1], al[1][1]);
  split_tf32(x0.w, ah[1][2], al[1][2]);
  split_tf32(x8.w, ah[1][3], al[1][3]);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float4 y = *reinterpret_cast<const float4*>(
        b + swz_w<W>(brow + 8 * n + g, col));
    uint32_t bh[4], bl[4];
    split_tf32(y.x, bh[0], bl[0]);
    split_tf32(y.y, bh[1], bl[1]);
    split_tf32(y.z, bh[2], bl[2]);
    split_tf32(y.w, bh[3], bl[3]);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(part, ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
    mma3(part, ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// mma3_abt_step over the chunk's W / 16 groups of 16 columns, unrolled by
// two (kUnroll; unrolled whole at W = 128, the kernels spilled) or not.
template <int W, int NB, bool kUnroll>
__device__ __forceinline__ void mma3_abt(float (&acc)[NB][4], const float* a,
                                         int arow, const float* b, int brow,
                                         int lane) {
  if constexpr (kUnroll) {
#pragma unroll 2
    for (int k16 = 0; k16 < W / 16; ++k16)
      mma3_abt_step<W>(acc, a, arow, b, brow, k16, lane);
  } else {
#pragma unroll 1
    for (int k16 = 0; k16 < W / 16; ++k16)
      mma3_abt_step<W>(acc, a, arow, b, brow, k16, lane);
  }
}

// part[n] += X B over the 8 contraction rows of k step kk (see mma3_xb).
template <int W, bool kT, int NB>
__device__ __forceinline__ void mma3_xb_step(float (&part)[NB][4],
                                             const float* x, int xrow,
                                             const float* b, int col0,
                                             int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int k0 = 8 * kk + 2 * t;
  float xa[4];
  if constexpr (kT) {
    xa[0] = x[swz(k0, xrow + g, kTile)];
    xa[1] = x[swz(k0, xrow + g + 8, kTile)];
    xa[2] = x[swz(k0 + 1, xrow + g, kTile)];
    xa[3] = x[swz(k0 + 1, xrow + g + 8, kTile)];
  } else {
    const float2 u =
        *reinterpret_cast<const float2*>(x + swz(xrow + g, k0, kTile));
    const float2 w =
        *reinterpret_cast<const float2*>(x + swz(xrow + g + 8, k0, kTile));
    xa[0] = u.x;
    xa[1] = w.x;
    xa[2] = u.y;
    xa[3] = w.y;
  }
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(xa[i], ah[i], al[i]);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = col0 + 8 * n + g;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b[swz_w<W>(k0, col)], bh0, bl0);
    split_tf32(b[swz_w<W>(k0 + 1, col)], bh1, bl1);
    mma3(part[n], ah, al, bh0, bh1, bl0, bl1);
  }
}

// acc[n] += X B: X is the 16 rows from `xrow` of a swizzled [kTile][kTile]
// tile (dS), or with kT its columns from `xrow` as rows (P^T, dS^T); B is
// the swizzled chunk `b`'s columns col0 + 8n (n < NB), contracted along its
// 64 rows.  An MMA k step's k = t and t + 4 are rows 8kk + 2t and
// 8kk + 2t + 1.  Each 16 rows' six MMAs go into a zeroed partial added to
// acc in float32, as in mma3_abt.
template <int W, bool kT, int NB>
__device__ __forceinline__ void mma3_xb(float (&acc)[NB][4], const float* x,
                                        int xrow, const float* b, int col0,
                                        int lane) {
#pragma unroll 1
  for (int kk = 0; kk < kTile / 8; kk += 2) {
    float part[NB][4];
    zero(part);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      mma3_xb_step<W, kT, NB>(part, x, xrow, b, col0, kk + u, lane);
    add_to(acc, part);
  }
}

// ---- the cluster: rank, size, barrier, stores into another CTA's memory --
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// Every thread of every CTA of the cluster arrives; shared-memory stores
// before it (to any CTA) are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The split-D exchange of one tile pair (q tile qt, k tile kt): the
// warps' partial S and dP blocks (rows 16 (warp & 3), keys 32 (warp >> 2))
// go to their rows' owners; each owner adds the cluster's partials in rank
// order and writes P (into `pt`, unless null) and dS (into `dst`), swizzled
// [kTile][kTile] tiles, into every CTA of the cluster.  `rows` holds the
// LSE, then (from R on) delta of this CTA's rows.  Ends with every tile
// complete in every CTA.
__device__ __forceinline__ void split_exchange(
    const float (&s)[4][4], const float (&dp)[4][4], float* ex, float* pt,
    float* dst, const float* rows, int qt, int kt, int causal, float scale,
    int rank, int c) {
  const int R = split_rows(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* xs = ex;                        // [c * R][kTile], slot-major
  float* xdp = ex + c * R * kTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * (warp & 3) + g + 8 * h;
    const int owner = row / R;
    const int slot_row = rank * R + row - owner * R;
    const uint32_t s_at = cluster_addr(smem_addr(xs), owner);
    const uint32_t dp_at = cluster_addr(smem_addr(xdp), owner);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const uint32_t off = 4u * (uint32_t)swz(
          slot_row, 32 * (warp >> 2) + 8 * n + 2 * t, kTile);
      st_cluster2(s_at + off, s[n][2 * h], s[n][2 * h + 1]);
      st_cluster2(dp_at + off, dp[n][2 * h], dp[n][2 * h + 1]);
    }
  }
  cluster_sync();  // every partial is at its owner
  const int own0 = rank * R;
  const int nown = max(0, min(kTile, own0 + R) - own0);
  for (int i = threadIdx.x; i < nown * (kTile / 4); i += kTcThreads) {
    const int lr = i / (kTile / 4);
    const int col = (i % (kTile / 4)) * 4;
    const int row = own0 + lr;
    float sv[4], dv[4];
    {
      const float4 a = *reinterpret_cast<const float4*>(
          xs + swz(lr, col, kTile));
      const float4 b = *reinterpret_cast<const float4*>(
          xdp + swz(lr, col, kTile));
      sv[0] = a.x, sv[1] = a.y, sv[2] = a.z, sv[3] = a.w;
      dv[0] = b.x, dv[1] = b.y, dv[2] = b.z, dv[3] = b.w;
    }
    for (int j = 1; j < c; ++j) {  // rank order
      const int at = swz(j * R + lr, col, kTile);
      const float4 a = *reinterpret_cast<const float4*>(xs + at);
      const float4 b = *reinterpret_cast<const float4*>(xdp + at);
      sv[0] += a.x, sv[1] += a.y, sv[2] += a.z, sv[3] += a.w;
      dv[0] += b.x, dv[1] += b.y, dv[2] += b.z, dv[3] += b.w;
    }
    const float lse_r = rows[lr];
    const float del_r = rows[R + lr];
    const int query = qt * kTile + row;
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = causal && kt * kTile + col + e > query
                 ? 0.f
                 : expf(scale * sv[e] - lse_r);
      ds[e] = p[e] * (dv[e] - del_r);
    }
    const uint32_t at = 4u * (uint32_t)swz(row, col, kTile);
    const uint32_t ds_at = smem_addr(dst) + at;
    const uint32_t p_at = pt ? smem_addr(pt) + at : 0u;
    for (int j = 0; j < c; ++j) {
      st_cluster4(cluster_addr(ds_at, j),
                  make_float4(ds[0], ds[1], ds[2], ds[3]));
      if (pt)
        st_cluster4(cluster_addr(p_at, j),
                    make_float4(p[0], p[1], p[2], p[3]));
    }
  }
  cluster_sync();  // P and dS complete in every CTA
}

// Store the warp's 16 rows from `row0` of 8 NB output columns from `col0`
// (row stride d), times `scale`: float32, or the 16-bit forward's O.
template <int NB, typename Out>
__device__ __forceinline__ void store_tc_rows(Out* out, int d, int row0,
                                              int col0,
                                              const float (&acc)[NB][4],
                                              float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(out + (size_t)(row0 + g + 8 * h) * d + col0 + 8 * n + 2 * t,
             scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
}

__device__ __forceinline__ float* tc_rows(float* smem) { return smem; }
__device__ __forceinline__ float* tc_chunks(float* smem) {
  return smem + 2 * kTile;
}

// Size of the CTA's cluster and its rank there; 1 and 0 without one.
template <bool kCluster>
__device__ __forceinline__ int ctas() {
  if constexpr (kCluster) return cluster_size();
  else return 1;
}
template <bool kCluster>
__device__ __forceinline__ int cta_rank() {
  if constexpr (kCluster) return cluster_rank();
  else return 0;
}

// Rows of the q tile this CTA owns in the exchange: [own0, own0 + nown)
// (all 64 without a cluster).
template <bool kCluster>
__device__ __forceinline__ void owned_rows(int& own0, int& nown) {
  const int R = split_rows(ctas<kCluster>());
  own0 = cta_rank<kCluster>() * R;
  nown = max(0, min(kTile, own0 + R) - own0);
}

// P (into `pt`, unless null) and dS (into `dst`), swizzled [kTile][kTile]
// tiles, of one tile pair (q tile qt, k tile kt) without a cluster: the
// CTA holds all of D, so its warps' S and dP blocks (rows 16 (warp & 3),
// keys 32 (warp >> 2)) are the whole sums.  `rows` holds the tile's LSE,
// then (from kTile on) delta.  split_exchange's arithmetic, from the
// registers; ends with both tiles complete.
__device__ __forceinline__ void tile_pds(const float (&s)[4][4],
                                         const float (&dp)[4][4], float* pt,
                                         float* dst, const float* rows,
                                         int qt, int kt, int causal,
                                         float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * (warp & 3) + g + 8 * h;
    const float lse_r = rows[row];
    const float del_r = rows[kTile + row];
    const int query = qt * kTile + row;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 32 * (warp >> 2) + 8 * n + 2 * t;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = causal && kt * kTile + col + e > query
                   ? 0.f
                   : expf(scale * s[n][2 * h + e] - lse_r);
        ds[e] = p[e] * (dp[n][2 * h + e] - del_r);
      }
      const int at = swz(row, col, kTile);
      store2(dst + at, ds[0], ds[1]);
      if (pt) store2(pt + at, p[0], p[1]);
    }
  }
  __syncthreads();
}

// dQ of the q tile `qt` over the k tiles [kt0, kt1) in float32 at slice
// width W, this CTA's slices of it (see the section's note), written to
// `out` (the tile's first row, row stride d) times out_scale.  The caller
// has put the LSE and delta of the CTA's rows in tc_rows.
template <int W, bool kCluster>
__device__ __forceinline__ void dq_tiles_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* dout, int d, int qt, int kt0, int kt1, int causal,
    float scale, float out_scale, float* out) {
  constexpr int kChunk = kTile * W;
  const int c = ctas<kCluster>(), rank = cta_rank<kCluster>();
  float* qc = tc_chunks(smem);
  float* doc = qc + kChunk;
  float* kc = doc + kChunk;
  float* vc = kc + kChunk;
  float* ex = vc + kChunk;          // the exchange rows, in a cluster
  float* dst = ex + (kCluster ? 2 * c * split_rows(c) * kTile : 0);
  const float* rows = tc_rows(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = 16 * (warp & 3);      // the warp's rows
  const int kh = 32 * (warp >> 2);     // its keys in the first products
  const int oh = W / 2 * (warp >> 2);  // its columns of the output slice
  const int n = d / W;
  const int spc = kCluster ? (n + c - 1) / c : 1;  // slices a CTA takes
  const size_t qo = (size_t)qt * kTile * d;
  for (int pass = 0; pass < spc; ++pass) {
    const int jo = rank + pass * c;  // the slice this pass outputs (if < n)
    if (spc == 1) {
      chunk_f32_async<W>(qc, q + qo + jo * W, d);
      chunk_f32_async<W>(doc, dout + qo + jo * W, d);
      chunk_f32_async<W>(vc, v + (size_t)kt0 * kTile * d + jo * W, d);
      cp_async_commit();
      chunk_f32_async<W>(kc, k + (size_t)kt0 * kTile * d + jo * W, d);
      cp_async_commit();
    }
    // the cluster runs before any store reaches a CTA
    if constexpr (kCluster) cluster_sync();
    float acc[W / 16][4];
    zero(acc);
    for (int kt = kt0; kt < kt1; ++kt) {
      const size_t ko = (size_t)kt * kTile * d;
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      if (spc == 1) {
        cp_async_wait_prev();  // Q, dO and V of tile kt
        __syncthreads();
        mma3_abt<W, 4, true>(dp, doc, rw, vc, kh, lane);
        __syncthreads();  // every warp is done with V
        if (kt + 1 < kt1)
          chunk_f32_async<W>(vc, v + ko + kTile * d + jo * W, d);
        cp_async_commit();
        cp_async_wait_prev();  // K of tile kt
        __syncthreads();
        mma3_abt<W, 4, true>(s, qc, rw, kc, kh, lane);
      } else {
        int last = -1;
        for (int j = rank; j < n; j += c) {
          __syncthreads();
          chunk_f32_async<W>(qc, q + qo + j * W, d);
          chunk_f32_async<W>(doc, dout + qo + j * W, d);
          chunk_f32_async<W>(kc, k + ko + j * W, d);
          chunk_f32_async<W>(vc, v + ko + j * W, d);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          mma3_abt<W, 4, true>(dp, doc, rw, vc, kh, lane);
          mma3_abt<W, 4, true>(s, qc, rw, kc, kh, lane);
          last = j;
        }
        if (jo < n && last != jo) {  // the output slice's K for dS K
          __syncthreads();
          chunk_f32_async<W>(kc, k + ko + jo * W, d);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
      }
      if constexpr (kCluster)
        split_exchange(s, dp, ex, nullptr, dst, rows, qt, kt, causal, scale,
                       rank, c);
      else
        tile_pds(s, dp, nullptr, dst, rows, qt, kt, causal, scale);
      if (jo < n) mma3_xb<W, false, W / 16>(acc, dst, rw, kc, oh, lane);
      if (spc == 1) {
        __syncthreads();  // every warp is done with K
        if (kt + 1 < kt1)
          chunk_f32_async<W>(kc, k + ko + kTile * d + jo * W, d);
        cp_async_commit();
      }
    }
    if (jo < n) store_tc_rows(out, d, rw, jo * W + oh, acc, out_scale);
  }
}

// Resident dQ: grid x is the q tiles (the longest causal rows first)
// times the cluster's CTAs; each CTA computes delta = rowsum(dO * O) of its
// owned rows over all of D and writes it out for the dK/dV kernel.
template <int W, bool kCluster>
__device__ __forceinline__ void bwd_dq_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* o, const float* dout, const float* lse, float* dq,
    float* delta, int seq, int d, float scale, int causal) {
  const int qt = seq / kTile - 1 - (int)blockIdx.x / ctas<kCluster>();
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * d;
  int own0, nown;
  owned_rows<kCluster>(own0, nown);
  const int R = split_rows(ctas<kCluster>());
  float* rows = tc_rows(smem);
  for (int r = threadIdx.x >> 5; r < nown; r += kTcWarps) {
    const size_t row = (size_t)bh * seq + qt * kTile + own0 + r;
    const float dl = warp_row_dot(dout + row * d, o + row * d, d);
    if ((threadIdx.x & 31) == 0) {
      rows[r] = lse[row];
      rows[R + r] = dl;
      delta[row] = dl;
    }
  }
  dq_tiles_f32<W, kCluster>(smem, q + base, k + base, v + base, dout + base,
                            d, qt, 0, causal ? qt + 1 : seq / kTile, causal,
                            scale, scale, dq + base + (size_t)qt * kTile * d);
}

template <int W, bool kCluster>
__device__ __forceinline__ void bwd_dq_str_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dq_ws,
    int seq, int d, int split, float scale, int causal) {
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - (int)blockIdx.x / ctas<kCluster>();
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  const int kt0 = sp * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;  // the whole cluster: its CTAs share the tile

  const size_t base = (size_t)bh * seq * d;
  int own0, nown;
  owned_rows<kCluster>(own0, nown);
  const int R = split_rows(ctas<kCluster>());
  float* rows = tc_rows(smem);
  if (threadIdx.x < nown) {
    const size_t row = (size_t)bh * seq + qt * kTile + own0 + threadIdx.x;
    rows[threadIdx.x] = lse[row];
    rows[R + threadIdx.x] = delta[row];
  }
  dq_tiles_f32<W, kCluster>(
      smem, q + base, k + base, v + base, dout + base, d, qt, kt0, kt1,
      causal, scale, 1.f,
      dq_ws + ws_row(sp, bh, gridDim.z, seq, qt * kTile) * d);
}

// dK and dV of the k tile `kt` over the q tiles [qt0, qt1) in float32 at
// slice width W, this CTA's slices of both (see the section's note),
// written to dk_out and dv_out (the tile's first row, row stride d), dK
// times dk_scale.  `lse` and `delta` point at the (batch*head)'s rows.
template <int W, bool kCluster>
__device__ __forceinline__ void dkv_tiles_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, int d, int kt,
    int qt0, int qt1, int causal, float scale, float dk_scale, float* dk_out,
    float* dv_out) {
  constexpr int kChunk = kTile * W;
  // A warp's W / 2 columns of dK and of dV, in halves of 32 at W = 128.
  constexpr int kHalves = W == 128 ? 2 : 1;
  constexpr int kHB = W / 16 / kHalves;  // n8 blocks a half
  const int c = ctas<kCluster>(), rank = cta_rank<kCluster>();
  float* kc = tc_chunks(smem);
  float* vc = kc + kChunk;
  float* qc = vc + kChunk;
  float* doc = qc + kChunk;
  float* ex = doc + kChunk;  // the exchange rows, in a cluster
  float* pt = ex + (kCluster ? 2 * c * split_rows(c) * kTile : 0);
  float* dst = pt + kTile * kTile;
  float* rows = tc_rows(smem);
  int own0, nown;
  owned_rows<kCluster>(own0, nown);
  const int R = split_rows(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = 16 * (warp & 3);      // the warp's q rows, then its keys
  const int kh = 32 * (warp >> 2);     // its keys in the first products
  const int oh = W / 2 * (warp >> 2);  // its columns of the output slices
  const int n = d / W;
  const int spc = kCluster ? (n + c - 1) / c : 1;
  const size_t ko = (size_t)kt * kTile * d;
  // dK and dV take 64 registers a thread beside the products' at W = 128:
  // with the first products' k steps unrolled by two as well the kernels
  // spilled a few bytes (scripts/flash_f32_wide_ab.py, variant dkvunroll);
  // rolling the second products' instead was slower (PERF.md).
  constexpr bool kAbtUnroll = false;
  for (int pass = 0; pass < spc; ++pass) {
    const int jo = rank + pass * c;
    if (spc == 1) {
      chunk_f32_async<W>(kc, k + ko + jo * W, d);
      chunk_f32_async<W>(vc, v + ko + jo * W, d);
      chunk_f32_async<W>(doc, dout + (size_t)qt0 * kTile * d + jo * W, d);
      cp_async_commit();
      chunk_f32_async<W>(qc, q + (size_t)qt0 * kTile * d + jo * W, d);
      cp_async_commit();
    }
    if constexpr (kCluster) cluster_sync();
    float dk[kHalves][kHB][4], dv[kHalves][kHB][4];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      zero(dk[h]);
      zero(dv[h]);
    }
    for (int qt = qt0; qt < qt1; ++qt) {
      const size_t qo = (size_t)qt * kTile * d;
      if (threadIdx.x < nown) {  // the owned rows' LSE and delta
        rows[threadIdx.x] = lse[qt * kTile + own0 + threadIdx.x];
        rows[R + threadIdx.x] = delta[qt * kTile + own0 + threadIdx.x];
      }
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      if (spc == 1) {
        cp_async_wait_prev();  // K, V and dO of tile qt
        __syncthreads();
        mma3_abt<W, 4, kAbtUnroll>(dp, doc, rw, vc, kh, lane);
        cp_async_wait_all();  // Q of tile qt
        __syncthreads();
        mma3_abt<W, 4, kAbtUnroll>(s, qc, rw, kc, kh, lane);
      } else {
        int last = -1;
        for (int j = rank; j < n; j += c) {
          __syncthreads();
          chunk_f32_async<W>(kc, k + ko + j * W, d);
          chunk_f32_async<W>(vc, v + ko + j * W, d);
          chunk_f32_async<W>(qc, q + qo + j * W, d);
          chunk_f32_async<W>(doc, dout + qo + j * W, d);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          mma3_abt<W, 4, kAbtUnroll>(dp, doc, rw, vc, kh, lane);
          mma3_abt<W, 4, kAbtUnroll>(s, qc, rw, kc, kh, lane);
          last = j;
        }
        if (jo < n && last != jo) {  // the output slice's Q and dO
          __syncthreads();
          chunk_f32_async<W>(qc, q + qo + jo * W, d);
          chunk_f32_async<W>(doc, dout + qo + jo * W, d);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
      }
      if constexpr (kCluster)
        split_exchange(s, dp, ex, pt, dst, rows, qt, kt, causal, scale, rank,
                       c);
      else
        tile_pds(s, dp, pt, dst, rows, qt, kt, causal, scale);
      if (jo < n) {
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          mma3_xb<W, true, kHB>(dv[h], pt, rw, doc, oh + 8 * kHB * h, lane);
      }
      if (spc == 1) {
        __syncthreads();  // every warp is done with dO
        if (qt + 1 < qt1)
          chunk_f32_async<W>(doc, dout + qo + kTile * d + jo * W, d);
        cp_async_commit();
      }
      if (jo < n) {
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          mma3_xb<W, true, kHB>(dk[h], dst, rw, qc, oh + 8 * kHB * h, lane);
      }
      if (spc == 1) {
        __syncthreads();  // every warp is done with Q
        if (qt + 1 < qt1)
          chunk_f32_async<W>(qc, q + qo + kTile * d + jo * W, d);
        cp_async_commit();
      }
    }
    if (jo < n) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        store_tc_rows(dk_out, d, rw, jo * W + oh + 8 * kHB * h, dk[h],
                      dk_scale);
        store_tc_rows(dv_out, d, rw, jo * W + oh + 8 * kHB * h, dv[h], 1.f);
      }
    }
  }
}

// Resident dK/dV: grid x is the k tiles times the cluster's CTAs.
template <int W, bool kCluster>
__device__ __forceinline__ void bwd_dkv_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, int seq, int d, float scale, int causal) {
  const int kt = (int)blockIdx.x / ctas<kCluster>();
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * seq * d;
  const size_t at = base + (size_t)kt * kTile * d;
  dkv_tiles_f32<W, kCluster>(smem, q + base, k + base, v + base, dout + base,
                             lse + (size_t)bh * seq, delta + (size_t)bh * seq,
                             d, kt, causal ? kt : 0, seq / kTile, causal,
                             scale, scale, dk + at, dv + at);
}

template <int W, bool kCluster>
__device__ __forceinline__ void bwd_dkv_str_f32(
    float* smem, const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dk_ws,
    float* dv_ws, int seq, int d, int split, float scale, int causal) {
  const int num_t = seq / kTile;
  const int kt = (int)blockIdx.x / ctas<kCluster>();
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  int qt0 = sp * split;
  const int qt1 = min(qt0 + split, num_t);
  if (causal) qt0 = max(qt0, kt);
  if (qt0 >= qt1) return;  // dead pair, for the whole cluster

  const size_t base = (size_t)bh * seq * d;
  const size_t at = ws_row(sp, bh, gridDim.z, seq, kt * kTile) * d;
  dkv_tiles_f32<W, kCluster>(smem, q + base, k + base, v + base, dout + base,
                             lse + (size_t)bh * seq, delta + (size_t)bh * seq,
                             d, kt, qt0, qt1, causal, scale, 1.f, dk_ws + at,
                             dv_ws + at);
}

// The kernels: at a wide D (256 and above, D at run time) the clusters of
// split_ctas(D) CTAs, W = 128; at D <= 128 one CTA a tile, W = D.
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dq,
                             float* __restrict__ delta, int seq, int d,
                             float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dq_f32<kWide, true>(tc_smem, q, k, v, o, dout, lse, dq, delta, seq, d,
                          scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_bwd_dq_tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ dq, float* __restrict__ delta,
                           int seq, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dq_f32<D, false>(tc_smem, q, k, v, o, dout, lse, dq, delta, seq, D,
                       scale, causal);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_str_wide_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dq_ws, int seq, int d,
                                 int split, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dq_str_f32<kWide, true>(tc_smem, q, k, v, dout, lse, delta, dq_ws, seq,
                              d, split, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_bwd_dq_str_tc_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq_ws, int seq, int split,
                               float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dq_str_f32<D, false>(tc_smem, q, k, v, dout, lse, delta, dq_ws, seq, D,
                           split, scale, causal);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int seq, int d, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dkv_f32<kWide, true>(tc_smem, q, k, v, dout, lse, delta, dk, dv, seq, d,
                           scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_bwd_dkv_tc_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int seq, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dkv_f32<D, false>(tc_smem, q, k, v, dout, lse, delta, dk, dv, seq, D,
                        scale, causal);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_str_wide_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  float* __restrict__ dk_ws,
                                  float* __restrict__ dv_ws, int seq, int d,
                                  int split, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dkv_str_f32<kWide, true>(tc_smem, q, k, v, dout, lse, delta, dk_ws,
                               dv_ws, seq, d, split, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_bwd_dkv_str_tc_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk_ws,
                                float* __restrict__ dv_ws, int seq,
                                int split, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  bwd_dkv_str_f32<D, false>(tc_smem, q, k, v, dout, lse, delta, dk_ws, dv_ws,
                            seq, D, split, scale, causal);
}

// ---- the float32 forward on the tensor cores: 3xTF32 ----------------------
// flash_fwd_tc_kernel<D> and flash_fwd_str_tc_kernel<D> (D = 16, 32, 64 and
// 128) and flash_fwd_wide_kernel and flash_fwd_str_wide_kernel (D = 256 and
// above) replace the TPU kernels _fwd_kernel_res (:142) and _fwd_kernel_str
// (:221) of byteps_tpu/ops/flash_attention.py in float32.  What bounds them
// is the products: 4 FLOPs per visible (q, k) pair and head-dim element,
// 0.026 ms at the 3xTF32 ceiling for [128, 512, 64] causal and 0.16 ms for
// [128, 512, 384], against 0.020 and 0.12 ms of bytes.
//
// The backward's design (the section above) with S alone, one tile loop
// for every width (fwd_tiles_f32, templated on the slice width W and on
// kCluster).  From D = 256, W = 128 and the n = D / 128 slices of a q tile
// run as one cluster of split_ctas(D) CTAs: each CTA contracts S = Q K^T
// over its own 128 columns and pushes its partial rows to their owners
// (row r to rank r / R); the owner adds the partials in rank order, so
// every CTA applies the same bits, masks, and takes the online-softmax
// step of its rows: m' = max(m, scale S), alpha = exp(m - m'),
// P = exp(scale S - m'), l' = alpha l + rowsum(P), with m and l of its rows
// kept in its own shared memory.  It pushes P, alpha and l' to every CTA of
// the cluster, and each CTA rescales its O accumulator by alpha and adds
// P V over its own columns.  At D <= 128, W = D and one CTA a q tile holds
// all of D: its warps' S blocks are the whole sums, it stores them to a
// swizzled 64 x 64 tile of its own shared memory, and takes the step of
// every row itself (owner_step with one CTA), turning S into P in place.
//
// P V runs one tile behind, so one barrier a tile pair (the cluster's, or
// without one the CTA's) brings both this tile's S to the rows' owners and
// the last tile's P, alpha and l to every warp (the backward takes two;
// see fwd_tiles_f32; with two cluster barriers the wide forward ran 5-7%
// slower, and one slice a CTA recomputing S over all of D without a
// cluster 1.65-2.1x slower, PERF.md).  A CTA barrier after the streamed
// chunks land comes on top.  Without a cluster one barrier a pair would
// need a third stage of the S/P tile and a second of K, 129.5 KB at
// W = 64: one CTA an SM, which with two barriers measured 1.16-1.17x
// slower at D = 64 (scripts/flash_f32_fwd_ab.py, variant ctas1).  After
// the last k tile every CTA holds l of every row: the resident kernel
// writes O / l and the owners LSE = m + log l; the streaming one writes
// (m, l, acc) to the workspaces, which the merge pass reads.  The
// products are 3xTF32 with a zeroed partial every 16 contraction elements
// (mma3_abt, mma3_xb); P lies in [0, 1] and still enters as a hi/lo pair,
// which the float32 gate needs (tests/test_torch_port_flash_f32tc.py
// emulates the recipe).
//
// Eight warps: warp w takes rows 16 (w & 3) of the tile pair and keys
// 32 (w >> 2) of S, then the same rows and W / 2 of the slice's columns of
// O (W / 4 accumulators a thread, 32 at W = 128).  With one slice a CTA the
// Q chunk stays for the whole k loop, and the next K and V come in by
// cp.async while the exchange and the products run: Q and K, two stages of
// V and of P, in a cluster two stages of the exchange rows (193.5-196.5 KB
// at W = 128, one CTA an SM); without one, 97.5 KB at W = 64 and 161.5 KB
// at W = 128, two CTAs an SM up to W = 64 (f32_tc_ctas); D = 128 as a
// cluster of one CTA, with exchange rows of its own, ran 1.10x slower
// (variant cluster128).  Above 8 slices a CTA takes ceil(n / 8), loads
// them one at a time and runs the tile loop once for each slice it
// outputs, as the backward does.
// ---------------------------------------------------------------------------

// Shared memory of the float32 forward at slice width W: two stages of
// (alpha, l) of every row, m and l of the owned rows, the Q and K chunks,
// two stages of the V chunk and of the P tile, and in a cluster of c CTAs
// two stages of the exchange rows (c slots of R rows).  Without a cluster
// S is stored into the P tile's stage and turned into P there.
template <int W, bool kCluster>
__host__ __device__ constexpr size_t f32_fwd_smem(int c) {
  return (6 * kTile + 4 * kTile * W + 2 * kTile * kTile +
          (kCluster ? 2 * c * split_rows(c) * kTile : 0)) * sizeof(float);
}

// The barrier of a tile pair's exchange: the cluster's, or the CTA's.
template <bool kCluster>
__device__ __forceinline__ void exchange_sync() {
  if constexpr (kCluster) cluster_sync();
  else __syncthreads();
}

// Put the warps' partial S blocks (rows 16 (warp & 3), keys 32 (warp >> 2))
// into slot `rank` of their rows' owners' exchange rows: in a cluster by
// distributed shared memory, without one into the CTA's own S tile (one
// slot of all 64 rows).
template <bool kCluster>
__device__ __forceinline__ void push_partials(const float (&s)[4][4],
                                              float* ex, int rank, int c) {
  const int R = split_rows(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * (warp & 3) + g + 8 * h;
    const int owner = row / R;
    const int slot_row = rank * R + row - owner * R;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int at = swz(slot_row, 32 * (warp >> 2) + 8 * n + 2 * t, kTile);
      if constexpr (kCluster)
        st_cluster2(cluster_addr(smem_addr(ex), owner) + 4u * (uint32_t)at,
                    s[n][2 * h], s[n][2 * h + 1]);
      else
        store2(ex + at, s[n][2 * h], s[n][2 * h + 1]);
    }
  }
}

// The owner's step of one tile pair (q tile qt, k tile kt), the partials
// in `ex`: adds them in rank order, masks, takes the online-softmax step of
// its rows (their m and l in `ml`, pairs by owned row) and writes P (`pt`,
// a swizzled [kTile][kTile] tile) and (alpha, l) of each row (`al`, pairs
// by row) into every CTA of the cluster, or without one into its own
// memory (there `ex` may be `pt`: each lane overwrites the S it read).  A
// half warp takes a row, 4 keys a lane.  k16 is the 16-bit wide
// forward's owner (fwd_tiles16, kCluster false): `scale` includes log2(e),
// m is kept in units of log2 and the exponentials are exp2f's, as in
// fwd_mma_tiles (else expf's); the slots of `ex` hold the senders' rows as
// they lie in their P tiles, swizzled by the tile's row; (alpha, l) fills 4
// floats a row; and a quarter warp takes a row, 8 keys a lane (one pass
// over the 22 rows an owner holds at 3 CTAs).
template <bool kCluster, bool k16 = false>
__device__ __forceinline__ void owner_step(const float* ex, float* pt,
                                           float* al, float* ml, int qt,
                                           int kt, int causal, float scale,
                                           int rank, int c) {
  constexpr int kL = k16 ? 8 : 16;  // lanes a row
  constexpr int kK = kTile / kL;     // keys a lane
  const int R = split_rows(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int own0 = rank * R;
  const int nown = max(0, min(kTile, own0 + R) - own0);
  const int col = kK * (lane % kL);
  const bool lead = lane % kL == 0;
  for (int lr0 = 32 / kL * warp; lr0 < nown; lr0 += 32 / kL * kTcWarps) {
    const int lr = lr0 + lane / kL;
    const bool live = lr < nown;
    float x[kK];
#pragma unroll
    for (int e = 0; e < kK; ++e) x[e] = 0.f;
    float m_old = 0.f, l_old = 0.f;
    if (live) {
      for (int j = 0; j < c; ++j) {  // rank order
#pragma unroll
        for (int u = 0; u < kK; u += 4) {
          const float4 a = *reinterpret_cast<const float4*>(
              ex + (k16 ? swz(own0 + lr, col + u, kTile) +
                                (j * R - own0) * kTile
                          : swz(j * R + lr, col + u, kTile)));
          x[u] += a.x, x[u + 1] += a.y, x[u + 2] += a.z, x[u + 3] += a.w;
        }
      }
      m_old = ml[2 * lr];
      l_old = ml[2 * lr + 1];
    }
    const int query = qt * kTile + own0 + lr;
    float mx = m_old;
#pragma unroll
    for (int e = 0; e < kK; ++e) {
      x[e] = causal && kt * kTile + col + e > query ? -INFINITY
                                                    : scale * x[e];
      mx = fmaxf(mx, x[e]);
    }
#pragma unroll
    for (int off = kL / 2; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = k16 ? exp2f(m_old - mx) : expf(m_old - mx);
    float p[kK], rs = 0.f;
#pragma unroll
    for (int e = 0; e < kK; ++e) {
      p[e] = k16 ? exp2f(x[e] - mx) : expf(x[e] - mx);
      rs += p[e];
    }
#pragma unroll
    for (int off = kL / 2; off; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    const float l = l_old * alpha + rs;
    if (live) {
      const int row = own0 + lr;
      if (lead) {
        ml[2 * lr] = mx;
        ml[2 * lr + 1] = l;
      }
#pragma unroll
      for (int u = 0; u < kK; u += 4) {
        const int p_at = swz(row, col + u, kTile);
        const float4 pv = make_float4(p[u], p[u + 1], p[u + 2], p[u + 3]);
        if constexpr (kCluster) {
          for (int j = 0; j < c; ++j)
            st_cluster4(cluster_addr(smem_addr(pt) + 4u * (uint32_t)p_at, j),
                        pv);
        } else {
          *reinterpret_cast<float4*>(pt + p_at) = pv;
        }
      }
      if (lead) {
        if constexpr (kCluster) {
          for (int j = 0; j < c; ++j)
            st_cluster2(cluster_addr(smem_addr(al + 2 * row), j), alpha, l);
        } else {
          al[(k16 ? 4 : 2) * row] = alpha;
          al[(k16 ? 4 : 2) * row + 1] = l;
        }
      }
    }
  }
}

// O of the q tile `qt` over the k tiles [kt0, kt1) in float32 at slice
// width W, this CTA's slices of it (see the section's note).  `out` is the
// tile's first row (row stride d).  Resident (`lse` set): O / l, and the
// owners write LSE of their rows to lse; streaming: the unnormalised acc,
// and the owners m and l to m_out and l_out (the tile's first row each).
//
// One exchange barrier a tile pair: step i puts tile kt0 + i's partials,
// waits at the barrier, then (the owners) takes that tile's softmax step
// and applies the previous tile's P: P V runs one tile behind, so the
// barrier that brings this tile's partials to their owners also brings
// the previous tile's P, alpha and l to every warp.  P, (alpha, l), V and
// in a cluster the exchange rows have two stages, by the parity of the
// tile; K one, as its products are issued before the barrier after which
// the next K loads.  Without a cluster S lies in P's stage: the CTA
// barrier after the chunks land keeps tile i's S from the warps still
// applying tile i - 2's P there, where the cluster's exchange rows need
// their own stages (another CTA's partials can arrive while this CTA still
// reads the last ones).
template <int W, bool kCluster>
__device__ __forceinline__ void fwd_tiles_f32(
    float* smem, const float* q, const float* k, const float* v, int d,
    int qt, int kt0, int kt1, int causal, float scale, float* out,
    float* lse, float* m_out, float* l_out) {
  constexpr int kChunk = kTile * W;
  constexpr int NB = W / 16;       // n8 blocks of the warp's O columns
  const int c = ctas<kCluster>(), rank = cta_rank<kCluster>();
  float* al = smem;                // (alpha, l) of every row, two stages
  float* ml = al + 4 * kTile;      // m and l of the owned rows
  float* qc = ml + 2 * kTile;
  float* kc = qc + kChunk;
  float* vc = kc + kChunk;         // two stages
  float* pt = vc + 2 * kChunk;     // two stages
  const int R = split_rows(c);
  float* ex = kCluster ? pt + 2 * kTile * kTile : pt;  // two stages
  const int ex_stage = kCluster ? c * R * kTile : kTile * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int rw = 16 * (warp & 3);      // the warp's rows
  const int kh = 32 * (warp >> 2);     // its keys of S
  const int oh = W / 2 * (warp >> 2);  // its columns of the output slice
  const int n = d / W;
  const int spc = kCluster ? (n + c - 1) / c : 1;  // slices a CTA outputs
  const int own0 = rank * R;
  const int nown = max(0, min(kTile, own0 + R) - own0);
  const int nt = kt1 - kt0;
  const size_t qo = (size_t)qt * kTile * d;
  for (int pass = 0; pass < spc; ++pass) {
    const int jo = rank + pass * c;  // the slice this pass writes (if < n)
    for (int r = threadIdx.x; r < nown; r += kTcThreads) {
      ml[2 * r] = -INFINITY;
      ml[2 * r + 1] = 0.f;
    }
    if (n == c) {
      chunk_f32_async<W>(qc, q + qo + jo * W, d);
      chunk_f32_async<W>(kc, k + (size_t)kt0 * kTile * d + jo * W, d);
      cp_async_commit();
    }
    // the cluster runs before any store reaches a CTA
    if constexpr (kCluster) cluster_sync();
    float acc[NB][4];
    zero(acc);
    for (int i = 0; i <= nt; ++i) {  // the last step only applies P
      const int kt = kt0 + i;
      const size_t ko = (size_t)kt * kTile * d;
      const int b = i & 1;  // the stage of tile kt
      cp_async_wait_all();  // K of tile kt, V of tile kt - 1
      __syncthreads();
      if (i < nt) {
        float s[4][4];
        zero(s);
        if (n == c) {
          mma3_abt<W, 4, true>(s, qc, rw, kc, kh, lane);
        } else {
          for (int j = rank; j < n; j += c) {
            __syncthreads();
            chunk_f32_async<W>(qc, q + qo + j * W, d);
            chunk_f32_async<W>(kc, k + ko + j * W, d);
            cp_async_commit();
            cp_async_wait_all();
            __syncthreads();
            mma3_abt<W, 4, true>(s, qc, rw, kc, kh, lane);
          }
        }
        push_partials<kCluster>(s, ex + b * ex_stage, rank, c);
      }
      exchange_sync<kCluster>();  // tile kt's S at its owners, tile
                                  // kt - 1's P, alpha and l at every warp
      if (i < nt) {
        if (jo < n)
          chunk_f32_async<W>(vc + b * kChunk, v + ko + jo * W, d);
        if (n == c && i + 1 < nt)
          chunk_f32_async<W>(kc, k + ko + kTile * d + jo * W, d);
        cp_async_commit();
        owner_step<kCluster>(ex + b * ex_stage, pt + b * kTile * kTile,
                             al + b * 2 * kTile, ml, qt, kt, causal, scale,
                             rank, c);
      }
      if (i > 0 && jo < n) {  // P V of tile kt - 1, stage b ^ 1
        const float* alp = al + (b ^ 1) * 2 * kTile;
        const float a0 = alp[2 * (rw + g)], a8 = alp[2 * (rw + g + 8)];
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          acc[u][0] *= a0, acc[u][1] *= a0;
          acc[u][2] *= a8, acc[u][3] *= a8;
        }
        mma3_xb<W, false, NB>(acc, pt + (b ^ 1) * kTile * kTile, rw,
                              vc + (b ^ 1) * kChunk, oh, lane);
      }
    }
    if (jo < n) {
      if (lse) {
        const float* alp = al + ((nt - 1) & 1) * 2 * kTile;
        const float l0 = alp[2 * (rw + g) + 1], l8 = alp[2 * (rw + g + 8) + 1];
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          acc[u][0] /= l0, acc[u][1] /= l0;
          acc[u][2] /= l8, acc[u][3] /= l8;
        }
      }
      store_tc_rows(out, d, rw, jo * W + oh, acc, 1.f);
    }
    if (pass == 0 && threadIdx.x < nown) {
      const int r = own0 + threadIdx.x;
      const float m = ml[2 * threadIdx.x], l = ml[2 * threadIdx.x + 1];
      if (lse) {
        lse[r] = m + logf(l);
      } else {
        m_out[r] = m;
        l_out[r] = l;
      }
    }
  }
}

// Resident forward: grid x is the q tiles (the longest causal rows first)
// times the cluster's CTAs.
template <int W, bool kCluster>
__device__ __forceinline__ void fwd_f32(float* smem, const float* q,
                                        const float* k, const float* v,
                                        float* o, float* lse, int seq, int d,
                                        float scale, int causal) {
  const int qt = seq / kTile - 1 - (int)blockIdx.x / ctas<kCluster>();
  const size_t row0 = (size_t)blockIdx.y * seq + qt * kTile;
  const size_t base = (size_t)blockIdx.y * seq * d;
  fwd_tiles_f32<W, kCluster>(smem, q + base, k + base, v + base, d, qt, 0,
                             causal ? qt + 1 : seq / kTile, causal, scale,
                             o + row0 * d, lse + row0, nullptr, nullptr);
}

template <int W, bool kCluster>
__device__ __forceinline__ void fwd_str_f32(float* smem, const float* q,
                                            const float* k, const float* v,
                                            float* m_ws, float* l_ws,
                                            float* acc_ws, int seq, int d,
                                            int split, float scale,
                                            int causal) {
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - (int)blockIdx.x / ctas<kCluster>();
  const int sp = blockIdx.y;
  const int bh = blockIdx.z;
  const int kt0 = sp * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;  // dead pair, for the whole cluster

  const size_t base = (size_t)bh * seq * d;
  const size_t at = ws_row(sp, bh, gridDim.z, seq, qt * kTile);
  fwd_tiles_f32<W, kCluster>(smem, q + base, k + base, v + base, d, qt, kt0,
                             kt1, causal, scale, acc_ws + at * d, nullptr,
                             m_ws + at, l_ws + at);
}

// The kernels: at a wide D (256 and above, D at run time) the clusters of
// split_ctas(D) CTAs, W = 128; at D <= 128 one CTA a tile, W = D.
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int seq, int d,
                          float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  fwd_f32<kWide, true>(tc_smem, q, k, v, o, lse, seq, d, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_fwd_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int seq, float scale,
                        int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  fwd_f32<D, false>(tc_smem, q, k, v, o, lse, seq, D, scale, causal);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_str_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ m_ws,
                              float* __restrict__ l_ws,
                              float* __restrict__ acc_ws, int seq, int d,
                              int split, float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  fwd_str_f32<kWide, true>(tc_smem, q, k, v, m_ws, l_ws, acc_ws, seq, d,
                           split, scale, causal);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, f32_tc_ctas(D))
    flash_fwd_str_tc_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ m_ws,
                            float* __restrict__ l_ws,
                            float* __restrict__ acc_ws, int seq, int split,
                            float scale, int causal) {
  extern __shared__ __align__(16) float tc_smem[];
  fwd_str_f32<D, false>(tc_smem, q, k, v, m_ws, l_ws, acc_ws, seq, D, split,
                        scale, causal);
}

// ---- the 16-bit forward at a wide D: split-D clusters ---------------------
// flash_fwd_wide16_kernel<T16> and flash_fwd_str_wide16_kernel<T16> (bf16
// and float16, D above 256) replace the TPU kernels _fwd_kernel_res (:142)
// and _fwd_kernel_str (:221) of byteps_tpu/ops/flash_attention.py there.
// What bounds them: at [128, 512, 512] causal the bytes, 0.080 ms (the
// products, 4 FLOPs per visible (q, k) pair and head-dim element, take
// 0.035 ms at the bf16 tensor-core peak); at [16, 8192, 512] the
// products, 1.11 ms.
//
// One 128-column output slice a CTA, each CTA contracting S = Q K^T over
// all of D itself, issued 2 (D / 128) + 4 tensor-core FLOPs a pair and
// head-dim element (3x the function's at D = 512) and ran at 50-60
// TFLOP/s of the function's work.  Here the n = D / 128 slices of a q
// tile run as one cluster of split_ctas(D) CTAs, as in the float32
// forward (fwd_tiles_f32): each CTA keeps its 128-column chunk of Q in
// shared memory for the whole k loop and contracts its partial S over
// those columns into a zeroed float32 partial (exact 16-bit products,
// float32 sums, as mma_abt_chunk takes a chunk); the owner of a row
// (rank r / R, R = split_rows) adds the partials in rank order from zero,
// as the one-slice kernels added their chunks, so S keeps their bits;
// masks on the diagonal tile with global positions and takes the
// online-softmax step of its rows in units of log2 with exp2f
// (owner_step<false, true>, m leaving in natural units for the merge);
// and every CTA rescales its O accumulator by alpha and adds P V over its
// own 128 columns of V, P entering as its hi/lo pair
// (mma_xb_split, as in every 16-bit forward; float16 needs no row scale:
// P is relative to the running max).  The products issued are 6 FLOPs a
// pair and head-dim element whatever D.  Above 8 slices a CTA takes
// ceil(n / 8): its partial sums its slices in ascending order, and it
// runs the tile loop once for each slice it outputs.
//
// The exchange.  The float32 forward's (per-thread stores into the other
// CTAs' memory, one cluster barrier a tile pair) cost this kernel half
// its time at one CTA an SM: 0.73 ms at [128, 512, 512] against 0.39
// without it (scripts/flash_wide16_fwd_ab.py probes, PERF.md).  Here each
// CTA stores its partial S into its own P tile, and one thread per owner
// sends the owner's rows (R rows of 256 bytes) with one bulk copy
// (cp.async.bulk shared::cta -> shared::cluster), which completes on the
// owner's mbarrier; the owner's step writes P and (alpha, l) of its rows
// over the same rows of its own tile, and bulk copies send them to the
// same rows of every other CTA, completing on their mbarriers.  A P row
// lands only where the partial it replaces has been delivered (the owner
// has it), so S and P share one tile; a CTA sends its next partials only
// after every owner's P of this tile has come in and its P V is done, so
// one stage of each buffer serves.  No cluster barrier runs inside the
// tile loop.  The chunks of Q, K, two stages of V, the P tile and the
// exchange rows make 101.5-103 KB: two CTAs an SM (kFwd16Ctas; one ran
// 1.3-1.5x slower), 128 registers a thread.  To stay within them without
// spilling, every shared-memory offset but the exchange rows' is a
// constant and the kernel's pointers are offset where they are used.
//
// Eight warps: warp w takes rows 16 (w & 3) and keys 32 (w >> 2) of S,
// then the same rows and 64 of the slice's 128 columns of O, its 64 keys
// of P read from the P tile into mma_xb_split's fragment layout, 16 at a
// time.
constexpr int kFwd16Ctas = 2;   // CTAs an SM (__launch_bounds__)

// mbarrier and bulk-copy primitives (sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// One arrival on `bar`, and `bytes` more for its phase to wait for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Copy `bytes` (a multiple of 16) from `src` in this CTA's shared memory
// to `dst`'s offset in CTA `rank`'s, completing on `bar`'s offset there.
__device__ __forceinline__ void bulk_to(void* dst, int rank, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(cluster_addr(smem_addr(dst), rank)),
      "r"(smem_addr(src)), "r"(bytes),
      "r"(cluster_addr(smem_addr(bar), rank))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's shared-memory stores, seen by the bulk copies after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Shared memory of the 16-bit wide forward in a cluster of c CTAs: the
// two mbarriers (padded to 16 bytes), (alpha, l) of every row (4 floats
// a row), m and l of the owned rows and the P tile, float32; the Q and K
// chunks and two stages of the V chunk, 16-bit; then the exchange rows (c
// slots of R rows), float32, last, so that every other offset is a
// constant.
constexpr size_t kFwd16Fixed =
    16 + (4 * kTile + 2 * kTile + kTile * kTile) * sizeof(float) +
    4 * kWideTile * sizeof(uint16_t);
__host__ __device__ constexpr size_t fwd16_smem(int c) {
  return kFwd16Fixed + c * split_rows(c) * kTile * sizeof(float);
}

// The warp's 16 rows from `row0` of a swizzled [kTile][kTile] float32
// tile (P), columns 16 kk..16 kk + 15, in the accumulator layout
// mma_xb_split takes: x[n][e] at row row0 + g + 8 (e >> 1), column
// 16 kk + 8n + 2t + (e & 1).
__device__ __forceinline__ void tile_rows_acc(float (&x)[2][4],
                                              const float* tile, int row0,
                                              int kk) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 u = *reinterpret_cast<const float2*>(
          tile + swz(row0 + g + 8 * h, 16 * kk + 8 * n + 2 * t, kTile));
      x[n][2 * h] = u.x;
      x[n][2 * h + 1] = u.y;
    }
}

// O of the q tile `qt` over the k tiles [kt0, kt1), this CTA's slices of
// it (see the section's note); `scale2` is scale log2(e).  The pointers
// are the kernel's parameters, offset where they are used (head bh from
// blockIdx: registers are what limits two CTAs an SM).  Resident: O / l
// into o, and the owners write LSE = m ln 2 + log l of their rows;
// streaming (kStr): the unnormalised float32 acc, and the owners m
// (natural units) and l, into split blockIdx.y's workspaces.  A tile
// pair: S's partial into the P tile, the owners' rows sent; the owner's
// step once its partials are in; its P and (alpha, l) sent; P V once
// every owner's rows are in.  V's chunk of tile kt0 + u lands in stage
// u & 1 (loading while tile kt0 + u - 1's pair runs), K has one stage (the
// next K loads once the CTA's S products are done).  Every CTA of the
// cluster runs the same tiles and passes; the mbarriers count phases
// across the passes.
template <typename T16, bool kStr>
__device__ __forceinline__ void fwd_tiles16(
    unsigned char* smem, const T16* q, const T16* k, const T16* v, T16* o,
    float* lse, float* m_ws, float* l_ws, float* acc_ws, int seq, int d,
    int qt, int kt0, int kt1, int causal, float scale2) {
  constexpr int NB = kWide / 16;   // n8 blocks of the warp's 64 O columns
  const int c = cluster_size(), rank = cluster_rank();
  const int R = split_rows(c);
  uint64_t* bar_ex = reinterpret_cast<uint64_t*>(smem);  // partials in
  uint64_t* bar_p = bar_ex + 1;                          // P rows in
  float* al = reinterpret_cast<float*>(smem + 16);  // (alpha, l, -, -)
  float* ml = al + 4 * kTile;      // m and l of the owned rows
  float* pt = ml + 2 * kTile;      // S's partial, then P
  T16* qc = reinterpret_cast<T16*>(pt + kTile * kTile);
  T16* kc = qc + kWideTile;
  T16* vc = kc + kWideTile;        // two stages
  float* ex = reinterpret_cast<float*>(smem + kFwd16Fixed);  // c slots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);          // the warp's rows
  const int kh = 32 * (warp >> 2);         // its keys of S
  const int oh = kWide / 2 * (warp >> 2);  // its columns of the slice
  const int n = d / kWide;
  const int spc = (n + c - 1) / c;         // slices a CTA outputs
  const int own0 = rank * R;
  const int nown = max(0, min(kTile, own0 + R) - own0);
  const int nt = kt1 - kt0;
  // the element offset of row `row` of this head in q, k, v and o
  auto at = [&](int row) {
    return ((size_t)(kStr ? blockIdx.z : blockIdx.y) * seq + row) * d;
  };
  // Rows of owner j.
  auto rows_of = [&](int j) { return max(0, min(kTile, j * R + R) - j * R); };
  if (threadIdx.x == 0) {
    mbar_init(bar_ex, 1);
    mbar_init(bar_p, 1);
    fence_mbar_init();
  }
  for (int pass = 0; pass < spc; ++pass) {
    const int jo = rank + pass * c;  // the slice this pass writes (if < n)
    // V's chunk of tile kt0 + u, into stage u & 1
    auto load_v = [&](int u) {
      if (jo < n && u < nt)
        chunk_async<kTile, kTcThreads>(vc + (u & 1) * kWideTile,
                                       v + at((kt0 + u) * kTile) + jo * kWide,
                                       d);
    };
    for (int r = threadIdx.x; r < nown; r += kTcThreads) {
      ml[2 * r] = -INFINITY;
      ml[2 * r + 1] = 0.f;
    }
    if (n == c) {
      chunk_async<kTile, kTcThreads>(qc, q + at(qt * kTile) + jo * kWide, d);
      chunk_async<kTile, kTcThreads>(kc, k + at(kt0 * kTile) + jo * kWide, d);
    }
    load_v(0);
    cp_async_commit();
    // the cluster runs, its mbarriers set, before any copy reaches a CTA
    if (pass == 0) cluster_sync();
    float acc[NB][4];
    zero(acc);
    for (int i = 0; i < nt; ++i) {
      const int kt = kt0 + i;
      // the phase of both mbarriers: they complete once a tile pair
      const uint32_t phase = (pass * nt + i) & 1;
      if (threadIdx.x == 0) {
        // the bytes a tile pair brings: the c partials of the owned rows,
        // and the P and (alpha, l) rows of every other owner
        mbar_expect(bar_ex, c * nown * kTile * sizeof(float));
        mbar_expect(bar_p, (kTile - nown) * (kTile + 4) * sizeof(float));
      }
      if (threadIdx.x < c) bulk_wait_read();  // the last tile's sends
      cp_async_wait_all();  // K and V of tile kt
      __syncthreads();      // ... and every warp done with the P tile
      // V of the next tile into the stage the last P V read (with more
      // slices than CTAs after S, whose chunk loads wait for every group)
      if (n == c) load_v(i + 1);
      float s[4][4];
      zero(s);
      if (n == c) {
        mma_abt<T16, kWide, 4>(s, qc + rw * kWideLd, kc + kh * kWideLd,
                               lane);
      } else {
        for (int j = rank; j < n; j += c) {
          __syncthreads();
          chunk_async<kTile, kTcThreads>(qc, q + at(qt * kTile) + j * kWide,
                                         d);
          chunk_async<kTile, kTcThreads>(kc, k + at(kt * kTile) + j * kWide,
                                         d);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          mma_abt_chunk<T16, 4>(s, qc + rw * kWideLd, kc + kh * kWideLd,
                                lane);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          store2(pt + swz(rw + g + 8 * h, kh + 8 * w + 2 * t, kTile),
                 s[w][2 * h], s[w][2 * h + 1]);
      fence_proxy_async();
      __syncthreads();  // the partial whole, the K chunk free
      if (threadIdx.x < c) {  // owner j's rows to slot `rank` of its ex
        const int j = threadIdx.x;
        bulk_to(ex + rank * R * kTile, j, pt + j * R * kTile,
                rows_of(j) * kTile * sizeof(float), bar_ex);
        bulk_commit();
      }
      if (n != c) load_v(i + 1);
      if (n == c && i + 1 < nt)
        chunk_async<kTile, kTcThreads>(kc, k + at((kt + 1) * kTile) +
                                               jo * kWide, d);
      cp_async_commit();
      mbar_wait(bar_ex, phase);  // every partial of the owned rows
      owner_step<false, true>(ex, pt, al, ml, qt, kt, causal, scale2, rank,
                              c);
      fence_proxy_async();
      __syncthreads();  // the owned rows of P and (alpha, l) written
      if (threadIdx.x < c && threadIdx.x != rank) {
        const int j = threadIdx.x;
        bulk_to(pt + own0 * kTile, j, pt + own0 * kTile,
                nown * kTile * sizeof(float), bar_p);
        bulk_to(al + 4 * own0, j, al + 4 * own0, nown * 4 * sizeof(float),
                bar_p);
        bulk_commit();
      }
      mbar_wait(bar_p, phase);  // every other owner's rows
      if (jo < n) {
        const float a0 = al[4 * (rw + g)], a8 = al[4 * (rw + g + 8)];
#pragma unroll
        for (int w = 0; w < NB; ++w) {
          acc[w][0] *= a0, acc[w][1] *= a0;
          acc[w][2] *= a8, acc[w][3] *= a8;
        }
        // one k step (16 keys) of P at a time: the order of mma_xb_split
        // over all 64, in fewer registers
        auto pv = [&](int kk) {
          float x[2][4];
          tile_rows_acc(x, pt, rw, kk);
          mma_xb_split<T16, kWide, kWide / 2, 1>(
              acc, x, vc + (i & 1) * kWideTile + 16 * kk * kWideLd + oh,
              lane);
        };
        if constexpr (kStr) {  // unrolled whole, the streaming kernel spilled
#pragma unroll 2
          for (int kk = 0; kk < kTile / 16; ++kk) pv(kk);
        } else {
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) pv(kk);
        }
      }
    }
    // the workspaces' row of the tile's first row (streaming)
    const size_t ws =
        kStr ? ws_row(blockIdx.y, blockIdx.z, gridDim.z, seq, qt * kTile) : 0;
    if (jo < n) {
      if constexpr (kStr) {
        store_tc_rows(acc_ws + ws * d, d, rw, jo * kWide + oh, acc, 1.f);
      } else {
        const float l0 = al[4 * (rw + g) + 1], l8 = al[4 * (rw + g + 8) + 1];
#pragma unroll
        for (int w = 0; w < NB; ++w) {
          acc[w][0] /= l0, acc[w][1] /= l0;
          acc[w][2] /= l8, acc[w][3] /= l8;
        }
        store_tc_rows(o + at(qt * kTile), d, rw, jo * kWide + oh, acc, 1.f);
      }
    }
    if (pass == 0 && threadIdx.x < nown) {
      // m rounded to natural units before the sum (never one FMA), as the
      // merge pass adds it: one split gives the resident kernel's bits
      const int r = own0 + threadIdx.x;
      const float m = __fmul_rn(ml[2 * threadIdx.x], kLn2);
      const float l = ml[2 * threadIdx.x + 1];
      if constexpr (kStr) {
        m_ws[ws + r] = m;
        l_ws[ws + r] = l;
      } else {
        lse[(size_t)blockIdx.y * seq + qt * kTile + r] = m + logf(l);
      }
    }
    // A CTA leaves, or reloads its chunks, once its own copies are read;
    // every copy into it has arrived (its mbarriers).
    if (threadIdx.x < c) bulk_wait_read();
    __syncthreads();
  }
}

// Resident: grid x is the q tiles (the longest causal rows first) times
// the cluster's CTAs.
template <typename T16>
__global__ void __launch_bounds__(kTcThreads, kFwd16Ctas)
    flash_fwd_wide16_kernel(const T16* __restrict__ q,
                            const T16* __restrict__ k,
                            const T16* __restrict__ v, T16* __restrict__ o,
                            float* __restrict__ lse, int seq, int d,
                            float scale, int causal) {
  extern __shared__ __align__(16) unsigned char wide16_smem[];
  const int qt = seq / kTile - 1 - (int)blockIdx.x / cluster_size();
  fwd_tiles16<T16, false>(wide16_smem, q, k, v, o, lse, nullptr, nullptr,
                          nullptr, seq, d, qt, 0,
                          causal ? qt + 1 : seq / kTile, causal,
                          scale * kLog2e);
}

// Streaming: grid (q tiles times the cluster's CTAs, splits, BH); every CTA
// of a cluster shares qt and the split, so a dead pair exits for the
// whole cluster before its first barrier.
template <typename T16>
__global__ void __launch_bounds__(kTcThreads, kFwd16Ctas)
    flash_fwd_str_wide16_kernel(const T16* __restrict__ q,
                                const T16* __restrict__ k,
                                const T16* __restrict__ v,
                                float* __restrict__ m_ws,
                                float* __restrict__ l_ws,
                                float* __restrict__ acc_ws, int seq, int d,
                                int split, float scale, int causal) {
  const int num_t = seq / kTile;
  const int qt = num_t - 1 - (int)blockIdx.x / cluster_size();
  const int kt0 = blockIdx.y * split;
  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);
  if (kt0 >= kt1) return;  // dead pair, for the whole cluster

  extern __shared__ __align__(16) unsigned char wide16_smem[];
  fwd_tiles16<T16, true>(wide16_smem, q, k, v, nullptr, nullptr, m_ws, l_ws,
                         acc_ws, seq, d, qt, kt0, kt1, causal,
                         scale * kLog2e);
}

// ---- the streaming passes at a wide D: grid x is the row tiles times the
// D / kWide output slices ----------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_str_merge_wide_kernel(const float* __restrict__ m_ws,
                                    const float* __restrict__ l_ws,
                                    const float* __restrict__ acc_ws,
                                    T* __restrict__ o,
                                    float* __restrict__ lse, int seq, int d,
                                    int nsplit, int split, int causal) {
  int qt, pass;
  wide_block(d / kWide, qt, pass);
  const int col0 = pass * kWide;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const int row = qt * kTile + r;
  int j0, j1;
  live_splits(qt, nsplit, split, causal, 0, j0, j1);
  float mx = -INFINITY;
  for (int j = j0; j < j1; ++j)
    mx = fmaxf(mx, m_ws[ws_row(j, bh, gridDim.y, seq, row)]);
  float l = 0.f;
  float acc[kWide / kLanes];
#pragma unroll
  for (int i = 0; i < kWide / kLanes; ++i) acc[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const size_t at = ws_row(j, bh, gridDim.y, seq, row);
    const float w = expf(m_ws[at] - mx);
    l += w * l_ws[at];
    const float* arow = acc_ws + at * d + col0;
#pragma unroll
    for (int i = 0; i < kWide / kLanes; ++i)
      acc[i] += w * arow[c + kLanes * i];
  }
  const size_t at0 = (size_t)bh * seq + row;
  T* orow = o + at0 * d + col0;
#pragma unroll
  for (int i = 0; i < kWide / kLanes; ++i)
    orow[c + kLanes * i] = from_f32<T>(acc[i] / l);
  if (pass == 0 && c == 0) lse[at0] = mx + logf(l);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_delta_wide_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta, int seq, int d) {
  for (int r = threadIdx.x >> 5; r < kTile; r += kThreads / 32) {
    const size_t at0 = (size_t)blockIdx.y * seq + blockIdx.x * kTile + r;
    const float dl = warp_row_dot(dout + at0 * d, o + at0 * d, d);
    if ((threadIdx.x & 31) == 0) delta[at0] = dl;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_sum_splits_wide_kernel(const float* __restrict__ ws,
                                 T* __restrict__ out, int seq, int d,
                                 int nsplit, int split, float scale,
                                 int causal, int upper) {
  int t, pass;
  wide_block(d / kWide, t, pass);
  const int col0 = pass * kWide;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const int row = t * kTile + r;
  int j0, j1;
  live_splits(t, nsplit, split, causal, upper, j0, j1);
  float acc[kWide / kLanes];
#pragma unroll
  for (int i = 0; i < kWide / kLanes; ++i) acc[i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const float* arow = ws + ws_row(j, bh, gridDim.y, seq, row) * d + col0;
#pragma unroll
    for (int i = 0; i < kWide / kLanes; ++i) acc[i] += arow[c + kLanes * i];
  }
  T* orow = out + ((size_t)bh * seq + row) * d + col0;
#pragma unroll
  for (int i = 0; i < kWide / kLanes; ++i)
    orow[c + kLanes * i] = from_f32<T>(scale * acc[i]);
}

// ---------------------------------------------------------------------------
// Host side: shared-memory sizes, launches, dtype/head-dim dispatch.
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// bf16 and float16 kernels run on the tensor cores in 16-bit; float32 ones
// in 3xTF32 (see the header).
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value ||
                              std::is_same<T, __half>::value;

#define BPS_RETURN_IF_ERROR(expr)              \
  do {                                         \
    const cudaError_t bps_err_ = (expr);       \
    if (bps_err_ != cudaSuccess) return bps_err_; \
  } while (0)

int num_splits(int seq, int split) {
  return (seq / kTile + split - 1) / split;
}

// CTAs of a split-D cluster (the float32 kernels from D = 256, the 16-bit
// forward above it): the D / kWide slices over at most kSplitCtas CTAs,
// ceil(n / kSplitCtas) slices a CTA.
int split_ctas(int d) {
  const int n = d / kWide;
  const int per = (n + kSplitCtas - 1) / kSplitCtas;
  return (n + per - 1) / per;
}

// The launch of clusters of `ctas` CTAs along grid x, kTcThreads a CTA.
struct SplitLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  SplitLaunch(dim3 grid, int ctas, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kTcThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  SplitLaunch(const SplitLaunch&) = delete;
};

// Launch `kernel` as clusters of `ctas` CTAs along grid x; a cluster the
// card cannot place is an error of the launch.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int ctas,
                         size_t smem, cudaStream_t stream, Args... args) {
  BPS_RETURN_IF_ERROR(allow_smem(kernel, smem));
  const SplitLaunch launch(grid, ctas, smem, stream);
  BPS_RETURN_IF_ERROR(cudaLaunchKernelEx(&launch.cfg, kernel, args...));
  return cudaGetLastError();
}

// Clusters of `ctas` CTAs of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int ctas, size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  const SplitLaunch launch(dim3(ctas), ctas, smem, nullptr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &launch.cfg) ==
                 cudaSuccess
             ? n
             : -1;
}

// Launchers at a wide head dim (above 256, a multiple of kWide; and
// float32 at D = 256): the same work as the launchers below, D a
// run-time argument; the forward and the float32 backward as clusters of
// split_ctas CTAs, the 16-bit backward as kWide-column output passes in
// grid x.
template <typename T>
cudaError_t launch_fwd_wide(int d, const void* q, const void* k,
                            const void* v, void* o, float* lse, int bh, int seq,
                            float scale, int causal, cudaStream_t stream) {
  const int ctas = split_ctas(d);
  const dim3 grid(seq / kTile * ctas, bh);
  if constexpr (kTensorCores<T>)
    return launch_split(flash_fwd_wide16_kernel<T>, grid, ctas,
                        fwd16_smem(ctas), stream, (const T*)q, (const T*)k,
                        (const T*)v, (T*)o, lse, seq, d, scale, causal);
  else
    return launch_split(flash_fwd_wide_kernel, grid, ctas,
                        f32_fwd_smem<kWide, true>(ctas), stream,
                        (const float*)q, (const float*)k, (const float*)v,
                        (float*)o, lse, seq, d, scale, causal);
}

template <typename T>
cudaError_t launch_dq_wide(int d, const void* q, const void* k,
                           const void* v, const void* o, const void* dout, const float* lse,
                           void* dq, float* delta, int bh, int seq,
                           float scale, int causal, cudaStream_t stream) {
  const dim3 grid(seq / kTile * (d / kWide), bh);
  if constexpr (kTensorCores<T>) {
    const size_t smem = wide_mma_smem(5);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dq_wide_mma_kernel<T>, smem));
    flash_bwd_dq_wide_mma_kernel<T><<<grid, kMmaThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        lse, (T*)dq, delta, seq, d, scale, causal);
  } else {
    const int ctas = split_ctas(d);
    return launch_split(flash_bwd_dq_wide_kernel,
                        dim3(seq / kTile * ctas, bh), ctas,
                        f32_bwd_smem<kWide, true>(ctas, 1), stream,
                        (const float*)q, (const float*)k, (const float*)v,
                        (const float*)o,
                        (const float*)dout, lse, (float*)dq, delta, seq, d,
                        scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(int d, const void* q, const void* k,
                            const void* v, const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int bh,
                            int seq, float scale, int causal,
                            cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    const dim3 grid(seq / kTile * 2 * (d / kWide), bh);
    const size_t smem = wide_mma_smem(5);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dkv_wide_mma_kernel<T>, smem));
    flash_bwd_dkv_wide_mma_kernel<T><<<grid, kMmaThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, seq, d, scale, causal);
  } else {
    const int ctas = split_ctas(d);
    return launch_split(flash_bwd_dkv_wide_kernel,
                        dim3(seq / kTile * ctas, bh), ctas,
                        f32_bwd_smem<kWide, true>(ctas, 2), stream,
                        (const float*)q, (const float*)k, (const float*)v,
                        (const float*)dout,
                        lse, delta, (float*)dk, (float*)dv, seq, d, scale,
                        causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_str_wide(int d, const void* q, const void* k,
                                const void* v, void* o, float* lse,
                                float* m_ws, float* l_ws, float* acc_ws,
                                int bh, int seq, float scale, int causal,
                                int split, cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int npass = d / kWide;
  const int nsplit = num_splits(seq, split);
  const int ctas = split_ctas(d);
  const dim3 grid(num_t * ctas, nsplit, bh);
  if constexpr (kTensorCores<T>)
    BPS_RETURN_IF_ERROR(launch_split(
        flash_fwd_str_wide16_kernel<T>, grid, ctas, fwd16_smem(ctas), stream,
        (const T*)q, (const T*)k, (const T*)v, m_ws, l_ws, acc_ws, seq, d,
        split, scale, causal));
  else
    BPS_RETURN_IF_ERROR(launch_split(
        flash_fwd_str_wide_kernel, grid, ctas,
        f32_fwd_smem<kWide, true>(ctas), stream, (const float*)q,
        (const float*)k, (const float*)v, m_ws, l_ws, acc_ws, seq, d, split,
        scale, causal));
  flash_fwd_str_merge_wide_kernel<T>
      <<<dim3(num_t * npass, bh), kThreads, 0, stream>>>(
          m_ws, l_ws, acc_ws, (T*)o, lse, seq, d, nsplit, split, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_str_wide(int d, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const float* lse, void* dq, float* delta,
                               float* dq_ws, int bh, int seq,
                               float scale, int causal, int split,
                               cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int npass = d / kWide;
  const int nsplit = num_splits(seq, split);
  flash_delta_wide_kernel<T><<<dim3(num_t, bh), kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, seq, d);
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  if constexpr (kTensorCores<T>) {
    const dim3 grid(num_t * npass, nsplit, bh);
    const size_t smem = wide_mma_smem(5);
    BPS_RETURN_IF_ERROR(
        allow_smem(flash_bwd_dq_str_wide_mma_kernel<T>, smem));
    flash_bwd_dq_str_wide_mma_kernel<T><<<grid, kMmaThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        dq_ws, seq, d, split, scale, causal);
    BPS_RETURN_IF_ERROR(cudaGetLastError());
  } else {
    const int ctas = split_ctas(d);
    BPS_RETURN_IF_ERROR(launch_split(
        flash_bwd_dq_str_wide_kernel, dim3(num_t * ctas, nsplit, bh), ctas,
        f32_bwd_smem<kWide, true>(ctas, 1), stream, (const float*)q,
        (const float*)k, (const float*)v, (const float*)dout, lse, (const float*)delta, dq_ws,
        seq, d, split, scale, causal));
  }
  flash_sum_splits_wide_kernel<T>
      <<<dim3(num_t * npass, bh), kThreads, 0, stream>>>(
          dq_ws, (T*)dq, seq, d, nsplit, split, scale, causal, 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_str_wide(int d, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, float* dk_ws,
                                float* dv_ws, int bh, int seq, float scale,
                                int causal, int split, cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int npass = d / kWide;
  const int nsplit = num_splits(seq, split);
  if constexpr (kTensorCores<T>) {
    const dim3 grid(num_t * 2 * npass, nsplit, bh);
    const size_t smem = wide_mma_smem(5);
    BPS_RETURN_IF_ERROR(
        allow_smem(flash_bwd_dkv_str_wide_mma_kernel<T>, smem));
    flash_bwd_dkv_str_wide_mma_kernel<T>
        <<<grid, kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
            delta, dk_ws, dv_ws, seq, d, split, scale, causal);
    BPS_RETURN_IF_ERROR(cudaGetLastError());
  } else {
    const int ctas = split_ctas(d);
    BPS_RETURN_IF_ERROR(launch_split(
        flash_bwd_dkv_str_wide_kernel, dim3(num_t * ctas, nsplit, bh), ctas,
        f32_bwd_smem<kWide, true>(ctas, 2), stream, (const float*)q,
        (const float*)k, (const float*)v, (const float*)dout, lse, delta, dk_ws, dv_ws, seq,
        d, split, scale, causal));
  }
  const dim3 sum_grid(num_t * npass, bh);
  flash_sum_splits_wide_kernel<T><<<sum_grid, kThreads, 0, stream>>>(
      dk_ws, (T*)dk, seq, d, nsplit, split, scale, causal, 1);
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  flash_sum_splits_wide_kernel<T><<<sum_grid, kThreads, 0, stream>>>(
      dv_ws, (T*)dv, seq, d, nsplit, split, 1.f, causal, 1);
  return cudaGetLastError();
}

// The smallest head dim whose float32 kernels (forward and backward) run
// as clusters of split_ctas(D) CTAs (the wide kernels, W = kWide); below it
// one CTA holds all of D (the *_tc_kernel<D> instances, W = D).
constexpr int kF32ClusterMin = 256;

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, float scale, int causal,
                       cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    const size_t smem = fwd_mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_fwd_mma_kernel<T, D>, smem));
    flash_fwd_mma_kernel<T, D>
        <<<dim3(seq / kTile, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
            seq, scale, causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_fwd_wide<float>(D, q, k, v, o, lse, bh, seq, scale, causal,
                                  stream);
  } else {
    const size_t smem = f32_fwd_smem<D, false>(1);
    BPS_RETURN_IF_ERROR(allow_smem(flash_fwd_tc_kernel<D>, smem));
    flash_fwd_tc_kernel<D>
        <<<dim3(seq / kTile, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v, (float*)o,
            lse, seq, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* delta, int bh, int seq, float scale,
                      int causal, cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    const size_t smem = mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dq_mma_kernel<T, D>, smem));
    flash_bwd_dq_mma_kernel<T, D>
        <<<dim3(seq / kTile, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)o,
            (const T*)dout, lse, (T*)dq, delta, seq, scale, causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_dq_wide<float>(D, q, k, v, o, dout, lse, dq, delta, bh, seq,
                                 scale, causal, stream);
  } else {
    const size_t smem = f32_bwd_smem<D, false>(1, 1);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dq_tc_kernel<D>, smem));
    flash_bwd_dq_tc_kernel<D>
        <<<dim3(seq / kTile, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v,
            (const float*)o, (const float*)dout, lse, (float*)dq, delta, seq,
            scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int seq, float scale,
                       int causal, cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    const size_t smem = mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dkv_mma_kernel<T, D>, smem));
    flash_bwd_dkv_mma_kernel<T, D>
        <<<dim3(seq / kTile, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v,
            (const T*)dout, lse, delta, (T*)dk, (T*)dv, seq, scale,
            causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_dkv_wide<float>(D, q, k, v, dout, lse, delta, dk, dv, bh,
                                  seq, scale, causal, stream);
  } else {
    const size_t smem = f32_bwd_smem<D, false>(1, 2);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dkv_tc_kernel<D>, smem));
    flash_bwd_dkv_tc_kernel<D>
        <<<dim3(seq / kTile, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v,
            (const float*)dout, lse, delta, (float*)dk, (float*)dv, seq,
            scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_str(const void* q, const void* k, const void* v,
                           void* o, float* lse, float* m_ws, float* l_ws,
                           float* acc_ws, int bh, int seq, float scale,
                           int causal, int split, cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int nsplit = num_splits(seq, split);
  if constexpr (kTensorCores<T>) {
    const size_t smem = fwd_mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_fwd_str_mma_kernel<T, D>, smem));
    flash_fwd_str_mma_kernel<T, D>
        <<<dim3(num_t, nsplit, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, m_ws, l_ws,
            acc_ws, seq, split, scale, causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_fwd_str_wide<float>(D, q, k, v, o, lse, m_ws, l_ws, acc_ws,
                                      bh, seq, scale, causal, split, stream);
  } else {
    const size_t smem = f32_fwd_smem<D, false>(1);
    BPS_RETURN_IF_ERROR(allow_smem(flash_fwd_str_tc_kernel<D>, smem));
    flash_fwd_str_tc_kernel<D>
        <<<dim3(num_t, nsplit, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v, m_ws, l_ws,
            acc_ws, seq, split, scale, causal);
  }
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  flash_fwd_str_merge_kernel<T, D><<<dim3(num_t, bh), kThreads, 0, stream>>>(
      m_ws, l_ws, acc_ws, (T*)o, lse, seq, nsplit, split, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_str(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          void* dq, float* delta, float* dq_ws, int bh,
                          int seq, float scale, int causal, int split,
                          cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int nsplit = num_splits(seq, split);
  if constexpr (kTensorCores<T>) {
    flash_delta_kernel<T, D><<<dim3(num_t, bh), kThreads, 0, stream>>>(
        (const T*)o, (const T*)dout, delta, seq);
    BPS_RETURN_IF_ERROR(cudaGetLastError());
    const size_t smem = mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dq_str_mma_kernel<T, D>, smem));
    flash_bwd_dq_str_mma_kernel<T, D>
        <<<dim3(num_t, nsplit, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
            lse, delta, dq_ws, seq, split, scale, causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_dq_str_wide<float>(D, q, k, v, o, dout, lse, dq, delta,
                                     dq_ws, bh, seq, scale, causal, split,
                                     stream);
  } else {
    // delta summed as the resident kernel sums it (warp_row_dot), so that
    // one split gives the resident kernel's bits
    flash_delta_wide_kernel<float><<<dim3(num_t, bh), kThreads, 0, stream>>>(
        (const float*)o, (const float*)dout, delta, seq, D);
    BPS_RETURN_IF_ERROR(cudaGetLastError());
    const size_t smem = f32_bwd_smem<D, false>(1, 1);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dq_str_tc_kernel<D>, smem));
    flash_bwd_dq_str_tc_kernel<D>
        <<<dim3(num_t, nsplit, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v,
            (const float*)dout, lse, delta, dq_ws, seq, split, scale,
            causal);
  }
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  flash_sum_splits_kernel<T, D><<<dim3(num_t, bh), kThreads, 0, stream>>>(
      dq_ws, (T*)dq, seq, nsplit, split, scale, causal, 0);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_str(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           float* dk_ws, float* dv_ws, int bh, int seq,
                           float scale, int causal, int split,
                           cudaStream_t stream) {
  const int num_t = seq / kTile;
  const int nsplit = num_splits(seq, split);
  if constexpr (kTensorCores<T>) {
    const size_t smem = mma_smem<D>();
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dkv_str_mma_kernel<T, D>, smem));
    flash_bwd_dkv_str_mma_kernel<T, D>
        <<<dim3(num_t, nsplit, bh), kMmaThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
            lse, delta, dk_ws, dv_ws, seq, split, scale, causal);
  } else if constexpr (D >= kF32ClusterMin) {
    return launch_dkv_str_wide<float>(D, q, k, v, dout, lse, delta, dk, dv,
                                      dk_ws, dv_ws, bh, seq, scale, causal,
                                      split, stream);
  } else {
    const size_t smem = f32_bwd_smem<D, false>(1, 2);
    BPS_RETURN_IF_ERROR(allow_smem(flash_bwd_dkv_str_tc_kernel<D>, smem));
    flash_bwd_dkv_str_tc_kernel<D>
        <<<dim3(num_t, nsplit, bh), kTcThreads, smem, stream>>>(
            (const float*)q, (const float*)k, (const float*)v,
            (const float*)dout, lse, delta, dk_ws, dv_ws, seq, split, scale,
            causal);
  }
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  flash_sum_splits_kernel<T, D><<<dim3(num_t, bh), kThreads, 0, stream>>>(
      dk_ws, (T*)dk, seq, nsplit, split, scale, causal, 1);
  BPS_RETURN_IF_ERROR(cudaGetLastError());
  flash_sum_splits_kernel<T, D><<<dim3(num_t, bh), kThreads, 0, stream>>>(
      dv_ws, (T*)dv, seq, nsplit, split, 1.f, causal, 1);
  return cudaGetLastError();
}

bool shape_ok(int bh, int seq) {
  return bh >= 1 && bh <= 65535 && seq >= kTile && seq % kTile == 0;
}

// Every kernel that reads q, k, v and dO (every dtype and head dim) copies
// them, and dK/dV also LSE and delta, in 16-byte pieces (cp.async).
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

bool split_ok(int seq, int split) {
  return split >= 1 && num_splits(seq, split) <= 65535;
}

// Instantiates `launcher<T, D>(args...)` for the supported head dims.
#define BPS_HEAD_DIMS(launcher, T, d, ...)                                 \
  switch (d) {                                                             \
    case 16: return (int)launcher<T, 16>(__VA_ARGS__);                     \
    case 32: return (int)launcher<T, 32>(__VA_ARGS__);                     \
    case 64: return (int)launcher<T, 64>(__VA_ARGS__);                     \
    case 128: return (int)launcher<T, 128>(__VA_ARGS__);                   \
    case 256: return (int)launcher<T, 256>(__VA_ARGS__);                   \
  }
// Head dims above 256 (multiples of kWide) go to the wide launchers,
// `launcher`_wide<T>(...), with D among their arguments.
#define BPS_DISPATCH(launcher, dtype, d, ...)                              \
  do {                                                                     \
    if ((d) > 256) {                                                       \
      if ((d) % kWide) return (int)cudaErrorInvalidValue;                  \
      if ((dtype) == 0) return (int)launcher##_wide<float>(d, __VA_ARGS__);   \
      if ((dtype) == 1)                                                    \
        return (int)launcher##_wide<__nv_bfloat16>(d, __VA_ARGS__);           \
      if ((dtype) == 2) return (int)launcher##_wide<__half>(d, __VA_ARGS__);  \
      return (int)cudaErrorInvalidValue;                                   \
    }                                                                      \
    if ((dtype) == 0) {                                                    \
      BPS_HEAD_DIMS(launcher, float, d, __VA_ARGS__)                       \
    } else if ((dtype) == 1) {                                             \
      BPS_HEAD_DIMS(launcher, __nv_bfloat16, d, __VA_ARGS__)               \
    } else if ((dtype) == 2) {                                             \
      BPS_HEAD_DIMS(launcher, __half, d, __VA_ARGS__)                      \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 16, 32, 64,
// 128 or 256, or above 256 a multiple of 128 (the wide kernels).  bh: at
// most 65,535.
// Returns a cudaError_t as int; 0 means the launch was accepted.
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int seq,
                             int head_dim, int dtype, float scale, int causal,
                             void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_fwd, dtype, head_dim, q, k, v, o, lse, bh, seq, scale,
               causal, (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, void* dq, float* delta,
                                int bh, int seq, int head_dim, int dtype,
                                float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_dq, dtype, head_dim, q, k, v, o, dout, lse, dq, delta,
               bh, seq, scale, causal, (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int bh, int seq, int head_dim, int dtype,
                                 float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout, lse, delta}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_dkv, dtype, head_dim, q, k, v, dout, lse, delta, dk,
               dv, bh, seq, scale, causal, (cudaStream_t)stream);
}

// Streaming family.  `split` is the split length in 64-row tiles; the
// workspaces hold ceil(S / 64 / split) splits: m_ws and l_ws [n, BH, S],
// acc_ws, dq_ws, dk_ws and dv_ws [n, BH, S, D], all float32.
extern "C" int bps_flash_fwd_str(const void* q, const void* k, const void* v,
                                 void* o, float* lse, float* m_ws,
                                 float* l_ws, float* acc_ws, int bh, int seq,
                                 int head_dim, int dtype, float scale,
                                 int causal, int split, void* stream) {
  if (!shape_ok(bh, seq) || !split_ok(seq, split))
    return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_fwd_str, dtype, head_dim, q, k, v, o, lse, m_ws, l_ws,
               acc_ws, bh, seq, scale, causal, split, (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dq_str(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    void* dq, float* delta, float* dq_ws,
                                    int bh, int seq, int head_dim, int dtype,
                                    float scale, int causal, int split,
                                    void* stream) {
  if (!shape_ok(bh, seq) || !split_ok(seq, split))
    return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_dq_str, dtype, head_dim, q, k, v, o, dout, lse, dq,
               delta, dq_ws, bh, seq, scale, causal, split,
               (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dkv_str(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, float* dk_ws,
                                     float* dv_ws, int bh, int seq,
                                     int head_dim, int dtype, float scale,
                                     int causal, int split, void* stream) {
  if (!shape_ok(bh, seq) || !split_ok(seq, split))
    return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout, lse, delta}))
    return (int)cudaErrorMisalignedAddress;
  BPS_DISPATCH(launch_dkv_str, dtype, head_dim, q, k, v, dout, lse, delta,
               dk, dv, dk_ws, dv_ws, bh, seq, scale, causal, split,
               (cudaStream_t)stream);
}

// CTAs of one cluster of the float32 kernels (forward and backward) at
// `head_dim`: 1 below kF32ClusterMin, where one CTA holds all of D and no
// cluster is launched, else split_ctas(D); 0 for a head dim the kernels do
// not take.
extern "C" int bps_flash_f32_cluster(int head_dim) {
  if (head_dim < kF32ClusterMin)
    return head_dim == 16 || head_dim == 32 || head_dim == 64 ||
                   head_dim == 128
               ? 1
               : 0;
  return head_dim % kWide == 0 ? split_ctas(head_dim) : 0;
}

// CTAs of one cluster of the 16-bit (bf16, float16) forward at
// `head_dim`: split_ctas(D) above 256, where it runs as clusters; 1 at the
// instantiated head dims, one CTA a tile; 0 for a head dim it does not
// take.
extern "C" int bps_flash_fwd16_cluster(int head_dim) {
  if (head_dim <= 256)
    return head_dim == 16 || head_dim == 32 || head_dim == 64 ||
                   head_dim == 128 || head_dim == 256
               ? 1
               : 0;
  return head_dim % kWide == 0 ? split_ctas(head_dim) : 0;
}

// Clusters of the resident 16-bit wide forward (dtype 1 = bfloat16,
// 2 = float16) at `head_dim` (above 256) that the card holds at once;
// -1 on an error or for what the kernel does not take.
extern "C" int bps_flash_fwd16_max_clusters(int head_dim, int dtype) {
  if (head_dim <= 256 || head_dim % kWide) return -1;
  const int ctas = split_ctas(head_dim);
  if (dtype == 1)
    return max_clusters(flash_fwd_wide16_kernel<__nv_bfloat16>, ctas,
                        fwd16_smem(ctas));
  if (dtype == 2)
    return max_clusters(flash_fwd_wide16_kernel<__half>, ctas,
                        fwd16_smem(ctas));
  return -1;
}

extern "C" const char* bps_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
