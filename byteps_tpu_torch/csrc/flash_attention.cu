// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Three kernels, one per Pallas kernel of the K/V-resident path in
// byteps_tpu/ops/flash_attention.py:
//
//   flash_fwd      replaces _fwd_kernel_res  (:142-165)
//   flash_bwd_dq   replaces _dq_kernel_res   (:168-189), plus the
//                  delta = rowsum(dO * O) pre-pass that the JAX version
//                  leaves to XLA (_bwd, :357-359)
//   flash_bwd_dkv  replaces _dkv_kernel_res  (:192-215)
//
// Layout: q, k, v, o, dO are contiguous [BH, S, D] in float32 or bfloat16;
// lse and delta are contiguous [BH, S] float32.
//
// What bounds them on the H100.  At the flagship shape (BH = 128, S = 512,
// D = 64, bf16, causal) each kernel moves 34-51 MB, about 10-15 us at
// 3.35 TB/s, and does 4-9 GFLOP, about 4-9 us at the bf16 tensor-core peak:
// the bound is the bytes.  These kernels do their products as float32 FMAs
// on the CUDA cores (67 TFLOP/s at most), so what bounds them in practice is
// FMA issue and shared-memory bandwidth, not device memory.  The design
// keeps every intermediate the TPU kernels keep out of HBM out of device
// memory too: the [S, S] logits and probabilities only ever exist as one
// 64 x 64 tile in registers and shared memory, and the backward recomputes
// them from the saved log-sum-exp.  Moving the two products of each step
// onto the tensor cores (mma.sync, then wgmma with TMA) is the next step.
//
// Tiling.  The TPU kernels take one q block of up to 512 rows and keep K/V
// whole in VMEM.  A 512 x 512 float32 logits tile does not fit in 227 KB of
// shared memory, so these kernels pick their own tiles: 64 q rows by 64 k
// rows, 256 threads, four threads to a row, each thread owning 16 columns
// of the logits tile and D / 4 columns of the accumulator.  Causal masking
// skips tiles above the diagonal (the loop bound) and masks inside the
// diagonal tile, with global positions, as _causal_mask does.
//
// Each entry point returns cudaGetLastError() after its launch (or the
// error of the attribute call before it), so a refused launch surfaces in
// the caller and never passes silently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // rows of a q tile and of a k tile
constexpr int kLanes = 4;              // threads that share one tile row
constexpr int kThreads = kTile * kLanes;
constexpr int kCols = kTile / kLanes;  // logits columns per thread
constexpr int kTileLd = kTile + 1;     // padded row of a logits tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum (or max) over the four consecutive lanes that share a tile row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Copy the contiguous [kTile, D] tile at `src` into shared float32 with a
// padded row of D + 1 floats (so that the four lanes of a row, and the rows
// of a warp, read different banks), multiplied by `scale`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          float scale) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    dst[(i / D) * (D + 1) + (i % D)] = to_f32(src[i]) * scale;
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, bh).  Online softmax over the k tiles,
// as _online_step: running max m, running sum l, float32 accumulator.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale,
                     int causal) {
  constexpr int ld = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [kTile][ld], pre-scaled by sm_scale
  float* ks = qs + kTile * ld;      // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* ps = vs + kTile * ld;      // [kTile][kTileLd] probabilities

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const size_t base = (size_t)bh * seq * D;

  load_tile<T, D>(qs, q + base + (size_t)qt * kTile * D, scale);

  float m = -INFINITY;
  float l = 0.f;
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;

  const int num_kt = causal ? qt + 1 : seq / kTile;
  for (int kt = 0; kt < num_kt; ++kt) {
    __syncthreads();  // every thread is done with the previous K/V tile
    load_tile<T, D>(ks, k + base + (size_t)kt * kTile * D, 1.f);
    load_tile<T, D>(vs, v + base + (size_t)kt * kTile * D, 1.f);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] += qv * ks[(c + kLanes * j) * ld + d];
    }
    if (causal && kt == qt) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (c + kLanes * j > r) s[j] = -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kCols; ++j) mx = fmaxf(mx, s[j]);
    mx = row_max(mx);
    const float alpha = expf(m - mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - mx);
      ps[r * kTileLd + c + kLanes * j] = p;
      rs += p;
    }
    l = l * alpha + row_sum(rs);
    m = mx;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's probabilities are written and read by one warp
    for (int j = 0; j < kTile; ++j) {
      const float p = ps[r * kTileLd + j];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) acc[i] += p * vs[j * ld + c + kLanes * i];
    }
  }

  const int row = qt * kTile + r;
  T* orow = o + base + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) orow[c + kLanes * i] = from_f32<T>(acc[i] / l);
  if (c == 0) lse[(size_t)bh * seq + row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh).  Preamble: delta for the block's rows,
// written out for the dK/dV kernel.  Then, per k tile, recompute
// P = exp(scale * Q K^T - lse), dS = P * (dO V^T - delta), dQ += dS K.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, int seq, float scale,
                        int causal) {
  constexpr int ld = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ks = dos + kTile * ld;     // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* dss = vs + kTile * ld;     // [kTile][kTileLd] dS tile

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const size_t base = (size_t)bh * seq * D;
  const int row = qt * kTile + r;

  load_tile<T, D>(qs, q + base + (size_t)qt * kTile * D, 1.f);
  load_tile<T, D>(dos, dout + base + (size_t)qt * kTile * D, 1.f);
  __syncthreads();

  const T* orow = o + base + (size_t)row * D;
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i)
    dl += dos[r * ld + c + kLanes * i] * to_f32(orow[c + kLanes * i]);
  dl = row_sum(dl);
  if (c == 0) delta[(size_t)bh * seq + row] = dl;
  const float lse_r = lse[(size_t)bh * seq + row];

  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;

  const int num_kt = causal ? qt + 1 : seq / kTile;
  for (int kt = 0; kt < num_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(ks, k + base + (size_t)kt * kTile * D, 1.f);
    load_tile<T, D>(vs, v + base + (size_t)kt * kTile * D, 1.f);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * ld + d];
      const float dv = dos[r * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = c + kLanes * j;
        s[j] += qv * ks[col * ld + d];
        dp[j] += dv * vs[col * ld + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = c + kLanes * j;
      const bool masked = causal && kt == qt && col > r;
      const float p = masked ? 0.f : expf(scale * s[j] - lse_r);
      dss[r * kTileLd + col] = p * (dp[j] - dl);
    }
    __syncwarp();
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[r * kTileLd + j];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) acc[i] += ds * ks[j * ld + c + kLanes * i];
    }
  }

  T* dqrow = dq + base + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) dqrow[c + kLanes * i] = from_f32<T>(scale * acc[i]);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (k tile, bh).  Loops over the q tiles from the
// diagonal (causal) or from 0, accumulating dV = P^T dO and
// dK = scale * dS^T Q in float32 registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int seq, float scale,
                         int causal) {
  constexpr int ld = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                   // [kTile][ld]
  float* vs = ks + kTile * ld;        // [kTile][ld]
  float* qs = vs + kTile * ld;        // [kTile][ld]
  float* dos = qs + kTile * ld;       // [kTile][ld]
  float* pt = dos + kTile * ld;       // [kTile][kTileLd] P^T tile
  float* dst = pt + kTile * kTileLd;  // [kTile][kTileLd] dS^T tile
  float* lses = dst + kTile * kTileLd;  // [kTile]
  float* dels = lses + kTile;           // [kTile]

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int j = threadIdx.x / kLanes;  // this thread's k row in the tile
  const int c = threadIdx.x % kLanes;
  const size_t base = (size_t)bh * seq * D;

  load_tile<T, D>(ks, k + base + (size_t)kt * kTile * D, 1.f);
  load_tile<T, D>(vs, v + base + (size_t)kt * kTile * D, 1.f);

  float dk_acc[D / kLanes], dv_acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int num_qt = seq / kTile;
  for (int qt = causal ? kt : 0; qt < num_qt; ++qt) {
    __syncthreads();
    load_tile<T, D>(qs, q + base + (size_t)qt * kTile * D, 1.f);
    load_tile<T, D>(dos, dout + base + (size_t)qt * kTile * D, 1.f);
    if (threadIdx.x < kTile) {
      const size_t at = (size_t)bh * seq + (size_t)qt * kTile + threadIdx.x;
      lses[threadIdx.x] = lse[at];
      dels[threadIdx.x] = delta[at];
    }
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[j * ld + d];
      const float vv = vs[j * ld + d];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int qr = c + kLanes * i;
        s[i] += qs[qr * ld + d] * kv;
        dp[i] += dos[qr * ld + d] * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int qr = c + kLanes * i;
      const bool masked = causal && qt == kt && j > qr;
      const float p = masked ? 0.f : expf(scale * s[i] - lses[qr]);
      pt[j * kTileLd + qr] = p;
      dst[j * kTileLd + qr] = p * (dp[i] - dels[qr]);
    }
    __syncwarp();
    for (int qr = 0; qr < kTile; ++qr) {
      const float p = pt[j * kTileLd + qr];
      const float ds = dst[j * kTileLd + qr];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) {
        const int d = c + kLanes * i;
        dv_acc[i] += p * dos[qr * ld + d];
        dk_acc[i] += ds * qs[qr * ld + d];
      }
    }
  }

  const int row = kt * kTile + j;
  T* dkrow = dk + base + (size_t)row * D;
  T* dvrow = dv + base + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) {
    dkrow[c + kLanes * i] = from_f32<T>(scale * dk_acc[i]);
    dvrow[c + kLanes * i] = from_f32<T>(dv_acc[i]);
  }
}

// ---------------------------------------------------------------------------
// Host side: shared-memory sizes, launches, dtype/head-dim dispatch.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return (3 * kTile * (D + 1) + kTile * kTileLd) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kTileLd) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kTileLd + 2 * kTile) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, seq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* delta, int bh, int seq, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse,
      (T*)dq, delta, seq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int seq, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, seq, scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int bh, int seq) {
  return bh >= 1 && bh <= 65535 && seq >= kTile && seq % kTile == 0;
}

// Instantiates `launcher<T, D>(args...)` for the supported head dims.
#define BPS_DISPATCH(launcher, dtype, d, ...)                              \
  do {                                                                     \
    if ((dtype) == 0) {                                                    \
      switch (d) {                                                         \
        case 16: return (int)launcher<float, 16>(__VA_ARGS__);             \
        case 32: return (int)launcher<float, 32>(__VA_ARGS__);             \
        case 64: return (int)launcher<float, 64>(__VA_ARGS__);             \
        case 128: return (int)launcher<float, 128>(__VA_ARGS__);           \
      }                                                                    \
    } else if ((dtype) == 1) {                                             \
      switch (d) {                                                         \
        case 16: return (int)launcher<__nv_bfloat16, 16>(__VA_ARGS__);     \
        case 32: return (int)launcher<__nv_bfloat16, 32>(__VA_ARGS__);     \
        case 64: return (int)launcher<__nv_bfloat16, 64>(__VA_ARGS__);     \
        case 128: return (int)launcher<__nv_bfloat16, 128>(__VA_ARGS__);   \
      }                                                                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 16, 32, 64 or 128.
// Returns a cudaError_t as int; 0 means the launch was accepted.
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int seq,
                             int head_dim, int dtype, float scale, int causal,
                             void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  BPS_DISPATCH(launch_fwd, dtype, head_dim, q, k, v, o, lse, bh, seq, scale,
               causal, (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, void* dq, float* delta,
                                int bh, int seq, int head_dim, int dtype,
                                float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  BPS_DISPATCH(launch_dq, dtype, head_dim, q, k, v, o, dout, lse, dq, delta,
               bh, seq, scale, causal, (cudaStream_t)stream);
}

extern "C" int bps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int bh, int seq, int head_dim, int dtype,
                                 float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq)) return (int)cudaErrorInvalidValue;
  BPS_DISPATCH(launch_dkv, dtype, head_dim, q, k, v, dout, lse, delta, dk,
               dv, bh, seq, scale, causal, (cudaStream_t)stream);
}

extern "C" const char* bps_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
