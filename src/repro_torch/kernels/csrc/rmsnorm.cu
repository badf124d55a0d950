// RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm_pallas (the pallas_call at
// rmsnorm.py:34): out = x * rsqrt(mean(x^2) + eps) * scale, statistics in
// fp32, cast back to the input type.
//
// What bounds it on this card: bytes.  The arithmetic is ~4 FLOP per
// element, far below the ~295 FLOP/byte an H100 needs before compute is the
// limit.  So the design moves each byte once, in the widest transactions
// the card has:
//   * a row belongs to TPR threads (a power of two); each thread loads its
//     part of the row with 16-byte vector loads (8 bf16 or 4 fp32), NV
//     vectors a thread, neighbouring threads on neighbouring vectors, and
//     keeps them in registers: no shared-memory staging;
//   * the sum of squares is taken in fp32, reduced with shuffles within a
//     warp and, for rows wider than a warp, one small shared array of
//     per-warp partials;
//   * the row is scaled in registers and written back with 16-byte stores;
//     `scale` is read with vector loads too, after the reduction (read with
//     the row instead, it was slower at (4096, 5120) on the H100).
// NV and TPR are template parameters chosen at launch from D, and only the
// pairs the served widths need are compiled: 5120 bf16 (qwen3) is 128
// threads x 5 vectors, 4096 (falcon-mamba, recurrentgemma) 128 x 4, 128
// (qk-norm) 16 threads x 1, so narrow rows share a warp and a 256-thread
// block holds 16 of them.  Rows of up to 64 vectors take the narrow
// variants, rows of up to 640 the 128 x 4 or 128 x 5 one, lane-masked.
// Wider rows (fp32 at 4096 and 5120), rows whose D is not a multiple of
// the vector width, and pointers not 16-byte aligned take the same
// kernel's scalar branch (NV = 0): strided 2- or 4-byte loads, and a second
// read of the row from device memory for the write.
// Products in fp32 as (x * r) * scale, rounded to bf16 to nearest even.
//
// C entry: rmsnorm_fwd(...) launches on the given stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// N values of type T at p (aligned to N * sizeof(T)), as fp32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * sizeof(T);
  static_assert(BYTES % 8 == 0, "vector of 8, 16 or 32 bytes");
  if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* v = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(v[i]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(v[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte store");
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum over the TPR threads of a row (TPR a power of two; a row's threads
// are contiguous and aligned in the block).  red holds one float per warp.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;                 // warps per row
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    v = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) v += red[first + w];
  }
  return v;
}

// Block: BLOCK threads = BLOCK / TPR rows.  NV > 0: vector branch, each
// thread holds NV vectors of VEC = 16 / sizeof(T) values (lane-masked where
// D / VEC is not a multiple of TPR).  NV == 0: scalar branch for any D.
template <typename T, typename S, int TPR, int NV>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int rows, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RPB = (TPR >= 128 ? TPR : 256) / TPR;   // rows per block
  __shared__ float red[(TPR >= 128 ? TPR : 256) / 32];
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const bool in = row < rows;          // no early return: row_sum may sync
  const T* xr = x + static_cast<size_t>(row) * D;
  T* orow = out + static_cast<size_t>(row) * D;

  if constexpr (NV > 0) {
    const int nvec = D / VEC;
    float v[NV][VEC];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * TPR + lane;
      if (in && c < nvec) {
        load_vec<T, VEC>(xr + c * VEC, v[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss += v[j][i] * v[j][i];
      }
    }
    const float r = rsqrtf(row_sum<TPR>(ss, red) / (float)D + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * TPR + lane;
      if (in && c < nvec) {
        float w[VEC];
        load_vec<S, VEC>(scale + c * VEC, w);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[j][i] = v[j][i] * r * w[i];
        store_vec<T, VEC>(orow + c * VEC, v[j]);
      }
    }
  } else {
    float ss = 0.f;
    if (in)
      for (int i = lane; i < D; i += TPR) {
        const float f = to_f(xr[i]);
        ss += f * f;
      }
    const float r = rsqrtf(row_sum<TPR>(ss, red) / (float)D + eps);
    if (in)
      for (int i = lane; i < D; i += TPR)
        orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
  }
}

template <typename T, typename S, int TPR, int NV>
cudaError_t go(const void* x, const void* scale, void* out, int rows, int D, float eps,
               cudaStream_t stream) {
  constexpr int BLOCK = TPR >= 128 ? TPR : 256;
  constexpr int RPB = BLOCK / TPR;
  rmsnorm_kernel<T, S, TPR, NV><<<(rows + RPB - 1) / RPB, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D,
                   float eps, bool aligned, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = D / VEC;
  if (aligned && D % VEC == 0 && nvec <= 5 * 128) {
    // rows of up to 64 vectors: one vector a thread, threads per row the
    // vectors' count rounded up to a power of two; wider rows: 128 threads
    // of 4 vectors (bf16 D 4096) or 5 (bf16 D 5120), lane-masked below that
    if (nvec <= 4) return go<T, S, 4, 1>(x, scale, out, rows, D, eps, s);
    if (nvec <= 8) return go<T, S, 8, 1>(x, scale, out, rows, D, eps, s);
    if (nvec <= 16) return go<T, S, 16, 1>(x, scale, out, rows, D, eps, s);
    if (nvec <= 32) return go<T, S, 32, 1>(x, scale, out, rows, D, eps, s);
    if (nvec <= 64) return go<T, S, 64, 1>(x, scale, out, rows, D, eps, s);
    if (nvec <= 4 * 128) return go<T, S, 128, 4>(x, scale, out, rows, D, eps, s);
    return go<T, S, 128, 5>(x, scale, out, rows, D, eps, s);
  }
  if (D <= 32) return go<T, S, 32, 0>(x, scale, out, rows, D, eps, s);
  if (D < 1024) return go<T, S, 128, 0>(x, scale, out, rows, D, eps, s);
  return go<T, S, 256, 0>(x, scale, out, rows, D, eps, s);
}

}  // namespace

// x, out: (rows, D) contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// scale: (D,), fp32 or bf16 (scale_bf16); device: the tensors' CUDA ordinal.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                           int D, float eps, int x_bf16, int scale_bf16,
                           int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)
                         | reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  if (x_bf16) {
    e = scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, eps, aligned, s)
        : launch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, aligned, s);
  } else {
    e = scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, aligned, s)
                   : launch<float, float>(x, scale, out, rows, D, eps, aligned, s);
  }
  return (int)e;
}
