// RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm_pallas (the pallas_call at
// rmsnorm.py:34): out = x * rsqrt(mean(x^2) + eps) * scale, statistics in
// fp32, cast back to the input type.
//
// What bounds it on this card: bytes.  The arithmetic is ~4 FLOP per
// element, far below the ~295 FLOP/byte an H100 needs before compute is the
// limit.  So the design moves each byte once: a row is read from device
// memory once into shared memory (as fp32), its sum of squares is reduced
// with warp shuffles and one pass over per-warp partials, and the normalized
// row is written once.  The TPU kernel's (bt, D) row tile in VMEM becomes
// one row per blockDim.x threads; short rows (qk-norm, D = head_dim) share a
// block, blockDim.y rows to a block, so a block is never mostly idle.
//
// C entry: rmsnorm_fwd(...) launches on the given stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// smem: blockDim.y rows of D fp32 values, then one partial per warp.
template <typename T, typename S>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int rows, int D, float eps) {
  extern __shared__ float smem[];
  const int ty = threadIdx.y;
  const int row = blockIdx.x * blockDim.y + ty;
  const int nwarp = blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf = smem + (size_t)ty * D;
  float* red = smem + (size_t)blockDim.y * D;

  float ss = 0.f;
  if (row < rows) {
    const T* xr = x + (size_t)row * D;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float v = to_f(xr[i]);
      buf[i] = v;
      ss += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) red[ty * nwarp + warp] = ss;
  __syncthreads();
  if (row >= rows) return;

  float tot = 0.f;
  for (int w = 0; w < nwarp; ++w) tot += red[ty * nwarp + w];
  const float r = rsqrtf(tot / (float)D + eps);
  T* orow = out + (size_t)row * D;
  // each thread reads back only the buf entries it wrote: no barrier needed
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    orow[i] = from_f<T>(buf[i] * r * to_f(scale[i]));
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D,
                   float eps, cudaStream_t stream) {
  // long rows: 256 threads on one row; short rows: one warp per row, 8 rows
  const int tx = D >= 1024 ? 256 : 32;
  const int ty = D >= 1024 ? 1 : 8;
  const size_t smem = ((size_t)ty * D + (size_t)ty * (tx / 32)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 block(tx, ty);
  dim3 grid((rows + ty - 1) / ty);
  rmsnorm_kernel<T, S><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      rows, D, eps);
  return cudaGetLastError();
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
  if (x_bf16) {
    e = scale_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, eps, s)
                   : launch<__nv_bfloat16, float>(x, scale, out, rows, D, eps, s);
  } else {
    e = scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, rows, D, eps, s)
                   : launch<float, float>(x, scale, out, rows, D, eps, s);
  }
  return (int)e;
}
