// Row-wise symmetric int8 quantization, for Hopper (sm_90a).
//
// Replaces repro/kernels/quantize.py::quantize_int8_pallas (the pallas_call
// at quantize.py:45): for each row of x (T, D),
//   scale = max(amax(|x|), floor) / 127,   q = clip(round(x / scale), +-127)
// with round half to even (jnp.round), q int8 (T, D) and scale fp32 (T, 1).
// The TPU kernel's floor is 1e-12; the int8 KV cache passes 1e-8.
//
// What bounds it on this card: bytes.  It does ~4 operations per element
// against the ~295 FLOP/byte an H100 needs before compute is the limit, so
// the design moves each byte once: one warp owns one row, loads it once into
// registers (up to 8 values a lane, D <= 256: the KV rows are head_dim
// wide), takes amax by a shuffle max, and writes the codes and the scale.
// Longer rows take a strided loop that reads the row a second time for the
// codes (from L1/L2, not device memory, at these row lengths).
//
// Bit-identical to the plain PyTorch version: both divisions are IEEE
// (no --use_fast_math: a / b is div.rn.f32; the plain version divides by a
// device tensor, since torch multiplies by the reciprocal of a Python
// scalar), rintf rounds half to even as torch.round and jnp.round do
// (roundf would round half away from zero), and the max is exact in any
// order.
//
// C entry: quantize_int8_fwd(...) launches on the given stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // rows per block
constexpr int kVPT = 8;        // values a lane keeps in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t code(float x, float s) {
  const float r = fminf(fmaxf(rintf(x / s), -127.f), 127.f);
  return (int8_t)__float2int_rn(r);   // r is integral: the conversion is exact
}

template <typename T>
__global__ void quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ scale, int64_t rows, int D,
                                     float floor_) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;             // the whole warp leaves together
  const T* xr = x + row * (int64_t)D;
  int8_t* qr = q + row * (int64_t)D;
  const bool in_regs = D <= 32 * kVPT;

  float v[kVPT];
  float amax = 0.f;
  if (in_regs) {
#pragma unroll
    for (int j = 0; j < kVPT; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < D ? to_f(xr[i]) : 0.f;
      amax = fmaxf(amax, fabsf(v[j]));
    }
  } else {
    for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(to_f(xr[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, floor_) / 127.0f;

  if (in_regs) {
#pragma unroll
    for (int j = 0; j < kVPT; ++j) {
      const int i = lane + 32 * j;
      if (i < D) qr[i] = code(v[j], s);
    }
  } else {
    for (int i = lane; i < D; i += 32) qr[i] = code(to_f(xr[i]), s);
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int64_t rows, int D,
                   float floor_, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quantize_int8_kernel<T><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows, D, floor_);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, D) contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// q: (rows, D) int8; scale: (rows,) fp32; device: the tensors' CUDA ordinal.
extern "C" int quantize_int8_fwd(const void* x, void* q, void* scale, long long rows,
                                 int D, float floor_, int x_bf16, int device,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = x_bf16 ? launch<__nv_bfloat16>(x, q, scale, rows, D, floor_, s)
             : launch<float>(x, q, scale, rows, D, floor_, s);
  return (int)e;
}
