// Linear-recurrence scans for Hopper (sm_90a): the RG-LRU gate scan and the
// Mamba-1 selective scan fused with its C-contraction.
//
// Replaces repro/kernels/linear_scan.py::rglru_scan_pallas (pallas_call at
// linear_scan.py:61) and ::ssm_scan_pallas (pallas_call at :122).
//
// Both compute h_t = a_t * h_{t-1} + b_t with h_{-1} = 0, strictly in
// sequence order per state element, so they agree with the step-by-step
// plain versions (repro_torch/kernels/linear_scan.py) to rounding: the
// multiply and the add are rounded separately (__fmul_rn, __fadd_rn), as
// the plain version's `a * h + b` is, so h itself matches bit for bit.
//
// What bounds them on this card: bytes.  Each does one fp32 FMA-pair per
// element it reads (~0.25 FLOP/byte), far below the H100's ridge.  The
// TPU kernels keep h resident in VMEM across a sequential grid axis; here
// the sequential axis is a loop inside each thread, h lives in a register,
// and each input element is read once and each output written once.
// Blocks run in no order, so a thread owns its state column for the whole
// sequence.  To keep enough bytes in flight while every thread walks its
// column in order, the loop loads U steps of a and b (independent of h)
// before it folds them in: U = 16 for rglru_scan, whose one-row prefill
// has only W = 4096 threads, and U = 4 for ssm_scan, which has N times
// as many.
//
//   rglru_scan: a, b (B, S, W) -> h (B, S, W).  One thread per (b, w);
//     consecutive threads read consecutive w, so each step is one
//     coalesced row read of a and of b and one row write of h.  No padding:
//     the grid is bounded by W and the loop by S.
//   ssm_scan: a, b (B, S, D, N), c (B, S, N) -> y (B, S, D), h_last
//     (B, D, N).  Read in the model's layout, so no (B, S, N, D) transpose
//     is ever materialised.  The N states of one d sit on N neighbouring
//     lanes (N a power of two <= 32); a warp covers 32 / N d's and reads
//     128 contiguous bytes of a and of b per step.  y_t = sum_n h_t c_t is a
//     shuffle reduction over those N lanes; the state history never leaves
//     registers, and h_last is written once, at the end.
//
// C entries launch on the given stream and return cudaGetLastError(), so a
// refused launch reaches the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int U_RGLRU = 16;  // steps loaded ahead of the dependent recurrence
constexpr int U_SSM = 4;

__global__ void __launch_bounds__(64)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;  // no lane of this kernel talks to another
  constexpr int U = U_RGLRU;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float at[U], bt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t0 + u < S;
      const size_t i = base + (size_t)(t0 + u) * W;
      at[u] = in ? a[i] : 1.f;
      bt[u] = in ? b[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(at[u], h), bt[u]);
      if (t0 + u < S) h_out[base + (size_t)(t0 + u) * W] = h;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(256)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ y,
                float* __restrict__ h_last, int S, int D) {
  const int bi = blockIdx.y;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;   // (d, n) flat
  const int d = g / N, n = g % N;
  // lanes past D stay in the loop (the shuffles need the whole warp) but
  // read and write nothing; they fill whole N-lane groups of their own
  const bool valid = d < D;
  const size_t DN = (size_t)D * N;
  const size_t ab0 = (size_t)bi * S * DN + (size_t)d * N + n;
  const size_t c0 = (size_t)bi * S * N + n;
  const size_t y0 = (size_t)bi * S * D + d;
  constexpr int U = U_SSM;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float at[U], bt[U], ct[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = valid && t0 + u < S;
      const size_t t = (size_t)(t0 + u);
      at[u] = in ? a[ab0 + t * DN] : 1.f;
      bt[u] = in ? b[ab0 + t * DN] : 0.f;
      ct[u] = in ? c[c0 + t * N] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(at[u], h), bt[u]);
      float p = h * ct[u];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (valid && n == 0 && t0 + u < S) y[y0 + (size_t)(t0 + u) * D] = p;
    }
  }
  if (valid) h_last[(size_t)bi * DN + (size_t)d * N + n] = h;
}

template <int N>
cudaError_t launch_ssm(const float* a, const float* b, const float* c, float* y,
                       float* h_last, int B, int S, int D, cudaStream_t s) {
  constexpr int NT = 256;
  const long long lanes = (long long)D * N;
  dim3 grid((unsigned)((lanes + NT - 1) / NT), B);
  ssm_scan_kernel<N><<<grid, NT, 0, s>>>(a, b, c, y, h_last, S, D);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, W) float32, contiguous; device is the tensors' CUDA
// ordinal (this library links its own cudart, whose current device is per
// thread).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int W, int device, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  constexpr int NT = 64;  // a one-row W = 4096 scan still spans 64 SMs
  dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}

// a, b: (B, S, D, N), c: (B, S, N) float32, contiguous -> y (B, S, D),
// h_last (B, D, N).  N must be a power of two <= 32.
extern "C" int ssm_scan_fwd(const void* a, const void* b, const void* c,
                            void* y, void* h_last, int B, int S, int D, int N,
                            int device, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto* A = static_cast<const float*>(a);
  auto* Bp = static_cast<const float*>(b);
  auto* C = static_cast<const float*>(c);
  auto* Y = static_cast<float*>(y);
  auto* H = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return (int)launch_ssm<1>(A, Bp, C, Y, H, B, S, D, s);
    case 2: return (int)launch_ssm<2>(A, Bp, C, Y, H, B, S, D, s);
    case 4: return (int)launch_ssm<4>(A, Bp, C, Y, H, B, S, D, s);
    case 8: return (int)launch_ssm<8>(A, Bp, C, Y, H, B, S, D, s);
    case 16: return (int)launch_ssm<16>(A, Bp, C, Y, H, B, S, D, s);
    case 32: return (int)launch_ssm<32>(A, Bp, C, Y, H, B, S, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
