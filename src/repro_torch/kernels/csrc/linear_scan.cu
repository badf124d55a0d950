// Linear-recurrence scans for Hopper (sm_90a): the RG-LRU gate scan and the
// Mamba-1 selective scan fused with its C-contraction on materialised a, b.
//
// Replaces repro/kernels/linear_scan.py::rglru_scan_pallas (pallas_call at
// linear_scan.py:61) and ::ssm_scan_pallas (pallas_call at :122).  Both
// compute h_t = a_t * h_{t-1} + b_t with h_{-1} = 0, the multiply and the
// add rounded separately (__fmul_rn, __fadd_rn) as the plain versions'
// `a * h + b` (repro_torch/kernels/linear_scan.py) is.
//
// What bounds them on this card: bytes.  Each does one fp32 multiply-add
// pair per element it reads (~0.25 FLOP/byte), far below the H100's ridge.
// The TPU kernels keep h resident in VMEM across a sequential grid axis.
//
//   rglru_scan: a, b (B, S, W) -> h (B, S, W), rglru_scan_lookback.  One
//     thread a column walking all of S (this kernel's first design) gives a
//     one-row prefill only W = 4096 threads: latency-bound at 13 % of the
//     HBM rate (H100 80GB HBM3 at 700 W, PERF.md).  So S is cut into chunks of RG_L = 64 steps, and one block
//     of RG_W = 128 threads takes a chunk of 128 columns (1,024 blocks at
//     B1 S2048 W4096).  A thread loads its column's 64 steps of a and b
//     into registers at once (all loads independent), folds them into the
//     chunk's aggregate (P = prod a, H = the scan from h = 0), and publishes
//     it; then it finds the carry into the chunk by a decoupled look-back
//     (single pass: chunks are handed out by an atomic ticket in sequence
//     order, each publishes its aggregate and then its inclusive carry
//     P * carry + H behind a flag, and a chunk folds predecessors'
//     aggregates back to the nearest inclusive one), and finally rescans
//     its registers in sequence order from that carry, writing h once.  a
//     and b are read once, h written once, plus 3 floats a column a chunk
//     of workspace.  Numerics: within a chunk h is the sequential
//     recurrence from the carry; the carry is the fold
//     f_{c-1}(...f_0(0)), f_j(x) = P_j * x + H_j, whichever predecessor
//     had its inclusive value ready (the same operations either way), so
//     the result is deterministic, and off the plain version only by the
//     reassociation of the carry (held to 1e-5).
//   ssm_scan: a, b (B, S, D, N), c (B, S, N) -> y (B, S, D), h_last
//     (B, D, N).  Read in the model's layout, so no (B, S, N, D) transpose
//     is ever materialised.  The N states of one d sit on N neighbouring
//     lanes (N a power of two <= 32); a warp covers 32 / N d's and reads
//     128 contiguous bytes of a and of b per step, U = 4 steps loaded
//     before they are folded in.  y_t = sum_n h_t c_t is a shuffle
//     reduction over those N lanes; the state history never leaves
//     registers, and h_last is written once, at the end.  Strictly in
//     sequence order, so h matches the plain version bit for bit.  The
//     served path no longer calls it: selective_scan.cu fuses the
//     discretization that builds a and b into its own scan.
//
// C entries launch on the given stream and return cudaGetLastError(), so a
// refused launch reaches the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U_SSM = 4;  // steps loaded ahead of the dependent recurrence

constexpr int RG_L = 64;   // rglru_scan: steps a chunk
constexpr int RG_W = 128;  // columns a chunk (the block's threads)
enum : int { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every thread's writes, then the block's flag, visible device-wide in
// that order
__device__ __forceinline__ void publish(int* flag, int v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(flag), "r"(v) : "memory");
}

// the flag's value once it is set; a flag that is never set (which the
// ticket order rules out) traps after ~2^26 polls instead of hanging
__device__ __forceinline__ int wait_flag(const int* flag) {
  for (uint32_t n = 0;; ++n) {
    const int f = ld_acquire(flag);
    if (f != kEmpty) return f;
    if (n == (1u << 26)) __trap();
  }
}

// One block a chunk of RG_L steps x RG_W columns of one row b.  Chunks are
// handed out by an atomic ticket in sequence order, so every chunk a block
// looks back to belongs to a block that is already running.
__global__ void __launch_bounds__(RG_W)
rglru_scan_lookback(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ h_out, float* agg_p, float* agg_h,
                    float* incl, int* flags, int* ticket, int B, int S, int W,
                    int nchunks, int nwt) {
  __shared__ int s_job, s_stop;
  if (threadIdx.x == 0) s_job = atomicAdd(ticket, 1);
  __syncthreads();
  const int lanes = B * nwt;
  const int c = s_job / lanes, bi = (s_job % lanes) / nwt, wt = s_job % nwt;
  const int w = wt * RG_W + threadIdx.x;
  const bool live = w < W;
  const int nt = min(RG_L, S - c * RG_L);
  const size_t base = ((size_t)bi * S + (size_t)c * RG_L) * W + w;

  // the chunk into registers (identity a = 1, b = 0 past S or W): every
  // load is independent, so all RG_L rows are in flight at once
  float at[RG_L], bt[RG_L];
#pragma unroll
  for (int u = 0; u < RG_L; ++u) {
    const bool in = live && u < nt;
    at[u] = in ? a[base + (size_t)u * W] : 1.f;
    bt[u] = in ? b[base + (size_t)u * W] : 0.f;
  }
  // its aggregate: h from 0 over the chunk, and the product of its a's
  float P = 1.f, Hc = 0.f;
#pragma unroll
  for (int u = 0; u < RG_L; ++u) {
    Hc = __fadd_rn(__fmul_rn(at[u], Hc), bt[u]);
    P = __fmul_rn(P, at[u]);
  }
  const size_t slot = ((size_t)bi * nchunks + c) * W + w;
  int* flag = flags + ((size_t)bi * nchunks + c) * nwt + wt;
  float carry = 0.f;
  if (c == 0) {
    if (live) incl[slot] = Hc;
    publish(flag, kInclusive);
  } else {
    if (live) {
      agg_p[slot] = P;
      agg_h[slot] = Hc;
    }
    publish(flag, kAggregate);
    // decoupled look-back: walk back over aggregates to the nearest
    // inclusive carry (chunk 0 publishes one at once)
    if (threadIdx.x == 0) {
      int j = c - 1;
      while (wait_flag(flags + ((size_t)bi * nchunks + j) * nwt + wt) != kInclusive)
        --j;
      s_stop = j;
    }
    __syncthreads();
    if (live) {
      const int j0 = s_stop;
      carry = __ldcg(incl + ((size_t)bi * nchunks + j0) * W + w);
      for (int j = j0 + 1; j < c; ++j) {
        const size_t sj = ((size_t)bi * nchunks + j) * W + w;
        carry = __fadd_rn(__fmul_rn(__ldcg(agg_p + sj), carry), __ldcg(agg_h + sj));
      }
      incl[slot] = __fadd_rn(__fmul_rn(P, carry), Hc);
    }
    publish(flag, kInclusive);
  }
  // the chunk again, in sequence order from its carry
  float h = carry;
#pragma unroll
  for (int u = 0; u < RG_L; ++u) {
    h = __fadd_rn(__fmul_rn(at[u], h), bt[u]);
    if (live && u < nt) h_out[base + (size_t)u * W] = h;
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

// the RG-LRU scan's chunk geometry, so the wrapper sizes its workspace
extern "C" int rglru_scan_chunk() { return RG_L; }
extern "C" int rglru_scan_cols() { return RG_W; }

// a, b, h: (B, S, W) float32, contiguous.  ws: 3 * B * nchunks * W floats
// (no initial value needed); flags: 1 + B * nchunks * nwt ints, zeroed
// (the ticket, then one flag a chunk), where nchunks = ceil(S / chunk) and
// nwt = ceil(W / cols).  device is the tensors' CUDA ordinal (this library
// links its own cudart, whose current device is per thread).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, void* ws,
                              void* flags, int B, int S, int W, int device,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (S + RG_L - 1) / RG_L, nwt = (W + RG_W - 1) / RG_W;
  const long long blocks = (long long)B * nchunks * nwt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nchunks * W;
  float* w0 = static_cast<float*>(ws);
  int* f = static_cast<int*>(flags);
  rglru_scan_lookback<<<(unsigned)blocks, RG_W, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), w0, w0 + n, w0 + 2 * n, f + 1, f, B, S, W, nchunks,
      nwt);
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
