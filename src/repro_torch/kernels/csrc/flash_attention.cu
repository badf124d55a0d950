// Tiled online-softmax (flash) attention forward, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_hm (the
// pallas_call at flash_attention.py:119, body _attn_kernel at :34).
// Head-major layout: q (B, H, Sq, hd), k/v (B, KV, Skv, hd), out (B, H, Sq,
// hd) in q's type.  GQA reads kv head h / (H / KV); no head is broadcast in
// memory.
//
// What bounds it on this card: operations.  At the main path's prefill
// shapes (hd 128, S >= 512) attention does ~S/2 FLOP per byte of q/k/v,
// above the H100's ~295 FLOP/byte ridge.  This first version is plain fp32
// FMA (no mma.sync / wgmma / TMA yet), so its ceiling is the 67 TFLOP/s
// CUDA-core rate, not the 989 TFLOP/s bf16 tensor-core rate; the tensor-core
// rewrite is later work.  What the design does about the bound it has:
//   * one thread block per (b, h, 64-row q tile); 256 threads, each owning
//     a 4x4 patch of the 64x64 score tile and a 4 x (hd/16) patch of the
//     output accumulator, so every shared-memory load feeds 2-3 FMAs;
//   * the TPU grid's sequential kv axis (nk) becomes a loop inside the
//     block over 64-key tiles staged in shared memory; the running (m, l,
//     acc) statistics live in registers across that loop, in fp32;
//   * the loop bounds skip whole tiles that the causal or sliding-window
//     mask removes (the Pallas kernel's pl.when(live)), so causal work is
//     about half;
//   * rows of the smem tiles are padded to hd + 1 floats so the 16 lanes
//     reading 16 different keys hit 16 different banks.
// Head dims 32, 64, 128 and 256 (recurrentgemma's).  At hd 256 the staged
// Q, K and V tiles take 3 x 64 x 257 x 4 = 197,376 bytes of shared memory
// (P reuses K), under the 232,448-byte opt-in limit: one block per SM, and
// each thread keeps 64 accumulator floats in registers.
// Numerics follow the Pallas body: q is scaled in fp32, masked scores are
// the finite sentinel -1e30 (not -inf: a tile where a row is wholly masked
// then gives exp(0) garbage that the next live tile wipes through
// corr = exp(-1e30 - m) = 0, where -inf would give inf - inf = NaN), and
// the output is acc / max(l, 1e-30).
//
// C entry: flash_attention_fwd(...) launches on the given stream and
// returns cudaGetLastError(), so a refused launch reaches the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per staged kv tile
constexpr int NT = 256;   // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int HD>
struct Smem {
  static constexpr int LD = HD + 1;                  // padded row, in floats
  static constexpr int LDP = BK + 1;
  // P reuses the K tile once scores are taken, when it fits (hd >= 64)
  static constexpr bool P_IN_K = LD >= LDP;
  static constexpr int floats = BQ * LD + 2 * BK * LD + (P_IN_K ? 0 : BQ * LDP);
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int HD, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Skv, int causal, int window, float scale) {
  using SM = Smem<HD>;
  constexpr int LD = SM::LD;
  constexpr int LDP = SM::LDP;
  constexpr int NJ = HD / 16;                        // acc columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = SM::P_IN_K ? Ks : Vs + BK * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_lo = iq * BQ;
  const T* qp = q + ((size_t)b * H + h) * (size_t)Sq * HD;
  const T* kp = k + ((size_t)b * KV + hk) * (size_t)Skv * HD;
  const T* vp = v + ((size_t)b * KV + hk) * (size_t)Skv * HD;
  T* op = o + ((size_t)b * H + h) * (size_t)Sq * HD;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;        // row group: rows rg*4 .. rg*4+3
  const int cl = tid & 15;        // column lane: cols cl + 16*j

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qr = q_lo + r;
    Qs[r * LD + d] = qr < Sq ? to_f(qp[(size_t)qr * HD + d]) * scale : 0.f;
  }

  // kv tiles that hold at least one key some row of this q tile may see
  const int k_end = causal ? min(Skv, q_lo + BQ) : Skv;
  const int k_start = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = k_start / BK;
  const int t1 = (k_end + BK - 1) / BK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int k_lo = t * BK;
    __syncthreads();  // previous tile's K/V/P reads are done (and Q is staged)
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kr = k_lo + r;
      const bool in = kr < Skv;
      Ks[r * LD + d] = in ? to_f(kp[(size_t)kr * HD + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f(vp[(size_t)kr * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
    if (SM::P_IN_K) __syncthreads();  // every thread is done reading K

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + cl + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a half-warp share this row group
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        rs += p;
        Ps[(rg * 4 + i) * LDP + cl + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(rg * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = Vs[c * LD + cl + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + rg * 4 + i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[(size_t)qpos * HD + cl + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Skv, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_fwd_kernel<HD, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Skv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int causal, int window,
                        cudaStream_t s) {
  switch (hd) {
    case 32: return launch<32, T>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 64: return launch<64, T>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 128: return launch<128, T>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 256: return launch<256, T>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no sliding window; is_bf16 selects bf16 (1) or fp32 (0);
// device is the tensors' CUDA ordinal (this library links its own cudart, whose
// current device is per thread).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV, int Sq, int Skv,
                                   int hd, int causal, int window, int is_bf16,
                                   int device, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = is_bf16
      ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Skv, causal, window, s)
      : dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
  return (int)e;
}
