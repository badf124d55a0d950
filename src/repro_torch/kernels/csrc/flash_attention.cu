// Tiled online-softmax (flash) attention forward, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_hm (the
// pallas_call at flash_attention.py:119, body _attn_kernel at :34).
// Head-major layout: q (B, H, Sq, hd), k/v (B, KV, Skv, hd), out (B, H, Sq,
// hd) in q's type.  GQA reads kv head h / (H / KV); no head is broadcast in
// memory.  Head dims 32, 64, 128 and 256 (recurrentgemma's).
//
// What bounds it on this card: operations.  At the main path's prefill
// shapes (hd 128, S >= 512) attention does ~S/2 FLOP per byte of q/k/v,
// far above the H100's ~295 FLOP/byte bf16 ridge, so the kernel has to run
// on the tensor cores.  Two kernels, chosen by type:
//
// bf16 (every call of the served models): flash_fwd_wgmma, warp-specialised
// wgmma fed by TMA.
//   * One block per (b, h, 128-row q tile), 288 threads: two consumer
//     warpgroups of 64 q rows each, then one producer warp.  One producer
//     thread issues TMA loads of the Q tile (once) and of K and V tiles into
//     a two-stage ring in shared memory, each stage with a full and an
//     empty mbarrier.
//   * Registers bound the tile sizes.  ptxas gives this warp-specialised
//     kernel 168 registers a thread (65,536 over three warpgroups' worth),
//     with or without setmaxnreg moving the producer's to the consumers, so
//     no setmaxnreg is used and the kv tiles are sized to 168: a consumer
//     thread holds the fp32 score tile (BK/2), the fp32 output (hd/2) and P
//     in bf16 (BK/4).  kv tiles of 128 keys at hd 32 and 64, 64 at hd 128
//     (112 live accumulator registers; 128-key tiles made ptxas serialise
//     the wgmma, C7512), 32 at hd 256 (152; ptxas still spills 140 bytes
//     and serialises there).  Shared memory, Q 128 x hd plus 2 stages of K
//     and V, all bf16: 80 KB at hd 64, 96 KB at hd 128, 128 KB at hd 256.
//   * S = Q K^T by wgmma m64nBKk16 with both operands in shared memory
//     (K-major); the scale 1/sqrt(hd) (times log2 e, for exp2) is applied
//     to the fp32 scores.  Online softmax on the accumulator fragment: each
//     row lives on the four threads of a quad, reduced by two shuffles.
//   * O += P V by wgmma m64nHDk16 with P as the register A operand (the
//     score fragment rounded to bf16 in place: the accumulator layout is
//     the A-fragment layout) and V from shared memory as an MN-major B
//     operand (the transpose bit), so no transposed copy of V is made.
//   * Tiles are loaded with CU_TENSOR_MAP_SWIZZLE_128B, whose 128-byte box
//     row is 64 bf16: a tile is stored as hd/64 column chunks of
//     [rows][64], the canonical 128B-swizzled wgmma layout.  hd 32 loads a
//     64-wide box whose upper half TMA fills with zeros, and runs as hd 64
//     (reduced configs only).  3-D tensor maps (hd, S, B*heads) give ragged
//     Sq and Skv TMA's out-of-bounds zero fill; keys at or past Skv are
//     masked and q rows at or past Sq are not stored.
//   * Whole kv tiles that the causal or window mask removes are skipped by
//     the loop bounds; a consumer skips a tile none of its rows may see;
//     only the diagonal, window-edge and ragged tiles build a mask.
//   * The warpgroup index is broadcast from lane 0 so that ptxas knows the
//     branches on it are uniform (it serialises wgmma in a branch it takes
//     for divergent, C7518).
// fp32: flash_fwd_kernel, the plain fp32-FMA kernel (CUDA cores, 67 TFLOP/s
// ceiling).  On the card fp32 reaches this kernel only from the tests and
// chip_smoke.py's f32 cases, whose 1e-4 tolerance rules out TF32 tensor
// cores; one block per (b, h, 64-row q tile), 256 threads each owning a 4x4
// patch of the score tile, rows padded to hd + 1 floats.
//
// Numerics of both follow the Pallas body: masked scores are the finite
// sentinel -1e30 (not -inf: a tile where a row is wholly masked then gives
// exp(0) garbage that the next live tile wipes through corr = exp(-1e30 - m)
// = 0, where -inf would give inf - inf = NaN), corr = exp(m_prev - m_cur),
// fp32 (m, l, acc), and the output is acc / max(l, 1e-30) in q's type.  The
// bf16 kernel rounds P to bf16 before P V, as the tensor cores need.
//
// C entry: flash_attention_fwd(...) launches on the given stream and
// returns a cudaError_t (cudaGetLastError() after the launch, or the
// tensor-map encoder's failure), so a refused launch reaches the wrapper.
// The mbarrier and TMA helpers and the tensor-map encoder are in
// hopper.cuh, shared with selective_scan.cu.

#include <cuda_bf16.h>

#include "hopper.cuh"

constexpr float NEG_INF = -1e30f;   // the Pallas body's finite mask sentinel

namespace simt {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // keys per staged kv tile
constexpr int NT = 256;   // threads per block: 16 row groups x 16 lanes

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

}  // namespace simt

namespace tc {

constexpr int BQ = 128;                    // q rows per block
constexpr int NCONS = 2;                   // consumer warpgroups, 64 rows each
constexpr int NTHREADS = 128 * NCONS + 32;  // + one producer warp
constexpr int STAGES = 2;                  // K/V ring depth

template <int HDP>
struct Cfg {
  static constexpr int BK = HDP == 256 ? 32 : HDP == 128 ? 64 : 128;  // keys a tile
  static constexpr int NC = HDP / 64;                // 128-byte column chunks
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_TILE = BK * HDP * 2;       // one K or one V tile
  static constexpr int TILES = Q_BYTES + 2 * STAGES * KV_TILE;
  // + 1 KB to align the tiles to the swizzle atom, + the mbarriers
  static constexpr size_t bytes = TILES + 1024 + 8 * (2 * STAGES + 1);
};

using namespace hopper;   // mbarrier, TMA and tensor-map helpers

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across the async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64x32, fp32) (+)= A(64x16, smem, K-major) * B(32x16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x64, fp32) (+)= A(64x16, smem, K-major) * B(64x16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x128, fp32) (+)= A(64x16, smem, K-major) * B(128x16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x64, fp32) += A(64x16, bf16 registers) * B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D(64x128, fp32) += A(64x16, bf16 registers) * B(16x128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D(64x256, fp32) += A(64x16, bf16 registers) * B(16x256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, acc);
  else wgmma_rs_n256(d, a, db, acc);
}

// Accumulator fragment of wgmma m64nN (fp32), per thread of a warpgroup:
// element e = 4 * nb + 2 * i + j holds row 16 * warp + lane / 4 + 8 * i and
// column 8 * nb + 2 * (lane % 4) + j.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int H, int KV, int Sq, int Skv,
                int causal, int window, float scale_log2) {
  constexpr int HDP = HD < 64 ? 64 : HD;             // hd 32 runs zero-padded
  using C = Cfg<HDP>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;       // swizzle atoms: 1 KB
  const uint32_t k_s = q_s + C::Q_BYTES;             // stage s at + s * KV_TILE
  const uint32_t v_s = k_s + STAGES * C::KV_TILE;
  const uint32_t bars = q_s + C::TILES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t q_bar = bars + 8u * 2 * STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;         // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int q_lo = iq * BQ;
  // kv tiles that hold at least one key some row of this q tile may see
  const int k_end = causal ? min(Skv, q_lo + BQ) : Skv;
  const int k_start = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = k_start / BK;
  const int t1 = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCONS * 128);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // broadcast, so that ptxas sees it (and each branch on it) as uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NCONS) {
    // ---- producer: one thread keeps the K/V ring full --------------------
    if (threadIdx.x == NCONS * 128) {
      const int q_plane = b * H + h, kv_plane = b * KV + hk;
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        tma_load_3d(q_s + c * BQ * 128, &tq, q_bar, c * 64, q_lo, q_plane);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::KV_TILE);
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load_3d(k_s + s * C::KV_TILE + c * BK * 128, &tk, full(s), c * 64,
                      t * BK, kv_plane);
          tma_load_3d(v_s + s * C::KV_TILE + c * BK * 128, &tv, full(s), c * 64,
                      t * BK, kv_plane);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qa = q_lo + wg * 64;                   // this warpgroup's rows
    const int r0 = qa + warp * 16 + lane / 4;        // this thread's: r0, r0 + 8
    const int cq = 2 * (lane % 4);                   // its column in each 8
    const bool rows_live = qa < Sq;

    float acc[HDP / 2];
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % STAGES;
      const int k_lo = t * BK;
      bool live = rows_live;
      if (causal) live = live && k_lo <= qa + 63;
      if (window > 0) live = live && k_lo + BK - 1 > qa - window;
      mbar_wait(full(s), (i / STAGES) & 1);
      if (live) {
        // S = Q K^T over hd in k16 steps (a step is 32 bytes of a 128-byte
        // swizzled row; every 4 steps the next column chunk)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          const uint64_t da = desc_sw128(
              q_s + (kk / 4) * BQ * 128 + wg * 64 * 128 + col, 16, 1024);
          const uint64_t db = desc_sw128(
              k_s + s * C::KV_TILE + (kk / 4) * BK * 128 + col, 16, 1024);
          mma_ss<BK>(sc, da, db, kk > 0);
        }
        wg_commit();
        wg_wait0();
        reg_fence(sc);

        const bool need_mask = k_lo + BK > Skv || (causal && k_lo + BK - 1 > qa)
                               || (window > 0 && k_lo <= qa + 63 - window);
        // masks as bounds on the fragment column c = 8 (e / 4) + e % 2, a
        // constant after unrolling: key k_lo + cq + c is live for row qpos
        // when c < hi[r] and c > lo[r]
        int hi[2], lo[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int base = k_lo + cq, qpos = r0 + 8 * r;
          hi[r] = causal ? min(Skv, qpos + 1) - base : Skv - base;
          lo[r] = window > 0 ? qpos - window - base : -1 - BK;
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = (e >> 1) & 1, c = 8 * (e >> 2) + (e & 1);
          float x = sc[e] * scale_log2;
          if (need_mask && (c >= hi[r] || c <= lo[r])) x = NEG_INF;
          sc[e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
        float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_cur = fmaxf(m[r], mx[r]);
          corr[r] = exp2f(m[r] - m_cur);
          m[r] = m_cur;
        }
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const float p = exp2f(sc[e] - m[(e >> 1) & 1]);
          rs[(e >> 1) & 1] += p;
          sc[e] = p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[r] = l[r] * corr[r] + rs[r];
        }
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e) acc[e] *= corr[(e >> 1) & 1];

        // O += P V over the tile's keys in k16 steps: P's fragment for keys
        // 16kk..16kk+15 is score elements 8kk..8kk+7; V's 16 rows are 2 KB on
        // from the last, its column chunks BK * 128 bytes apart (LBO)
        uint32_t pb[BK / 4];
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) pb[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t a[4] = {pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3]};
          const uint64_t db = desc_sw128(v_s + s * C::KV_TILE + kk * 16 * 128,
                                         BK * 128, 1024);
          mma_rs<HDP>(acc, a, db, 1);
        }
        wg_commit();
        wg_wait0();
        reg_fence(acc);
      }
      mbar_arrive(empty(s));
    }

    if (rows_live) {
      __nv_bfloat16* op = o + (static_cast<size_t>(b) * H + h) * Sq * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = r0 + 8 * r;
        if (qpos >= Sq) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int nb = 0; nb < HDP / 8; ++nb) {
          const int col = 8 * nb + cq;
          if (col >= HD) continue;
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(
              acc[4 * nb + 2 * r] / den, acc[4 * nb + 2 * r + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(qpos) * HD
                                             + col) = v2;
        }
      }
    }
  }
}

// (hd, rows, planes) bf16, read in boxes of 64 columns x box_rows rows
cudaError_t make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int planes,
                     int box_rows) {
  const uint64_t dims[3] = {(uint64_t)hd, (uint64_t)rows, (uint64_t)planes};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return make_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dims, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Skv, int causal, int window,
                   cudaStream_t stream) {
  using C = Cfg<(HD < 64 ? 64 : HD)>;
  CUtensorMap mq, mk, mv;
  cudaError_t e = make_map(&mq, q, HD, Sq, B * H, BQ);
  if (e == cudaSuccess) e = make_map(&mk, k, HD, Skv, B * KV, C::BK);
  if (e == cudaSuccess) e = make_map(&mv, v, HD, Skv, B * KV, C::BK);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_fwd_wgmma<HD><<<grid, NTHREADS, C::bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, KV, Sq, Skv, causal, window,
      scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int causal, int window,
                        cudaStream_t s) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 64: return launch<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 128: return launch<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    case 256: return launch<256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// window <= 0 means no sliding window; is_bf16 selects bf16 (1: the wgmma
// kernel) or fp32 (0: the SIMT kernel); device is the tensors' CUDA ordinal
// (this library links its own cudart, whose current device is per thread).
// bf16 pointers must be 16-byte aligned (TMA); the wrapper checks.
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
      ? tc::dispatch_hd(hd, q, k, v, o, B, H, KV, Sq, Skv, causal, window, s)
      : simt::dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, causal, window, s);
  return (int)e;
}
