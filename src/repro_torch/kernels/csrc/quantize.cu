// Row-wise symmetric int8 quantization, for Hopper (sm_90a), and the int8
// KV-cache stores built on it.
//
// Replaces repro/kernels/quantize.py::quantize_int8_pallas (the pallas_call
// at quantize.py:45): for each row of x (T, D),
//   scale = max(amax(|x|), floor) / 127,   q = clip(round(x / scale), +-127)
// with round half to even (jnp.round), q int8 (T, D) and scale fp32 (T, 1).
// The TPU kernel's floor is 1e-12; the int8 KV cache passes 1e-8.
//
// Three entries share one kernel body and differ only in where a row comes
// from and where its codes and scale go (``locate``):
//   quantize_int8_fwd       — the TPU kernel's interface, row i to row i;
//   quantize_kv_store_fwd   — one decode step: the new K and V vectors
//                             (B, KV, hd) of every batch row written in
//                             place into ring slot (pos[b] mod W) - offset
//                             of the int8 caches (B, s_loc, KV, hd) and
//                             their fp32 scales (B, s_loc, KV, 1), where
//                             that slot lies in [0, s_loc); other rows are
//                             left as they are.  K and V in one launch.
//   quantize_kv_prefill_fwd — prefill: K and V (B, S, KV, hd) into fresh
//                             rings (B, W, KV, hd); slot j holds position
//                             p in [max(0, S - W), S) with p = j (mod W),
//                             the reference's slice and roll; for S < W
//                             slots j >= S are the reference's zero pad
//                             (code 0, scale floor / 127).
// The slot arithmetic reads pos on the device: no host sync, no branch on
// tensor values.
//
// What bounds it on this card: bytes.  It does ~5 operations per element
// against the ~295 FLOP/byte an H100 needs before compute is the limit, so
// the design moves each byte once and keeps enough of them in flight:
//  * a row of D values is read by a group of D * elem / 16 lanes with one
//    16-byte load each (16 lanes at hd 128 bf16: 2 rows a warp; 8 at hd
//    64; 32 at hd 256, or hd 128 in fp32), a power of two rounded up;
//    rows too long for that take up to 8 loads a lane, whole warp a row;
//  * each lane group issues the loads of R rows (2 when a row is one load a
//    lane) before it reduces any of them, so 32 bytes or more a thread are
//    in flight to cover the latency of device memory; loads are streaming
//    (ld.global.cs: each byte is read once);
//  * amax is a __shfl_xor_sync max inside the group (offsets below the
//    group's width); every lane of a warp reaches every shuffle, since rows
//    past the end and rows that are not written load zeros instead of
//    leaving, so the full mask is always right;
//  * 8 (bf16) or 4 (fp32) codes leave as one 8- or 4-byte store.
// A D or a pointer that is not 16-byte aligned takes the same kernel with
// one value a load (VEC = 1), the scalar path; rows longer than 8 loads a
// lane (D > 2048 bf16, > 1024 fp32 aligned) take a warp-a-row loop that
// reads the row twice, the second time from L1/L2.
//
// Tuned on an H100 (PERF.md): 128-thread blocks, 2 rows in flight
// a group and no clip beat 256 threads, 1, 3, 4 or 8 rows, and a
// grid-stride loop.
//
// Bit-identical to the plain PyTorch version: both divisions are IEEE
// (no --use_fast_math: a / b is div.rn.f32; the plain version divides by a
// device tensor, since torch multiplies by the reciprocal of a Python
// scalar), the conversion rounds half to even as torch.round and jnp.round
// do (roundf would round half away from zero), and the max is exact in any
// order.  Vector loads do not change values.
//
// Each C entry launches on the given stream and returns cudaGetLastError(),
// so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
enum Mode { kRows = 0, kDecodeStore = 1, kPrefillStore = 2 };

struct Args {
  const void* src[2];       // the rows' values: x, or the new K and V
  int8_t* q[2];             // codes: q, or the K and V caches
  float* scale[2];          // scales
  long long n;              // rows per tensor
  long long rows;           // n times the number of tensors (1 or 2)
  int D;
  float floor_;
  int mode;
  int KV;                   // stores: heads a batch row
  long long W;              // stores: the ring's period
  // decode store
  const long long* pos;     // (B,) next absolute position
  long long offset;         // first ring slot this cache holds
  int s_loc;                // slots this cache holds
  // prefill store
  int S;                    // prompt length
  int shift;                // (S - W) mod W: the ring's roll when S >= W
};

template <typename T>
struct Row {
  const T* x;     // null: a row of zeros
  int8_t* q;      // null: nothing is written
  float* s;
};

__device__ __forceinline__ long long pmod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;       // torch.remainder / jnp.mod for m > 0
}

template <typename T>
__device__ __forceinline__ Row<T> locate(const Args& a, long long r) {
  if (r >= a.rows) return {nullptr, nullptr, nullptr};
  // K (0) or V (1), chosen without indexing the arrays by a variable: that
  // would copy the whole kernel parameter block into local memory
  const bool t = r >= a.n;
  const long long i = t ? r - a.n : r;        // row within its tensor
  const T* x = static_cast<const T*>(t ? a.src[1] : a.src[0]);
  int8_t* q = t ? a.q[1] : a.q[0];
  float* sc = t ? a.scale[1] : a.scale[0];
  const long long D = a.D;
  if (a.mode == kRows) return {x + i * D, q + i * D, sc + i};
  // The stores' row counts stay below 2^31 (the C entries check), so their
  // index arithmetic divides in 32 bits: a 64-bit division has no
  // instruction and costs several times as many, per row and lane.
  const unsigned ii = (unsigned)i, KV = (unsigned)a.KV;
  if (a.mode == kDecodeStore) {
    // i = b * KV + h over the new vectors (B, KV, D)
    const unsigned b = ii / KV, h = ii - b * KV;
    const long long slot = pmod(a.pos[b], a.W) - a.offset;
    if (slot < 0 || slot >= a.s_loc) return {nullptr, nullptr, nullptr};
    const long long o = ((long long)b * a.s_loc + slot) * a.KV + h;
    return {x + i * D, q + o * D, sc + o};
  }
  // prefill: i = (b * W + j) * KV + h over the ring (B, W, KV, D); slot j
  // holds p = S - W + ((j - shift) mod W) when S >= W, else p = j (j < S)
  // or the zero pad
  const unsigned W = (unsigned)a.W, bj = ii / KV, h = ii - bj * KV;
  const unsigned b = bj / W, j = bj - b * W;
  long long p;
  if (a.S >= a.W) {
    p = (long long)(a.S - a.W) + (j >= (unsigned)a.shift ? j - a.shift
                                                          : j + W - a.shift);
  } else {
    p = j < (unsigned)a.S ? (long long)j : -1;
  }
  const T* src =
      p >= 0 ? x + (((long long)b * a.S + p) * a.KV + h) * D : nullptr;
  return {src, q + i * D, sc + i};
}

// VEC values of T as one load (16 bytes, or one value on the scalar path)
template <typename T, int VEC> struct Load;
template <> struct Load<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ float get(const Raw& u, int e) {
    const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Load<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ float get(const Raw& u, int e) {
    return __uint_as_float(e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w);
  }
};
template <> struct Load<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ float get(const Raw& v, int) {
    return __bfloat162float(v);
  }
};
template <> struct Load<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ float get(const Raw& v, int) { return v; }
};

template <typename T, int VEC>
__device__ __forceinline__ typename Load<T, VEC>::Raw load(const T* row, int c) {
  using Raw = typename Load<T, VEC>::Raw;
  if (row == nullptr) return Raw{};
  return __ldcs(reinterpret_cast<const Raw*>(row) + c);   // read once: stream
}

// clip(rint(x / s), -127, 127) as one conversion: cvt.rni rounds half to
// even as rintf does, and the clip never acts on finite x while s is a
// normal float, which the launchers ensure by refusing floor < 127 * 2^-126
// (quantize.py's FLOOR_MIN).  |x| <= m for the row's m = max(amax, floor),
// and s = m / 127 rounded to a normal float, so |x / s| <= 127 (1 + 2^-23)
// before the quotient is rounded: at most 127 + 2^-17, which rounds to 127.
// (A subnormal s loses that relative precision: x / s could pass 127.5, and
// the int8 cast would wrap.)  Dropping the clip's two instructions per value
// is measurable.
__device__ __forceinline__ uint32_t code(float x, float s) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(x / s);
}

// the VEC codes of one load, as one store of VEC bytes
template <typename T, int VEC>
__device__ __forceinline__ void store_codes(int8_t* qrow, int c,
                                            const typename Load<T, VEC>::Raw& u,
                                            float s) {
  using L = Load<T, VEC>;
  if constexpr (VEC == 8) {
    uint2 w;
    w.x = code(L::get(u, 0), s) | code(L::get(u, 1), s) << 8 |
          code(L::get(u, 2), s) << 16 | code(L::get(u, 3), s) << 24;
    w.y = code(L::get(u, 4), s) | code(L::get(u, 5), s) << 8 |
          code(L::get(u, 6), s) << 16 | code(L::get(u, 7), s) << 24;
    reinterpret_cast<uint2*>(qrow)[c] = w;
  } else if constexpr (VEC == 4) {
    reinterpret_cast<uint32_t*>(qrow)[c] =
        code(L::get(u, 0), s) | code(L::get(u, 1), s) << 8 |
        code(L::get(u, 2), s) << 16 | code(L::get(u, 3), s) << 24;
  } else {
    qrow[c] = (int8_t)code(L::get(u, 0), s);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ float amax_of(const typename Load<T, VEC>::Raw& u) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(Load<T, VEC>::get(u, e)));
  return m;
}

// Lane groups of 2^lg lanes; each group owns R rows, R * blockDim/2^lg rows
// a block, and reads a row as nvec = D / VEC loads, VPL a lane.
template <typename T, int VEC, int VPL, int R>
__global__ void __launch_bounds__(kThreads)
quantize_int8_rows(const Args a, int lg) {
  using Raw = typename Load<T, VEC>::Raw;
  const int gw = 1 << lg;
  const int gl = threadIdx.x & (gw - 1);      // lane within the group
  const int groups = kThreads >> lg;
  const long long first = (long long)blockIdx.x * groups * R + (threadIdx.x >> lg);
  const int nvec = a.D / VEC;

  Row<T> row[R];
  Raw raw[R][VPL];
#pragma unroll
  for (int k = 0; k < R; ++k) {               // every load before any reduction
    row[k] = locate<T>(a, first + (long long)k * groups);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = gl + v * gw;
      raw[k][v] = c < nvec ? load<T, VEC>(row[k].x, c) : Raw{};
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float amax = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) amax = fmaxf(amax, amax_of<T, VEC>(raw[k][v]));
    for (int o = gw >> 1; o > 0; o >>= 1)     // inside the group only
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (row[k].q != nullptr) {
      const float s = fmaxf(amax, a.floor_) / 127.0f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int c = gl + v * gw;
        if (c < nvec) store_codes<T, VEC>(row[k].q, c, raw[k][v], s);
      }
      if (gl == 0) *row[k].s = s;
    }
  }
}

// Rows longer than 8 loads a lane: one warp a row, read twice.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) quantize_int8_long(const Args a) {
  const int lane = threadIdx.x & 31;
  const Row<T> row = locate<T>(
      a, (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5));
  const int nvec = a.D / VEC;
  float amax = 0.f;
  for (int c = lane; c < nvec; c += 32)
    amax = fmaxf(amax, amax_of<T, VEC>(load<T, VEC>(row.x, c)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (row.q == nullptr) return;
  const float s = fmaxf(amax, a.floor_) / 127.0f;
  for (int c = lane; c < nvec; c += 32)
    store_codes<T, VEC>(row.q, c, load<T, VEC>(row.x, c), s);
  if (lane == 0) *row.s = s;
}

template <typename T, int VEC, int VPL, int R>
cudaError_t launch_rows(const Args& a, int lg, cudaStream_t stream) {
  const long long per_block = (long long)(kThreads >> lg) * R;
  const long long blocks = (a.rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quantize_int8_rows<T, VEC, VPL, R><<<(unsigned)blocks, kThreads, 0, stream>>>(a, lg);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const int nvec = a.D / VEC;
  if (nvec <= 32) {                  // one load a lane; groups of 2^lg lanes
    int lg = 0;
    while ((1 << lg) < nvec) ++lg;
    return launch_rows<T, VEC, 1, 2>(a, lg, stream);
  }
  if (nvec <= 64) return launch_rows<T, VEC, 2, 1>(a, 5, stream);
  if (nvec <= 128) return launch_rows<T, VEC, 4, 1>(a, 5, stream);
  if (nvec <= 256) return launch_rows<T, VEC, 8, 1>(a, 5, stream);
  const long long blocks = (a.rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quantize_int8_long<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// aligned: every row starts on 16 bytes in the source and in the codes and
// D * elem is a multiple of 16 (the launcher checks); else one value a load
int run(Args& a, int x_bf16, int aligned, int device, void* stream) {
  if (a.rows <= 0) return 0;
  if (a.D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    e = aligned ? dispatch<__nv_bfloat16, 8>(a, s) : dispatch<__nv_bfloat16, 1>(a, s);
  else
    e = aligned ? dispatch<float, 4>(a, s) : dispatch<float, 1>(a, s);
  return (int)e;
}

}  // namespace

// x: (rows, D) contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// q: (rows, D) int8; scale: (rows,) fp32; device: the tensors' CUDA ordinal.
extern "C" int quantize_int8_fwd(const void* x, void* q, void* scale, long long rows,
                                 int D, float floor_, int x_bf16, int aligned,
                                 int device, void* stream) {
  Args a{};
  a.src[0] = x;
  a.q[0] = static_cast<int8_t*>(q);
  a.scale[0] = static_cast<float*>(scale);
  a.n = a.rows = rows;
  a.D = D;
  a.floor_ = floor_;
  a.mode = kRows;
  return run(a, x_bf16, aligned, device, stream);
}

// new_k, new_v: (B, KV, D) contiguous; k, v: (B, s_loc, KV, D) int8 and
// k_scale, v_scale: (B, s_loc, KV) fp32, contiguous, written in place;
// pos: (B,) int64 on the device.
extern "C" int quantize_kv_store_fwd(const void* new_k, const void* new_v, void* k,
                                     void* v, void* k_scale, void* v_scale,
                                     const void* pos, int B, int KV, int D,
                                     long long W, long long offset, int s_loc,
                                     float floor_, int x_bf16, int aligned,
                                     int device, void* stream) {
  if (W <= 0 || s_loc <= 0 || KV <= 0 || (long long)B * KV >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src[0] = new_k;
  a.src[1] = new_v;
  a.q[0] = static_cast<int8_t*>(k);
  a.q[1] = static_cast<int8_t*>(v);
  a.scale[0] = static_cast<float*>(k_scale);
  a.scale[1] = static_cast<float*>(v_scale);
  a.n = (long long)B * KV;
  a.rows = 2 * a.n;
  a.D = D;
  a.floor_ = floor_;
  a.mode = kDecodeStore;
  a.KV = KV;
  a.W = W;
  a.pos = static_cast<const long long*>(pos);
  a.offset = offset;
  a.s_loc = s_loc;
  return run(a, x_bf16, aligned, device, stream);
}

// k_in, v_in: (B, S, KV, D) contiguous; k, v: (B, W, KV, D) int8 and
// k_scale, v_scale: (B, W, KV) fp32, every slot written.
extern "C" int quantize_kv_prefill_fwd(const void* k_in, const void* v_in, void* k,
                                       void* v, void* k_scale, void* v_scale, int B,
                                       int S, int KV, int D, int W, float floor_,
                                       int x_bf16, int aligned, int device,
                                       void* stream) {
  if (W <= 0 || S <= 0 || KV <= 0 || (long long)B * W * KV >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src[0] = k_in;
  a.src[1] = v_in;
  a.q[0] = static_cast<int8_t*>(k);
  a.q[1] = static_cast<int8_t*>(v);
  a.scale[0] = static_cast<float*>(k_scale);
  a.scale[1] = static_cast<float*>(v_scale);
  a.n = (long long)B * W * KV;
  a.rows = 2 * a.n;
  a.D = D;
  a.floor_ = floor_;
  a.mode = kPrefillStore;
  a.KV = KV;
  a.W = W;
  a.S = S;
  a.shift = S >= W ? (S - W) % W : 0;
  return run(a, x_bf16, aligned, device, stream);
}
