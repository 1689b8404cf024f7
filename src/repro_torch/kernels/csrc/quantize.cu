// Quantization kernels for Hopper: the bf16 wire casts of the hierarchical
// allreduce's slow stage, and the int8 rows of the serving K/V cache.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   _cast_kernel (pallas_call at quantize.py:90), as compress_bf16 and
//     decompress_bf16;
//   _quant_kernel (quantize.py:32, pallas_call at :63), as quantize_int8 and
//     the fused K/V write quantize_int8_into;
//   _dequant_kernel (quantize.py:41, pallas_call at :130), as dequantize_int8.
//
// compress: f32 -> bf16, round to nearest even (__float2bfloat16_rn), the
// conversion PyTorch's .to(torch.bfloat16) performs on this card, so the two
// are bit-identical for every input: +-inf, NaN, subnormals and ties.
// decompress: bf16 -> f32, exact (the 16 bits move to the top of the word).
//
// Bound: memory. A cast of n elements moves n * (4 + 2) bytes and does one
// conversion per element. Both directions are streams over a full grid (no
// grid-stride loop) with evict-first cache hints (ld/st.global.cs), since
// no byte is read twice. compress: each thread one 16-byte f32 load and one
// 8-byte bf16 store; decompress: each thread two 8-byte bf16 loads a
// block-width apart (a warp's accesses stay contiguous), both issued before
// its two 16-byte f32 stores. The n % 4 tail, or every element when a
// pointer is misaligned, goes one per thread in the same launch. On an H100
// these won over a grid-stride loop capped at 16 blocks per SM (the first
// design), over two or four loads per thread for compress and four for
// decompress, over 32 contiguous bytes per thread, and over plain,
// non-allocating or prefetching loads (tools/torch_cast_variants.py times
// the candidates in turns; PERF.md has the readings).
//
// quantize_int8: each row of `width` (<= 256) f32 or bf16 values becomes
// int8 codes and one f32 scale:
//   absmax = max |x| in f32, NaN-propagating (as torch.amax and jnp.max);
//   scale  = max(absmax, 1e-8) * f32(1/127);
//   q      = clamp(rint(x / scale), -127, 127)   (half to even, IEEE divide).
// The scale is a product with the f32 reciprocal of 127, not a division by
// 127: XLA folds the reference's `/ 127.0` into that product when it
// compiles the decode step and the Pallas kernel, and this is the value the
// reference's int8 K/V cache holds. Bound: memory in principle (width * 3
// bytes per bf16 row), but the decode path hands it one token's K and V
// rows, 2 x (batch * kv_heads) = 2 x 576 rows of head_dim 64 at full width,
// so launches and the host set its pace. Design: one warp per row over a
// full grid, each lane holding up to eight values in registers, a shuffle
// reduction for the absmax; no shared memory. The fused entry takes K and
// V together (one launch per decode layer) and writes each row's codes and
// scale straight into the ring at (b, slot + t, g), every address from the
// strides it is given, so neither a contiguity copy nor a slice assignment
// follows; quantize_int8 is the same kernel over (R, W) rows into fresh
// buffers.
//
// dequantize_int8: out = (float)q * scale[row], rounded once to bf16
// (__float2bfloat16_rn) or kept f32. Bound: memory, the byte-heavy kernel of
// the decode path (the whole int8 ring every step). Design: when the row
// width is a multiple of 16 and the codes are 16-byte aligned, each thread
// of a full grid takes one 16-code chunk (one row, one scale) with a 16-byte
// load and 32- or 64-byte stores; else one code per thread per iteration of
// a grid-stride loop. (A grid-stride loop over the chunks, capped at 16
// blocks per SM, read 0.41 ms for the 302 MB ring of MiniCPM-2B's decode
// cell in chip_smoke.py on an H100 at 700 W, against 0.32 ms for the full
// grid; the bound is 0.28 ms.) Nothing is compiled with fast math, and neither kernel has an add
// that could contract into a fused multiply-add, so each matches the plain
// PyTorch version bit for bit.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::aligned;
using repro_torch::grid_for;
using repro_torch::kThreads;

__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float from_bf16(uint16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// Streaming (evict-first) loads and stores: every byte of a cast passes
// once, so none should displace what L2 holds for others.
__device__ __forceinline__ void load_stream(const float4* p, float4& v) {
  asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
}

__device__ __forceinline__ void load_stream(const uint2* p, uint2& v) {
  asm volatile("ld.global.cs.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
}

__device__ __forceinline__ void store_stream(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x),
               "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void store_stream(float4* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Four values, the first in the low half of the first word.
__device__ __forceinline__ uint2 convert4(float4 v) {
  const unsigned lo = to_bf16(v.x), hi = to_bf16(v.z);
  return make_uint2(lo | (static_cast<unsigned>(to_bf16(v.y)) << 16),
                    hi | (static_cast<unsigned>(to_bf16(v.w)) << 16));
}

__device__ __forceinline__ float4 convert4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint16_t convert1(float x) { return to_bf16(x); }
__device__ __forceinline__ float convert1(uint16_t h) { return from_bf16(h); }

// Vectors of four values: f32 as float4, bf16 as uint2.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint16_t> { using type = uint2; };

constexpr int kCompressLoads = 1;     // vectors in flight per thread
constexpr int kDecompressLoads = 2;

// Block i converts vectors [i * kThreads * LOADS, (i + 1) * ...) of the
// first nvec (thread t: t, t + kThreads, ...); then thread k of the grid
// converts element 4 * nvec + k, if there is one.
template <typename In, typename Out, int LOADS>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const In* __restrict__ x, Out* __restrict__ y, int64_t n,
                int64_t nvec) {
  using VIn = typename Vec4<In>::type;
  using VOut = typename Vec4<Out>::type;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads * LOADS + threadIdx.x;
  VIn v[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    if (first + j * kThreads < nvec)
      load_stream(reinterpret_cast<const VIn*>(x) + first + j * kThreads,
                  v[j]);
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    if (first + j * kThreads < nvec)
      store_stream(reinterpret_cast<VOut*>(y) + first + j * kThreads,
                   convert4(v[j]));
  const int64_t t = nvec * 4 + static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (t < n) y[t] = convert1(x[t]);
}

// One launch of cast_kernel over n elements; vectors only when both
// pointers are aligned for them.
template <typename In, typename Out, int LOADS>
int launch_cast(const void* x, void* y, int64_t n, cudaStream_t st) {
  if (n <= 0) return 0;
  const int64_t nvec =
      (aligned(x, 4 * sizeof(In)) && aligned(y, 4 * sizeof(Out))) ? n / 4
                                                                  : 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * LOADS;
  const int64_t vec_blocks = (nvec + per_block - 1) / per_block;
  const int64_t tail_blocks = (n - nvec * 4 + kThreads - 1) / kThreads;
  const int64_t blocks = vec_blocks > tail_blocks ? vec_blocks : tail_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cast_kernel<In, Out, LOADS><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const In*>(x), static_cast<Out*>(y), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

// ---- int8 K/V rows ---------------------------------------------------------

constexpr int kWarp = 32;
constexpr int kMaxWidth = 256;
constexpr int kPerLane = kMaxWidth / kWarp;
// f32(1/127), bits 0x3c010204: the constant XLA folds `/ 127.0` into.
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const uint16_t* p, int64_t i) {
  return from_bf16(p[i]);
}

// max that returns NaN if either operand is NaN (fmaxf drops NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Where the rows of the fused write live, in elements: source row
// (b, t, g) starts at b * sb + t * st + g * sg, its codes at
// b * qb + (slot + t) * qs + g * qg and its scale at
// b * cb + (slot + t) * cs + g * cg; a row's values are contiguous.
struct RowGeometry {
  int64_t rows;               // B * T * KV rows per source
  int64_t T, KV, slot;
  int64_t sb, st, sg, qb, qs, qg, cb, cs, cg;
  int width;
};

// Warp r < rows quantizes source 0's row r, warp rows + r source 1's (when
// there is one). The grid holds a warp for every row, so r is the same on
// every lane of a warp and the shuffles below see all 32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_write_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                       int8_t* __restrict__ q0, int8_t* __restrict__ q1,
                       float* __restrict__ s0, float* __restrict__ s1,
                       RowGeometry g) {
  const int lane = threadIdx.x % kWarp;
  int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / kWarp) +
              threadIdx.x / kWarp;
  const bool second = r >= g.rows;
  if (second) {
    r -= g.rows;
    if (x1 == nullptr || r >= g.rows) return;
  }
  const int64_t gi = r % g.KV, ti = (r / g.KV) % g.T, bi = r / (g.KV * g.T);
  const int64_t pos = g.slot + ti;
  const T* x = (second ? x1 : x0) + bi * g.sb + ti * g.st + gi * g.sg;
  int8_t* q = (second ? q1 : q0) + bi * g.qb + pos * g.qs + gi * g.qg;
  float* scale = (second ? s1 : s0) + bi * g.cb + pos * g.cs + gi * g.cg;
  float v[kPerLane];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + j * kWarp;
    v[j] = c < g.width ? load_f32(x, c) : 0.0f;
    m = nan_max(m, fabsf(v[j]));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = (m != m ? m : fmaxf(m, 1e-8f)) * kInv127;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + j * kWarp;
    if (c < g.width) {
      float t = rintf(v[j] / s);
      // clamp as torch.clamp does: a NaN stays NaN
      t = t < -127.0f ? -127.0f : (t > 127.0f ? 127.0f : t);
      q[c] = static_cast<int8_t>(t);
    }
  }
  if (lane == 0) *scale = s;
}

int launch_quant(int dtype, const void* x0, const void* x1, void* q0,
                 void* q1, void* s0, void* s1, const RowGeometry& g,
                 cudaStream_t st) {
  if (g.width < 1 || g.width > kMaxWidth || dtype < 0 || dtype > 1 ||
      g.T < 1 || g.KV < 1 || g.rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.rows == 0) return 0;
  const int64_t warps = g.rows * (x1 == nullptr ? 1 : 2);
  const int64_t blocks = (warps + kThreads / kWarp - 1) / (kThreads / kWarp);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* c0 = static_cast<int8_t*>(q0);
  int8_t* c1 = static_cast<int8_t*>(q1);
  float* f0 = static_cast<float*>(s0);
  float* f1 = static_cast<float*>(s1);
  if (dtype == 0)
    quant_write_kernel<float><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(x0), static_cast<const float*>(x1), c0, c1,
        f0, f1, g);
  else
    quant_write_kernel<uint16_t><<<static_cast<int>(blocks), kThreads, 0,
                                   st>>>(
        static_cast<const uint16_t*>(x0), static_cast<const uint16_t*>(x1),
        c0, c1, f0, f1, g);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void store16(float* out, int64_t k,
                                        const float (&f)[16]) {
  float4* o = reinterpret_cast<float4*>(out) + 4 * k;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
}

__device__ __forceinline__ void store16(uint16_t* out, int64_t k,
                                        const float (&f)[16]) {
  uint4* o = reinterpret_cast<uint4*>(out) + 2 * k;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = static_cast<uint32_t>(to_bf16(f[8 * i + 2 * j])) |
             (static_cast<uint32_t>(to_bf16(f[8 * i + 2 * j + 1])) << 16);
    o[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void store1(float* out, int64_t i, float f) {
  out[i] = f;
}

__device__ __forceinline__ void store1(uint16_t* out, int64_t i, float f) {
  out[i] = to_bf16(f);
}

// One 16-code chunk per thread over a full grid: the chunk lies in one row
// (width % 16 == 0), so it reads one scale.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_chunks_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ scale,
                          OutT* __restrict__ out, int64_t nvec, int width) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= nvec) return;
  const int4 raw = reinterpret_cast<const int4*>(q)[k];
  const float s = scale[(k * 16) / width];
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(words[i / 4] >>
                                                  (8 * (i % 4)))) * s;
  store16(out, k, f);
}

// Any width or alignment: one code per thread per iteration.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_codes_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         OutT* __restrict__ out, int64_t n, int width) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    store1(out, i, static_cast<float>(q[i]) * scale[i / width]);
}

template <typename OutT>
int launch_dequant(const void* q, const void* scale, void* out, int64_t n,
                   int width, cudaStream_t st) {
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  OutT* o = static_cast<OutT*>(out);
  if (width % 16 == 0 && aligned(q, 16) && aligned(out, 16)) {
    const int64_t nvec = n / 16;
    const int64_t blocks = (nvec + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    dequant_chunks_kernel<OutT><<<static_cast<int>(blocks), kThreads, 0,
                                  st>>>(qc, sc, o, nvec, width);
  } else {
    dequant_codes_kernel<OutT><<<grid_for(n), kThreads, 0, st>>>(qc, sc, o,
                                                                  n, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int q_compress_bf16(const void* x, void* y, long long n,
                               void* stream) {
  return launch_cast<float, uint16_t, kCompressLoads>(
      x, y, n, static_cast<cudaStream_t>(stream));
}

extern "C" int q_decompress_bf16(const void* x, void* y, long long n,
                                 void* stream) {
  return launch_cast<uint16_t, float, kDecompressLoads>(
      x, y, n, static_cast<cudaStream_t>(stream));
}

// dtype codes: 0 = f32, 1 = bf16. (rows, width) contiguous rows into
// fresh (rows, width) codes and (rows, 1) scales.
extern "C" int q_quantize_int8(int dtype, const void* x, void* q, void* scale,
                               long long rows, int width, void* stream) {
  RowGeometry g{};
  g.rows = rows;
  g.T = g.KV = 1;
  g.sb = g.qb = width;
  g.cb = 1;
  g.width = width;
  return launch_quant(dtype, x, nullptr, q, nullptr, scale, nullptr, g,
                      static_cast<cudaStream_t>(stream));
}

// The fused K/V write: xk, xv (B, T, KV, width) into the rings qk, qv
// (B, S, KV, width) and scales sk, sv (B, S, KV, 1) at slot..slot + T - 1.
// geo: B, T, KV, width, slot, then the strides (in elements, for b, t or s,
// g) of the sources, of the rings and of the scales; the two sources share
// theirs, as do the two rings and the two scale arrays.
extern "C" int q_quantize_int8_into(int dtype, const void* xk,
                                    const void* xv, void* qk, void* qv,
                                    void* sk, void* sv, const long long* geo,
                                    void* stream) {
  if (geo[0] < 0 || geo[3] > kMaxWidth || geo[4] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RowGeometry g{};
  g.T = geo[1];
  g.KV = geo[2];
  g.rows = geo[0] * g.T * g.KV;
  g.width = static_cast<int>(geo[3]);
  g.slot = geo[4];
  g.sb = geo[5], g.st = geo[6], g.sg = geo[7];
  g.qb = geo[8], g.qs = geo[9], g.qg = geo[10];
  g.cb = geo[11], g.cs = geo[12], g.cg = geo[13];
  return launch_quant(dtype, xk, xv, qk, qv, sk, sv, g,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int q_dequantize_int8(int dtype, const void* q, const void* scale,
                                 void* out, long long rows, int width,
                                 void* stream) {
  if (width < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_dequant<float>(q, scale, out, rows * width,
                                            width, st)
                    : launch_dequant<uint16_t>(q, scale, out, rows * width,
                                               width, st);
}

extern "C" const char* q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
