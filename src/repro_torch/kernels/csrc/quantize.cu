// Quantization kernels for Hopper: the bf16 wire casts of the hierarchical
// allreduce's slow stage, and the int8 rows of the serving K/V cache.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   _cast_kernel (pallas_call at quantize.py:90), as compress_bf16 and
//     decompress_bf16;
//   _quant_kernel (quantize.py:32, pallas_call at :63), as quantize_int8;
//   _dequant_kernel (quantize.py:41, pallas_call at :130), as dequantize_int8.
//
// compress: f32 -> bf16, round to nearest even (__float2bfloat16_rn), the
// conversion PyTorch's .to(torch.bfloat16) performs on this card, so the two
// are bit-identical for every input: +-inf, NaN, subnormals and ties.
// decompress: bf16 -> f32, exact (the 16 bits move to the top of the word).
//
// Bound: memory. A cast of n elements moves n * (4 + 2) bytes and does one
// conversion per element. Design: one grid-stride loop, four elements per
// thread per iteration with a 16-byte access on the f32 side and an 8-byte
// access on the bf16 side when both pointers are aligned, and a scalar tail.
// (Eight elements per thread, with 32-byte strides between neighbouring
// threads' f32 accesses, measured slower on the H100.)
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
// bytes per bf16 row), but the decode path hands it one token's rows,
// (batch * kv_heads, head_dim) = 576 x 64 at full width, so launch latency
// rules. Design: one warp per row, each lane holding up to eight values in
// registers, a shuffle reduction for the absmax; no shared memory.
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

__global__ void __launch_bounds__(kThreads)
    f32_to_bf16_kernel(const float* __restrict__ x, uint16_t* __restrict__ y,
                       int64_t n, int64_t nvec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t k = tid; k < nvec; k += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[k];
    ushort4 o;
    o.x = to_bf16(v.x);
    o.y = to_bf16(v.y);
    o.z = to_bf16(v.z);
    o.w = to_bf16(v.w);
    reinterpret_cast<ushort4*>(y)[k] = o;
  }
  for (int64_t k = nvec * 4 + tid; k < n; k += stride) y[k] = to_bf16(x[k]);
}

__global__ void __launch_bounds__(kThreads)
    bf16_to_f32_kernel(const uint16_t* __restrict__ x, float* __restrict__ y,
                       int64_t n, int64_t nvec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t k = tid; k < nvec; k += stride) {
    const ushort4 v = reinterpret_cast<const ushort4*>(x)[k];
    reinterpret_cast<float4*>(y)[k] =
        make_float4(from_bf16(v.x), from_bf16(v.y), from_bf16(v.z),
                    from_bf16(v.w));
  }
  for (int64_t k = nvec * 4 + tid; k < n; k += stride) y[k] = from_bf16(x[k]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scale, int64_t rows, int width) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / kWarp);
  // r is the same on every lane of a warp, so the shuffles below see all 32
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / kWarp) +
                   threadIdx.x / kWarp;
       r < rows; r += warps) {
    const int64_t base = r * width;
    float v[kPerLane];
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + j * kWarp;
      v[j] = c < width ? load_f32(x, base + c) : 0.0f;
      m = nan_max(m, fabsf(v[j]));
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = (m != m ? m : fmaxf(m, 1e-8f)) * kInv127;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + j * kWarp;
      if (c < width) {
        float t = rintf(v[j] / s);
        // clamp as torch.clamp does: a NaN stays NaN
        t = t < -127.0f ? -127.0f : (t > 127.0f ? 127.0f : t);
        q[base + c] = static_cast<int8_t>(t);
      }
    }
    if (lane == 0) scale[r] = s;
  }
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
  if (n <= 0) return 0;
  const int64_t nvec = (aligned(x, 16) && aligned(y, 8)) ? n / 4 : 0;
  f32_to_bf16_kernel<<<grid_for(nvec + n - nvec * 4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(y), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int q_decompress_bf16(const void* x, void* y, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int64_t nvec = (aligned(x, 8) && aligned(y, 16)) ? n / 4 : 0;
  bf16_to_f32_kernel<<<grid_for(nvec + n - nvec * 4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(y), n, nvec);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = f32, 1 = bf16.
extern "C" int q_quantize_int8(int dtype, const void* x, void* q, void* scale,
                               long long rows, int width, void* stream) {
  if (width < 1 || width > kMaxWidth || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const int grid = grid_for(rows * kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quant_rows_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, width);
  else
    quant_rows_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, width);
  return static_cast<int>(cudaGetLastError());
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
