// bf16 wire casts for the hierarchical allreduce's slow stage, for Hopper.
//
// Replaces the Pallas TPU kernel _cast_kernel of src/repro/kernels/quantize.py,
// launched by _cast_1d (pallas_call at quantize.py:90) for compress_bf16 and
// decompress_bf16.
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

extern "C" const char* q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
