// Candidate designs of the port's combine2 (f32 add, the slab the collective
// hands it), for tools/torch_combine_variants.py to time in turns on the
// card. Each adds in f32 with one rounding, so each is bit-identical to
// torch.add. Entry a_<name>(a, b, out, n, stream):
//   stride    the port's design: a grid-stride loop capped at 16 blocks per
//             SM, one float4 of each operand per iteration, plain loads;
//   grid1     a full grid, one float4 of each operand per thread, plain;
//   grid1cs   grid1 with streaming (evict-first) loads and stores;
//   grid2cs   a full grid, two float4 of each operand a block-width apart
//             loaded before either store, streaming.
// Each handles the n % 4 tail in the same launch. Pointers must be 16-byte
// aligned (the harness allocates them so).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;

template <bool CS>
__device__ __forceinline__ float4 ld(const float4* p) {
  float4 v;
  if constexpr (CS)
    asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  else
    v = *p;
  return v;
}

template <bool CS>
__device__ __forceinline__ void st(float4* p, float4 v) {
  if constexpr (CS)
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
  else
    *p = v;
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

__device__ __forceinline__ void tail(const float* a, const float* b,
                                     float* out, int64_t n, int64_t k0) {
  const int64_t k = k0 + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k < n) out[k] = a[k] + b[k];
}

__global__ void __launch_bounds__(kT) stride_k(const float* a, const float* b,
                                               float* out, int64_t n) {
  const int64_t nv = n / 4;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  for (int64_t k = t; k < nv; k += step)
    reinterpret_cast<float4*>(out)[k] =
        add4(reinterpret_cast<const float4*>(a)[k],
             reinterpret_cast<const float4*>(b)[k]);
  for (int64_t k = nv * 4 + t; k < n; k += step) out[k] = a[k] + b[k];
}

template <bool CS, int U>
__global__ void __launch_bounds__(kT) grid_k(const float* a, const float* b,
                                             float* out, int64_t n) {
  const int64_t nv = n / 4;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kT * U +
                        threadIdx.x;
  float4 x[U], y[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int64_t k = first + j * kT;
    if (k < nv) {
      x[j] = ld<CS>(reinterpret_cast<const float4*>(a) + k);
      y[j] = ld<CS>(reinterpret_cast<const float4*>(b) + k);
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int64_t k = first + j * kT;
    if (k < nv) st<CS>(reinterpret_cast<float4*>(out) + k, add4(x[j], y[j]));
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) tail(a, b, out, n, nv * 4);
}

int grid_for_stride(int64_t items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (items + kT - 1) / kT;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <bool CS, int U>
int run_grid(const void* a, const void* b, void* out, long long n,
             void* stream) {
  const int64_t nv = n / 4;
  const int64_t blocks = (nv + kT * U - 1) / (kT * U);
  grid_k<CS, U><<<blocks < 1 ? 1 : blocks, kT, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int a_stride(const void* a, const void* b, void* out, long long n,
                        void* stream) {
  stride_k<<<grid_for_stride(n / 4 + (n & 3)), kT, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int a_grid1(const void* a, const void* b, void* out, long long n,
                       void* stream) {
  return run_grid<false, 1>(a, b, out, n, stream);
}

extern "C" int a_grid1cs(const void* a, const void* b, void* out, long long n,
                         void* stream) {
  return run_grid<true, 1>(a, b, out, n, stream);
}

extern "C" int a_grid2cs(const void* a, const void* b, void* out, long long n,
                         void* stream) {
  return run_grid<true, 2>(a, b, out, n, stream);
}
