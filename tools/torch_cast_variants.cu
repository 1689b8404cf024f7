// Candidate designs of the port's bf16 wire casts, for
// tools/torch_cast_variants.py to time in turns on the card. Every variant
// converts with __float2bfloat16_rn (compress) or moves the 16 bits to the
// top of the word (decompress), so each is bit-identical to PyTorch's cast.
//
// Compress (f32 -> bf16), each entry c_<name>(x, y, n, stream):
//   stride1   the first design: a grid-stride loop capped at 16 blocks
//             per SM, one float4 load and one 8-byte store per iteration;
//   grid1     a full grid, one float4 per thread, plain loads and stores;
//   grid1cs   grid1 with streaming (evict-first) loads and stores;
//   grid2     a full grid, two float4 loads a block-width apart issued
//             before either store, plain;
//   grid2cs   grid2, streaming;
//   grid2nc   grid2 with ld.global.nc.L1::no_allocate loads and streaming
//             stores;
//   grid2pf   grid2cs with a 256-byte L2 prefetch hint on the loads;
//   grid4cs   four float4 loads a block-width apart, streaming;
//   wide16    a full grid, each thread 8 contiguous floats (two adjacent
//             float4 loads) and one 16-byte store, streaming.
// Decompress (bf16 -> f32), d_<name>:
//   stride1   the first design (8-byte load, 16-byte store, grid-stride);
//   grid2cs   a full grid, two 8-byte loads a block-width apart, streaming;
//   grid4cs   four, streaming;
//   wide16    a full grid, one 16-byte load of 8 values and two 16-byte
//             stores, streaming.
// Each handles the n % 4 (wide16: n % 8) tail in the same launch. Pointers
// must be 16-byte aligned (the harness allocates them so).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;

__device__ __forceinline__ uint16_t bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fb(uint16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ uint2 pack4(float4 v) {
  return make_uint2(bf(v.x) | (static_cast<unsigned>(bf(v.y)) << 16),
                    bf(v.z) | (static_cast<unsigned>(bf(v.w)) << 16));
}

__device__ __forceinline__ float4 unpack4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

enum Ld { kPlain, kCs, kNc, kCsPf };

template <int L>
__device__ __forceinline__ float4 ld16(const float4* p) {
  float4 v;
  if constexpr (L == kPlain) {
    v = *p;
  } else if constexpr (L == kCs) {
    asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  } else if constexpr (L == kNc) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.cs.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  }
  return v;
}

template <bool CS>
__device__ __forceinline__ uint2 ld8(const uint2* p) {
  uint2 v;
  if constexpr (CS)
    asm volatile("ld.global.cs.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
  else
    v = *p;
  return v;
}

template <bool CS>
__device__ __forceinline__ void st8(uint2* p, uint2 v) {
  if constexpr (CS)
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
                 :: "l"(p), "r"(v.x), "r"(v.y) : "memory");
  else
    *p = v;
}

template <bool CS>
__device__ __forceinline__ void st16(void* p, uint4 v) {
  if constexpr (CS)
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  else
    *static_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint4 as_u4(float4 f) {
  return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                    __float_as_uint(f.z), __float_as_uint(f.w));
}

__device__ __forceinline__ int64_t gid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---- compress ---------------------------------------------------------------

__global__ void __launch_bounds__(kT)
    k_c_stride1(const float* __restrict__ x, uint16_t* __restrict__ y,
              int64_t n, int64_t nvec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = gid(); k < nvec; k += stride)
    reinterpret_cast<uint2*>(y)[k] =
        pack4(reinterpret_cast<const float4*>(x)[k]);
  for (int64_t k = nvec * 4 + gid(); k < n; k += stride) y[k] = bf(x[k]);
}

template <int V, int L, bool CS>
__global__ void __launch_bounds__(kT)
    k_c_grid(const float* __restrict__ x, uint16_t* __restrict__ y, int64_t n,
           int64_t nvec) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kT * V +
                        threadIdx.x;
  float4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (first + j * kT < nvec)
      v[j] = ld16<L>(reinterpret_cast<const float4*>(x) + first + j * kT);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (first + j * kT < nvec)
      st8<CS>(reinterpret_cast<uint2*>(y) + first + j * kT, pack4(v[j]));
  const int64_t t = nvec * 4 + gid();
  if (t < n) y[t] = bf(x[t]);
}

__global__ void __launch_bounds__(kT)
    k_c_wide16(const float* __restrict__ x, uint16_t* __restrict__ y,
             int64_t n, int64_t n8) {
  const int64_t k = gid();
  if (k < n8) {
    const float4 a = ld16<kCs>(reinterpret_cast<const float4*>(x) + 2 * k);
    const float4 b = ld16<kCs>(reinterpret_cast<const float4*>(x) + 2 * k + 1);
    const uint2 lo = pack4(a), hi = pack4(b);
    st16<true>(reinterpret_cast<uint4*>(y) + k,
               make_uint4(lo.x, lo.y, hi.x, hi.y));
  }
  const int64_t t = n8 * 8 + k;
  if (t < n) y[t] = bf(x[t]);
}

// ---- decompress -------------------------------------------------------------

__global__ void __launch_bounds__(kT)
    k_d_stride1(const uint16_t* __restrict__ x, float* __restrict__ y,
              int64_t n, int64_t nvec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = gid(); k < nvec; k += stride)
    reinterpret_cast<float4*>(y)[k] =
        unpack4(reinterpret_cast<const uint2*>(x)[k]);
  for (int64_t k = nvec * 4 + gid(); k < n; k += stride) y[k] = fb(x[k]);
}

template <int V>
__global__ void __launch_bounds__(kT)
    k_d_grid(const uint16_t* __restrict__ x, float* __restrict__ y, int64_t n,
           int64_t nvec) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kT * V +
                        threadIdx.x;
  uint2 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (first + j * kT < nvec)
      v[j] = ld8<true>(reinterpret_cast<const uint2*>(x) + first + j * kT);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (first + j * kT < nvec)
      st16<true>(reinterpret_cast<float4*>(y) + first + j * kT,
                 as_u4(unpack4(v[j])));
  const int64_t t = nvec * 4 + gid();
  if (t < n) y[t] = fb(x[t]);
}

__global__ void __launch_bounds__(kT)
    k_d_wide16(const uint16_t* __restrict__ x, float* __restrict__ y,
             int64_t n, int64_t n8) {
  const int64_t k = gid();
  if (k < n8) {
    uint4 u;
    asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                 : "l"(reinterpret_cast<const uint4*>(x) + k));
    st16<true>(reinterpret_cast<float4*>(y) + 2 * k,
               as_u4(unpack4(make_uint2(u.x, u.y))));
    st16<true>(reinterpret_cast<float4*>(y) + 2 * k + 1,
               as_u4(unpack4(make_uint2(u.z, u.w))));
  }
  const int64_t t = n8 * 8 + k;
  if (t < n) y[t] = fb(x[t]);
}

int blocks(int64_t items) {
  return static_cast<int>((items + kT - 1) / kT);
}

int capped(int64_t items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int b = blocks(items < 1 ? 1 : items);
  return b < sms * 16 ? b : sms * 16;
}

int done() { return static_cast<int>(cudaGetLastError()); }

template <int V, int L, bool CS>
int c_grid_launch(const void* x, void* y, long long n, void* st) {
  const int64_t nvec = n / 4;
  const int64_t b1 = (nvec + static_cast<int64_t>(kT) * V - 1) / (kT * V);
  const int b = static_cast<int>(b1 > 0 ? b1 : 1);
  k_c_grid<V, L, CS><<<b, kT, 0, static_cast<cudaStream_t>(st)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(y), n, nvec);
  return done();
}

template <int V>
int d_grid_launch(const void* x, void* y, long long n, void* st) {
  const int64_t nvec = n / 4;
  const int64_t b1 = (nvec + static_cast<int64_t>(kT) * V - 1) / (kT * V);
  const int b = static_cast<int>(b1 > 0 ? b1 : 1);
  k_d_grid<V><<<b, kT, 0, static_cast<cudaStream_t>(st)>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(y), n, nvec);
  return done();
}

}  // namespace

#define CAST_ENTRY(name, ...)                                           \
  extern "C" int name(const void* x, void* y, long long n, void* st) { \
    __VA_ARGS__                                                       \
  }

CAST_ENTRY(c_stride1, {
  const int64_t nvec = n / 4;
  k_c_stride1<<<capped(nvec + n - nvec * 4), kT, 0,
              static_cast<cudaStream_t>(st)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(y), n, nvec);
  return done();
})
CAST_ENTRY(c_grid1, { return c_grid_launch<1, kPlain, false>(x, y, n, st); })
CAST_ENTRY(c_grid1cs, { return c_grid_launch<1, kCs, true>(x, y, n, st); })
CAST_ENTRY(c_grid2, { return c_grid_launch<2, kPlain, false>(x, y, n, st); })
CAST_ENTRY(c_grid2cs, { return c_grid_launch<2, kCs, true>(x, y, n, st); })
CAST_ENTRY(c_grid2nc, { return c_grid_launch<2, kNc, true>(x, y, n, st); })
CAST_ENTRY(c_grid2pf, { return c_grid_launch<2, kCsPf, true>(x, y, n, st); })
CAST_ENTRY(c_grid4cs, { return c_grid_launch<4, kCs, true>(x, y, n, st); })
CAST_ENTRY(c_wide16, {
  const int64_t n8 = n / 8;
  const int64_t items = n8 > n - n8 * 8 ? n8 : n - n8 * 8;
  k_c_wide16<<<blocks(items > 0 ? items : 1), kT, 0,
             static_cast<cudaStream_t>(st)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(y), n, n8);
  return done();
})
CAST_ENTRY(d_stride1, {
  const int64_t nvec = n / 4;
  k_d_stride1<<<capped(nvec + n - nvec * 4), kT, 0,
              static_cast<cudaStream_t>(st)>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(y), n, nvec);
  return done();
})
CAST_ENTRY(d_grid2cs, { return d_grid_launch<2>(x, y, n, st); })
CAST_ENTRY(d_grid4cs, { return d_grid_launch<4>(x, y, n, st); })
CAST_ENTRY(d_wide16, {
  const int64_t n8 = n / 8;
  const int64_t items = n8 > n - n8 * 8 ? n8 : n - n8 * 8;
  k_d_wide16<<<blocks(items > 0 ? items : 1), kT, 0,
             static_cast<cudaStream_t>(st)>>>(
      static_cast<const uint16_t*>(x), static_cast<float*>(y), n, n8);
  return done();
})
