// Blockwise elementwise combine for the pipelined allreduce, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/block_combine.py:
// _combine2_kernel and _combine3_kernel, launched by _run (pallas_call at
// block_combine.py:72) for combine2 and combine3.
//
// Computes out = op(a, b) (combine2) or op(op(a, b), c) (combine3),
// elementwise over n contiguous elements, with op in {add, max, min, mul}
// and the element type in {f32, bf16, i32}. bf16 rounds the intermediate
// op(a, b) to bf16 before the second op, so the result is bit-equal to two
// separate bf16 PyTorch ops. max/min propagate NaN the way PyTorch's
// maximum/minimum do (the NaN operand's own bits) and treat +-inf as
// ordinary values; int32 add/mul wrap as two's complement.
//
// Bound: memory. combine3 reads three operands and writes one, 4*n*s bytes
// for an element of s bytes, against two operations per element: far below
// the card's operations-per-byte ratio. Design: 16-byte vector loads and
// stores when every pointer is 16-byte aligned, and a scalar tail in the
// same launch. combine3 runs one grid-stride loop (at most 16 blocks per
// SM). combine2 streams over a full grid, one 16-byte vector of each
// operand per thread with evict-first hints (ld/st.global.cs), the design
// of the bf16 wire cast: the capped grid-stride loop ran 1.3 % behind
// torch.add's device time on this card (PERF.md). There is no tiling or
// padding: the TPU's (512, 128) VMEM tiles have no counterpart here.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::aligned;
using repro_torch::grid_for;
using repro_torch::kThreads;

enum { OP_ADD = 0, OP_MAX = 1, OP_MIN = 2, OP_MUL = 3 };
enum { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };

// Storage type S, and its conversions to and from the type the op runs in.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S x) { return x; }
  static __device__ __forceinline__ S store(float x) { return x; }
};

// bf16 travels as its raw 16 bits; arithmetic runs in f32 and rounds to
// nearest even on the way back, as PyTorch's bf16 ops do on this card.
struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float load(S x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  static __device__ __forceinline__ S store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

struct I32 {
  using S = int32_t;
};

template <class T, int OP>
__device__ __forceinline__ typename T::S apply(typename T::S a,
                                               typename T::S b) {
  if constexpr (std::is_same<T, I32>::value) {
    if constexpr (OP == OP_ADD)
      return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                  static_cast<uint32_t>(b));
    else if constexpr (OP == OP_MUL)
      return static_cast<int32_t>(static_cast<uint32_t>(a) *
                                  static_cast<uint32_t>(b));
    else if constexpr (OP == OP_MAX)
      return a > b ? a : b;
    else
      return a < b ? a : b;
  } else {
    const float fa = T::load(a), fb = T::load(b);
    if constexpr (OP == OP_ADD) {
      return T::store(fa + fb);
    } else if constexpr (OP == OP_MUL) {
      return T::store(fa * fb);
    } else {
      // A NaN operand is returned as it is, bits and all.
      if (fa != fa) return a;
      if (fb != fb) return b;
      return T::store(OP == OP_MAX ? fmaxf(fa, fb) : fminf(fa, fb));
    }
  }
}

template <class S, int V>
union Pack {
  uint4 u;
  S s[V];
};

// combine3 in a grid-stride loop: vector k of a, b and c, then the tail.
template <class T, int OP>
__global__ void __launch_bounds__(kThreads)
    combine3_kernel(const typename T::S* __restrict__ a,
                    const typename T::S* __restrict__ b,
                    const typename T::S* __restrict__ c,
                    typename T::S* __restrict__ out, int64_t n,
                    int64_t nvec) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t k = tid; k < nvec; k += stride) {
    Pack<S, V> pa, pb, pc, po;
    pa.u = reinterpret_cast<const uint4*>(a)[k];
    pb.u = reinterpret_cast<const uint4*>(b)[k];
    pc.u = reinterpret_cast<const uint4*>(c)[k];
#pragma unroll
    for (int j = 0; j < V; ++j)
      po.s[j] = apply<T, OP>(apply<T, OP>(pa.s[j], pb.s[j]), pc.s[j]);
    reinterpret_cast<uint4*>(out)[k] = po.u;
  }
  for (int64_t k = nvec * V + tid; k < n; k += stride)
    out[k] = apply<T, OP>(apply<T, OP>(a[k], b[k]), c[k]);
}

// 16-byte loads and stores that evict first: each byte is touched once.
__device__ __forceinline__ uint4 ld_cs(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// combine2 over a full grid: thread k < nvec takes vector k of a and b;
// the next (n - nvec * V) threads take the scalar tail, one element each.
template <class T, int OP>
__global__ void __launch_bounds__(kThreads)
    combine2_kernel(const typename T::S* __restrict__ a,
                    const typename T::S* __restrict__ b,
                    typename T::S* __restrict__ out, int64_t n,
                    int64_t nvec) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k < nvec) {
    Pack<S, V> pa, pb, po;
    pa.u = ld_cs(reinterpret_cast<const uint4*>(a) + k);
    pb.u = ld_cs(reinterpret_cast<const uint4*>(b) + k);
#pragma unroll
    for (int j = 0; j < V; ++j) po.s[j] = apply<T, OP>(pa.s[j], pb.s[j]);
    st_cs(reinterpret_cast<uint4*>(out) + k, po.u);
  } else {
    const int64_t e = nvec * V + (k - nvec);
    if (e < n) out[e] = apply<T, OP>(a[e], b[e]);
  }
}

template <class T, int OP, int NARGS>
void launch(const void* a, const void* b, const void* c, void* out, int64_t n,
            cudaStream_t stream) {
  using S = typename T::S;
  constexpr int V = 16 / sizeof(S);
  const bool vec = aligned(a, 16) && aligned(b, 16) && aligned(out, 16) &&
                   (NARGS == 2 || aligned(c, 16));
  const int64_t nvec = vec ? n / V : 0;
  const int64_t items = nvec + (n - nvec * V);
  if constexpr (NARGS == 2) {
    const int64_t blocks = (items + kThreads - 1) / kThreads;
    combine2_kernel<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(static_cast<const S*>(a),
                                       static_cast<const S*>(b),
                                       static_cast<S*>(out), n, nvec);
  } else {
    combine3_kernel<T, OP><<<grid_for(items), kThreads, 0, stream>>>(
        static_cast<const S*>(a), static_cast<const S*>(b),
        static_cast<const S*>(c), static_cast<S*>(out), n, nvec);
  }
}

template <class T, int NARGS>
bool launch_op(int op, const void* a, const void* b, const void* c, void* out,
               int64_t n, cudaStream_t stream) {
  switch (op) {
    case OP_ADD: launch<T, OP_ADD, NARGS>(a, b, c, out, n, stream); return true;
    case OP_MAX: launch<T, OP_MAX, NARGS>(a, b, c, out, n, stream); return true;
    case OP_MIN: launch<T, OP_MIN, NARGS>(a, b, c, out, n, stream); return true;
    case OP_MUL: launch<T, OP_MUL, NARGS>(a, b, c, out, n, stream); return true;
    default: return false;
  }
}

template <int NARGS>
int combine(int op, int dtype, const void* a, const void* b, const void* c,
            void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case DT_F32: ok = launch_op<F32, NARGS>(op, a, b, c, out, n, st); break;
    case DT_BF16: ok = launch_op<BF16, NARGS>(op, a, b, c, out, n, st); break;
    case DT_I32: ok = launch_op<I32, NARGS>(op, a, b, c, out, n, st); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bc_combine2(int op, int dtype, const void* a, const void* b,
                           void* out, long long n, void* stream) {
  return combine<2>(op, dtype, a, b, nullptr, out, n, stream);
}

extern "C" int bc_combine3(int op, int dtype, const void* a, const void* b,
                           const void* c, void* out, long long n,
                           void* stream) {
  return combine<3>(op, dtype, a, b, c, out, n, stream);
}

extern "C" const char* bc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
