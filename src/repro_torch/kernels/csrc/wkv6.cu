// The RWKV-6 WKV recurrence, token by token: the serving paths' time mix
// (the fixed-batch decode step, the engine's decode ticks, prefill chunks
// and speculative verify calls).
//
// It replaces no TPU kernel. The reference runs the exact recurrence as a
// lax.scan over tokens (repro/models/ssm.py, wkv_recurrent, lines 112-152),
// which XLA compiles into a loop; the port's plain version
// (kernels/ref.py, wkv6_recurrent_ref) is the same scan in PyTorch, some
// seven launches per token and layer. A 1,024-token prefill chunk through
// RWKV-6 7B's 32 layers would be about 230,000 launches; here it is one
// per layer.
//
// Layout: r, k, v and out (B, T, H, K), contiguous, f32 or bf16 (one dtype);
// w_log (B, T, H, K) f32; u (H, K) f32; state (B, H, K, K) f32, indexed
// [k][v]; valid (B, T) bytes (0 or 1) or null (every token valid); the new
// state (B, H, K, K), or with collect the state after every token (B, T, H,
// K, K). In f32, with w = exp(w_log), for each token t of row b, head h:
//   o[v]    = sum_k r[k] * (S[k][v] + u[k] * k[k] * v[v])
//   S[k][v] = w[k] * S[k][v] + k[k] * v[v]       (only where valid[b, t])
// o rounds once to the input type. The plain version's arithmetic up to
// the order of its sums and its roundings: here kv = k[k] * v[v] rounds
// once, S + u kv and the update are single fused multiply-adds, and the
// sum over k runs in k order in one chain (fmaf, never contracted
// otherwise: every operation is an explicit __f*_rn intrinsic).
//
// The contract: a token's o and state have the same bits in any call, for
// any T and B, whatever the other rows' valid and whether the call collects
// the states. Each (row, head) is one block that walks its row's tokens in
// order, and each token's arithmetic is the same instructions on the same
// values; nothing is shared between rows. The slot paths' bitwise streams
// (a verify call against decode ticks, a prompt split across chunks against
// one call) rest on it, as they do on ring_attention's.
//
// Design: one block of K threads per (row, head); thread j owns column j of
// the state, K floats in registers, for the whole call. Tokens are staged
// kTile at a time: every thread loads its element of each token's r, k and
// exp(w_log) into shared memory, then every thread reads them back as
// broadcasts. v[j] is the thread's own. The state is read once at the start
// and written once at the end (or after every token with collect), each
// access a K-float row of coalesced columns.
//
// Bound: at a decode tick the state's bytes (B H K^2 f32, read and written
// once), 16.8 MB at 8 slots of RWKV-6 7B's 64 heads of 64: 0.005 ms at 3.35
// TB/s. At a 1,024-token prefill chunk the operations the recurrence
// needs: 5 K^2 + 5 K a token and head (r . S 2 K^2, the update 3 K^2, the
// bonus (sum_k r_k u_k k_k) v in O(K)), 1.4e9 at 64 heads, 0.020 ms at the
// card's 67 TFLOP/s of f32 outside the tensor cores (wkv.work counts
// both). This kernel does the bonus in K^2 multiply-adds besides, and is
// far from both bounds: one block per (row, head) leaves most of the card
// idle at B = 1, and each token's sum is a chain of K dependent
// multiply-adds. It is the simple, right first kernel; a chunked
// tensor-core form is later work (ROADMAP).
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;     // tokens staged in shared memory at a time

template <class S>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

// bf16 travels as its raw 16 bits and widens exactly; the output rounds to
// nearest even, as PyTorch's cast does.
template <>
struct Io<uint16_t> {
  static __device__ __forceinline__ float load(uint16_t x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  static __device__ __forceinline__ uint16_t store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <class S, int K, bool kCollect>
__global__ void __launch_bounds__(K)
wkv6_kernel(const S* __restrict__ r, const S* __restrict__ k,
            const S* __restrict__ v, const float* __restrict__ w_log,
            const float* __restrict__ u, const float* __restrict__ state,
            const uint8_t* __restrict__ valid, S* __restrict__ out,
            float* __restrict__ state_out, int T, int H) {
  __shared__ __align__(16) float sr[kTile][K];
  __shared__ __align__(16) float sk[kTile][K];
  __shared__ __align__(16) float sw[kTile][K];
  __shared__ __align__(16) float su[K];
  __shared__ uint8_t sm[kTile];
  const int bh = blockIdx.x;            // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;            // the state column this thread owns
  float st[K];
  const float* s0 = state + static_cast<int64_t>(bh) * K * K;
#pragma unroll
  for (int q = 0; q < K; ++q) st[q] = s0[q * K + j];
  su[j] = u[h * K + j];
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();                    // the previous tile's reads are done
    for (int i = 0; i < n; ++i) {
      const int64_t at =
          ((static_cast<int64_t>(b) * T + t0 + i) * H + h) * K + j;
      sr[i][j] = Io<S>::load(r[at]);
      sk[i][j] = Io<S>::load(k[at]);
      sw[i][j] = expf(w_log[at]);
    }
    for (int i = j; i < n; i += K)
      sm[i] = valid ? valid[static_cast<int64_t>(b) * T + t0 + i] : 1;
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int64_t tok = static_cast<int64_t>(b) * T + t0 + i;
      const int64_t at = (tok * H + h) * K + j;
      const float vj = Io<S>::load(v[at]);
      const bool keep = sm[i] != 0;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float kv = __fmul_rn(sk[i][q], vj);
        o = __fmaf_rn(sr[i][q], __fmaf_rn(su[q], kv, st[q]), o);
        const float nxt = __fmaf_rn(sw[i][q], st[q], kv);
        st[q] = keep ? nxt : st[q];
      }
      out[at] = Io<S>::store(o);
      if constexpr (kCollect) {
        float* dst = state_out + (tok * H + h) * K * K;
#pragma unroll
        for (int q = 0; q < K; ++q) dst[q * K + j] = st[q];
      }
    }
  }
  if constexpr (!kCollect) {
    float* dst = state_out + static_cast<int64_t>(bh) * K * K;
#pragma unroll
    for (int q = 0; q < K; ++q) dst[q * K + j] = st[q];
  }
}

template <class S, int K>
void launch(bool collect, const void* r, const void* k, const void* v,
            const void* w_log, const void* u, const void* state,
            const void* valid, void* out, void* state_out, int B, int T,
            int H, cudaStream_t stream) {
  auto kernel = collect ? wkv6_kernel<S, K, true> : wkv6_kernel<S, K, false>;
  kernel<<<B * H, K, 0, stream>>>(
      static_cast<const S*>(r), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const float*>(w_log),
      static_cast<const float*>(u), static_cast<const float*>(state),
      static_cast<const uint8_t*>(valid), static_cast<S*>(out),
      static_cast<float*>(state_out), T, H);
}

template <class S>
int dispatch(bool collect, const void* r, const void* k, const void* v,
             const void* w_log, const void* u, const void* state,
             const void* valid, void* out, void* state_out, int B, int T,
             int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16:
      launch<S, 16>(collect, r, k, v, w_log, u, state, valid, out, state_out,
                    B, T, H, stream);
      break;
    case 64:
      launch<S, 64>(collect, r, k, v, w_log, u, state, valid, out, state_out,
                    B, T, H, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16 (r, k, v and out). valid may be null. B * H blocks
// of K threads, K in {16, 64}; T >= 1.
extern "C" int wkv6_forward(int dtype, int collect, const void* r,
                            const void* k, const void* v, const void* w_log,
                            const void* u, const void* state,
                            const void* valid, void* out, void* state_out,
                            int B, int T, int H, int K, void* stream) {
  if (B < 1 || T < 1 || H < 1 || dtype < 0 || dtype > 1 ||
      static_cast<int64_t>(B) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(collect != 0, r, k, v, w_log, u, state, valid,
                               out, state_out, B, T, H, K, st)
             : dispatch<uint16_t>(collect != 0, r, k, v, w_log, u, state,
                                  valid, out, state_out, B, T, H, K, st);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
