// The Mamba selective scan, token by token: the serving paths' recurrence
// of a Mamba mixer (the fixed-batch decode step, the engine's decode ticks,
// prefill chunks and speculative verify calls).
//
// It replaces no TPU kernel. The reference runs the exact recurrence as a
// lax.scan over tokens (repro/models/ssm.py, mamba_scan_recurrent, lines
// 390-424, and the T = 1 step at 486-491), which XLA compiles into a loop;
// the port's plain version (kernels/ref.py, mamba_scan_recurrent_ref) is
// the same scan in PyTorch, some six launches per token and layer. A
// 1,024-token prefill chunk through Jamba's 7 Mamba layers a period would
// be about 43,000 launches; here it is one per layer.
//
// Layout: dt, dtx and y (B, T, Di) f32; Bm and C (B, T, N) f32; A (Di, N)
// f32 (negative: -exp(A_log)); state (B, Di, N) f32; valid (B, T) bytes (0
// or 1) or null (every token valid); the new state (B, Di, N), or with
// collect the state after every token (B, T, Di, N). All contiguous, every
// pointer but valid 16-byte aligned. For each token t of row b, channel d:
//   h'[n] = exp(dt * A[d][n]) * h[n] + dtx * Bm[n]
//   y     = sum_n h'[n] * C[n]
//   h[n]  = h'[n]                                 (only where valid[b, t])
// Each product, exp and sum of the update rounds on its own (__fmul_rn,
// __fadd_rn, expf; nothing is contracted into a fused multiply-add), as
// the plain version's separate PyTorch ops round on the card: the state
// is the plain version's bit for bit wherever expf is PyTorch's exp. Only
// y's sum over n is a reduction, and its order is fixed as follows.
//
// The order, and why a token has the same bits in any call. Q = N / 4
// lanes of one warp share a channel; lane q holds states 4q .. 4q + 3 in
// registers for the whole call. Its part of y is ((h'0 C0 + h'1 C1) + h'2
// C2) + h'3 C3 over its four (each product and sum rounded), then the Q
// parts meet in a butterfly of xor shuffles (offsets 1, then 2), which
// leaves the same sum in every lane (IEEE addition commutes). Q, the
// quads and the butterfly depend on N alone: no sum's order depends on B,
// T, Di, the grid, valid or collect, and nothing is shared between
// channels or rows. So a decode tick, a verify call and a prefill chunk
// round a token's y and state alike, and a prompt split across chunks
// leaves the bits of one call; the slot paths' bitwise streams rest on
// it, as they do on wkv6's and ring_attention's.
//
// Design (simple first): one thread a (row, channel, quad), blocks of 128
// threads over the (row, channel) pairs in order, so at B = 1, Di = 8192,
// N = 16 the grid is 256 blocks (two an SM). A lane reads its channel's
// quad of A and of the state once with 16-byte loads and keeps them; per
// token it reads dt and dtx (one word each; the Q lanes of a channel read
// the same word) and its quads of Bm and C (16-byte loads every channel
// of the row shares, from L1), with the next token's words loaded before
// this token's arithmetic. With collect it stores the state after every
// token with one 16-byte store a lane (a warp writes 512 contiguous bytes
// a token), else the final state once. y is written by lane 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;

struct Token {
  float dt, dtx;
  float4 b, c;
  bool ok;
};

__device__ __forceinline__ Token load_token(const float* dt, const float* dtx,
                                            const float* Bm, const float* C,
                                            const uint8_t* valid,
                                            int64_t row_t, int64_t chan,
                                            int N, int q) {
  Token k;
  k.dt = __ldg(dt + chan);
  k.dtx = __ldg(dtx + chan);
  k.b = __ldg(reinterpret_cast<const float4*>(Bm + row_t * N) + q);
  k.c = __ldg(reinterpret_cast<const float4*>(C + row_t * N) + q);
  k.ok = valid == nullptr || __ldg(valid + row_t) != 0;
  return k;
}

// One state element's update: exp(dt * a) * h + dtx * b, each operation
// rounded on its own.
__device__ __forceinline__ float update(float h, float dt, float a,
                                        float dtx, float b) {
  return __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a)), h), __fmul_rn(dtx, b));
}

template <int N, bool kCollect>
__global__ void __launch_bounds__(kBlock)
    mamba_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ dtx,
                      const float* __restrict__ Bm,
                      const float* __restrict__ C,
                      const float* __restrict__ A,
                      const float* __restrict__ state,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ y, float* __restrict__ state_out,
                      int T, int Di, int64_t lanes) {
  constexpr int Q = N / 4;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  // Di is a multiple of 16, so every warp lies wholly inside or outside the
  // grid's lanes and the shuffles below always see 32 live lanes
  if (gid >= lanes) return;
  const int q = static_cast<int>(gid % Q);
  const int64_t bd = gid / Q;  // b * Di + d
  const int d = static_cast<int>(bd % Di);
  const int64_t b = bd / Di;

  const float4 a = __ldg(reinterpret_cast<const float4*>(A + d * N) + q);
  float4 h = __ldg(reinterpret_cast<const float4*>(state + bd * N) + q);

  int64_t row_t = b * T;
  Token cur = load_token(dt, dtx, Bm, C, valid, row_t, row_t * Di + d, N, q);
  for (int t = 0; t < T; ++t, ++row_t) {
    Token nxt = cur;
    if (t + 1 < T)
      nxt = load_token(dt, dtx, Bm, C, valid, row_t + 1, (row_t + 1) * Di + d,
                       N, q);
    float4 hn;
    hn.x = update(h.x, cur.dt, a.x, cur.dtx, cur.b.x);
    hn.y = update(h.y, cur.dt, a.y, cur.dtx, cur.b.y);
    hn.z = update(h.z, cur.dt, a.z, cur.dtx, cur.b.z);
    hn.w = update(h.w, cur.dt, a.w, cur.dtx, cur.b.w);
    float s = __fmul_rn(hn.x, cur.c.x);
    s = __fadd_rn(s, __fmul_rn(hn.y, cur.c.y));
    s = __fadd_rn(s, __fmul_rn(hn.z, cur.c.z));
    s = __fadd_rn(s, __fmul_rn(hn.w, cur.c.w));
#pragma unroll
    for (int off = 1; off < Q; off <<= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (q == 0) y[row_t * Di + d] = s;
    if (cur.ok) h = hn;
    if constexpr (kCollect)
      reinterpret_cast<float4*>(state_out + (row_t * Di + d) * N)[q] = h;
    cur = nxt;
  }
  if constexpr (!kCollect)
    reinterpret_cast<float4*>(state_out + bd * N)[q] = h;
}

template <int N>
int launch(bool collect, const float* dt, const float* dtx, const float* Bm,
           const float* C, const float* A, const float* state,
           const uint8_t* valid, float* y, float* state_out, int B, int T,
           int Di, cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(B) * Di * (N / 4);
  const int64_t blocks = (lanes + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = collect ? mamba_scan_kernel<N, true>
                        : mamba_scan_kernel<N, false>;
  kernel<<<static_cast<int>(blocks), kBlock, 0, stream>>>(
      dt, dtx, Bm, C, A, state, valid, y, state_out, T, Di, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N (d_state) in {8, 16}; Di a multiple of 16; B, T >= 1; valid may be
// null; every other pointer 16-byte aligned. Another shape is refused.
extern "C" int mamba_scan_forward(int collect, const void* dt,
                                  const void* dtx, const void* Bm,
                                  const void* C, const void* A,
                                  const void* state, const void* valid,
                                  void* y, void* state_out, int B, int T,
                                  int Di, int N, void* stream) {
  const void* ptrs[] = {dt, dtx, Bm, C, A, state, y, state_out};
  for (const void* p : ptrs)
    if (!repro_torch::aligned(p, 16))
      return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || T < 1 || Di < 16 || Di % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* yo = static_cast<float*>(y);
  auto* so = static_cast<float*>(state_out);
  if (N == 8)
    return launch<8>(collect != 0, f(dt), f(dtx), f(Bm), f(C), f(A),
                     f(state), v, yo, so, B, T, Di, st);
  if (N == 16)
    return launch<16>(collect != 0, f(dt), f(dtx), f(Bm), f(C), f(A),
                      f(state), v, yo, so, B, T, Di, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
