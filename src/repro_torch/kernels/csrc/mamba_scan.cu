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
// quads and the butterfly depend on N alone (mamba_scan.ORDER): no sum's
// order depends on B, T, Di, the launch plan, valid or collect, and
// nothing is shared between channels or rows. So a decode tick, a verify
// call and a prefill chunk round a token's y and state alike, and a
// prompt split across chunks leaves the bits of one call; the slot paths'
// bitwise streams rest on it, as they do on wkv6's and ring_attention's.
// Both paths below keep that layout and those operations in that order,
// as the first kernel of this file did (one lane a quad, every token's
// inputs loaded from device memory); only where the inputs come from
// changed, so each gives its bits.
//
// Bound. A decode tick (a token a row) moves the state, read and written
// once: 8.4 MB at 8 rows of Jamba's Di = 8192, N = 16, 0.0029 ms at 3.35
// TB/s. A 1,024-token prefill chunk of one row moves 101 MB (dt and dtx
// read, y written, 12 bytes a channel and token), 0.030 ms; but its 134 M
// state updates each issue about 14 instructions (expf alone is 8, one of
// them MUFU.EX2, and may not be shortened: its bits are PyTorch's exp's;
// the rest products and sums, none fused) plus about 3 for a lane's share
// of the loads, y's butterfly and the stores: some 73 M warp instructions
// on the card's 528 schedulers, about 0.07 ms at one a cycle. So the
// ticks are bound by bytes and the chunk by the issue rate of expf and
// its neighbours, at two warps a scheduler (one row has 1,024 warps).
//
// Design (the launch plan is mamba_scan.plan's, in Python; this file
// checks it). Both paths run one block per (row, group of `channels`
// channels), Q lanes a channel.
// - The direct path, for calls of a few tokens (decode ticks, verify
//   calls: mamba_scan.DIRECT_TOKENS): each lane reads its token's dt, dtx
//   and quads of Bm and C from device memory, the next token's before
//   this token's arithmetic, in blocks of at most 128 lanes; a verify
//   call's collected states leave by evict-first stores. Staging would
//   only add a barrier and a round trip through shared memory to a call
//   whose time is its state's bytes.
// - The staged path, for prefill chunks: a ring of token tiles in shared
//   memory. The block's threads copy each tile of up to 64 tokens (their
//   dt and dtx for the block's channels, a box of rows `channels` x 4
//   bytes long, and their Bm and C, N floats a token that every channel
//   of the block shares) by 16-byte cp.async into one of up to 3 stages,
//   two tiles ahead, each thread the same pieces of every tile. Each warp
//   takes a tile's valid bytes by loads a tile ahead and two ballots (a
//   bit a token); a tile whose tokens are all valid runs without the
//   valid select. Exps come off the chain: a lane takes 8 tokens at a
//   time, computes their exp(dt a), dtx b and C (32 independent exps)
//   from the tile, then runs the 8 updates, each one product and one sum
//   a state on the dependent chain. y leaves a tile at a time: the
//   channel's lane 0 writes each token's y into a (tile, channels) buffer
//   in shared memory (two, one a tile), and the block stores it with
//   16-byte stores while it computes the next tile. With collect each
//   lane stores the state after every token from registers (16 bytes a
//   lane, 512 contiguous bytes a warp); else the final state once.
// Measured on one H100 (PERF.md, tools/torch_mamba_ab.py): the chunk
// issues some 70 instructions a token and lane, about 0.10 ms against
// the first kernel's 0.52; the ticks run at 80-98 % of their byte bound
// and the verify call at it.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxTile = 64;          // tokens a tile: two ballots' bits
constexpr int kMaxSmem = 232448;      // 227 KB, a block's most on sm_90
constexpr int kMaxThreads = 256;      // 64 channels of 4 lanes
constexpr int kDirectThreads = 128;   // the direct path's blocks, at most
constexpr int kGroup = 8;             // tokens whose exps precede the chain

// Byte offsets of a staged block's shared memory: `stages` (3, or as many
// as the call has tiles) of a tile's dt (tile, channels), dtx (tile,
// channels), Bm (tile, N) and C (tile, N); then `bufs` (2, or 1 for one
// tile) y buffers (tile, channels). mamba_scan.plan computes the same
// total.
struct Layout {
  int stages;
  int dtx, bm, c, stage;                // within a stage; dt at 0
  int y0, ybuf, bytes;                  // the first y buffer, one's bytes
};

__host__ __device__ inline Layout layout(int N, int channels, int tile,
                                         int tiles) {
  const int bufs = tiles < 2 ? tiles : 2;
  Layout L;
  L.stages = tiles < 3 ? tiles : 3;
  L.dtx = tile * channels * 4;
  L.bm = 2 * L.dtx;
  L.c = L.bm + tile * N * 4;
  L.stage = L.c + tile * N * 4;
  L.ybuf = tile * channels * 4;
  L.y0 = L.stages * L.stage;
  L.bytes = L.y0 + bufs * L.ybuf;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const void* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(void* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// One state element's update: exp(dt * a) * h + dtx * b, each operation
// rounded on its own; `da` is exp(dt * a) and `bx` dtx * b.
__device__ __forceinline__ float4 update(float4 h, float4 da, float4 bx) {
  return make_float4(__fadd_rn(__fmul_rn(da.x, h.x), bx.x),
                     __fadd_rn(__fmul_rn(da.y, h.y), bx.y),
                     __fadd_rn(__fmul_rn(da.z, h.z), bx.z),
                     __fadd_rn(__fmul_rn(da.w, h.w), bx.w));
}

__device__ __forceinline__ float4 exps(float dt, float4 a) {
  return make_float4(expf(__fmul_rn(dt, a.x)), expf(__fmul_rn(dt, a.y)),
                     expf(__fmul_rn(dt, a.z)), expf(__fmul_rn(dt, a.w)));
}

__device__ __forceinline__ float4 scale(float dtx, float4 b) {
  return make_float4(__fmul_rn(dtx, b.x), __fmul_rn(dtx, b.y),
                     __fmul_rn(dtx, b.z), __fmul_rn(dtx, b.w));
}

// y of one token, the same in every lane of the channel: the lane's quad
// in order, then the butterfly over the channel's Q lanes (N's alone).
template <int Q>
__device__ __forceinline__ float y_of(float4 hn, float4 c) {
  float s = __fmul_rn(hn.x, c.x);
  s = __fadd_rn(s, __fmul_rn(hn.y, c.y));
  s = __fadd_rn(s, __fmul_rn(hn.z, c.z));
  s = __fadd_rn(s, __fmul_rn(hn.w, c.w));
#pragma unroll
  for (int off = 1; off < Q; off <<= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The direct path, for calls of a few tokens (decode ticks, verify
// calls), where staging has no latency to hide: each lane reads its
// token's dt, dtx and quads of Bm and C from device memory, the next
// token's before this token's arithmetic; collected states leave by
// evict-first stores.
template <int N, bool kCollect>
__global__ void __launch_bounds__(kDirectThreads)
    mamba_scan_direct(const float* __restrict__ dt,
                      const float* __restrict__ dtx,
                      const float* __restrict__ Bm,
                      const float* __restrict__ C,
                      const float* __restrict__ A,
                      const float* __restrict__ state,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ y, float* __restrict__ state_out,
                      int T, int Di, int channels) {
  constexpr int Q = N / 4;
  const int groups = Di / channels;
  const int b = blockIdx.x / groups;
  const int c = threadIdx.x / Q, q = threadIdx.x - c * Q;
  const int d = (blockIdx.x - b * groups) * channels + c;
  const int64_t bd = static_cast<int64_t>(b) * Di + d;
  const float4 a = __ldg(reinterpret_cast<const float4*>(A + d * N) + q);
  float4 h = __ldg(reinterpret_cast<const float4*>(state + bd * N) + q);
  struct Token {
    float dt, dtx;
    float4 b, c;
    bool ok;
  };
  auto load = [&](int64_t row_t) {
    Token k;
    k.dt = __ldg(dt + row_t * Di + d);
    k.dtx = __ldg(dtx + row_t * Di + d);
    k.b = __ldg(reinterpret_cast<const float4*>(Bm + row_t * N) + q);
    k.c = __ldg(reinterpret_cast<const float4*>(C + row_t * N) + q);
    k.ok = valid == nullptr || __ldg(valid + row_t) != 0;
    return k;
  };
  int64_t row_t = static_cast<int64_t>(b) * T;
  Token cur = load(row_t);
  for (int t = 0; t < T; ++t, ++row_t) {
    const Token nxt = t + 1 < T ? load(row_t + 1) : cur;
    const float4 hn = update(h, exps(cur.dt, a), scale(cur.dtx, cur.b));
    const float s = y_of<Q>(hn, cur.c);
    if (q == 0) y[row_t * Di + d] = s;
    if (cur.ok) h = hn;
    // a verify call's bytes are mostly these states, written once and
    // read by no one here: evict-first stores keep them out of L2's way
    if constexpr (kCollect)
      __stcs(reinterpret_cast<float4*>(state_out + (row_t * Di + d) * N) + q,
             h);
    cur = nxt;
  }
  if constexpr (!kCollect) st4(state_out + bd * N + q * 4, h);
}

// The staged path: `channels` channels of one row a block, Q lanes each.
// Tile i lands in stage i % S (S = 3, or 2 for a call of fewer tiles) and
// writes y buffer i % 2; while the block computes tile i, tiles i + 1 and
// i + 2 are in flight and tile i - 1's y goes out.
template <int N, bool kCollect>
__global__ void __launch_bounds__(kMaxThreads, 1)
    mamba_scan_staged(const float* __restrict__ dt,
                      const float* __restrict__ dtx,
                      const float* __restrict__ Bm,
                      const float* __restrict__ C,
                      const float* __restrict__ A,
                      const float* __restrict__ state,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ y, float* __restrict__ state_out,
                      int T, int Di, int channels, int tile) {
  constexpr int Q = N / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = channels * Q;
  const int tiles = (T + tile - 1) / tile;
  const int S = tiles >= 3 ? 3 : 2;     // stage of tile i: i % S
  const Layout L = layout(N, channels, tile, tiles);

  const int groups = Di / channels;
  const int b = blockIdx.x / groups;
  const int d0 = (blockIdx.x - b * groups) * channels;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = tid / Q, q = tid - c * Q;   // the lane's channel and quad
  const int64_t row_tok = static_cast<int64_t>(b) * T;
  const int64_t bd = static_cast<int64_t>(b) * Di + d0 + c;
  // the thread's share of a tile's copies, the same in every tile: piece
  // cj (16 bytes) of dt's and dtx's rows ct, ct + cstep, ...; pieces tid,
  // tid + threads, ... of Bm's and C's (contiguous) span
  const int per = channels / 4;
  const int cj = tid % per, ct = tid / per, cstep = threads / per;

  auto stage_of = [&](int i) { return smem + (i % S) * L.stage; };
  auto ybuf_of = [&](int i) {
    return reinterpret_cast<float*>(smem + L.y0 + (i & 1) * L.ybuf);
  };
  auto issue = [&](int i) {             // tile i's copies, one group
    if (i < tiles) {
      const int t0 = i * tile, n = min(tile, T - t0);
      unsigned char* dst = stage_of(i);
      const int64_t at = (row_tok + t0) * Di + d0 + cj * 4;
      for (int t = ct; t < n; t += cstep) {
        cp_async16(dst + (t * channels + cj * 4) * 4, dt + at + t * Di);
        cp_async16(dst + L.dtx + (t * channels + cj * 4) * 4,
                   dtx + at + t * Di);
      }
      const float* sb = Bm + (row_tok + t0) * N;
      const float* sc = C + (row_tok + t0) * N;
      for (int k = tid; k < n * (N / 4); k += threads) {
        cp_async16(dst + L.bm + k * 16, sb + k * 4);
        cp_async16(dst + L.c + k * 16, sc + k * 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the lane's valid byte of tile i's half `hf` (1 past the call's tokens)
  auto valid_of = [&](int i, int hf) -> int {
    const int t = hf * 32 + lane;
    return valid == nullptr || i >= tiles || t >= min(tile, T - i * tile)
               ? 1
               : __ldg(valid + row_tok + i * tile + t);
  };
  // y of tile i out of its buffer: rows of `channels` floats, 16 bytes a
  // thread
  auto store_y = [&](int i) {
    const int t0 = i * tile, n = min(tile, T - t0);
    const float* yb = ybuf_of(i);
    for (int t = ct; t < n; t += cstep)
      st4(y + (row_tok + t0 + t) * Di + d0 + cj * 4,
          ld4(yb + t * channels + cj * 4));
  };

  issue(0);
  if (S == 3) issue(1);
  int keep0 = valid_of(0, 0), keep1 = valid_of(0, 1);
  const float4 a = ld4(A + static_cast<int64_t>(d0 + c) * N + q * 4);
  float4 h = ld4(state + bd * N + q * 4);

  for (int i = 0; i < tiles; ++i) {
    const int t0 = i * tile, n = min(tile, T - t0);
    // tile i's copies are in: the next tile's group may still fly
    if (S == 3)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                    // ... every thread's; tile i - 1 done
    issue(i + S - 1);                   // into tile i - 1's stage
    if (i > 0) store_y(i - 1);
    const uint64_t keep =
        static_cast<uint64_t>(__ballot_sync(0xffffffffu, keep1 != 0)) << 32 |
        __ballot_sync(0xffffffffu, keep0 != 0);
    keep0 = valid_of(i + 1, 0);
    keep1 = valid_of(i + 1, 1);

    const unsigned char* st = stage_of(i);
    // the lane's inputs and outputs, bumped a group of tokens at a time
    const float* pdt = reinterpret_cast<const float*>(st) + c;
    const float* pdx = reinterpret_cast<const float*>(st + L.dtx) + c;
    const float* pb = reinterpret_cast<const float*>(st + L.bm) + q * 4;
    const float* pc = reinterpret_cast<const float*>(st + L.c) + q * 4;
    float* py = ybuf_of(i) + c;
    float* so = state_out + ((row_tok + t0) * Di + d0 + c) * N + q * 4;
    const int64_t so_step = static_cast<int64_t>(Di) * N;

    // G tokens from t: their exps, dtx b and C first, then the chain, a
    // product and a sum a state and token
    auto run = [&](int t, auto g, auto masked) {
      constexpr int G = decltype(g)::value;
      float4 da[G], bx[G], cc[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        da[u] = exps(pdt[u * channels], a);
        bx[u] = scale(pdx[u * channels], ld4(pb + u * N));
        cc[u] = ld4(pc + u * N);
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float4 hn = update(h, da[u], bx[u]);
        const float s = y_of<Q>(hn, cc[u]);
        if (q == 0) py[u * channels] = s;
        if constexpr (decltype(masked)::value) {
          if ((keep >> (t + u)) & 1u) h = hn;
        } else {
          h = hn;
        }
        if constexpr (kCollect) st4(so + u * so_step, h);
      }
      pdt += G * channels;
      pdx += G * channels;
      pb += G * N;
      pc += G * N;
      py += G * channels;
      if constexpr (kCollect) so += G * so_step;
    };
    auto tokens = [&](auto masked) {
      int t = 0;
      for (; t + kGroup <= n; t += kGroup)
        run(t, std::integral_constant<int, kGroup>(), masked);
      for (; t < n; ++t) run(t, std::integral_constant<int, 1>(), masked);
    };
    if (keep == ~0ull)
      tokens(std::false_type());
    else
      tokens(std::true_type());
  }
  __syncthreads();
  store_y(tiles - 1);
  if constexpr (!kCollect) st4(state_out + bd * N + q * 4, h);
}

// Raise an instantiation's dynamic shared memory limit to kMaxSmem, once
// per device (each card holds its own function attributes).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (*done & (1u << dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) *done |= 1u << dev;
  return e;
}

template <int N>
int launch(bool collect, const float* dt, const float* dtx, const float* Bm,
           const float* C, const float* A, const float* state,
           const uint8_t* valid, float* y, float* state_out, int B, int T,
           int Di, int channels, int tile, int stages, int threads, int smem,
           cudaStream_t stream) {
  const int tiles = (T + tile - 1) / tile;
  const Layout L = layout(N, channels, tile, tiles);
  const bool direct = stages == 0;
  if ((channels != 16 && channels != 32 && channels != 64) ||
      Di % channels != 0 || threads != channels * (N / 4) ||
      (direct ? tile != 1 || smem != 0 || threads > kDirectThreads
              : tile < 1 || tile > kMaxTile || stages != L.stages ||
                    smem != L.bytes || smem > kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(B) * (Di / channels);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (direct) {
    auto kernel = collect ? mamba_scan_direct<N, true>
                          : mamba_scan_direct<N, false>;
    kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
        dt, dtx, Bm, C, A, state, valid, y, state_out, T, Di, channels);
    return static_cast<int>(cudaGetLastError());
  }
  static unsigned done[2];
  auto kernel = collect ? mamba_scan_staged<N, true>
                        : mamba_scan_staged<N, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kernel, &done[collect]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
      dt, dtx, Bm, C, A, state, valid, y, state_out, T, Di, channels, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N (d_state) in {8, 16}; Di a multiple of 16; B, T >= 1; valid may be
// null; every other pointer 16-byte aligned. The launch plan
// (mamba_scan.plan): channels, the channels a block owns (16, 32 or 64,
// dividing Di); stages, 0 for the direct path (then tile 1, smem 0 and at
// most 128 threads), else the staged path's stages of that layout (1 to
// 3); tile, the tokens staged at a time (1 to 64); threads, channels * N /
// 4; smem, the dynamic shared memory bytes of that layout. Another shape
// or plan is refused.
extern "C" int mamba_scan_forward(int collect, const void* dt,
                                  const void* dtx, const void* Bm,
                                  const void* C, const void* A,
                                  const void* state, const void* valid,
                                  void* y, void* state_out, int B, int T,
                                  int Di, int N, int channels, int tile,
                                  int stages, int threads, int smem,
                                  void* stream) {
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
                     f(state), v, yo, so, B, T, Di, channels, tile, stages,
                     threads, smem, st);
  if (N == 16)
    return launch<16>(collect != 0, f(dt), f(dtx), f(Bm), f(C), f(A),
                      f(state), v, yo, so, B, T, Di, channels, tile, stages,
                      threads, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
